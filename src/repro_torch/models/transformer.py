"""Decoder-only LM: the port of ``repro/models/transformer.py::
TransformerLM`` for the dense GQA transformers (qwen3, llama3.2,
minitron, nemotron), the mixture-of-experts ones (granite-moe, qwen3-moe),
the VLM backbone (llava: patch embeddings and padded q heads), the RG-LRU
+ local-attention hybrid (recurrentgemma) and attention-free RWKV6.

The reference stacks the layers of each block-pattern position and scans
over periods; here the params hold a per-layer list and a loop runs it, in
the reference's layer order (layer l has kind ``block_pattern[l % P]``).
Block kinds:

- ``attn`` / ``attn_local``: prefill attention through
  ``ops.flash_attention`` (B15) and decode attention through
  ``ops.decode_attention`` (B14), ``attn_local`` with ``cfg.window``; the
  KV cache (bf16, or int8 codes and scales with ``cfg.kv_quant``) is
  updated in place (``attention.kv_cache_update``); with
  ``cfg.pad_heads_to`` the q and output projections hold that many heads,
  attention runs on the ``num_heads`` real ones and the dummy heads'
  outputs are 0, as the reference masks them;
- ``rec``: the RG-LRU mixer (``recurrent.rglru_apply`` / ``rglru_step``);
- ``rwkv``: RWKV6's time mix and its own channel-mix FFN in place of the
  MLP (``recurrent.rwkv_time_mix`` / ``rwkv_time_mix_step`` /
  ``rwkv_channel_mix``).

The FFN after a mixer is a dense MLP or, with ``cfg.moe``, the
mixture of experts (``moe.moe_apply``), whose load-balancing terms
``forward`` sums over the layers. With ``cfg.num_patches`` the first
positions of a prompt take rms-normed patch embeddings (``forward``'s
``patch_embeds``, ``prefill``'s ``extra``).

A prefill writes the recurrent state into the cache's leaves in place (the
engine's static decode cache); a decode step returns new state tensors
beside the in-place KV cache, which the decode loop copies into its static
buffers (``runtime.assign``) and the speculative chain keeps as its
checkpoints (``spec.verify``). The training forward (``forward`` /
``loss``) takes the reference's train-mode attention in plain PyTorch
(``attention.train_attention``, windowed for ``attn_local``), never B15,
so every weight gets its gradient; with ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the reference
remats each period.

The projections, the MLP or the experts, the recurrent mixers, the
embedding and the head go through ``dist.tensor_parallel``'s forms
(``self.tp``): the one-device math without a mesh; under one
(``with_mesh``: every block kind, the int8 cache too) the
tensor-parallel forms on each rank's pieces of the params, which the
prefill and the split-KV decode step share, and the training forward and
backward of every family (``loss``: the vocab-parallel cross-entropy).
"""
from __future__ import annotations

import copy

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from . import moe as M
from . import recurrent as R
from ..device import resolve_device
from ..dist.tensor_parallel import TensorParallel

KINDS = ("attn", "attn_local", "rec", "rwkv")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a block kind the model does not know."""
    kinds = sorted(set(cfg.block_pattern) - set(KINDS))
    if kinds:
        raise ValueError(f"{cfg.name}: unknown block kinds {kinds}")


class TransformerLM:
    """A decoder-only LM of attention, RG-LRU and RWKV6 blocks (dense or
    mixture-of-experts FFNs) behind the serving contract (``cache_defs`` /
    ``init_cache`` / ``prefill`` / ``decode_step``)."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.vocab_padded = L.pad_vocab(cfg.vocab_size)
        P = len(cfg.block_pattern)
        self.kinds = tuple(cfg.block_pattern[i % P]
                           for i in range(cfg.num_layers))
        self.has_attention = any(k.startswith("attn") for k in self.kinds)
        # q heads stored: the real ones, then dummy ones (pad_heads_to)
        self.h_eff = cfg.pad_heads_to or cfg.num_heads
        # a (data, model) DeviceMesh: tensor-parallel forward, split-KV
        # sharded decode (with_mesh)
        self.mesh = None
        self.tp = TensorParallel(None)

    def with_mesh(self, mesh) -> "TransformerLM":
        """Copy of this model over ``mesh`` (a DeviceMesh with a ``model``
        axis), or, with None, on one device. Its params are DTensors laid
        out by ``training.param_shardings``
        (``dist.splitkv.partition_transformer_params``): the training
        forward, the prefill and the decode step run tensor-parallel on
        each rank's pieces (``dist.tensor_parallel``: a mixture's experts
        on their ranks); its cache is the rank's segment of ``cache_seq``
        (int8 codes and scales under ``kv_quant``), decoded split-KV
        (``dist.splitkv``: a local-attention layer's from its first key of
        the window); the recurrent blocks on the rank's ``d_rnn`` columns
        or heads, their state the rank's slice."""
        other = copy.copy(self)
        other.mesh = mesh
        other.tp = TensorParallel(mesh)
        return other

    # ------------------------------------------------------------- params
    def _block_defs(self, kind: str) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        d = {"norm1": L.norm_defs(cfg.norm, cfg.d_model),
             "norm2": L.norm_defs(cfg.norm, cfg.d_model)}
        if kind in ("attn", "attn_local"):
            d["attn"] = A.attn_defs(cfg.d_model, self.h_eff,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qk_norm, dt)
        elif kind == "rec":
            d["rec"] = R.rglru_defs(cfg.d_model, cfg.rnn_width,
                                    cfg.conv_width, dt)
        else:
            d["rwkv"] = R.rwkv_defs(cfg.d_model, cfg.num_heads, cfg.head_dim,
                                    cfg.d_ff, dt)
        if kind == "rwkv":      # rwkv carries its own channel-mix FFN
            return d
        if cfg.moe:
            d["moe"] = M.moe_defs(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                  cfg.activation, dt)
        else:
            d["mlp"] = L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.activation, dt)
        return d

    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        defs = {
            "embed": L.embed_defs(self.vocab_padded, cfg.d_model, dt),
            "final_norm": L.norm_defs(cfg.norm, cfg.d_model),
            "head": {"w": L.PSpec((cfg.d_model, self.vocab_padded), dtype=dt,
                                  axes=("embed", "vocab"))},
            "layers": [self._block_defs(k) for k in self.kinds],
        }
        if cfg.num_patches:
            defs["patch_norm"] = L.norm_defs("rmsnorm", cfg.d_model)
        return defs

    def param_axes(self):
        """Each param's logical axes (the sharding rules' names; ``()``
        where a leaf names none)."""
        return L.param_axes(self.param_defs())

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (seed 0 on the CPU when None;
        ``layers.init_params`` draws on the generator's device) on
        ``device`` (default ``cuda``; raises without a card unless
        ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def abstract_params(self, device="meta"):
        """The params' stand-ins (``layers.abstract_params``): their shapes
        and dtypes, no data."""
        return L.abstract_params(self.param_defs(), device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------- blocks
    def _zero_state(self, p, x):
        """The rwkv mixer's and channel mix's state before a sequence, on
        the heads of ``p`` (the layer's params: a rank's under a mesh)."""
        from ..dist.tensor_parallel import local
        cfg = self.cfg
        B, d = x.shape[0], x.shape[2]
        heads = local(p["u"]).shape[0]
        return {"S": torch.zeros((B, heads, cfg.head_dim,
                                  cfg.head_dim), dtype=torch.float32,
                                 device=x.device),
                "x_tm": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                "x_cm": torch.zeros((B, d), dtype=x.dtype, device=x.device)}

    def _attention(self, kind, p, h, rot, cache, pos, lengths, train):
        """The attention mixer of ``_block``: (B, S, h_eff, Dh) outputs,
        the dummy heads' 0; under a mesh, the rank's heads' outputs."""
        cfg = self.cfg
        window = cfg.window if kind == "attn_local" else None
        H = cfg.num_heads
        q, k, v = self.tp.qkv(p, h, rot, qk_norm=cfg.qk_norm)
        if self.mesh is not None and not train:
            from ..dist import splitkv
            return splitkv.attend(self, q, k, v, cache, pos, lengths,
                                  window)
        if train and H != self.h_eff and q.shape[2] < self.h_eff:
            # the rank's block of padded heads: all attend, the dummy
            # heads' outputs scaled to 0
            q, k, v, real = self.tp.real_heads(q, k, v, H, cfg.num_kv_heads)
            return A.train_attention(q, k, v, block_q=cfg.block_q,
                                     block_kv=cfg.block_kv,
                                     window=window) * real
        q = q[:, :, :H]                  # the real heads attend
        k, v = self.tp.kv_for_q(q, k, v, H, cfg.num_kv_heads)
        if train:
            o = A.train_attention(q, k, v, block_q=cfg.block_q,
                                  block_kv=cfg.block_kv, window=window)
        elif lengths is not None:
            A.kv_cache_update(cache, k, v, pos)
            o = A.decode_attention(q, A.dequantize_cache(cache, h.dtype),
                                   lengths, window=window)
        else:
            o = A.prefill_attention(q, k, v, window=window)
            if cache is not None:
                A.kv_cache_update(cache, k, v, 0)
        if self.h_eff != H:
            o = torch.cat([o, o.new_zeros(*o.shape[:2], self.h_eff - H,
                                          o.shape[3])], dim=2)
        return o

    def _block(self, kind, p, x, rot, cache, pos, lengths, train=False):
        """One layer of ``kind``, RoPE by ``rot`` (the positions' tables).
        ``train``: the training forward (plain PyTorch attention). Else
        ``lengths`` None: the prompt's pass, attention over x's own keys
        (also written into ``cache`` at 0 when one is given) and the
        recurrences from a zero state; else x is one token per sequence:
        attention written at ``pos`` over ``lengths`` rows, the
        recurrences stepped from ``cache``. Returns (x, state, aux): the
        recurrent block's new state (None for attention and in training)
        and the MoE's load-balancing term (None without experts)."""
        cfg, tp = self.cfg, self.tp
        h = tp.norm(cfg.norm, p["norm1"], x)
        decode = lengths is not None and not train
        state = aux = None
        if kind in ("attn", "attn_local"):
            o = self._attention(kind, p["attn"], h, rot, cache, pos,
                                lengths, train)
            x = x + tp.row(o, p["attn"]["wo"], flat_in=2)
        elif kind == "rec":
            y, state = tp.rglru(p["rec"], h, cache if decode else None,
                                step=decode)
            x = x + y
        else:
            st = cache if decode else self._zero_state(p["rwkv"], h)
            y, mix = tp.rwkv_time_mix(p["rwkv"], h, st, chunk=cfg.rwkv_chunk,
                                      step=decode)
            x = x + y
            h = tp.norm(cfg.norm, p["norm2"], x)
            y, x_cm = tp.rwkv_channel_mix(p["rwkv"], h, st["x_cm"])
            state = dict(mix, x_cm=x_cm)
            return x + y, (None if train else state), None
        h = tp.norm(cfg.norm, p["norm2"], x)
        if cfg.moe:
            y, aux = tp.moe(p["moe"], h, num_experts=cfg.num_experts,
                            top_k=cfg.experts_per_token,
                            capacity_factor=cfg.capacity_factor,
                            activation=cfg.activation,
                            group_size=cfg.moe_group)
        else:
            y = tp.mlp(p["mlp"], h, cfg.activation)
        return x + y, (None if train else state), aux

    def _train_block(self, kind, p, x, rot):
        x, _, aux = self._block(kind, p, x, rot, None, None, None, True)
        return x, aux

    def _embed_inputs(self, params, tokens, patch_embeds):
        """Token embeddings, the first P positions replaced by the rms-normed
        patch embeddings (B, P, d) where the config takes patches."""
        x = self.tp.embed(params["embed"]["table"], tokens)
        if self.cfg.num_patches and patch_embeds is not None:
            if patch_embeds.shape[1] > x.shape[1]:
                raise ValueError(f"{patch_embeds.shape[1]} patch embeddings "
                                 f"for a prompt of {x.shape[1]} positions")
            pe = self.tp.norm("rmsnorm", params["patch_norm"],
                              patch_embeds.to(x.dtype))
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _run(self, params, tokens, positions, cache=None, pos=None,
             lengths=None, train=False, patches=None):
        """Embed (``patches`` over the first positions), the layers, the
        final norm. Returns (x, states, aux): the recurrent blocks' new
        states, one entry a layer (None for an attention layer), and the
        MoE layers' summed load-balancing terms (0.0 without experts)."""
        x = self._embed_inputs(params, tokens, patches)
        rot = (L.rope_tables(positions, self.cfg.head_dim // 2,
                             self.cfg.rope_theta)
               if self.has_attention else None)
        remat = train and self.cfg.remat and torch.is_grad_enabled()
        states, aux_total = [], 0.0
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            c = None if cache is None else cache["layers"][i]
            if remat:
                (x, aux), st = checkpoint(self._train_block, kind, p, x, rot,
                                          use_reentrant=False), None
            else:
                x, st, aux = self._block(kind, p, x, rot, c, pos, lengths,
                                         train)
                if lengths is None and st is not None:
                    # a prompt's last-token states are views of the
                    # layer's (B, S, ·) activations: copies free them
                    st = {k: v.clone() for k, v in st.items()}
            if aux is not None:
                aux_total = aux_total + aux
            states.append(st)
        return (self.tp.norm(self.cfg.norm, params["final_norm"], x), states,
                aux_total)

    def forward(self, params, tokens, patch_embeds=None):
        """The training forward: tokens (B, S) (and, for a VLM, patch
        embeddings (B, P, d) over the first P positions) → (logits (B, S,
        Vp) float32, the pad columns at -1e30; aux, the MoE layers' summed
        load-balancing terms, a float32 scalar, 0.0 without experts), causal
        attention over the whole sequence in plain PyTorch
        (``attention.train_attention``)."""
        x, aux = self._hidden(params, tokens, patch_embeds)
        return self.tp.logits(params["head"], x, self.cfg.vocab_size), aux

    def _hidden(self, params, tokens, patch_embeds=None):
        """The training forward's (last hidden state (B, S, d), aux)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x, _, aux = self._run(params, tokens, positions, train=True,
                              patches=patch_embeds)
        return x, aux

    def loss_terms(self, params, batch):
        """(the next-token cross-entropy of ``batch``, ``aux_loss_coef``
        times the MoE's load-balancing term or None without experts):
        ``loss``'s two terms. The cross-entropy goes through
        ``TensorParallel.cross_entropy``: under a mesh whose ``model`` axis
        splits the head's vocabulary, on each rank's columns, never the
        whole row of logits."""
        x, aux = self._hidden(params, batch["tokens"],
                              batch.get("patch_embeds"))
        ce = self.tp.cross_entropy(params["head"], x, batch["labels"],
                                   batch.get("mask"), self.cfg.vocab_size)
        return ce, (self.cfg.aux_loss_coef * aux if self.cfg.moe else None)

    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch`` ({"tokens", "labels"},
        optional "mask" over positions 1..S-1 and "patch_embeds") plus
        ``aux_loss_coef`` times the MoE's load-balancing term, as the
        reference's."""
        ce, aux = self.loss_terms(params, batch)
        return ce if aux is None else ce + aux

    # ------------------------------------------------------------- serving
    def _cache_defs_block(self, kind, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        if kind in ("attn", "attn_local"):
            return A.kv_cache_defs(batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim, dt, quant=cfg.kv_quant)
        if kind == "rec":
            return R.rglru_state_defs(batch, cfg.rnn_width, cfg.conv_width,
                                      dt)
        return R.rwkv_state_defs(batch, cfg.num_heads, cfg.head_dim,
                                 cfg.d_model, dt)

    def cache_defs(self, batch: int, max_len: int) -> dict:
        """One entry a layer: an attention layer's (k, v) pair, (B,
        max_len, Hkv, Dh) each (int8, with float32 ``k_scale`` / ``v_scale``
        of (B, max_len, Hkv, 1), under ``cfg.kv_quant``), with a
        ``cache_seq`` axis (positional, ``spec.verify``); an RG-LRU
        layer's ``h`` and ``conv``, an RWKV6 layer's ``S``, ``x_tm`` and
        ``x_cm`` (recurrent state). Under a mesh the rank's pieces: an
        attention layer's segment of ``cache_seq``
        (``dist.splitkv.cache_segment``), a recurrent layer's state cut on
        the dims the rule table splits over ``model`` (``model_piece``:
        ``h`` and ``conv`` on ``d_rnn``, ``S`` on the heads)."""
        if self.mesh is None:
            return {"layers": [self._cache_defs_block(k, batch, max_len)
                               for k in self.kinds]}
        from ..dist.splitkv import cache_segment, model_piece
        seg = max_len
        if self.has_attention:
            s0, s1 = cache_segment(self.mesh, max_len)
            seg = s1 - s0
        return {"layers": [
            self._cache_defs_block(k, batch, seg) if k.startswith("attn")
            else {n: model_piece(self.mesh, d) for n, d in
                  self._cache_defs_block(k, batch, max_len).items()}
            for k in self.kinds]}

    def init_cache(self, batch: int, max_len: int, device):
        return L.init_params(self.cache_defs(batch, max_len), None,
                             torch.device(device))

    def prefill(self, params, tokens, max_len: int, extra=None, cache=None):
        """Process a full prompt and build the cache (keys written at 0,
        the recurrent states copied in). ``cache``: a cache of
        ``cache_defs(B, max_len)``'s shapes to build in, in place (zeroed
        first, so it ends as a new one would), rather than a new one: the
        engine's static decode cache, so no second copy of the KV cache is
        made. ``extra``: a VLM's patch embeddings (B, P, d), which take the
        prompt's first P positions. Returns (logits at the last position
        (B, 1, Vp), cache). Under a mesh (``with_mesh``): tensor-parallel,
        each rank attending on its heads and keeping its segment of the
        keys (``dist.splitkv``)."""
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        if cache is None:
            cache = self.init_cache(B, max_len, tokens.device)
        else:
            for layer in cache["layers"]:
                for leaf in layer.values():
                    leaf.zero_()
        positions = torch.arange(S, device=tokens.device)[None]
        x, states, _ = self._run(params, tokens, positions, cache,
                                 patches=extra)
        for layer, st in zip(cache["layers"], states):
            for name, v in (st or {}).items():
                layer[name].copy_(v)
        logits = self.tp.logits(params["head"], x[:, -1:],
                                self.cfg.vocab_size)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step. tokens (B, 1); pos: an int or 0-d tensor (every
        sequence at that position) or a (B,) tensor of per-sequence
        positions. The KV cache is written in place at ``pos`` and read up
        to ``pos + 1``. Returns (logits (B, 1, Vp), cache): a new tree
        holding the same KV buffers and each recurrent layer's new state
        tensors. Under a mesh: tensor-parallel, attention split-KV over
        the ranks' cache segments (``dist.splitkv``)."""
        p = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = p.reshape(-1, 1) if p.ndim == 1 else p.reshape(1, 1)
        lengths = (p + 1).expand(tokens.shape[0]).contiguous()
        # an int position is written by a slice, a tensor one on the card
        x, states, _ = self._run(params, tokens, positions, cache,
                                 pos if isinstance(pos, int) else p, lengths)
        layers = [layer if st is None else st
                  for layer, st in zip(cache["layers"], states)]
        return (self.tp.logits(params["head"], x, self.cfg.vocab_size),
                {"layers": layers})
