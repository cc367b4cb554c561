"""Decoder-only LM: the port of ``repro/models/transformer.py::
TransformerLM`` for the dense GQA transformers (qwen3, llama3.2,
minitron, nemotron), the RG-LRU + local-attention hybrid (recurrentgemma)
and attention-free RWKV6, with a dense MLP.

The reference stacks the layers of each block-pattern position and scans
over periods; here the params hold a per-layer list and a loop runs it, in
the reference's layer order (layer l has kind ``block_pattern[l % P]``).
Block kinds:

- ``attn`` / ``attn_local``: prefill attention through
  ``ops.flash_attention`` (B15) and decode attention through
  ``ops.decode_attention`` (B14), ``attn_local`` with ``cfg.window``; the
  KV cache is updated in place (``attention.kv_cache_update``);
- ``rec``: the RG-LRU mixer (``recurrent.rglru_apply`` / ``rglru_step``);
- ``rwkv``: RWKV6's time mix and its own channel-mix FFN in place of the
  MLP (``recurrent.rwkv_time_mix`` / ``rwkv_time_mix_step`` /
  ``rwkv_channel_mix``).

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

Not ported yet (each raises ``NotImplementedError``, later parts of the
model zoo, queue A item 6): mixture-of-experts MLPs, VLM patch embeddings
(``num_patches``, prefill's ``extra``), the encoder-decoder, the int8 KV
cache and tensor-parallel head padding (``pad_heads_to``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from . import recurrent as R
from ..core.metrics import cross_entropy
from ..device import resolve_device

KINDS = ("attn", "attn_local", "rec", "rwkv")


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: a later part of the model zoo (queue A "
        "item 6); the port serves dense attention transformers, the RG-LRU "
        "hybrid and RWKV6")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port cannot serve yet."""
    if cfg.encdec:
        raise _unported(f"{cfg.name}: the encoder-decoder (EncDecLM)")
    kinds = sorted(set(cfg.block_pattern) - set(KINDS))
    if kinds:
        raise _unported(f"{cfg.name}: block kinds {kinds}")
    if cfg.moe:
        raise _unported(f"{cfg.name}: the mixture-of-experts MLP")
    if cfg.num_patches:
        raise _unported(f"{cfg.name}: VLM patch embeddings")
    if cfg.kv_quant:
        raise _unported(f"{cfg.name}: the int8 KV cache (kv_quant)")
    if cfg.pad_heads_to:
        raise _unported(f"{cfg.name}: tensor-parallel head padding "
                        "(pad_heads_to)")


class TransformerLM:
    """A decoder-only LM of attention, RG-LRU and RWKV6 blocks behind the
    serving contract (``cache_defs`` / ``init_cache`` / ``prefill`` /
    ``decode_step``)."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.vocab_padded = L.pad_vocab(cfg.vocab_size)
        P = len(cfg.block_pattern)
        self.kinds = tuple(cfg.block_pattern[i % P]
                           for i in range(cfg.num_layers))
        self.has_attention = any(k.startswith("attn") for k in self.kinds)

    # ------------------------------------------------------------- params
    def _block_defs(self, kind: str) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        d = {"norm1": L.norm_defs(cfg.norm, cfg.d_model),
             "norm2": L.norm_defs(cfg.norm, cfg.d_model)}
        if kind in ("attn", "attn_local"):
            d["attn"] = A.attn_defs(cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qk_norm, dt)
        elif kind == "rec":
            d["rec"] = R.rglru_defs(cfg.d_model, cfg.rnn_width,
                                    cfg.conv_width, dt)
        else:
            d["rwkv"] = R.rwkv_defs(cfg.d_model, cfg.num_heads, cfg.head_dim,
                                    cfg.d_ff, dt)
        if kind != "rwkv":      # rwkv carries its own channel-mix FFN
            d["mlp"] = L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.activation, dt)
        return d

    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        return {
            "embed": L.embed_defs(self.vocab_padded, cfg.d_model, dt),
            "final_norm": L.norm_defs(cfg.norm, cfg.d_model),
            "head": {"w": L.PSpec((cfg.d_model, self.vocab_padded), dtype=dt,
                                  axes=("embed", "vocab"))},
            "layers": [self._block_defs(k) for k in self.kinds],
        }

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (seed 0 on the CPU when None;
        ``layers.init_params`` draws on the generator's device) on
        ``device`` (default ``cuda``; raises without a card unless
        ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------- blocks
    def _zero_state(self, kind, x):
        """The rwkv mixer's and channel mix's state before a sequence."""
        cfg = self.cfg
        B, d = x.shape[0], x.shape[2]
        return {"S": torch.zeros((B, cfg.num_heads, cfg.head_dim,
                                  cfg.head_dim), dtype=torch.float32,
                                 device=x.device),
                "x_tm": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                "x_cm": torch.zeros((B, d), dtype=x.dtype, device=x.device)}

    def _block(self, kind, p, x, rot, cache, pos, lengths, train=False):
        """One layer of ``kind``, RoPE by ``rot`` (the positions' tables).
        ``train``: the training forward (plain PyTorch attention). Else
        ``lengths`` None: the prompt's pass, attention over x's own keys
        (also written into ``cache`` at 0 when one is given) and the
        recurrences from a zero state; else x is one token per sequence:
        attention written at ``pos`` over ``lengths`` rows, the
        recurrences stepped from ``cache``. Returns (x, state): the
        recurrent block's new state (None for attention and in training)."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, p["norm1"], x)
        decode = lengths is not None and not train
        state = None
        if kind in ("attn", "attn_local"):
            window = cfg.window if kind == "attn_local" else None
            q, k, v = A.qkv_project(p["attn"], h, rot, qk_norm=cfg.qk_norm)
            if train:
                o = A.train_attention(q, k, v, block_q=cfg.block_q,
                                      block_kv=cfg.block_kv, window=window)
            elif decode:
                A.kv_cache_update(cache, k, v, pos)
                o = A.decode_attention(q, cache, lengths, window=window)
            else:
                o = A.prefill_attention(q, k, v, window=window)
                if cache is not None:
                    A.kv_cache_update(cache, k, v, 0)
            x = x + A.out_project(p["attn"], o)
        elif kind == "rec":
            if decode:
                y, state = R.rglru_step(p["rec"], h, cache)
            else:
                y, state = R.rglru_apply(p["rec"], h)
            x = x + y
        else:
            st = cache if decode else self._zero_state(kind, h)
            if decode:
                y, mix = R.rwkv_time_mix_step(p["rwkv"], h, st)
            else:
                y, mix = R.rwkv_time_mix(p["rwkv"], h, st,
                                         chunk=cfg.rwkv_chunk)
            x = x + y
            h = L.apply_norm(cfg.norm, p["norm2"], x)
            y, x_cm = R.rwkv_channel_mix(p["rwkv"], h, st["x_cm"])
            state = dict(mix, x_cm=x_cm)
            return x + y, (None if train else state)
        h = L.apply_norm(cfg.norm, p["norm2"], x)
        x = x + L.mlp_apply(p["mlp"], h, cfg.activation)
        return x, (None if train else state)

    def _train_block(self, kind, p, x, rot):
        return self._block(kind, p, x, rot, None, None, None, True)[0]

    def _run(self, params, tokens, positions, cache=None, pos=None,
             lengths=None, train=False):
        """Embed, the layers, the final norm. Returns (x, states): the
        recurrent blocks' new states, one entry a layer (None for an
        attention layer)."""
        x = L.embed_apply(params["embed"], tokens)
        rot = (L.rope_tables(positions, self.cfg.head_dim // 2,
                             self.cfg.rope_theta)
               if self.has_attention else None)
        remat = train and self.cfg.remat and torch.is_grad_enabled()
        states = []
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            c = None if cache is None else cache["layers"][i]
            if remat:
                x = checkpoint(self._train_block, kind, p, x, rot,
                               use_reentrant=False)
                st = None
            else:
                x, st = self._block(kind, p, x, rot, c, pos, lengths, train)
            states.append(st)
        return L.apply_norm(self.cfg.norm, params["final_norm"], x), states

    def forward(self, params, tokens):
        """The training forward: tokens (B, S) → logits (B, S, Vp) float32
        (the pad columns at -1e30), causal attention over the whole
        sequence in plain PyTorch (``attention.train_attention``)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x, _ = self._run(params, tokens, positions, train=True)
        return L.logits_apply(params["head"], x, self.cfg.vocab_size)

    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch`` ({"tokens", "labels"},
        optional "mask" over positions 1..S-1). The reference adds
        ``aux_loss_coef`` times the MoE's load-balancing term, which is 0
        for the families the port builds."""
        logits = self.forward(params, batch["tokens"])
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                             batch.get("mask"))

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
        max_len, Hkv, Dh) each, with a ``cache_seq`` axis (positional,
        ``spec.verify``); an RG-LRU layer's ``h`` and ``conv``, an RWKV6
        layer's ``S``, ``x_tm`` and ``x_cm`` (recurrent state)."""
        return {"layers": [self._cache_defs_block(k, batch, max_len)
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
        made. Returns (logits at the last position (B, 1, Vp), cache)."""
        if extra is not None:
            raise _unported("prefill's extra (VLM patch embeddings)")
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
        x, states = self._run(params, tokens, positions, cache)
        for layer, st in zip(cache["layers"], states):
            for name, v in (st or {}).items():
                layer[name].copy_(v)
        logits = L.logits_apply(params["head"], x[:, -1:],
                                self.cfg.vocab_size)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step. tokens (B, 1); pos: an int or 0-d tensor (every
        sequence at that position) or a (B,) tensor of per-sequence
        positions. The KV cache is written in place at ``pos`` and read up
        to ``pos + 1``. Returns (logits (B, 1, Vp), cache): a new tree
        holding the same KV buffers and each recurrent layer's new state
        tensors."""
        p = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = p.reshape(-1, 1) if p.ndim == 1 else p.reshape(1, 1)
        lengths = (p + 1).expand(tokens.shape[0]).contiguous()
        # an int position is written by a slice, a tensor one on the card
        x, states = self._run(params, tokens, positions, cache,
                              pos if isinstance(pos, int) else p, lengths)
        layers = [layer if st is None else st
                  for layer, st in zip(cache["layers"], states)]
        return (L.logits_apply(params["head"], x, self.cfg.vocab_size),
                {"layers": layers})
