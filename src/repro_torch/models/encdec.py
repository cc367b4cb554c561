"""Encoder-decoder LM (seamless-m4t's backbone): the port of
``repro/models/encdec.py::EncDecLM``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d) through ``frame_proj``. A
bidirectional encoder stack, then a causal decoder stack whose every layer
also attends over the encoder's memory (cross-attention, no RoPE on its
queries, keys or values). The reference scans over stacked layers; here
``enc_blocks`` and ``dec_blocks`` are per-layer lists.

Serving: the encoder's self-attention and the prefill's cross-attention
go through ``ops.flash_attention`` (B15) without a causal mask, the
decoder's self-attention through B15 causal; a decode step runs
``ops.decode_attention`` (B14) twice a layer, over the self cache and over
the cross memory (every frame the prefill encoded live). The cache holds,
a decoder layer, the self KV cache (int8 under ``cfg.kv_quant``) and the
cross memory's keys and values in the compute dtype, as the reference's
prefill writes them, with as many rows as the prefill's frames. The
training forward takes plain PyTorch attention (``train_attention``:
the full masked softmax up to 4096 rows, the reference's threshold here).

Under a mesh (``with_mesh``) the projections, the MLPs, the embedding and
the head run through ``dist.tensor_parallel``'s forms on each rank's
pieces of the params: the encoder on the rank's heads (B15 without a
causal mask), the decoder's self cache and its cross memory each the
rank's segment of ``cache_seq`` (``enc_len / model`` positions of the
memory, the frames the prefill encoded live), both read by a decode step
split-KV (``dist.splitkv``). Training runs the same forms on the rank's
pieces, the loss on the rank's vocabulary columns.
"""
from __future__ import annotations

import copy

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from ..device import resolve_device
from ..dist.tensor_parallel import TensorParallel, local

FULL_UPTO = 4096     # the reference's full-attention threshold (rows)


class EncDecLM:
    """A bidirectional encoder over frame embeddings and a causal decoder
    with cross-attention, behind the serving contract (``cache_defs`` /
    ``init_cache`` / ``prefill(extra=frames)`` / ``decode_step``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.vocab_padded = L.pad_vocab(cfg.vocab_size)
        self.n_enc = cfg.enc_layers or cfg.num_layers
        self.n_dec = cfg.num_layers
        self.h_eff = cfg.num_heads
        # a (data, model) DeviceMesh: the tensor-parallel forward and the
        # split-KV decode (with_mesh)
        self.mesh = None
        self.tp = TensorParallel(None)

    def with_mesh(self, mesh) -> "EncDecLM":
        """Copy of this model over ``mesh`` (a DeviceMesh with a ``model``
        axis), or, with None, on one device: its params are DTensors laid
        out by ``training.param_shardings``, its forward tensor-parallel
        and its decode split-KV over its self cache and its cross memory
        (see the module docstring)."""
        other = copy.copy(self)
        other.mesh = mesh
        other.tp = TensorParallel(mesh)
        return other

    # ------------------------------------------------------------- params
    def _enc_block_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        return {"norm1": L.norm_defs(cfg.norm, cfg.d_model),
                "attn": A.attn_defs(cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qk_norm, dt),
                "norm2": L.norm_defs(cfg.norm, cfg.d_model),
                "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.activation, dt)}

    def _dec_block_defs(self) -> dict:
        cfg = self.cfg
        d = self._enc_block_defs()
        d["norm_x"] = L.norm_defs(cfg.norm, cfg.d_model)
        d["xattn"] = A.attn_defs(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, cfg.qk_norm, cfg.torch_dtype)
        return d

    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        return {
            "frame_proj": {"w": L.PSpec((cfg.d_model, cfg.d_model), dtype=dt,
                                        axes=("embed", None))},
            "embed": L.embed_defs(self.vocab_padded, cfg.d_model, dt),
            "enc_blocks": [self._enc_block_defs()
                           for _ in range(self.n_enc)],
            "enc_norm": L.norm_defs(cfg.norm, cfg.d_model),
            "dec_blocks": [self._dec_block_defs()
                           for _ in range(self.n_dec)],
            "final_norm": L.norm_defs(cfg.norm, cfg.d_model),
            "head": {"w": L.PSpec((cfg.d_model, self.vocab_padded), dtype=dt,
                                  axes=("embed", "vocab"))},
        }

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (seed 0 on the CPU when None)
        on ``device`` (default ``cuda``; raises without a card unless
        ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def param_axes(self):
        """Each param's logical axes (``()`` where a leaf names none)."""
        return L.param_axes(self.param_defs())

    def abstract_params(self, device="meta"):
        """The params' stand-ins (``layers.abstract_params``): their shapes
        and dtypes, no data."""
        return L.abstract_params(self.param_defs(), device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------ helpers
    def _rot(self, S: int, device):
        return L.rope_tables(torch.arange(S, device=device)[None],
                             self.cfg.head_dim // 2, self.cfg.rope_theta)

    def _attend(self, q, k, v, *, causal: bool, train: bool):
        """q (B, Sq, H, Dh) over k / v (B, Sk, Hkv, Dh): plain PyTorch in
        training, B15 otherwise; under a mesh q on the rank's heads, k / v
        on its kv heads or whole."""
        if train:
            k, v = self.tp.kv_for_q(q, k, v, self.cfg.num_heads,
                                    self.cfg.num_kv_heads)
            return A.train_attention(q, k, v, block_q=self.cfg.block_q,
                                     block_kv=self.cfg.block_kv,
                                     causal=causal, full_upto=FULL_UPTO)
        if self.mesh is not None:
            from ..dist.splitkv import prompt_attention
            return prompt_attention(self, q, k, v, causal)
        return A.prefill_attention(q, k, v, causal=causal)

    def _cross_q(self, p, h):
        """Cross-attention queries (the rank's heads under a mesh): no
        RoPE."""
        tp = self.tp
        split = tp.split_dim(p["wq"]) is not None
        q = L.pmm(tp.copy(h) if split else h, local(p["wq"]))
        if not self.cfg.qk_norm:
            return q
        qn = local(p["q_norm"])
        return L.rmsnorm(q, tp.copy(qn) if split else qn)

    def _cross_kv(self, p, enc_out):
        """The cross-attention keys and values of the encoder's memory (the
        rank's kv heads where ``wk`` / ``wv`` are split): no RoPE."""
        tp = self.tp
        kv_split = tp.split_dim(p["wk"]) == 1
        x = tp.copy(enc_out) if kv_split else enc_out
        k, v = L.pmm(x, local(p["wk"])), L.pmm(x, local(p["wv"]))
        if self.cfg.qk_norm:
            kn = local(p["k_norm"])
            k = L.rmsnorm(k, tp.copy(kn) if kv_split else kn)
        return k, v

    # ------------------------------------------------------------ encoder
    def _enc_block(self, p, x, rot, train):
        cfg, tp = self.cfg, self.tp
        h = tp.norm(cfg.norm, p["norm1"], x)
        q, k, v = tp.qkv(p["attn"], h, rot, qk_norm=cfg.qk_norm)
        x = x + tp.row(self._attend(q, k, v, causal=False, train=train),
                       p["attn"]["wo"], flat_in=2)
        h = tp.norm(cfg.norm, p["norm2"], x)
        return x + tp.mlp(p["mlp"], h, cfg.activation)

    def encode(self, params, frames, train: bool = False):
        """Frame embeddings (B, S_enc, d) → the encoder's memory (B, S_enc,
        d): ``frame_proj``, the bidirectional stack (B15 without a causal
        mask; plain PyTorch with ``train``), ``enc_norm``."""
        cfg = self.cfg
        x = L.pmm(frames.to(cfg.torch_dtype),
                  local(params["frame_proj"]["w"]))
        rot = self._rot(x.shape[1], x.device)
        remat = train and cfg.remat and torch.is_grad_enabled()
        for p in params["enc_blocks"]:
            if remat:
                x = checkpoint(self._enc_block, p, x, rot, True,
                               use_reentrant=False)
            else:
                x = self._enc_block(p, x, rot, train)
        return self.tp.norm(cfg.norm, params["enc_norm"], x)

    # ------------------------------------------------------------ decoder
    def _dec_block(self, p, x, rot, enc_out, cache, pos, lengths, train):
        """One decoder layer. ``lengths`` None: the prompt's pass (self
        attention causal over x's keys, written into ``cache["self"]`` at
        0 when a cache is given; cross-attention over ``enc_out``, whose
        keys and values go to ``cache["cross"]``); else one token a
        sequence, written at ``pos``, over ``lengths`` self rows and every
        row of the cross memory. Under a mesh both through
        ``dist.splitkv`` on the rank's segments."""
        cfg, tp = self.cfg, self.tp
        h = tp.norm(cfg.norm, p["norm1"], x)
        q, k, v = tp.qkv(p["attn"], h, rot, qk_norm=cfg.qk_norm)
        if self.mesh is not None and not train:
            from ..dist import splitkv
            o = splitkv.attend(self, q, k, v, cache["self"], pos, lengths)
        elif lengths is not None:
            A.kv_cache_update(cache["self"], k, v, pos)
            o = A.decode_attention(q, A.dequantize_cache(cache["self"],
                                                         h.dtype), lengths)
        else:
            o = self._attend(q, k, v, causal=True, train=train)
            if cache is not None:
                A.kv_cache_update(cache["self"], k, v, 0)
        x = x + tp.row(o, p["attn"]["wo"], flat_in=2)
        h = tp.norm(cfg.norm, p["norm_x"], x)
        qx = self._cross_q(p["xattn"], h)
        if lengths is not None:
            mem = cache["cross"]
            if self.mesh is not None:
                from ..dist.splitkv import attend_memory
                ox = attend_memory(self, qx, mem)
            else:
                n = torch.full_like(lengths, mem["k"].shape[1])
                ox = A.decode_attention(qx, mem, n)
        else:
            ck, cv = self._cross_kv(p["xattn"], enc_out)
            ox = self._attend(qx, ck, cv, causal=False, train=train)
            if cache is not None:
                cache["cross"] = self._memory(ck, cv)
        x = x + tp.row(ox, p["xattn"]["wo"], flat_in=2)
        h = tp.norm(cfg.norm, p["norm2"], x)
        return x + tp.mlp(p["mlp"], h, cfg.activation)

    def _memory(self, k, v) -> dict:
        """The cross memory a decode step reads: the encoder memory's keys
        and values (B, S_enc, Hkv, Dh); under a mesh, every kv head
        (gathered over ``model`` where split) at the live positions of the
        rank's segment of ``enc_len`` (``dist.splitkv.cache_segment``),
        which may be none."""
        if self.mesh is None:
            return {"k": k, "v": v}
        from ..dist.splitkv import whole_kv, cache_segment
        if k.shape[1] > self.cfg.enc_len:
            raise ValueError(f"{k.shape[1]} frames past the cross memory's "
                             f"enc_len {self.cfg.enc_len}, which a mesh "
                             "splits over its model axis")
        s0, s1 = cache_segment(self.mesh, self.cfg.enc_len)
        k, v = whole_kv(self, k, v)
        n = min(max(k.shape[1] - s0, 0), s1 - s0)
        return {"k": k[:, s0:s0 + n], "v": v[:, s0:s0 + n]}

    def _decode_stack(self, params, tokens, positions, enc_out, cache=None,
                      pos=None, lengths=None, train=False):
        """Embed, the decoder layers, the final norm."""
        x = self.tp.embed(params["embed"]["table"], tokens)
        rot = L.rope_tables(positions, self.cfg.head_dim // 2,
                            self.cfg.rope_theta)
        remat = train and self.cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(params["dec_blocks"]):
            c = None if cache is None else cache["dec"][i]
            if remat:
                x = checkpoint(self._dec_block, p, x, rot, enc_out, None,
                               None, None, True, use_reentrant=False)
            else:
                x = self._dec_block(p, x, rot, enc_out, c, pos, lengths,
                                    train)
        return self.tp.norm(self.cfg.norm, params["final_norm"], x)

    # ---------------------------------------------------------------- api
    def forward(self, params, tokens, frames):
        """The training forward: tokens (B, S_dec), frames (B, S_enc, d) →
        (logits (B, S_dec, Vp) float32, 0.0: no auxiliary loss), plain
        PyTorch attention throughout."""
        x = self._hidden(params, tokens, frames)
        return self.tp.logits(params["head"], x, self.cfg.vocab_size), 0.0

    def _hidden(self, params, tokens, frames):
        """The training forward's last hidden state (B, S_dec, d)."""
        enc_out = self.encode(params, frames, train=True)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return self._decode_stack(params, tokens, positions, enc_out,
                                  train=True)

    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch`` ({"tokens", "labels",
        "frames"}, optional "mask"): under a mesh whose ``model`` axis
        splits the head's vocabulary, on each rank's columns
        (``TensorParallel.cross_entropy``)."""
        x = self._hidden(params, batch["tokens"], batch["frames"])
        return self.tp.cross_entropy(params["head"], x, batch["labels"],
                                     batch.get("mask"), self.cfg.vocab_size)

    def cache_defs(self, batch: int, max_len: int) -> dict:
        """One entry a decoder layer: ``self``, its KV cache (B, max_len,
        Hkv, Dh), and ``cross``, the encoder memory's keys and values (B,
        enc_len, Hkv, Dh) in the compute dtype, every leaf under the
        ``cache_seq`` axis (positional: a rewind leaves them). A prefill's
        cross leaves hold as many rows as its frames. Under a mesh, the
        rank's segments of ``max_len`` and of ``enc_len``."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        enc_len = cfg.enc_len
        if self.mesh is not None:
            from ..dist.splitkv import cache_segment
            s0, s1 = cache_segment(self.mesh, max_len)
            e0, e1 = cache_segment(self.mesh, enc_len)
            max_len, enc_len = s1 - s0, e1 - e0
        blk = lambda: {
            "self": A.kv_cache_defs(batch, max_len, cfg.num_kv_heads,
                                    cfg.head_dim, dt, quant=cfg.kv_quant),
            "cross": A.kv_cache_defs(batch, enc_len, cfg.num_kv_heads,
                                     cfg.head_dim, dt)}
        return {"dec": [blk() for _ in range(self.n_dec)]}

    def init_cache(self, batch: int, max_len: int, device):
        return L.init_params(self.cache_defs(batch, max_len), None,
                             torch.device(device))

    def prefill(self, params, tokens, max_len: int, extra=None):
        """Encode ``extra``, the frame embeddings (B, S_enc, d) (required),
        then process the prompt and build the cache. Returns (logits at
        the last position (B, 1, Vp), cache)."""
        if extra is None:
            raise ValueError("EncDecLM.prefill needs encoder frames "
                             "(extra=...)")
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        enc_out = self.encode(params, extra)
        # the self caches (the rank's segments under a mesh); each layer's
        # cross memory comes from enc_out
        cache = {"dec": [{"self": L.init_params(blk["self"], None,
                                                tokens.device)}
                         for blk in self.cache_defs(B, max_len)["dec"]]}
        positions = torch.arange(S, device=tokens.device)[None]
        x = self._decode_stack(params, tokens, positions, enc_out, cache)
        logits = self.tp.logits(params["head"], x[:, -1:],
                                self.cfg.vocab_size)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step. tokens (B, 1); pos: an int or 0-d tensor, or a
        (B,) tensor of per-sequence positions. The self cache is written in
        place at ``pos`` and read up to ``pos + 1``; the cross memory is
        read whole. Returns (logits (B, 1, Vp), cache)."""
        p = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = p.reshape(-1, 1) if p.ndim == 1 else p.reshape(1, 1)
        lengths = (p + 1).expand(tokens.shape[0]).contiguous()
        x = self._decode_stack(params, tokens, positions, None, cache,
                               pos if isinstance(pos, int) else p, lengths)
        return self.tp.logits(params["head"], x, self.cfg.vocab_size), cache
