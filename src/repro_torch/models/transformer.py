"""Decoder-only dense transformer LM: the port of
``repro/models/transformer.py::TransformerLM`` for block kind ``"attn"``
with a dense MLP (qwen3, llama3.2, minitron, nemotron).

The reference stacks the layers of each block-pattern position and scans
over periods; here the params hold a per-layer list and a loop runs it, in
the reference's layer order. Prefill attention runs through
``ops.flash_attention`` (B15) and decode attention through
``ops.decode_attention`` (B14). The KV cache is updated in place
(``attention.kv_cache_update``). The training forward (``forward`` /
``loss``) takes the reference's train-mode attention in plain PyTorch
(``attention.train_attention``), never B15, so every weight gets its
gradient; with ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), as the reference remats each period.

Not ported yet (each raises ``NotImplementedError``, later parts of the
model zoo, queue A item 6): local attention (``attn_local``), RG-LRU
(``rec``) and RWKV6 (``rwkv``) blocks, mixture-of-experts MLPs, VLM patch
embeddings (``num_patches``, prefill's ``extra``), the encoder-decoder,
the int8 KV cache and tensor-parallel head padding (``pad_heads_to``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from ..core.metrics import cross_entropy
from ..device import resolve_device


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: a later part of the model zoo (queue A "
        "item 6); the port serves dense attention transformers")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port cannot serve yet."""
    if cfg.encdec:
        raise _unported(f"{cfg.name}: the encoder-decoder (EncDecLM)")
    kinds = sorted(set(cfg.block_pattern) - {"attn"})
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
    """A dense GQA transformer behind the serving contract (``cache_defs``
    / ``init_cache`` / ``prefill`` / ``decode_step``)."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.vocab_padded = L.pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------- params
    def _block_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        return {
            "norm1": L.norm_defs(cfg.norm, cfg.d_model),
            "attn": A.attn_defs(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, cfg.qk_norm, dt),
            "norm2": L.norm_defs(cfg.norm, cfg.d_model),
            "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.activation, dt),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        return {
            "embed": L.embed_defs(self.vocab_padded, cfg.d_model, dt),
            "final_norm": L.norm_defs(cfg.norm, cfg.d_model),
            "head": {"w": L.PSpec((cfg.d_model, self.vocab_padded), dtype=dt,
                                  axes=("embed", "vocab"))},
            "layers": [self._block_defs() for _ in range(cfg.num_layers)],
        }

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (a seeded CPU generator; seed 0
        when None) on ``device`` (default ``cuda``; raises without a card
        unless ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------- blocks
    def _block(self, p, x, rot, cache, pos, lengths, train=False):
        """One layer, RoPE by ``rot`` (the positions' tables). ``train``:
        the training forward's attention (plain PyTorch). Else ``lengths``
        None: attention over x's own keys, which are also written into
        ``cache`` at 0 when one is given (prefill); else x is one token per
        sequence, written at ``pos`` and attending to ``lengths`` rows
        (decode). Returns x."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, p["norm1"], x)
        q, k, v = A.qkv_project(p["attn"], h, rot, qk_norm=cfg.qk_norm)
        if train:
            o = A.train_attention(q, k, v, block_q=cfg.block_q,
                                  block_kv=cfg.block_kv)
        elif lengths is not None:
            A.kv_cache_update(cache, k, v, pos)
            o = A.decode_attention(q, cache, lengths)
        else:
            o = A.prefill_attention(q, k, v)
            if cache is not None:
                A.kv_cache_update(cache, k, v, 0)
        x = x + A.out_project(p["attn"], o)
        h = L.apply_norm(cfg.norm, p["norm2"], x)
        return x + L.mlp_apply(p["mlp"], h, cfg.activation)

    def _run(self, params, tokens, positions, cache=None, pos=None,
             lengths=None, train=False):
        x = L.embed_apply(params["embed"], tokens)
        rot = L.rope_tables(positions, self.cfg.head_dim // 2,
                            self.cfg.rope_theta)
        remat = train and self.cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(params["layers"]):
            c = None if cache is None else cache["layers"][i]
            if remat:
                x = checkpoint(self._block, p, x, rot, c, pos, lengths, True,
                               use_reentrant=False)
            else:
                x = self._block(p, x, rot, c, pos, lengths, train)
        return L.apply_norm(self.cfg.norm, params["final_norm"], x)

    def forward(self, params, tokens):
        """The training forward: tokens (B, S) → logits (B, S, Vp) float32
        (the pad columns at -1e30), causal attention over the whole
        sequence in plain PyTorch (``attention.train_attention``)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self._run(params, tokens, positions, train=True)
        return L.logits_apply(params["head"], x, self.cfg.vocab_size)

    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch`` ({"tokens", "labels"},
        optional "mask" over positions 1..S-1). The reference adds
        ``aux_loss_coef`` times the MoE's load-balancing term, which is 0
        for the dense families the port builds."""
        logits = self.forward(params, batch["tokens"])
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                             batch.get("mask"))

    # ------------------------------------------------------------- serving
    def cache_defs(self, batch: int, max_len: int) -> dict:
        """One (k, v) pair per layer, (B, max_len, Hkv, Dh) each; every leaf
        has a ``cache_seq`` axis, so the whole cache is positional
        (``spec.verify``)."""
        cfg = self.cfg
        return {"layers": [
            A.kv_cache_defs(batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                            cfg.torch_dtype, quant=cfg.kv_quant)
            for _ in range(cfg.num_layers)]}

    def init_cache(self, batch: int, max_len: int, device):
        return L.init_params(self.cache_defs(batch, max_len), None,
                             torch.device(device))

    def prefill(self, params, tokens, max_len: int, extra=None, cache=None):
        """Process a full prompt and build the cache (keys written at 0).
        ``cache``: a cache of ``cache_defs(B, max_len)``'s shapes to build
        in, in place (zeroed first, so it ends as a new one would), rather
        than a new one: the engine's static decode cache, so no second
        copy of the KV cache is made.
        Returns (logits at the last position (B, 1, Vp), cache)."""
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
        x = self._run(params, tokens, positions, cache)
        logits = L.logits_apply(params["head"], x[:, -1:],
                                self.cfg.vocab_size)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step. tokens (B, 1); pos: an int or 0-d tensor (every
        sequence at that position) or a (B,) tensor of per-sequence
        positions. The cache is written in place at ``pos`` and read up to
        ``pos + 1``. Returns (logits (B, 1, Vp), cache)."""
        p = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = p.reshape(-1, 1) if p.ndim == 1 else p.reshape(1, 1)
        lengths = (p + 1).expand(tokens.shape[0]).contiguous()
        # an int position is written by a slice, a tensor one on the card
        x = self._run(params, tokens, positions, cache,
                      pos if isinstance(pos, int) else p, lengths)
        return L.logits_apply(params["head"], x, self.cfg.vocab_size), cache
