"""Attention: GQA / MQA / MHA with qk-norm, RoPE and a KV cache.

The port of ``repro/models/attention.py`` for one device. Prefill attention
goes through ``ops.flash_attention`` (B15; causal for a decoder, not for
an encoder or cross-attention) and decode attention through
``ops.decode_attention`` (B14); both read GQA in place (q head h reads kv
head h // G), so the reference's tensor-parallel helpers
(``prepare_heads``, ``expand_cache_heads``, ``pad_q_heads``) have no
counterpart: with one device the model axis has size 1, and the cache is
never copied per head. A model whose q projection is stored with dummy
heads (``pad_heads_to``) attends with its real heads alone: the reference
maps q head h to kv head h // (num_heads / Hkv), and its dummy heads read
zero keys and values and are masked to 0 before the output projection.

The KV cache is updated in place: ``kv_cache_update`` writes the new rows
into the cache's buffers and returns the same dict. A step's positions
past its length are dead, so a rewind needs no copy (``spec.verify``).
The int8 cache (``kv_cache_defs(quant=True)``) holds int8 codes and
float32 scales a (position, kv head), written by ``kv_cache_update``
(``quantize_kv``); decode attends over ``dequantize_cache``'s view of it,
as the reference does.

Local attention (``attn_local``) passes its window to each of these.
Training takes the reference's train-mode attention in plain PyTorch
(``train_attention``: B15's plain version, the full masked softmax, up to
max(block_q, 1024) rows, ``blocked_attention``'s online softmax beyond), so autograd sees every op:
B15 has no backward, and its output carries no autograd history.
"""
from __future__ import annotations

import torch

from .layers import PSpec, apply_rope, pmm, rmsnorm
from ..kernels import ops as K
from ..kernels.ref import mha_ref
from ..quant.scheme import f32_scalar

CACHE_AXES = ("batch", "cache_seq", "kv_heads", "head_dim")


def attn_defs(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int,
              qk_norm: bool, dtype) -> dict:
    d = {
        "wq": PSpec((d_model, num_heads, head_dim), dtype=dtype,
                    axes=("embed", "heads", "head_dim")),
        "wk": PSpec((d_model, num_kv_heads, head_dim), dtype=dtype,
                    axes=("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d_model, num_kv_heads, head_dim), dtype=dtype,
                    axes=("embed", "kv_heads", "head_dim")),
        "wo": PSpec((num_heads, head_dim, d_model), dtype=dtype,
                    axes=("heads", "head_dim", "embed")),
    }
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            d[name] = PSpec((head_dim,), init="zeros", dtype=torch.float32,
                            axes=("head_dim",))
    return d


def qkv_project(p: dict, x, rot, *, qk_norm: bool):
    """x (B, S, d) → q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh); qk-norm, then
    RoPE by ``rot`` (the positions' ``layers.rope_tables``, one pair for
    every layer; None: no RoPE)."""
    q, k, v = pmm(x, p["wq"]), pmm(x, p["wk"]), pmm(x, p["wv"])
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if rot is not None:
        q, k = apply_rope(q, *rot), apply_rope(k, *rot)
    return q, k, v


def out_project(p: dict, o):
    """o (B, S, Hq, Dh) → (B, S, d)."""
    wo = p["wo"]
    return pmm(o.reshape(*o.shape[:2], -1), wo.reshape(-1, wo.shape[-1]))


def prefill_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None):
    """Attention of a prompt over keys: q (B, Sq, Hq, Dh), k/v (B, Sk,
    Hkv, Dh) → (B, Sq, Hq, Dh), through ``ops.flash_attention`` on
    head-major views. ``causal``: a prompt over its own keys; else every
    key is live (an encoder, or queries over an encoder's memory)."""
    o = K.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def decode_attention(q, cache: dict, lengths, *, window: int | None = None):
    """One query per sequence over the cache's first ``lengths`` rows:
    q (B, 1, Hq, Dh), lengths (B,) → (B, 1, Hq, Dh), through
    ``ops.decode_attention`` on head-major views of the cache."""
    o = K.decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                           cache["v"].transpose(1, 2), lengths,
                           window=window)
    return o[:, None]


# --------------------------------------------------------------- training

_NEG = -1e30


def blocked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, block_q: int = 512,
                      block_kv: int = 1024):
    """Online-softmax attention over q and kv blocks, the reference's
    memory-safe form, MHA layout (B, S, H, D), q row i at position i;
    ``causal``: keys at or before the query; ``window``: keys in (qpos -
    window, qpos]. Sq and Sk must be multiples of their blocks (a block
    is cut to the sequence)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_kv, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of their "
                         f"blocks {bq} and {bk}")
    dev = q.device
    outs = []
    for iq in range(Sq // bq):
        qf = q[:, iq * bq:(iq + 1) * bq].float() * D ** -0.5
        qpos = iq * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        for ik in range(Sk // bk):
            kb = k[:, ik * bk:(ik + 1) * bk].float()
            vb = v[:, ik * bk:(ik + 1) * bk].float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
            kpos = ik * bk + torch.arange(bk, device=dev)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (qpos[:, None] >= kpos)
            if window is not None:
                mask = mask & (kpos > qpos[:, None] - window)
            s = torch.where(mask[None, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s > _NEG / 2, torch.exp(s - m_new[..., None]),
                            0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def train_attention(q, k, v, *, block_q: int, block_kv: int,
                    window: int | None = None, causal: bool = True,
                    full_upto: int | None = None):
    """Attention for training, as the reference's "train" mode takes it:
    q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) → (B, Sq, Hq, Dh); the full
    masked softmax (B15's plain version, ``ref.mha_ref``) while Sq and Sk
    are at most ``full_upto`` (max(block_q, 1024) when None, the decoder's
    threshold; the encoder-decoder's is 4096), the blocked online softmax
    beyond. ``causal=False``: every key live (an encoder, or
    cross-attention); ``window`` (local attention): keys in (qpos -
    window, qpos]."""
    full_upto = max(block_q, 1024) if full_upto is None else full_upto
    if max(q.shape[1], k.shape[1]) <= full_upto:
        return mha_ref(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal,
                       window=window).transpose(1, 2)
    G = q.shape[2] // k.shape[2]        # GQA: q head h reads kv head h // G
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             block_q=block_q, block_kv=block_kv)


# ----------------------------------------------------------------- caches

def kv_cache_defs(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, quant: bool = False) -> dict:
    """KV cache declarations, (B, max_len, Hkv, Dh) each. ``quant``: int8
    codes ``k`` / ``v`` and float32 scales ``k_scale`` / ``v_scale`` of
    shape (B, max_len, Hkv, 1), every leaf under the ``cache_seq`` axis."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    if quant:
        sshape = shape[:3] + (1,)
        return {"k": PSpec(shape, init="zeros", dtype=torch.int8,
                           axes=CACHE_AXES),
                "v": PSpec(shape, init="zeros", dtype=torch.int8,
                           axes=CACHE_AXES),
                "k_scale": PSpec(sshape, init="zeros", dtype=torch.float32,
                                 axes=CACHE_AXES),
                "v_scale": PSpec(sshape, init="zeros", dtype=torch.float32,
                                 axes=CACHE_AXES)}
    return {"k": PSpec(shape, init="zeros", dtype=dtype, axes=CACHE_AXES),
            "v": PSpec(shape, init="zeros", dtype=dtype, axes=CACHE_AXES)}


def quantize_kv(x):
    """(B, S, H, D) → (int8 codes, (B, S, H, 1) float32 scales): the scale
    is the row's max |x| / 127, the code round(x / max(scale, 1e-12))
    clipped to ±127, both divisions by float32 tensors (true division on
    the card too), rounding half to even, as the reference's."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / f32_scalar(127.0, xf)
    q = torch.round(xf / torch.clamp(scale, min=1e-12))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_cache(cache: dict, dtype) -> dict:
    """The cache as plain {"k", "v"} in ``dtype`` (the cache itself when
    it is not quantized)."""
    if "k_scale" not in cache:
        return cache
    return {n: (cache[n].float() * cache[f"{n}_scale"]).to(dtype)
            for n in ("k", "v")}


def kv_cache_update(cache: dict, k_new, v_new, pos) -> dict:
    """Write k/v (B, S_new, Hkv, Dh) into the cache at ``pos``, in place.

    ``pos`` is an int or a 0-d tensor (every sequence at the same position:
    a slice write whose start clamps so the rows fit, as
    ``dynamic_update_slice`` does) or a (B,) tensor of per-sequence
    positions (a per-row scatter, S_new = 1; a row whose position lies
    past the cache is left as it is, as a dropped scatter). Tensor
    positions are never read back to the host. An int8 cache takes
    ``quantize_kv``'s codes and scales."""
    S_new, S_max = k_new.shape[1], cache["k"].shape[1]
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        writes = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        writes = (("k", k_new), ("v", v_new))
    if isinstance(pos, int):
        start = min(max(pos, 0), S_max - S_new)
        for name, new in writes:
            cache[name][:, start:start + S_new] = new
        return cache
    pos = pos.to(device=k_new.device, dtype=torch.long)
    if pos.ndim == 1:
        if S_new != 1:
            raise ValueError(f"per-sequence positions write one row, got "
                             f"{S_new}")
        rows = torch.arange(k_new.shape[0], device=k_new.device)
        idx = pos.clamp(0, S_max - 1)
        keep = (pos < S_max)[:, None, None]
        for name, new in writes:
            buf = cache[name]
            buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                         buf[rows, idx])
        return cache
    idx = pos.clamp(0, S_max - S_new) + torch.arange(S_new,
                                                     device=k_new.device)
    for name, new in writes:
        cache[name].index_copy_(1, idx, new.to(cache[name].dtype))
    return cache
