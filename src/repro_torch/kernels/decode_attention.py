"""CUDA kernel: single-query GQA decode attention over a KV cache
(``csrc/attention.cu``, B14).

One query per sequence against its first ``lengths[b]`` cache rows (the
last ``window`` of them when a window is given), online softmax in
float32. The cache is read where it lies, through strides: the model
passes its (B, S_max, Hkv, D) buffers as (B, Hkv, S, D) views, so no
head-major or GQA-expanded copy is made. Replaces
``repro/kernels/decode_attention.py::decode_attention``; the function it
computes is ``ref.decode_attention_window_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, check_strided, dtype_code


def num_splits(B: int, Hkv: int, S: int, device: torch.device) -> int:
    """Slices of the sequence per (b, kv head): enough blocks for two per
    SM, at least 256 cache rows a slice."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms // (B * Hkv))
    return max(1, min(want, -(-S // 256)))


def decode_attention(q, k, v, lengths, *, window: int | None = None):
    """q (B, Hq, D), k/v (B, Hkv, S, D), any strides with a unit last dim;
    lengths (B,) int32 on the card. fp32 or bf16, q/k/v alike. Returns
    (B, Hq, D) in q.dtype; a row with length 0 gives 0."""
    dev = q.device
    B, Hq, D = q.shape
    check_strided(q, "q", 3, dev)
    check_strided(k, "k", 4, dev, q.dtype)
    check_strided(v, "v", 4, dev, q.dtype)
    _build.require(lengths, "lengths", dtypes=(torch.int32,), ndim=1,
                   device=dev)
    Hkv, S = k.shape[1], k.shape[2]
    if (k.shape != (B, Hkv, S, D) or v.shape != k.shape
            or lengths.shape != (B,) or Hq % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}: want q (B, Hq, D), k/v "
                         "(B, Hkv, S, D) with Hkv dividing Hq, lengths (B,)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    nsplit = num_splits(B, Hkv, S, dev)
    ws = (torch.empty(B * Hq * nsplit * (D + 2), dtype=torch.float32,
                      device=dev) if nsplit > 1 else None)
    lib = _build.load("attention")
    err = lib.brds_decode_attention(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Hq, Hkv, S, D,
        0 if window is None else int(window), float(D ** -0.5), nsplit,
        dtype_code(q.dtype), _build.stream(dev))
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
