"""CUDA kernel: single-query GQA decode attention over a KV cache
(``csrc/attention.cu``, B14).

One query per sequence against its first ``lengths[b]`` cache rows (the
last ``window`` of them when a window is given), online softmax in
float32. The cache is read where it lies, through strides: the model
passes its (B, S_max, Hkv, D) buffers as (B, Hkv, S, D) views, so no
head-major or GQA-expanded copy is made. One launch: the slices of a
(b, kv head) pair run as one thread-block cluster and merge on chip
(``plan.decode_plan`` sizes slices, clusters and the copy ring).
With ``lse=`` the merge also stores each row's log-sum-exp (m + log l of
the scaled scores; -inf where no key is live), which a split-KV decode
weighs the ranks' partial outputs by; without it nothing more is stored.
With ``start=`` each row's keys begin at its own first live key (a
split-KV rank's first key of the window within its segment); without it
every launch is what it was.
Replaces ``repro/kernels/decode_attention.py::decode_attention``; the
function it computes is ``ref.decode_attention_window_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, check_strided, dtype_code
from .plan import DecodePlan, decode_plan, waves


def decode_plan_for(q, k) -> DecodePlan:
    """The launch plan of q (B, Hq, D) against k (B, Hkv, S, D) on q's
    card."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    return decode_plan(B=B, Hkv=Hkv, G=Hq // Hkv, S=S, D=D,
                       elem_bytes=q.element_size(),
                       sms=_build.sm_count(q.device))


def decode_attention(q, k, v, lengths, *, window: int | None = None,
                     fixed_length: int | None = None,
                     lse: torch.Tensor | None = None,
                     start: torch.Tensor | None = None):
    """q (B, Hq, D), k/v (B, Hkv, S, D), any strides with a unit last dim;
    lengths (B,) int32 on the card. fp32 or bf16, q/k/v alike. Returns
    (B, Hq, D) in q.dtype; a row with length 0 gives 0. ``lse``: a
    contiguous (B, Hq) float32 tensor on the card that takes each row's
    log-sum-exp (-inf for a row with no live key). ``start``: (B,) int32
    on the card, each row's first live key (the window's first too, where
    later); a row whose start is at or past its length gives 0 (and lse
    -inf). ``fixed_length``
    is a diagnostic (``launch.profile_kernels``): every row takes that
    length and ``lengths`` is not read."""
    _build.refuse_autograd("decode_attention", q, k, v, lengths)
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
    if start is not None:
        _build.require(start, "start", dtypes=(torch.int32,), ndim=1,
                       device=dev)
        if start.shape != (B,) or not start.is_contiguous():
            raise ValueError(f"start {tuple(start.shape)}: want a "
                             f"contiguous ({B},)")
    if lse is not None:
        _build.require(lse, "lse", dtypes=(torch.float32,), ndim=2,
                       device=dev)
        if lse.shape != (B, Hq) or not lse.is_contiguous():
            raise ValueError(f"lse {tuple(lse.shape)}: want a contiguous "
                             f"({B}, {Hq})")
    plan = decode_plan_for(q, k)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    lib = _build.load("attention")
    err = lib.brds_decode_attention(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        lengths.data_ptr(), None if start is None else start.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, S, D,
        0 if window is None else int(window), float(D ** -0.5), plan.splits,
        plan.stages, plan.smem,
        -1 if fixed_length is None else int(fixed_length),
        None if lse is None else lse.data_ptr(),
        dtype_code(q.dtype), _build.stream(dev))
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    if lse is not None:
        LSE_LAUNCHES[0] += 1
    if start is not None:
        START_LAUNCHES[0] += 1
    return out


# launches that stored lse / read start= (parts of
# LAUNCHES["decode_attention"])
LSE_LAUNCHES = [0]
START_LAUNCHES = [0]


def decode_info(plan: DecodePlan, D: int, G: int, dtype: torch.dtype,
                device) -> dict:
    """The decode instantiation ``plan`` launches: registers and local
    (spill) bytes a thread, static shared bytes, blocks an SM at the plan's
    shared memory, q heads a block, and the waves of the plan's grid."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.load("attention").brds_decode_attention_info(
        D, G, dtype_code(dtype), plan.smem, out), "decode_attention_info")
    regs, local, static, per_sm, heads = list(out)
    return dict(registers=regs, local_bytes=local, static_smem=static,
                blocks_per_sm=per_sm, heads=heads,
                waves=waves(plan.grid, per_sm, _build.sm_count(device))
                if per_sm else None)
