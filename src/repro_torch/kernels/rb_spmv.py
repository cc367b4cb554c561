"""CUDA kernel: packed row-balanced dual-family SpMV (``csrc/rb_spmv.cu``).

The BRDS accelerator's Gate-module MxV: z = Sx@x + Sh@h + bias, with both
packed families consumed by the warp that owns a row (the Large/Small
mult-array lockstep). Replaces ``repro/kernels/rb_spmv.py::rb_dual_spmv``.
"""
from __future__ import annotations

import torch

from . import _build

MAX_BATCH = 16          # brds::kMaxBatch in csrc/brds_common.cuh
DELTA_DTYPES = (torch.int8, torch.int16, torch.int32)


def check_packed(vals, deltas, name: str, device) -> None:
    _build.require(vals, f"{name} values", dtypes=(torch.float32,), ndim=2,
                   device=device)
    _build.require(deltas, f"{name} deltas", dtypes=DELTA_DTYPES, ndim=2,
                   device=device)
    if deltas.shape != vals.shape:
        raise ValueError(f"{name} deltas {tuple(deltas.shape)} != values "
                         f"{tuple(vals.shape)}")


def check_batch(B: int) -> None:
    if not 0 < B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside the kernels' 1..{MAX_BATCH}")


def rb_dual_spmv(vals_x, deltas_x, x, vals_h, deltas_h, h, bias):
    """z = Sx @ x + Sh @ h + bias over the first R = len(bias) rows of
    packed Sx (≥ R, Kx) and Sh (≥ R, Kh); rows past R (``pad_packed``'s
    zero rows) are not read.

    x (B, X), h (B, H), bias (R,), all float32 on one card. Returns (B, R)
    float32.
    """
    dev = x.device
    _build.require(x, "x", dtypes=(torch.float32,), ndim=2)
    _build.require(h, "h", dtypes=(torch.float32,), ndim=2, device=dev)
    _build.require(bias, "bias", dtypes=(torch.float32,), ndim=1, device=dev)
    check_packed(vals_x, deltas_x, "Sx", dev)
    check_packed(vals_h, deltas_h, "Sh", dev)
    R, Kx, Kh = bias.shape[0], vals_x.shape[1], vals_h.shape[1]
    B, X = x.shape
    H = h.shape[1]
    check_batch(B)
    if min(vals_x.shape[0], vals_h.shape[0]) < R or h.shape[0] != B:
        raise ValueError(f"shape mismatch: Sx {tuple(vals_x.shape)}, Sh "
                         f"{tuple(vals_h.shape)}, bias {tuple(bias.shape)}, "
                         f"x {tuple(x.shape)}, h {tuple(h.shape)}")
    z = torch.empty((B, R), dtype=x.dtype, device=dev)
    lib = _build.load("rb_spmv")
    err = lib.brds_rb_dual_spmv(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        x.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h.data_ptr(), H, bias.data_ptr(),
        z.data_ptr(), B, R, _build.stream(dev))
    _build.check(err, "rb_dual_spmv")
    _build.LAUNCHES["rb_dual_spmv"] += 1
    return z
