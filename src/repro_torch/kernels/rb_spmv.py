"""CUDA kernels: packed row-balanced float SpMV (``csrc/rb_spmv.cu``).

The BRDS accelerator's Gate-module MxV: z = Sx@x + Sh@h + bias, with both
packed families consumed by the warp that owns a row (the Large/Small
mult-array lockstep), and its single-family form y = S@x behind the
format API. Replaces ``repro/kernels/rb_spmv.py::rb_dual_spmv`` and
``::rb_spmv``.
"""
from __future__ import annotations

import torch

from . import _build

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
    """Any batch of at least one row: the kernels run a larger one in
    tiles of 16 rows (``brds::kMaxBatch``) inside one launch."""
    if B < 1:
        raise ValueError(f"batch {B}: the kernels need at least one row")


def check_rows(vals, rows: int, name: str) -> None:
    if not 0 < rows <= vals.shape[0]:
        raise ValueError(f"{name} has {vals.shape[0]} packed rows, asked "
                         f"for {rows}")


def rb_spmv(vals, deltas, x, rows: int):
    """y = S @ x over the first ``rows`` rows of packed S (≥ rows, K);
    rows past them (``pad_packed``'s zero rows) are not read. x (B, X)
    float32 on one card. Returns (B, rows) float32."""
    dev = x.device
    _build.require(x, "x", dtypes=(torch.float32,), ndim=2)
    check_packed(vals, deltas, "S", dev)
    check_rows(vals, rows, "S")
    B, X = x.shape
    check_batch(B)
    y = torch.empty((B, rows), dtype=x.dtype, device=dev)
    lib = _build.load("rb_spmv")
    err = lib.brds_rb_spmv(vals.data_ptr(), deltas.data_ptr(),
                           deltas.element_size(), vals.shape[1],
                           x.data_ptr(), X, y.data_ptr(), B, rows,
                           _build.stream(dev))
    _build.check(err, "rb_spmv")
    _build.LAUNCHES["rb_spmv"] += 1
    return y


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
