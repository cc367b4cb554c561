"""CUDA kernels: the temporal-delta SpMVs (``csrc/delta_rb_spmv.cu``).

The Spartus composition on the BRDS Gate-module MxV: the partial-sum memory
advances by the products of fired columns only, m' = m + Sx@(fx·dx) +
Sh@(fh·dh), over the same row-balanced packing as ``rb_dual_spmv``; the
single-family form y = S@(f·d) sits behind ``ops.delta_rb_spmv``. Both
run one block an SM on ``plan.stream_plan`` (the single-family form
without H, as ``rb_spmv``): the masked deltas staged in shared memory
once a block, each row's sums in ``row_dot``'s order (the fused delta
step's routine, so the dual kernel and the step stay bitwise a chain, and
m + y(Sx) + y(Sh), added in that order, is the dual kernel's m').
Thresholding happens in PyTorch before the launch
(``sparse.temporal.delta_threshold``), so a kernel and its plain version
read the same deltas and masks. Replaces
``repro/kernels/delta_rb_spmv.py::delta_rb_dual_spmv`` and
``::delta_rb_spmv``.
"""
from __future__ import annotations

import torch

from . import _build
from .rb_spmv import (check_batch, check_packed, check_rows,
                      single_plan_for, stream_args, stream_plan_for)


def check_delta(d, f, name: str, device) -> None:
    """A float32 (B, N) delta and its float32 0/1 fired mask."""
    _build.require(d, f"d{name}", dtypes=(torch.float32,), ndim=2,
                   device=device)
    _build.require(f, f"f{name}", dtypes=(torch.float32,), ndim=2,
                   device=device)
    if f.shape != d.shape:
        raise ValueError(f"d{name} {tuple(d.shape)} and f{name} "
                         f"{tuple(f.shape)} differ")


def delta_rb_spmv(vals, deltas, d, f, rows: int):
    """y = S @ (f·d) over the first ``rows`` rows of packed S (≥ rows, K);
    d, f (B, X) float32 on one card, the mask exactly 0 or 1. Returns
    (B, rows) float32."""
    _build.refuse_autograd("delta_rb_spmv", vals, deltas, d, f)
    dev = d.device
    check_delta(d, f, "", dev)
    check_packed(vals, deltas, "S", dev)
    check_rows(vals, rows, "S")
    B, X = d.shape
    check_batch(B)
    plan = single_plan_for(vals, d, rows)
    y = torch.empty((B, rows), dtype=d.dtype, device=dev)
    lib = _build.load("delta_rb_spmv")
    err = lib.brds_delta_rb_spmv(vals.data_ptr(), deltas.data_ptr(),
                                 deltas.element_size(), vals.shape[1],
                                 d.data_ptr(), f.data_ptr(), X, y.data_ptr(),
                                 B, rows, plan.rows, int(plan.stage_x),
                                 plan.shift_x, plan.slot_bits, plan.xpad,
                                 plan.smem, _build.stream(dev))
    _build.check(err, "delta_rb_spmv")
    _build.LAUNCHES["delta_rb_spmv"] += 1
    return y


def delta_rb_dual_spmv(vals_x, deltas_x, dx, fx, vals_h, deltas_h, dh, fh,
                       m):
    """m' = m + Sx @ (fx·dx) + Sh @ (fh·dh) over the first R = m.shape[1]
    rows of packed Sx (≥ R, Kx) and Sh (≥ R, Kh); rows past R
    (``pad_packed``'s zero rows) are not read.

    dx, fx (B, X); dh, fh (B, H); m (B, R); all float32 on one card, the
    masks exactly 0 or 1. Returns m' (B, R) float32.
    """
    _build.refuse_autograd("delta_rb_dual_spmv", vals_x, deltas_x, dx, fx,
                           vals_h, deltas_h, dh, fh, m)
    dev = m.device
    _build.require(m, "m", dtypes=(torch.float32,), ndim=2)
    B, R = m.shape
    check_batch(B)
    check_packed(vals_x, deltas_x, "Sx", dev)
    check_packed(vals_h, deltas_h, "Sh", dev)
    check_delta(dx, fx, "x", dev)
    check_delta(dh, fh, "h", dev)
    X, H = dx.shape[1], dh.shape[1]
    if (min(vals_x.shape[0], vals_h.shape[0]) < R or dx.shape[0] != B
            or dh.shape[0] != B):
        raise ValueError(f"shape mismatch: Sx {tuple(vals_x.shape)}, Sh "
                         f"{tuple(vals_h.shape)}, m {tuple(m.shape)}, dx "
                         f"{tuple(dx.shape)}, dh {tuple(dh.shape)}")
    plan = stream_plan_for(vals_x, vals_h, dx, dh, R)
    m_out = torch.empty_like(m)
    lib = _build.load("delta_rb_spmv")
    err = lib.brds_delta_rb_dual_spmv(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], dx.data_ptr(), fx.data_ptr(), X, vals_h.data_ptr(),
        deltas_h.data_ptr(), deltas_h.element_size(), vals_h.shape[1],
        dh.data_ptr(), fh.data_ptr(), H, m.data_ptr(), m_out.data_ptr(), B,
        R, plan.rows, *stream_args(plan), _build.stream(dev))
    _build.check(err, "delta_rb_dual_spmv")
    _build.LAUNCHES["delta_rb_dual_spmv"] += 1
    return m_out
