"""CUDA kernels: a whole BRDS-LSTM layer step in one launch
(``csrc/fused_step.cu``), in its float, temporal-delta, quantized and
quantized temporal-delta forms.

The gate stage (Gate module) feeds the cell (Function module) without z, c
or h leaving the chip between them, the paper's pipelined datapath. Each
block owns a tile of hidden units and computes their four gate rows with
the same row routine and epilogue as the chained gate kernel
(``rb_dual_spmv``, ``delta_rb_dual_spmv``, ``rb_dual_parts_q8``), then
closes the cell with the same cell function as ``lstm_gates``, so each
step is bitwise equal to its chained pair. Each runs its chained gate
kernel's design, one block an SM: the float and delta steps
``plan.stream_plan``'s (x and h or the masked deltas staged in shared
memory, the rows streamed in ``row_dot``'s order), the q8 and delta-q8
steps ``plan.q8_plan``'s (activation codes staged in shared memory, four
entries a lane; integer sums are exact in any order), and make z (and m')
in the epilogue. Replaces
``repro/kernels/fused_step.py::fused_brds_lstm_step``,
``::fused_brds_delta_lstm_step``, ``::fused_brds_lstm_step_q8`` and
``::fused_brds_delta_lstm_step_q8``.
"""
from __future__ import annotations

import torch

from . import _build
from .delta_rb_spmv import check_delta
from .lstm_gates import act_args
from .rb_spmv import check_batch, check_packed, stream_args, stream_plan_for
from .rb_spmv_q8 import check_aligned, check_q8, q8_args, q8_plan_for


def _check_cell(bias, c_prev, dev, B: int, H: int) -> None:
    """bias (4H,), c_prev (B, H), float32 on ``dev``."""
    _build.require(bias, "bias", dtypes=(torch.float32,), ndim=1, device=dev)
    _build.require(c_prev, "c_prev", dtypes=(torch.float32,), ndim=2,
                   device=dev)
    if bias.shape != (4 * H,) or c_prev.shape != (B, H):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({4 * H},) and "
                         f"c_prev {tuple(c_prev.shape)} ({B}, {H})")


def fused_brds_lstm_step(vals_x, deltas_x, x, vals_h, deltas_h, h, bias,
                         c_prev, *, pwl: bool = False):
    """One BRDS-LSTM decode step: (c, h) from packed Sx (≥ 4H, Kx) and
    Sh (≥ 4H, Kh) over the 4H gate rows grouped [f; i; g; o] (rows past 4H,
    ``pad_packed``'s zero rows, are not read), x (B, X), h and c_prev
    (B, H), bias (4H,), all float32 on one card."""
    _build.refuse_autograd("fused_brds_lstm_step", vals_x, deltas_x, x, vals_h,
                           deltas_h, h, bias, c_prev)
    dev = x.device
    _build.require(x, "x", dtypes=(torch.float32,), ndim=2)
    for name, t in (("h", h), ("c_prev", c_prev)):
        _build.require(t, name, dtypes=(torch.float32,), ndim=2, device=dev)
    _build.require(bias, "bias", dtypes=(torch.float32,), ndim=1, device=dev)
    check_packed(vals_x, deltas_x, "Sx", dev)
    check_packed(vals_h, deltas_h, "Sh", dev)
    Kx, Kh = vals_x.shape[1], vals_h.shape[1]
    B, X = x.shape
    H = h.shape[1]
    check_batch(B)
    if (min(vals_x.shape[0], vals_h.shape[0]) < 4 * H
            or bias.shape != (4 * H,) or h.shape[0] != B
            or c_prev.shape != h.shape):
        raise ValueError(f"shape mismatch: Sx {tuple(vals_x.shape)}, Sh "
                         f"{tuple(vals_h.shape)}, bias {tuple(bias.shape)}, "
                         f"x {tuple(x.shape)}, h {tuple(h.shape)}, c_prev "
                         f"{tuple(c_prev.shape)}")
    plan = stream_plan_for(vals_x, vals_h, x, h, 4 * H, fused=True)
    c_out = torch.empty_like(c_prev)
    h_out = torch.empty_like(c_prev)
    lib = _build.load("fused_step")
    err = lib.brds_fused_lstm_step(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        x.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h.data_ptr(), H, bias.data_ptr(),
        c_prev.data_ptr(), c_out.data_ptr(), h_out.data_ptr(), B,
        plan.units, *stream_args(plan), *act_args(pwl, dev),
        _build.stream(dev))
    _build.check(err, "fused_brds_lstm_step")
    _build.LAUNCHES["fused_brds_lstm_step"] += 1
    return c_out, h_out


def fused_brds_delta_lstm_step(vals_x, deltas_x, dx, fx, vals_h, deltas_h,
                               dh, fh, m, bias, c_prev, *, pwl: bool = False):
    """One temporal-delta BRDS-LSTM step: m' = m + Sx@(fx·dx) + Sh@(fh·dh),
    z = m' + bias, then the cell, over the 4H gate rows of packed Sx, Sh
    (rows past 4H are not read). dx, fx (B, X); dh, fh, c_prev (B, H);
    m (B, 4H); bias (4H,); all float32 on one card, the masks exactly 0 or
    1. Returns (c, h, m')."""
    _build.refuse_autograd("fused_brds_delta_lstm_step", vals_x, deltas_x, dx,
                           fx, vals_h, deltas_h, dh, fh, m, bias, c_prev)
    dev = m.device
    _build.require(m, "m", dtypes=(torch.float32,), ndim=2)
    check_delta(dx, fx, "x", dev)
    check_delta(dh, fh, "h", dev)
    check_packed(vals_x, deltas_x, "Sx", dev)
    check_packed(vals_h, deltas_h, "Sh", dev)
    B, X = dx.shape
    H = dh.shape[1]
    check_batch(B)
    _check_cell(bias, c_prev, dev, B, H)
    if (min(vals_x.shape[0], vals_h.shape[0]) < 4 * H
            or m.shape != (B, 4 * H) or dh.shape[0] != B):
        raise ValueError(f"shape mismatch: Sx {tuple(vals_x.shape)}, Sh "
                         f"{tuple(vals_h.shape)}, m {tuple(m.shape)}, dx "
                         f"{tuple(dx.shape)}, dh {tuple(dh.shape)}")
    plan = stream_plan_for(vals_x, vals_h, dx, dh, 4 * H, fused=True)
    c_out = torch.empty_like(c_prev)
    h_out = torch.empty_like(c_prev)
    m_out = torch.empty_like(m)
    lib = _build.load("fused_step")
    err = lib.brds_fused_delta_lstm_step(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], dx.data_ptr(), fx.data_ptr(), X, vals_h.data_ptr(),
        deltas_h.data_ptr(), deltas_h.element_size(), vals_h.shape[1],
        dh.data_ptr(), fh.data_ptr(), H, m.data_ptr(), bias.data_ptr(),
        c_prev.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
        m_out.data_ptr(), B, plan.units, *stream_args(plan),
        *act_args(pwl, dev), _build.stream(dev))
    _build.check(err, "fused_brds_delta_lstm_step")
    _build.LAUNCHES["fused_brds_delta_lstm_step"] += 1
    return c_out, h_out, m_out


def fused_brds_lstm_step_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h,
                            comb_h, qh, bias, c_prev, *, pwl: bool = False):
    """One quantized BRDS-LSTM step: zx, zh = dq(Sx@qx), dq(Sh@qh), z =
    zx + zh + bias, then the cell, over the 4H gate rows of packed integer
    codes Sx, Sh (int8 or int16, as qx (B, X) and qh (B, H); rows past 4H
    are not read; codes and deltas 16-byte aligned: the kernel loads four
    entries at once); comb_* (≥ 4H,) float32 combined dequant scales;
    bias (4H,) and c_prev (B, H) float32. Returns (c, h)."""
    _build.refuse_autograd("fused_brds_lstm_step_q8", vals_x, deltas_x, comb_x,
                           qx, vals_h, deltas_h, comb_h, qh, bias, c_prev)
    dev = qx.device
    B, X, H = check_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h,
                       comb_h, qh, 4 * qh.shape[-1])
    _check_cell(bias, c_prev, dev, B, H)
    check_aligned(vals_x, deltas_x, vals_h, deltas_h)
    plan = q8_plan_for(vals_x, vals_h, qx, qh)
    c_out = torch.empty_like(c_prev)
    h_out = torch.empty_like(c_prev)
    lib = _build.load("fused_step")
    err = lib.brds_fused_lstm_step_q8(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], comb_x.data_ptr(), qx.data_ptr(), X,
        vals_h.data_ptr(), deltas_h.data_ptr(), deltas_h.element_size(),
        vals_h.shape[1], comb_h.data_ptr(), qh.data_ptr(), H,
        vals_x.element_size(), bias.data_ptr(), c_prev.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(), B, plan.units, *q8_args(plan),
        *act_args(pwl, dev), _build.stream(dev))
    _build.check(err, "fused_brds_lstm_step_q8")
    _build.LAUNCHES["fused_brds_lstm_step_q8"] += 1
    return c_out, h_out


def fused_brds_delta_lstm_step_q8(vals_x, deltas_x, comb_x, qdx, vals_h,
                                  deltas_h, comb_h, qdh, m, bias, c_prev, *,
                                  pwl: bool = False):
    """One quantized temporal-delta BRDS-LSTM step: zx, zh = dq(Sx@qdx),
    dq(Sh@qdh) over the codes of the masked deltas, m' = m + zx + zh,
    z = m' + bias, then the cell, over the 4H gate rows of packed integer
    codes Sx, Sh (int8 or int16, as qdx (B, X) and qdh (B, H); rows past
    4H are not read; codes and deltas 16-byte aligned); comb_* (≥ 4H,)
    float32 combined dequant scales; m (B, 4H), bias (4H,) and c_prev
    (B, H) float32. Returns (c, h, m')."""
    _build.refuse_autograd("fused_brds_delta_lstm_step_q8", vals_x, deltas_x,
                           comb_x, qdx, vals_h, deltas_h, comb_h, qdh, m, bias,
                           c_prev)
    dev = qdx.device
    B, X, H = check_q8(vals_x, deltas_x, comb_x, qdx, vals_h, deltas_h,
                       comb_h, qdh, 4 * qdh.shape[-1])
    _check_cell(bias, c_prev, dev, B, H)
    _build.require(m, "m", dtypes=(torch.float32,), ndim=2, device=dev)
    if m.shape != (B, 4 * H):
        raise ValueError(f"m {tuple(m.shape)} must be ({B}, {4 * H})")
    check_aligned(vals_x, deltas_x, vals_h, deltas_h)
    plan = q8_plan_for(vals_x, vals_h, qdx, qdh, delta=True)
    c_out = torch.empty_like(c_prev)
    h_out = torch.empty_like(c_prev)
    m_out = torch.empty_like(m)
    lib = _build.load("fused_step")
    err = lib.brds_fused_delta_lstm_step_q8(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], comb_x.data_ptr(), qdx.data_ptr(), X,
        vals_h.data_ptr(), deltas_h.data_ptr(), deltas_h.element_size(),
        vals_h.shape[1], comb_h.data_ptr(), qdh.data_ptr(), H,
        vals_x.element_size(), m.data_ptr(), bias.data_ptr(),
        c_prev.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
        m_out.data_ptr(), B, plan.units, *q8_args(plan), *act_args(pwl, dev),
        _build.stream(dev))
    _build.check(err, "fused_brds_delta_lstm_step_q8")
    _build.LAUNCHES["fused_brds_delta_lstm_step_q8"] += 1
    return c_out, h_out, m_out
