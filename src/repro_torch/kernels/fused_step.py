"""CUDA kernel: the whole BRDS-LSTM layer step in one launch
(``csrc/fused_step.cu``).

The dual-ratio SpMV (Gate module) feeds the cell (Function module) without
z, c or h leaving the chip between them, the paper's pipelined datapath.
Each block owns a tile of hidden units and computes their four gate rows
with the same row routine as ``rb_dual_spmv``, then closes the cell with
the same cell function as ``lstm_gates``, so the step is bitwise equal to
the chained pair. Replaces
``repro/kernels/fused_step.py::fused_brds_lstm_step``.
"""
from __future__ import annotations

import torch

from . import _build
from .lstm_gates import act_args
from .rb_spmv import check_batch, check_packed


def fused_brds_lstm_step(vals_x, deltas_x, x, vals_h, deltas_h, h, bias,
                         c_prev, *, pwl: bool = False):
    """One BRDS-LSTM decode step: (c, h) from packed Sx (≥ 4H, Kx) and
    Sh (≥ 4H, Kh) over the 4H gate rows grouped [f; i; g; o] (rows past 4H,
    ``pad_packed``'s zero rows, are not read), x (B, X), h and c_prev
    (B, H), bias (4H,), all float32 on one card."""
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
    c_out = torch.empty_like(c_prev)
    h_out = torch.empty_like(c_prev)
    lib = _build.load("fused_step")
    err = lib.brds_fused_lstm_step(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        x.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h.data_ptr(), H, bias.data_ptr(),
        c_prev.data_ptr(), c_out.data_ptr(), h_out.data_ptr(), B,
        *act_args(pwl, dev), _build.stream(dev))
    _build.check(err, "fused_brds_lstm_step")
    _build.LAUNCHES["fused_brds_lstm_step"] += 1
    return c_out, h_out
