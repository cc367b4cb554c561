"""CUDA kernel: fused LSTM cell elementwise update (``csrc/lstm_gates.cu``).

The paper's Function + Buffer modules: σ/tanh (exact, or the 16-segment
piecewise-linear LUT of the fixed-point datapath study) and the cell update
c = f·c_prev + i·g, h = o·tanh(c), with each cell product rounded on its
own. A programmatic dependent launch: its blocks may start while the
kernel before it in the stream still runs and wait on the card for that
kernel's memory, so the launch latency hides behind the producer's tail
(``plan.gates_plan``: one unit a thread, at most one wave). Replaces
``repro/kernels/lstm_gates.py::lstm_gates``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .plan import GatesPlan, gates_plan
from .ref import pwl_tables

_T = pwl_tables()
# rows: a_sig, b_sig, a_tanh, b_tanh
_LUT = np.stack([_T["sig"][0], _T["sig"][1], _T["tanh"][0], _T["tanh"][1]])
# the reference clips to hi - 1e-6 in float32
_HIC = float(np.float32(_T["hi"] - 1e-6))
_lut_on: dict[torch.device, torch.Tensor] = {}


def act_args(pwl: bool, device: torch.device) -> tuple:
    """(lut pointer or None, lo, hi, hic): the cell's activation arguments
    for the C entry points. The LUT is copied to each card once."""
    lut = None
    if pwl:
        if device not in _lut_on:
            _lut_on[device] = torch.as_tensor(_LUT, device=device)
        lut = _lut_on[device].data_ptr()
    return lut, float(_T["lo"]), float(_T["hi"]), _HIC


def gates_info(plan: GatesPlan, device) -> dict:
    """``_build.kernel_info`` of the cell's kernel at ``plan``'s grid."""
    return _build.kernel_info("lstm_gates", "brds_lstm_gates_info", (),
                              plan.grid, device)


def lstm_gates(zf, zi, zg, zo, c_prev, *, pwl: bool = False,
               pdl: bool = True):
    """(c_t, h_t) from the four (B, H) gate preactivations and c_prev.

    The z inputs may be column slices of one (B, ldz) matrix (row stride
    ldz, unit column stride), as the chained step passes them; c_prev is
    contiguous. All float32 on one card. ``pdl`` False launches the kernel
    plainly, after the kernel before it has drained (a timing variant).
    """
    _build.refuse_autograd("lstm_gates", zf, zi, zg, zo, c_prev)
    dev = c_prev.device
    _build.require(c_prev, "c_prev", dtypes=(torch.float32,), ndim=2)
    B, H = c_prev.shape
    zs = (zf, zi, zg, zo)
    for name, z in zip(("zf", "zi", "zg", "zo"), zs):
        _build.require(z, name, dtypes=(torch.float32,), ndim=2, device=dev,
                       contiguous=False)
        if (z.shape != (B, H) or z.stride(1) != 1
                or z.stride(0) != zf.stride(0)):
            raise ValueError(f"{name} must be ({B}, {H}) with unit column "
                             "stride and the row stride of zf, got shape "
                             f"{tuple(z.shape)} strides {z.stride()}")
    c = torch.empty_like(c_prev)
    h = torch.empty_like(c_prev)
    plan = gates_plan(B=B, H=H, sms=_build.sm_count(dev))
    lib = _build.load("lstm_gates")
    err = lib.brds_lstm_gates(zf.data_ptr(), zi.data_ptr(), zg.data_ptr(),
                              zo.data_ptr(), zf.stride(0), c_prev.data_ptr(),
                              c.data_ptr(), h.data_ptr(), B, H, plan.grid,
                              int(pdl), *act_args(pwl, dev),
                              _build.stream(dev))
    _build.check(err, "lstm_gates")
    _build.LAUNCHES["lstm_gates"] += 1
    return c, h
