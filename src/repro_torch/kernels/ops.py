"""Public wrappers around the kernels, with backend selection.

The backend (``repro_torch.sparse.backend``) resolves per call: "cuda"
launches the hand-written kernel, "ref" runs the plain PyTorch version, and
"auto" picks by where the operands lie. A CUDA tensor never falls back to
the plain version.

A struct pre-padded by ``core.packing.pad_packed`` is consumed as it is
(no per-call copy of the weight stream), as is an unpadded one: the kernels
read only the logical rows, so only logical rows come out, and the bias is
fitted to them as the reference's ``_fit`` does.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from ._build import LAUNCHES
from .fused_step import fused_brds_lstm_step as _fused_kernel
from .lstm_gates import lstm_gates as _lstm_gates_kernel
from .rb_spmv import rb_dual_spmv as _rb_dual_kernel
from ..core.packing import RowBalancedSparse
from ..sparse import backend as _backend

__all__ = ["LAUNCHES", "rb_dual_spmv", "lstm_gates", "brds_lstm_step",
           "fused_brds_lstm_step"]


def _fit(vec, n):
    """Pad (with zeros) or slice ``vec``'s last axis to length ``n``."""
    have = vec.shape[-1]
    if have == n:
        return vec
    if have > n:
        return vec[..., :n]
    return torch.nn.functional.pad(vec, (0, n - have))


def _check_dual(sx: RowBalancedSparse, x, sh: RowBalancedSparse, h):
    """The kernels gather x and h by column without bounds checks, over the
    rows the two families share."""
    if sx.ncols != x.shape[-1] or sh.ncols != h.shape[-1]:
        raise ValueError(f"packed ncols ({sx.ncols}, {sh.ncols}) do not "
                         f"match x {tuple(x.shape)} and h {tuple(h.shape)}")
    if sx.rows != sh.rows:
        raise ValueError(f"Sx has {sx.rows} rows, Sh {sh.rows}")


def rb_dual_spmv(sx: RowBalancedSparse, x, sh: RowBalancedSparse, h, bias,
                 *, backend: str | None = None):
    """z = Sx@x + Sh@h + bias — the dual-ratio gate preactivation,
    (B, rows) in x.dtype."""
    if _backend.resolve(backend, x) == "ref":
        return _ref.rb_dual_spmv_ref(sx, x, sh, h, bias)
    _check_dual(sx, x, sh, h)
    return _rb_dual_kernel(sx.values, sx.deltas, x, sh.values, sh.deltas, h,
                           _fit(bias, sx.rows))


def lstm_gates(zf, zi, zg, zo, c_prev, *, pwl: bool = False,
               backend: str | None = None):
    """(c, h) from the four gate preactivations and c_prev."""
    if _backend.resolve(backend, c_prev) == "ref":
        return _ref.lstm_cell_ref(zf, zi, zg, zo, c_prev, pwl=pwl)
    return _lstm_gates_kernel(zf, zi, zg, zo, c_prev, pwl=pwl)


def brds_lstm_step(sx: RowBalancedSparse, x, sh: RowBalancedSparse, h_prev,
                   bias, c_prev, *, pwl: bool = False,
                   backend: str | None = None):
    """One BRDS-LSTM step, chained: the dual-ratio SpMV (Gate module), z
    through device memory, then the cell (Function module). x (B, X),
    h/c (B, H), sx/sh packed over the 4H gate rows. Returns (c, h)."""
    z = rb_dual_spmv(sx, x, sh, h_prev, bias, backend=backend)
    H = z.shape[-1] // 4
    return lstm_gates(z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                      z[:, 3 * H:], c_prev, pwl=pwl, backend=backend)


def fused_brds_lstm_step(sx: RowBalancedSparse, x, sh: RowBalancedSparse,
                         h_prev, bias, c_prev, *, pwl: bool = False,
                         backend: str | None = None):
    """``brds_lstm_step`` in one kernel launch, bitwise equal to the
    chained form. Returns (c, h)."""
    if _backend.resolve(backend, x) == "ref":
        z = _ref.rb_dual_spmv_ref(sx, x, sh, h_prev, bias)
        H = z.shape[-1] // 4
        return _ref.lstm_cell_ref(z[:, :H], z[:, H:2 * H],
                                  z[:, 2 * H:3 * H], z[:, 3 * H:],
                                  c_prev, pwl=pwl)
    _check_dual(sx, x, sh, h_prev)
    return _fused_kernel(sx.values, sx.deltas, x, sh.values, sh.deltas,
                         h_prev, _fit(bias, sx.rows), c_prev, pwl=pwl)
