"""CUDA kernels: the quantized row-balanced SpMVs (``csrc/rb_spmv_q8.cu``).

The fixed-point Gate-module MxV: integer weight codes times integer
activation codes, int32 accumulation, one dequant multiply per row by the
combined (row × activation) scale. The dual form returns the two
families' partial sums (zx, zh) apart, so the adds that follow happen in
PyTorch in the reference's order; the single-family form serves the
``row_balanced_q8`` format's matvec. The wrappers quantize the activations
before the launch, so a kernel and its plain version read the same codes
and agree bit for bit. Replaces
``repro/kernels/rb_spmv_q8.py::rb_dual_parts_q8`` and ``::rb_spmv_q8``.
"""
from __future__ import annotations

import torch

from . import _build
from .rb_spmv import check_batch

CODE_DTYPES = (torch.int8, torch.int16)
DELTA_DTYPES = (torch.int8, torch.int16, torch.int32)


def _check_family(name, vals, deltas, comb, q, rows: int) -> None:
    """One family's packed integer codes, delta indices and ≥ ``rows``
    combined float32 scales, and its activation codes q, all of one code
    type on q's card."""
    dev = q.device
    _build.require(q, f"{name} activation codes", dtypes=CODE_DTYPES,
                   ndim=2)
    _build.require(vals, f"{name} codes", dtypes=(q.dtype,), ndim=2,
                   device=dev)
    _build.require(deltas, f"{name} deltas", dtypes=DELTA_DTYPES, ndim=2,
                   device=dev)
    _build.require(comb, f"{name} scales", dtypes=(torch.float32,), ndim=1,
                   device=dev)
    if deltas.shape != vals.shape:
        raise ValueError(f"{name} deltas {tuple(deltas.shape)} != codes "
                         f"{tuple(vals.shape)}")
    if not 0 < rows <= min(vals.shape[0], comb.shape[0]):
        raise ValueError(f"{name} has {vals.shape[0]} rows and "
                         f"{comb.shape[0]} scales, need {rows}")
    check_batch(q.shape[0])


def check_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h, comb_h, qh,
             rows: int) -> tuple[int, int, int]:
    """Both families (``_check_family``), of one code type on one card and
    one batch. Returns (B, X, H)."""
    _check_family("Sx", vals_x, deltas_x, comb_x, qx, rows)
    _check_family("Sh", vals_h, deltas_h, comb_h, qh, rows)
    if qh.dtype != qx.dtype or qh.device != qx.device \
            or qh.shape[0] != qx.shape[0]:
        raise ValueError(f"qx ({qx.dtype}, {tuple(qx.shape)}) and qh "
                         f"({qh.dtype}, {tuple(qh.shape)}) differ in code "
                         "type, card or batch")
    return qx.shape[0], qx.shape[1], qh.shape[1]


def rb_spmv_q8(vals, deltas, comb, q, rows: int):
    """y = dq(S @ q) over the first ``rows`` rows of packed integer codes
    S (≥ rows, K) (int8 or int16, as the activation codes q (B, X));
    comb (≥ rows,) float32 combined dequant scales. Returns (B, rows)
    float32."""
    dev = q.device
    _check_family("S", vals, deltas, comb, q, rows)
    B, X = q.shape
    y = torch.empty((B, rows), dtype=torch.float32, device=dev)
    lib = _build.load("rb_spmv_q8")
    err = lib.brds_rb_spmv_q8(vals.data_ptr(), deltas.data_ptr(),
                              deltas.element_size(), vals.shape[1],
                              comb.data_ptr(), q.data_ptr(), X,
                              vals.element_size(), y.data_ptr(), B, rows,
                              _build.stream(dev))
    _build.check(err, "rb_spmv_q8")
    _build.LAUNCHES["rb_spmv_q8"] += 1
    return y


def rb_dual_parts_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h, comb_h,
                     qh, rows: int):
    """(zx, zh) = (dq(Sx @ qx), dq(Sh @ qh)) over the first ``rows`` rows
    of packed integer codes Sx (≥ rows, Kx), Sh (≥ rows, Kh) (int8 or int16,
    the same for both, as are qx (B, X) and qh (B, H)); comb_* (≥ rows,)
    float32 combined dequant scales. Returns two (B, rows) float32."""
    dev = qx.device
    B, X, H = check_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h,
                       comb_h, qh, rows)
    zx = torch.empty((B, rows), dtype=torch.float32, device=dev)
    zh = torch.empty_like(zx)
    lib = _build.load("rb_spmv_q8")
    err = lib.brds_rb_dual_parts_q8(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], comb_x.data_ptr(), qx.data_ptr(), X,
        vals_h.data_ptr(), deltas_h.data_ptr(), deltas_h.element_size(),
        vals_h.shape[1], comb_h.data_ptr(), qh.data_ptr(), H,
        vals_x.element_size(), zx.data_ptr(), zh.data_ptr(), B, rows,
        _build.stream(dev))
    _build.check(err, "rb_dual_parts_q8")
    _build.LAUNCHES["rb_dual_parts_q8"] += 1
    return zx, zh
