"""CUDA kernels: the quantized row-balanced SpMVs (``csrc/rb_spmv_q8.cu``).

The fixed-point Gate-module MxV: integer weight codes times integer
activation codes, int32 accumulation, one dequant multiply per row by the
combined (row × activation) scale. Both forms run one block an SM on
``plan.q8_plan`` with the fused q8 steps' row routine
(``brds::q8_rows_block``: codes staged in shared memory, or gathered when
too wide, four entries a lane, ``__dp4a`` for int8 codes): the dual form
returns the two families' partial sums (zx, zh) apart, so the adds that
follow happen in PyTorch in the reference's order; the single-family
form (the routine with one family, qx's codes alone staged) serves the
``row_balanced_q8`` format's matvec. The wrappers quantize the
activations before the launch, so a kernel and its plain version read the
same codes and agree bit for bit. Also the launch helpers of the staged q8
kernels (the SpMVs and the fused q8 and delta-q8 steps): plan, arguments
and occupancy. Replaces ``repro/kernels/rb_spmv_q8.py::rb_dual_parts_q8``
and ``::rb_spmv_q8``.
"""
from __future__ import annotations

import torch

from . import _build
from .plan import Q8Plan, q8_plan
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
    S (≥ rows, K) (int8 or int16, as the activation codes q (B, X); codes
    and deltas 16-byte aligned: the kernel loads four entries at once);
    comb (≥ rows,) float32 combined dequant scales. Returns (B, rows)
    float32."""
    _build.refuse_autograd("rb_spmv_q8", vals, deltas, comb, q)
    dev = q.device
    _check_family("S", vals, deltas, comb, q, rows)
    _build.require_aligned(vals, "S codes")
    _build.require_aligned(deltas, "S deltas")
    B, X = q.shape
    plan = single_q8_plan_for(vals, q, rows)
    y = torch.empty((B, rows), dtype=torch.float32, device=dev)
    lib = _build.load("rb_spmv_q8")
    err = lib.brds_rb_spmv_q8(vals.data_ptr(), deltas.data_ptr(),
                              deltas.element_size(), vals.shape[1],
                              comb.data_ptr(), q.data_ptr(), X,
                              vals.element_size(), y.data_ptr(), B, rows,
                              plan.rows, int(plan.staged), plan.shift_x,
                              plan.slot_bits, plan.xpad, plan.smem,
                              _build.stream(dev))
    _build.check(err, "rb_spmv_q8")
    _build.LAUNCHES["rb_spmv_q8"] += 1
    return y


def check_aligned(vals_x, deltas_x, vals_h, deltas_h) -> None:
    """The staged q8 kernels load four codes and four deltas at once: the
    packed arrays must start on 16 bytes."""
    for name, t in (("Sx codes", vals_x), ("Sx deltas", deltas_x),
                    ("Sh codes", vals_h), ("Sh deltas", deltas_h)):
        _build.require_aligned(t, name)


def q8_plan_for(vals_x, vals_h, qx, qh, delta: bool = False,
                R: int | None = None) -> Q8Plan:
    """The launch plan of a staged q8 kernel on qx's card: the fused q8
    (``delta``: delta-q8) step, or, given R, the dual SpMV over R rows."""
    return q8_plan(X=qx.shape[1], H=qh.shape[1], B=qx.shape[0],
                   Kx=vals_x.shape[1], Kh=vals_h.shape[1],
                   code_bytes=qx.element_size(), delta=delta, R=R,
                   sms=_build.sm_count(qx.device))


def single_q8_plan_for(vals, q, R: int) -> Q8Plan:
    """The launch plan of the single-family q8 SpMV over R rows of packed
    codes ``vals`` at the activation codes q (B, X) on q's card."""
    return q8_plan(X=q.shape[1], B=q.shape[0], Kx=vals.shape[1],
                   code_bytes=q.element_size(), R=R,
                   sms=_build.sm_count(q.device))


def q8_args(plan: Q8Plan) -> tuple:
    """The staged layout's launch arguments (after rows or units)."""
    return (int(plan.staged), plan.shift_x, plan.shift_h, plan.slot_bits,
            plan.xpad, plan.hpad, plan.smem)


def q8_info(plan: Q8Plan, B: int, code_bytes: int, device, *,
            fused: bool = True, delta: bool = False) -> dict:
    """``_build.kernel_info`` of the staged q8 instantiation ``plan``
    launches at batch B (every batch tile of its grid): the fused q8
    (``delta``: delta-q8) step, or (not ``fused``) the q8 SpMV of the
    plan's families (the dual SpMV, or the single-family one)."""
    if fused:
        source, entry = "fused_step", "brds_fused_lstm_step_q8_info"
        args = (code_bytes, B, int(plan.staged), int(delta), plan.smem)
    else:
        source, entry = "rb_spmv_q8", "brds_rb_spmv_q8_info"
        args = (plan.families, code_bytes, B, int(plan.staged), plan.smem)
    return _build.kernel_info(source, entry, args, plan.grid * plan.tiles,
                              device)


def rb_dual_parts_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h, comb_h,
                     qh, rows: int):
    """(zx, zh) = (dq(Sx @ qx), dq(Sh @ qh)) over the first ``rows`` rows
    of packed integer codes Sx (≥ rows, Kx), Sh (≥ rows, Kh) (int8 or int16,
    the same for both, as are qx (B, X) and qh (B, H); codes and deltas
    16-byte aligned: the kernel loads four entries at once); comb_*
    (≥ rows,) float32 combined dequant scales. Returns two (B, rows)
    float32."""
    _build.refuse_autograd("rb_dual_parts_q8", vals_x, deltas_x, comb_x, qx,
                           vals_h, deltas_h, comb_h, qh)
    dev = qx.device
    B, X, H = check_q8(vals_x, deltas_x, comb_x, qx, vals_h, deltas_h,
                       comb_h, qh, rows)
    check_aligned(vals_x, deltas_x, vals_h, deltas_h)
    plan = q8_plan_for(vals_x, vals_h, qx, qh, R=rows)
    zx = torch.empty((B, rows), dtype=torch.float32, device=dev)
    zh = torch.empty_like(zx)
    lib = _build.load("rb_spmv_q8")
    err = lib.brds_rb_dual_parts_q8(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(),
        vals_x.shape[1], comb_x.data_ptr(), qx.data_ptr(), X,
        vals_h.data_ptr(), deltas_h.data_ptr(), deltas_h.element_size(),
        vals_h.shape[1], comb_h.data_ptr(), qh.data_ptr(), H,
        vals_x.element_size(), zx.data_ptr(), zh.data_ptr(), B, rows,
        plan.rows, *q8_args(plan), _build.stream(dev))
    _build.check(err, "rb_dual_parts_q8")
    _build.LAUNCHES["rb_dual_parts_q8"] += 1
    return zx, zh
