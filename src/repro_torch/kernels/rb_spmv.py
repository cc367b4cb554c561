"""CUDA kernels: packed row-balanced float SpMV (``csrc/rb_spmv.cu``).

The BRDS accelerator's Gate-module MxV: z = Sx@x + Sh@h + bias, with both
packed families consumed by the warp that owns a row (the Large/Small
mult-array lockstep), and its single-family form y = S@x behind the
format API. Both run one block an SM on ``plan.stream_plan``: the
operands staged in shared memory once a block, each row's sums in
``row_dot``'s order (the fused float step's routine, so the fused step and
the dual SpMV stay bitwise a chain, and the two single-family sums plus
the bias are the dual SpMV's z). Also the launch helpers of the five
staged float kernels (the float and delta steps and dual SpMVs, and the
single-family SpMV, and its delta form B6): plan, arguments and
occupancy. Replaces
``repro/kernels/rb_spmv.py::rb_dual_spmv`` and ``::rb_spmv``.
"""
from __future__ import annotations

import torch

from . import _build
from .plan import StreamPlan, stream_plan

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
    _build.refuse_autograd("rb_spmv", vals, deltas, x)
    dev = x.device
    _build.require(x, "x", dtypes=(torch.float32,), ndim=2)
    check_packed(vals, deltas, "S", dev)
    check_rows(vals, rows, "S")
    B, X = x.shape
    check_batch(B)
    plan = single_plan_for(vals, x, rows)
    y = torch.empty((B, rows), dtype=x.dtype, device=dev)
    lib = _build.load("rb_spmv")
    err = lib.brds_rb_spmv(vals.data_ptr(), deltas.data_ptr(),
                           deltas.element_size(), vals.shape[1],
                           x.data_ptr(), X, y.data_ptr(), B, rows, plan.rows,
                           int(plan.stage_x), plan.shift_x, plan.slot_bits,
                           plan.xpad, plan.smem, _build.stream(dev))
    _build.check(err, "rb_spmv")
    _build.LAUNCHES["rb_spmv"] += 1
    return y


def single_plan_for(vals, x, R: int) -> StreamPlan:
    """The launch plan of a single-family SpMV over R rows of packed
    ``vals`` at x (B, X) on x's card (B6: at the deltas d)."""
    return stream_plan(X=x.shape[1], R=R, B=x.shape[0], Kx=vals.shape[1],
                       sms=_build.sm_count(x.device))


def stream_plan_for(vals_x, vals_h, ax, ah, R: int,
                    fused: bool = False) -> StreamPlan:
    """The launch plan of a staged float kernel over R rows on ax's card:
    a dual SpMV or (``fused``) a fused step, whose operands ax (B, X) and
    ah (B, H) are x and h or the deltas dx and dh."""
    return stream_plan(X=ax.shape[1], H=ah.shape[1], R=R, B=ax.shape[0],
                       Kx=vals_x.shape[1], Kh=vals_h.shape[1], fused=fused,
                       sms=_build.sm_count(ax.device))


def stream_args(plan: StreamPlan) -> tuple:
    """The staged layout's launch arguments (after rows or units)."""
    return (int(plan.stage_x), int(plan.stage_h), plan.shift_x,
            plan.shift_h, plan.slot_bits, plan.xpad, plan.hpad, plan.smem)


# (families, fused, delta) -> the source and info entry of that staged
# kernel
_STREAM_INFO = {
    (1, False, False): ("rb_spmv", "brds_rb_spmv_info"),
    (2, False, False): ("rb_spmv", "brds_rb_dual_spmv_info"),
    (2, True, False): ("fused_step", "brds_fused_lstm_step_info"),
    (1, False, True): ("delta_rb_spmv", "brds_delta_rb_spmv_info"),
    (2, False, True): ("delta_rb_spmv", "brds_delta_rb_dual_spmv_info"),
    (2, True, True): ("fused_step", "brds_fused_delta_lstm_step_info")}


def stream_info(plan: StreamPlan, B: int, device, *, fused: bool = False,
                delta: bool = False) -> dict:
    """``_build.kernel_info`` of the staged float kernel (a dual SpMV, a
    single-family SpMV for a one-family plan, or, ``fused``, a fused step;
    ``delta``: its temporal-delta form) instantiation ``plan`` launches at
    batch B (every batch tile of its grid)."""
    source, entry = _STREAM_INFO[plan.families, fused, delta]
    return _build.kernel_info(source, entry, (B, plan.smem),
                              plan.grid * plan.tiles, device)


def rb_dual_spmv(vals_x, deltas_x, x, vals_h, deltas_h, h, bias):
    """z = Sx @ x + Sh @ h + bias over the first R = len(bias) rows of
    packed Sx (≥ R, Kx) and Sh (≥ R, Kh); rows past R (``pad_packed``'s
    zero rows) are not read.

    x (B, X), h (B, H), bias (R,), all float32 on one card. Returns (B, R)
    float32.
    """
    _build.refuse_autograd("rb_dual_spmv", vals_x, deltas_x, x, vals_h,
                           deltas_h, h, bias)
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
    plan = stream_plan_for(vals_x, vals_h, x, h, R)
    z = torch.empty((B, R), dtype=x.dtype, device=dev)
    lib = _build.load("rb_spmv")
    err = lib.brds_rb_dual_spmv(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        x.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h.data_ptr(), H, bias.data_ptr(),
        z.data_ptr(), B, R, plan.rows, *stream_args(plan),
        _build.stream(dev))
    _build.check(err, "rb_dual_spmv")
    _build.LAUNCHES["rb_dual_spmv"] += 1
    return z
