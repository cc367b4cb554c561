"""CUDA kernels: T BRDS-LSTM layer steps in one persistent launch
(``csrc/fused_scan.cu``), float and temporal-delta.

Both scans are one kernel, launched cooperatively on a co-resident grid
of one block an SM (``plan.scan_plan``): each block owns its hidden units
for all T steps and keeps their c (and the delta scan's partial-sum memory
m and h reference) in shared memory, and only h (the delta scan: its
masked delta) crosses blocks, through one grid barrier a step. A block
decodes the packed columns once, computes the input projection Sx@xs[t]
(the delta scan: Sx@(fx·dx)[t], every step's x thresholds taken up front
in one grid-wide pass) for every t before the recurrence, into a scratch,
and stages xs and h in shared memory; the scratch (``scan_scratch``) is
allocated here. Each step is bitwise equal to one launch of the
single-step kernel of ``fused_step`` (the delta scan: after the
thresholds in PyTorch). A launch takes at most ``TILE`` batch rows (the
co-resident grid cannot grow with the batch): a larger batch runs as one
launch per tile of rows, which ``batch_tiles`` concatenates, bitwise the
whole batch's result since every row's sums are its own. Replaces
``repro/kernels/fused_step.py::fused_brds_lstm_scan`` and
``::fused_brds_delta_lstm_scan``.
"""
from __future__ import annotations

import torch

from . import _build
from .lstm_gates import act_args
from .plan import ScanPlan, scan_plan
from .rb_spmv import check_batch, check_packed

TILE = 16   # batch rows a scan launch takes (brds::kMaxBatch)


def batch_tiles(fn, B: int, args, in_dims, out_dims):
    """``fn(*args)`` over the batch in tiles of at most ``TILE`` rows, one
    call each: every arg is cut at its batch dim (``in_dims``; None for
    one shared by all rows) and the calls' outputs are concatenated at
    ``out_dims``. A batch of at most ``TILE`` rows is one call, uncut."""
    if B <= TILE:
        return fn(*args)
    parts = [fn(*(a if d is None else a.narrow(d, b0, min(TILE, B - b0))
                  .contiguous() for a, d in zip(args, in_dims)))
             for b0 in range(0, B, TILE)]
    return tuple(torch.cat(p, d) for p, d in zip(zip(*parts), out_dims))


def _check_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, c0, bias):
    """xs (T, B, X), h0 and c0 (B, H), bias (4H,): float32 on one card,
    with Sx and Sh packed over at least the 4H gate rows."""
    dev = xs.device
    _build.require(xs, "xs", dtypes=(torch.float32,), ndim=3)
    for name, t in (("h0", h0), ("c0", c0)):
        _build.require(t, name, dtypes=(torch.float32,), ndim=2, device=dev)
    _build.require(bias, "bias", dtypes=(torch.float32,), ndim=1, device=dev)
    check_packed(vals_x, deltas_x, "Sx", dev)
    check_packed(vals_h, deltas_h, "Sh", dev)
    T, B, X = xs.shape
    H = h0.shape[1]
    check_batch(B)
    if (T == 0 or min(vals_x.shape[0], vals_h.shape[0]) < 4 * H
            or bias.shape != (4 * H,) or h0.shape[0] != B
            or c0.shape != h0.shape):
        raise ValueError(f"shape mismatch: Sx {tuple(vals_x.shape)}, Sh "
                         f"{tuple(vals_h.shape)}, bias {tuple(bias.shape)}, "
                         f"xs {tuple(xs.shape)}, h0 {tuple(h0.shape)}, c0 "
                         f"{tuple(c0.shape)}")
    return T, B, X, H


def fused_brds_lstm_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, bias,
                         c0, *, pwl: bool = False):
    """T BRDS-LSTM decode steps of one layer: for each t, (c, h) from
    packed Sx (≥ 4H, Kx) and Sh (≥ 4H, Kh) over the 4H gate rows grouped
    [f; i; g; o] (rows past 4H are not read), xs[t] (B, X), the previous
    h (h0 at t = 0), c and bias (4H,); all float32 on one card. Returns
    (hs (T, B, H), c_T (B, H))."""
    _build.refuse_autograd("fused_brds_lstm_scan", vals_x, deltas_x, xs,
                           vals_h, deltas_h, h0, bias, c0)
    T, B, X, H = _check_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, c0,
                             bias)

    def tile(xs, h0, c0):
        return _scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, bias, c0,
                     pwl)
    return batch_tiles(tile, B, (xs, h0, c0), (1, 0, 0), (1, 0))


def _col_dtype(nbytes: int) -> torch.dtype:
    return torch.int16 if nbytes == 2 else torch.int32


def scan_scratch(plan: ScanPlan, Kx: int, Kh: int, device):
    """The device scratch of one scan launch: the hoisted input projection
    ``ax`` (T, 4H, NB) float32; the decoded columns of Sx (4H, Kx) and Sh
    (4H, Kh), int16 storage of uint16 columns, or int32 where that
    family's activations are not staged; and ``hx``, each step's h (the
    delta scan: its masked delta) in the staged layout for the next step
    (``plan.hx_shape``, float32). Returns (ax, colx, colh, hx); the delta
    scan also takes ``plan.dxm_shape``'s float32 masked x deltas."""
    R = plan.ax_shape[1]
    return (torch.empty(plan.ax_shape, dtype=torch.float32, device=device),
            torch.empty((R, Kx), dtype=_col_dtype(plan.col_bytes[0]),
                        device=device),
            torch.empty((R, Kh), dtype=_col_dtype(plan.col_bytes[1]),
                        device=device),
            torch.empty(plan.hx_shape, dtype=torch.float32, device=device))


def plan_for(vals_x, vals_h, xs, h0, delta: bool = False) -> ScanPlan:
    """The launch plan of a tile of at most TILE rows on xs's card (the
    delta scan's with ``delta``)."""
    T, B, X = xs.shape
    return scan_plan(X=X, H=h0.shape[1], T=T, B=B, Kx=vals_x.shape[1],
                     Kh=vals_h.shape[1], delta=delta,
                     sms=_build.sm_count(xs.device))


def _scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, bias, c0, pwl):
    """One launch of the float scan over at most TILE batch rows."""
    dev = xs.device
    T, B, X = xs.shape
    H = h0.shape[1]
    Kx, Kh = vals_x.shape[1], vals_h.shape[1]
    plan = plan_for(vals_x, vals_h, xs, h0)
    ax, colx, colh, hx = scan_scratch(plan, Kx, Kh, dev)
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(c0)
    lib = _build.load("fused_scan")
    err = lib.brds_fused_lstm_scan(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        xs.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h0.data_ptr(), H, bias.data_ptr(),
        c0.data_ptr(), hs.data_ptr(), c_out.data_ptr(),
        ax.data_ptr(), colx.data_ptr(), colh.data_ptr(), hx.data_ptr(), T,
        B, plan.units,
        int(plan.stage_x), int(plan.stage_h), plan.smem,
        *act_args(pwl, dev), _build.stream(dev))
    _build.check(err, "fused_brds_lstm_scan")
    _build.LAUNCHES["fused_brds_lstm_scan"] += 1
    return hs, c_out


def scan_info(plan: ScanPlan, B: int, device) -> dict:
    """``_build.kernel_info`` of the scan instantiation ``plan`` (float or
    delta) launches at batch B."""
    return _build.kernel_info(
        "fused_scan", "brds_fused_lstm_scan_info",
        (B, int(plan.stage_x), int(plan.stage_h), int(plan.delta),
         plan.smem), plan.grid, device)


def fused_brds_delta_lstm_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0,
                               c0, x_ref0, h_ref0, m0, bias, *,
                               theta_x: float, theta_h: float,
                               pwl: bool = False):
    """T uncapped temporal-delta BRDS-LSTM steps of one layer: for each t,
    the deltas of xs[t] and of the previous h against their references,
    fired where |d| > theta, the references moved to the fired values,
    m' = m + Sx@(fx·dx) + Sh@(fh·dh), z = m' + bias, then the cell. xs
    (T, B, X); h0, c0, h_ref0 (B, H); x_ref0 (B, X); m0 (B, 4H); bias
    (4H,); all float32 on one card. Returns (hs, c_T, x_ref_T, h_ref_T,
    m_T)."""
    _build.refuse_autograd("fused_brds_delta_lstm_scan", vals_x, deltas_x, xs,
                           vals_h, deltas_h, h0, c0, x_ref0, h_ref0, m0, bias)
    dev = xs.device
    T, B, X, H = _check_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, c0,
                             bias)
    for name, t, shape in (("x_ref0", x_ref0, (B, X)),
                           ("h_ref0", h_ref0, (B, H)),
                           ("m0", m0, (B, 4 * H))):
        _build.require(t, name, dtypes=(torch.float32,), ndim=2, device=dev)
        if t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")

    def tile(xs, h0, c0, x_ref0, h_ref0, m0):
        return _delta_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, c0,
                           x_ref0, h_ref0, m0, bias, theta_x, theta_h, pwl)
    return batch_tiles(tile, B, (xs, h0, c0, x_ref0, h_ref0, m0),
                       (1, 0, 0, 0, 0, 0), (1, 0, 0, 0, 0))


def _delta_scan(vals_x, deltas_x, xs, vals_h, deltas_h, h0, c0, x_ref0,
                h_ref0, m0, bias, theta_x, theta_h, pwl):
    """One launch of the delta scan over at most TILE batch rows."""
    dev = xs.device
    T, B, X = xs.shape
    H = h0.shape[1]
    Kx, Kh = vals_x.shape[1], vals_h.shape[1]
    plan = plan_for(vals_x, vals_h, xs, h0, delta=True)
    ax, colx, colh, hx = scan_scratch(plan, Kx, Kh, dev)
    dxm = torch.empty(plan.dxm_shape, dtype=torch.float32, device=dev)
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    c_out, h_ref = torch.empty_like(c0), torch.empty_like(h_ref0)
    m_out, x_ref = torch.empty_like(m0), torch.empty_like(x_ref0)
    lib = _build.load("fused_scan")
    err = lib.brds_fused_delta_lstm_scan(
        vals_x.data_ptr(), deltas_x.data_ptr(), deltas_x.element_size(), Kx,
        xs.data_ptr(), X, vals_h.data_ptr(), deltas_h.data_ptr(),
        deltas_h.element_size(), Kh, h0.data_ptr(), H, bias.data_ptr(),
        c0.data_ptr(), m0.data_ptr(), x_ref0.data_ptr(), h_ref0.data_ptr(),
        hs.data_ptr(), c_out.data_ptr(), m_out.data_ptr(), x_ref.data_ptr(),
        h_ref.data_ptr(), ax.data_ptr(), colx.data_ptr(), colh.data_ptr(),
        hx.data_ptr(), dxm.data_ptr(), float(theta_x), float(theta_h), T, B,
        plan.units, int(plan.stage_x), int(plan.stage_h), plan.smem,
        *act_args(pwl, dev), _build.stream(dev))
    _build.check(err, "fused_brds_delta_lstm_scan")
    _build.LAUNCHES["fused_brds_delta_lstm_scan"] += 1
    return hs, c_out, x_ref, h_ref, m_out
