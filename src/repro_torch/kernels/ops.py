"""Public wrappers around the kernels, with backend selection.

The backend (``repro_torch.sparse.backend``) resolves per call: "cuda"
launches the hand-written kernel, "ref" runs the plain PyTorch version, and
"auto" picks by where the operands lie. A CUDA tensor never falls back to
the plain version. The wrappers the reference gives ``use_kernel=``
(``rb_spmv``, ``rb_dual_spmv``, ``lstm_gates``, ``flash_attention``,
``decode_attention``) take it too, deprecated (``sparse.backend.
from_use_kernel``: True → "auto", False → "ref"), and refuse the
reference's Pallas tiling knobs by name: the port's launch plans are
``kernels/plan.py``'s.

A struct pre-padded by ``core.packing.pad_packed`` is consumed as it is
(no per-call copy of the weight stream), as is an unpadded one: the kernels
read only the logical rows, so only logical rows come out, and the bias
and the partial-sum memory are fitted to them as the reference's ``_fit``
does.

The attention wrappers take q, k and v through strides, so the model
hands over views of its (B, S, H, D) tensors and KV cache, copying
nothing.

The temporal-delta wrappers take the raw deltas and their fired masks from
``sparse.temporal.delta_threshold``; the quantized wrappers quantize the
activations here (``_quant_act``), so a kernel and its plain version read
the same masks and codes.

On fake card tensors (a ``FakeTensorMode`` trace: ``launch.dryrun``) an
entry point launches nothing and builds nothing: its fake makes the
kernel's outputs (and a scan's scratch) as the kernel's wrapper makes
them, so the trace sees what the kernel allocates, and adds the kernel's
work to ``KERNEL_FLOPS``, counted as ``chip_smoke.py``'s bound column
counts it (float32 flops, int8 ops, bf16 flops for attention on bf16
operands). An attention fake counts every key of the cache (its lengths
are data the trace does not see). ``KERNEL_FLOPS`` is apart from
``FlopCounterMode``'s aten count, which never sees a kernel.
"""
from __future__ import annotations

import contextlib

import torch

from . import ref as _ref
from ._build import LAUNCHES
from .decode_attention import decode_attention as _decode_attn_kernel
from .delta_rb_spmv import (delta_rb_dual_spmv as _delta_dual_kernel,
                            delta_rb_spmv as _delta_kernel)
from .fused_step import (
    fused_brds_delta_lstm_step as _fused_delta_kernel,
    fused_brds_delta_lstm_step_q8 as _fused_delta_q8_kernel,
    fused_brds_lstm_step as _fused_kernel,
    fused_brds_lstm_step_q8 as _fused_q8_kernel)
from .fused_scan import (
    fused_brds_delta_lstm_scan as _delta_scan_kernel,
    fused_brds_lstm_scan as _scan_kernel)
from .flash_attention import flash_attention as _flash_attn_kernel
from .lstm_gates import lstm_gates as _lstm_gates_kernel
from .rb_spmv import rb_dual_spmv as _rb_dual_kernel, rb_spmv as _rb_kernel
from .rb_spmv_q8 import (rb_dual_parts_q8 as _rb_dual_parts_q8_kernel,
                         rb_spmv_q8 as _rb_q8_kernel)
from .fused_scan import TILE as _SCAN_TILE, scan_scratch
from .plan import scan_plan as _scan_plan
from ..core.packing import RowBalancedSparse
from ..quant.scheme import f32_scalar, quantize
from ..sparse import backend as _backend
from ..sparse.temporal import delta_threshold

__all__ = ["LAUNCHES", "KERNEL_FLOPS", "reset_kernel_flops", "fakes_as_card",
           "live_pairs", "rb_spmv", "rb_dual_spmv", "lstm_gates",
           "brds_lstm_step", "fused_brds_lstm_step", "delta_rb_spmv",
           "delta_rb_dual_spmv", "brds_delta_lstm_step",
           "fused_brds_delta_lstm_step", "rb_spmv_q8", "rb_dual_spmv_q8",
           "delta_rb_dual_spmv_q8", "brds_lstm_step_q8",
           "brds_delta_lstm_step_q8", "fused_brds_lstm_step_q8",
           "fused_brds_delta_lstm_step_q8", "fused_brds_lstm_scan",
           "fused_brds_delta_lstm_scan", "flash_attention",
           "decode_attention"]


# ------------------------------------------------------------ kernel fakes
# {kernel: {"calls", "fp32", "int8", "bf16"}}: the fakes' work since the
# last reset_kernel_flops()
KERNEL_FLOPS: dict[str, dict] = {}


def reset_kernel_flops() -> None:
    KERNEL_FLOPS.clear()


_AS_CARD = [False]


@contextlib.contextmanager
def fakes_as_card():
    """Inside: fake CPU tensors stand for card tensors, so the entry
    points take their kernels' fakes on them (a dry run traced on fake
    CPU tensors, where torch is built without CUDA and autograd cannot
    run on fake card tensors)."""
    prev, _AS_CARD[0] = _AS_CARD[0], True
    try:
        yield
    finally:
        _AS_CARD[0] = prev


def _pick(backend, use_kernel, t, **tiling) -> str:
    """``_resolve`` for the wrappers that take the reference's deprecated
    ``use_kernel=`` (``sparse.backend.from_use_kernel``); its tiling knobs
    (``block_rows=``, ``block_q=``, ``block_kv=``) are refused by name."""
    for name, value in tiling.items():
        if value is not None:
            raise TypeError(
                f"{name}= is the reference's Pallas tiling; the port's "
                "kernels take their launch plans from kernels/plan.py")
    if use_kernel is not None:
        backend = _backend.from_use_kernel(use_kernel, stacklevel=4)
    return _resolve(backend, t)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _resolve(backend, t) -> str:
    """``sparse.backend.resolve``, but a fake tensor under
    ``fakes_as_card`` resolves as a card tensor does."""
    if (_AS_CARD[0] and _is_fake(t)
            and (backend or _backend.get_default_backend()) != "ref"):
        return "cuda"
    return _backend.resolve(backend, t)


def _faked(name: str, outs, fp32: int = 0, int8: int = 0, bf16: int = 0):
    """Record one fake launch of ``name`` and return its outputs."""
    acc = KERNEL_FLOPS.setdefault(name, dict(calls=0, fp32=0, int8=0,
                                             bf16=0))
    acc["calls"] += 1
    acc["fp32"] += int(fp32)
    acc["int8"] += int(int8)
    acc["bf16"] += int(bf16)
    return outs


def _dual_work(sx, sh, B: int) -> int:
    """2·B·(Rx·Kx + Rh·Kh): the products of both packed families."""
    return 2 * B * (sx.rows * sx.K + sh.rows * sh.K)


def _rows_out(B: int, R: int, dtype, like):
    return torch.empty((B, R), dtype=dtype, device=like.device)


def _attn_flops(dtype, n: int) -> dict:
    """Attention's flops under the rate of its operands: the tensor cores'
    for 16-bit ones, float32 otherwise."""
    return ({"bf16": n} if dtype in (torch.bfloat16, torch.float16)
            else {"fp32": n})


def _fake_scan_scratch(sx, sh, xs, h0, delta: bool):
    """A scan launch's device scratch, as its wrapper makes it for one
    batch tile (the tiles run one after the other), planned for the card
    ``hw`` describes."""
    from .. import hw
    T, B, X = xs.shape
    plan = _scan_plan(X=X, H=h0.shape[1], T=T, B=min(B, _SCAN_TILE),
                      Kx=sx.K, Kh=sh.K, delta=delta, sms=hw.SMS)
    out = scan_scratch(plan, sx.K, sh.K, xs.device)
    if delta:
        out += (torch.empty(plan.dxm_shape, dtype=torch.float32,
                            device=xs.device),)
    return out


def live_pairs(Sq: int, Sk: int, causal: bool = True,
               window: int | None = None) -> int:
    """Live (q, k) pairs of one head: q row i (right-aligned, at position
    Sk - Sq + i) sees keys 0..its position under the causal mask, and
    only the last ``window`` of them with a window; every key without a
    mask."""
    if not causal:
        return Sq * (min(Sk, window) if window else Sk)
    W = min(window or Sk, Sk)
    a, b = max(Sk - Sq, 0), Sk - 1          # the rows' positions
    ramp_hi = min(b, W - 1)                 # positions seeing p + 1 keys
    ramp = ((a + 1 + ramp_hi + 1) * (ramp_hi - a + 1) // 2
            if ramp_hi >= a else 0)
    flat = (b - max(a, W) + 1) * W if b >= max(a, W) else 0
    return ramp + flat


def _fit(vec, n):
    """Pad (with zeros) or slice ``vec``'s last axis to length ``n``."""
    have = vec.shape[-1]
    if have == n:
        return vec
    if have > n:
        return vec[..., :n]
    return torch.nn.functional.pad(vec, (0, n - have))


def _check_cols(s, x):
    """The kernels gather x by column without bounds checks."""
    if s.ncols != x.shape[-1]:
        raise ValueError(f"packed ncols {s.ncols} does not match "
                         f"{tuple(x.shape)}")


def _check_dual(sx, x, sh, h):
    """Both families' columns, over the rows the two share."""
    _check_cols(sx, x)
    _check_cols(sh, h)
    if sx.rows != sh.rows:
        raise ValueError(f"Sx has {sx.rows} rows, Sh {sh.rows}")


def _gates(z, c_prev, pwl, backend):
    """The cell on z (B, 4H) grouped [f; i; g; o]."""
    H = z.shape[-1] // 4
    return lstm_gates(z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                      z[:, 3 * H:], c_prev, pwl=pwl, backend=backend)


def _cell_ref(z, c_prev, pwl):
    H = z.shape[-1] // 4
    return _ref.lstm_cell_ref(z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                              z[:, 3 * H:], c_prev, pwl=pwl)


def _plus_bias(v, bias):
    """v + bias over v's rows, in float32: the chained steps' bias add."""
    return v.float() + bias[:v.shape[-1]].float()[None, :]


# ---------------------------------------------------------------- float

def rb_spmv(s: RowBalancedSparse, x, *, backend: str | None = None,
            use_kernel: bool | None = None, block_rows: int | None = None):
    """y = S@x — the packed row-balanced SpMV; x (B, ncols) → (B, rows)
    in x.dtype. ``use_kernel=`` / ``block_rows=``: see ``_pick``."""
    if _pick(backend, use_kernel, x, block_rows=block_rows) == "ref":
        return _ref.rb_spmv_ref(s, x)
    _check_cols(s, x)
    if _is_fake(x):
        return _faked("rb_spmv", _rows_out(x.shape[0], s.rows, x.dtype, x),
                      fp32=2 * x.shape[0] * s.rows * s.K)
    return _rb_kernel(s.values, s.deltas, x, s.rows)


def rb_dual_spmv(sx: RowBalancedSparse, x, sh: RowBalancedSparse, h, bias,
                 *, backend: str | None = None,
                 use_kernel: bool | None = None,
                 block_rows: int | None = None):
    """z = Sx@x + Sh@h + bias — the dual-ratio gate preactivation,
    (B, rows) in x.dtype."""
    if _pick(backend, use_kernel, x, block_rows=block_rows) == "ref":
        return _ref.rb_dual_spmv_ref(sx, x, sh, h, bias)
    _check_dual(sx, x, sh, h)
    if _is_fake(x):
        return _faked("rb_dual_spmv",
                      _rows_out(x.shape[0], sx.rows, x.dtype, x),
                      fp32=_dual_work(sx, sh, x.shape[0]))
    return _rb_dual_kernel(sx.values, sx.deltas, x, sh.values, sh.deltas, h,
                           _fit(bias, sx.rows))


def lstm_gates(zf, zi, zg, zo, c_prev, *, pwl: bool = False,
               backend: str | None = None, use_kernel: bool | None = None):
    """(c, h) from the four gate preactivations and c_prev."""
    if _pick(backend, use_kernel, c_prev) == "ref":
        return _ref.lstm_cell_ref(zf, zi, zg, zo, c_prev, pwl=pwl)
    if _is_fake(c_prev):
        return _faked("lstm_gates", (torch.empty_like(c_prev),
                                     torch.empty_like(c_prev)),
                      fp32=30 * c_prev.numel())
    return _lstm_gates_kernel(zf, zi, zg, zo, c_prev, pwl=pwl)


def brds_lstm_step(sx: RowBalancedSparse, x, sh: RowBalancedSparse, h_prev,
                   bias, c_prev, *, pwl: bool = False,
                   backend: str | None = None):
    """One BRDS-LSTM step, chained: the dual-ratio SpMV (Gate module), z
    through device memory, then the cell (Function module). x (B, X),
    h/c (B, H), sx/sh packed over the 4H gate rows. Returns (c, h)."""
    z = rb_dual_spmv(sx, x, sh, h_prev, bias, backend=backend)
    return _gates(z, c_prev, pwl, backend)


def fused_brds_lstm_step(sx: RowBalancedSparse, x, sh: RowBalancedSparse,
                         h_prev, bias, c_prev, *, pwl: bool = False,
                         backend: str | None = None):
    """``brds_lstm_step`` in one kernel launch, bitwise equal to the
    chained form. Returns (c, h)."""
    if _resolve(backend, x) == "ref":
        return _cell_ref(_ref.rb_dual_spmv_ref(sx, x, sh, h_prev, bias),
                         c_prev, pwl)
    _check_dual(sx, x, sh, h_prev)
    if _is_fake(x):
        return _faked("fused_brds_lstm_step", (torch.empty_like(c_prev),
                                               torch.empty_like(c_prev)),
                      fp32=_dual_work(sx, sh, x.shape[0])
                      + 30 * c_prev.numel())
    return _fused_kernel(sx.values, sx.deltas, x, sh.values, sh.deltas,
                         h_prev, _fit(bias, sx.rows), c_prev, pwl=pwl)


# ---------------------------------------------------------- temporal delta

def delta_rb_spmv(s: RowBalancedSparse, d, fired, *,
                  backend: str | None = None):
    """y = S@(fired·d) — the temporal-delta SpMV: ``d`` (B, ncols) raw
    activation deltas, ``fired`` their bool or 0/1 threshold mask; an
    unfired column contributes an exact 0. Returns (B, rows) in d.dtype."""
    fired = fired.float()
    if _resolve(backend, d) == "ref":
        return _ref.delta_rb_spmv_ref(s, d, fired)
    _check_cols(s, d)
    if _is_fake(d):
        return _faked("delta_rb_spmv",
                      _rows_out(d.shape[0], s.rows, d.dtype, d),
                      fp32=2 * d.shape[0] * s.rows * s.K)
    return _delta_kernel(s.values, s.deltas, d, fired, s.rows)


def delta_rb_dual_spmv(sx: RowBalancedSparse, dx, fx, sh: RowBalancedSparse,
                       dh, fh, m, *, backend: str | None = None):
    """m' = m + Sx@(fx·dx) + Sh@(fh·dh) — the temporal-delta gate
    accumulation (partial-sum memory update). fx, fh: bool or 0/1 fired
    masks."""
    fx, fh = fx.float(), fh.float()
    if _resolve(backend, dx) == "ref":
        return _ref.delta_rb_dual_spmv_ref(sx, dx, fx, sh, dh, fh, m)
    _check_dual(sx, dx, sh, dh)
    if _is_fake(dx):
        B = dx.shape[0]
        return _faked("delta_rb_dual_spmv",
                      torch.empty_like(_fit(m, sx.rows)),
                      fp32=_dual_work(sx, sh, B) + 2 * B * sx.rows)
    return _delta_dual_kernel(sx.values, sx.deltas, dx, fx, sh.values,
                              sh.deltas, dh, fh, _fit(m, sx.rows))


def brds_delta_lstm_step(sx: RowBalancedSparse, dx, fx,
                         sh: RowBalancedSparse, dh, fh, m_prev, bias, c_prev,
                         *, pwl: bool = False, backend: str | None = None):
    """One temporally-sparse BRDS-LSTM step, chained: the delta dual-SpMV
    advances the partial-sum memory m with the fired columns' products, the
    bias is added on top, and the cell closes. Returns (c, h, m)."""
    m = delta_rb_dual_spmv(sx, dx, fx, sh, dh, fh, m_prev, backend=backend)
    c, h = _gates(_plus_bias(m, bias), c_prev, pwl, backend)
    return c, h, m


def fused_brds_delta_lstm_step(sx: RowBalancedSparse, dx, fx,
                               sh: RowBalancedSparse, dh, fh, m_prev, bias,
                               c_prev, *, pwl: bool = False,
                               backend: str | None = None):
    """``brds_delta_lstm_step`` in one launch, bitwise equal to the
    chained form. Returns (c, h, m)."""
    fx, fh = fx.float(), fh.float()
    if _resolve(backend, dx) == "ref":
        m = _ref.delta_rb_dual_spmv_ref(sx, dx, fx, sh, dh, fh, m_prev)
        c, h = _cell_ref(_plus_bias(m, bias), c_prev, pwl)
        return c, h, m
    _check_dual(sx, dx, sh, dh)
    if _is_fake(dx):
        B = dx.shape[0]
        return _faked("fused_brds_delta_lstm_step",
                      (torch.empty_like(c_prev), torch.empty_like(c_prev),
                       torch.empty_like(_fit(m_prev, sx.rows))),
                      fp32=_dual_work(sx, sh, B) + 2 * B * sx.rows
                      + 30 * c_prev.numel())
    return _fused_delta_kernel(sx.values, sx.deltas, dx, fx, sh.values,
                               sh.deltas, dh, fh, _fit(m_prev, sx.rows),
                               _fit(bias, sx.rows), c_prev, pwl=pwl)


# --------------------------------------------------------------- quantized

def _quant_act(x, packed, act_scale):
    """→ (codes, scale): quantize one activation batch for a q8 matvec.

    ``act_scale`` None → the packing's scheme decides: fixed point uses
    its constant 2^-N; scaled schemes take the dynamic max-abs of ``x``,
    reduced on the device (no host sync)."""
    scheme = packed.scheme
    sa = scheme.act_scale(act_scale)
    if sa is None:
        amax = x.float().abs().amax()
        sa = torch.clamp_min(amax / f32_scalar(scheme.qmax, amax), 1e-12)
    return quantize(x, sa, scheme), sa


def rb_spmv_q8(s, x, *, act_scale=None, backend: str | None = None):
    """y = dq(S@q(x)) — the quantized packed SpMV: ``s`` a
    RowBalancedSparseQ8, x (B, ncols) float activations, quantized here
    (so the kernel and its plain version read the same codes), integer
    products accumulated in int32, one dequant multiply per row. Returns
    (B, rows) float32."""
    qx, sa = _quant_act(x, s, act_scale)
    if _resolve(backend, x) == "ref":
        return _ref.rb_spmv_q8_ref(s, qx, sa)
    _check_cols(s, qx)
    if _is_fake(qx):
        B = qx.shape[0]
        return _faked("rb_spmv_q8", _rows_out(B, s.rows, torch.float32, qx),
                      fp32=B * s.rows, int8=2 * B * s.rows * s.K)
    return _rb_q8_kernel(s.values, s.deltas, s.scales * sa, qx, s.rows)


def _dual_parts_q8(sx, qx, sax, sh, qh, sah):
    """(zx, zh): the two families' dequantized partial sums, (B, rows)
    float32, from the q8 kernel."""
    _check_dual(sx, qx, sh, qh)
    if _is_fake(qx):
        B = qx.shape[0]
        return _faked("rb_dual_parts_q8",
                      (_rows_out(B, sx.rows, torch.float32, qx),
                       _rows_out(B, sx.rows, torch.float32, qx)),
                      fp32=2 * B * sx.rows, int8=_dual_work(sx, sh, B))
    return _rb_dual_parts_q8_kernel(sx.values, sx.deltas, sx.scales * sax,
                                    qx, sh.values, sh.deltas,
                                    sh.scales * sah, qh, sx.rows)


def rb_dual_spmv_q8(sx, x, sh, h, bias, *, act_scale_x=None,
                    act_scale_h=None, backend: str | None = None):
    """z = dq(Sx@qx) + dq(Sh@qh) + bias — the quantized dual-ratio gate
    preactivation, each family dequantized by its own row × activation
    scales. Returns (B, rows) float32."""
    qx, sax = _quant_act(x, sx, act_scale_x)
    qh, sah = _quant_act(h, sh, act_scale_h)
    if _resolve(backend, x) == "ref":
        return _ref.rb_dual_spmv_q8_ref(sx, qx, sax, sh, qh, sah, bias)
    zx, zh = _dual_parts_q8(sx, qx, sax, sh, qh, sah)
    return _plus_bias(zx + zh, bias)


def _masked_codes(dx, fx, sx, act_scale_x, dh, fh, sh, act_scale_h):
    """(qdx, sax, qdh, sah): codes and scales of the masked deltas, so
    unfired columns carry exact 0 codes."""
    qdx, sax = _quant_act(torch.where(fx.bool(), dx, 0).to(dx.dtype), sx,
                          act_scale_x)
    qdh, sah = _quant_act(torch.where(fh.bool(), dh, 0).to(dh.dtype), sh,
                          act_scale_h)
    return qdx, sax, qdh, sah


def delta_rb_dual_spmv_q8(sx, dx, fx, sh, dh, fh, m, *, act_scale_x=None,
                          act_scale_h=None, backend: str | None = None):
    """m' = m + dq(Sx@q(fx·dx)) + dq(Sh@q(fh·dh)) — the quantized temporal
    gate accumulation; m stays the float32 partial-sum memory. Returns
    (B, rows) float32."""
    qdx, sax, qdh, sah = _masked_codes(dx, fx, sx, act_scale_x, dh, fh, sh,
                                       act_scale_h)
    if _resolve(backend, dx) == "ref":
        return _ref.delta_rb_dual_spmv_q8_ref(sx, qdx, sax, sh, qdh, sah, m)
    zx, zh = _dual_parts_q8(sx, qdx, sax, sh, qdh, sah)
    return m.float() + zx + zh


def brds_lstm_step_q8(sx, x, sh, h_prev, bias, c_prev, *, act_scale_x=None,
                      act_scale_h=None, pwl: bool = False,
                      backend: str | None = None):
    """One quantized BRDS-LSTM step, chained: the q8 dual-ratio SpMV (int32
    accumulate + per-row dequant), then the cell. Returns (c, h)."""
    z = rb_dual_spmv_q8(sx, x, sh, h_prev, bias, act_scale_x=act_scale_x,
                        act_scale_h=act_scale_h, backend=backend)
    return _gates(z, c_prev, pwl, backend)


def brds_delta_lstm_step_q8(sx, dx, fx, sh, dh, fh, m_prev, bias, c_prev,
                            *, act_scale_x=None, act_scale_h=None,
                            pwl: bool = False, backend: str | None = None):
    """One quantized temporally-sparse step, chained: the fired columns'
    quantized products advance the float32 partial-sum memory, the bias
    is added on top, the cell closes. Returns (c, h, m)."""
    m = delta_rb_dual_spmv_q8(sx, dx, fx, sh, dh, fh, m_prev,
                              act_scale_x=act_scale_x,
                              act_scale_h=act_scale_h, backend=backend)
    c, h = _gates(_plus_bias(m, bias), c_prev, pwl, backend)
    return c, h, m


def fused_brds_lstm_step_q8(sx, x, sh, h_prev, bias, c_prev, *,
                            act_scale_x=None, act_scale_h=None,
                            pwl: bool = False, backend: str | None = None):
    """``brds_lstm_step_q8`` in one launch, bitwise equal to the chained
    form. Returns (c, h)."""
    qx, sax = _quant_act(x, sx, act_scale_x)
    qh, sah = _quant_act(h_prev, sh, act_scale_h)
    if _resolve(backend, x) == "ref":
        z = _ref.rb_dual_spmv_q8_ref(sx, qx, sax, sh, qh, sah, bias)
        return _cell_ref(z, c_prev, pwl)
    _check_dual(sx, qx, sh, qh)
    if _is_fake(qx):
        B = qx.shape[0]
        return _faked("fused_brds_lstm_step_q8",
                      (torch.empty_like(c_prev), torch.empty_like(c_prev)),
                      fp32=4 * B * sx.rows + 30 * c_prev.numel(),
                      int8=_dual_work(sx, sh, B))
    return _fused_q8_kernel(sx.values, sx.deltas, sx.scales * sax, qx,
                            sh.values, sh.deltas, sh.scales * sah, qh,
                            _fit(bias, sx.rows), c_prev, pwl=pwl)


def fused_brds_delta_lstm_step_q8(sx, dx, fx, sh, dh, fh, m_prev, bias,
                                  c_prev, *, act_scale_x=None,
                                  act_scale_h=None, pwl: bool = False,
                                  backend: str | None = None):
    """``brds_delta_lstm_step_q8`` in one launch, bitwise equal to the
    chained form: the codes of the masked deltas (``_masked_codes``) and
    the combined scales are made here, so the kernel and the plain version
    read the same ones. Returns (c, h, m)."""
    qdx, sax, qdh, sah = _masked_codes(dx, fx, sx, act_scale_x, dh, fh, sh,
                                       act_scale_h)
    if _resolve(backend, dx) == "ref":
        m = _ref.delta_rb_dual_spmv_q8_ref(sx, qdx, sax, sh, qdh, sah,
                                           m_prev)
        c, h = _cell_ref(_plus_bias(m, bias), c_prev, pwl)
        return c, h, m
    _check_dual(sx, qdx, sh, qdh)
    if _is_fake(qdx):
        B = qdx.shape[0]
        return _faked("fused_brds_delta_lstm_step_q8",
                      (torch.empty_like(c_prev), torch.empty_like(c_prev),
                       torch.empty_like(_fit(m_prev, sx.rows))),
                      fp32=5 * B * sx.rows + 30 * c_prev.numel(),
                      int8=_dual_work(sx, sh, B))
    return _fused_delta_q8_kernel(sx.values, sx.deltas, sx.scales * sax,
                                  qdx, sh.values, sh.deltas,
                                  sh.scales * sah, qdh,
                                  _fit(m_prev, sx.rows), _fit(bias, sx.rows),
                                  c_prev, pwl=pwl)


# -------------------------------------------------------- multi-token scan

def fused_brds_lstm_scan(sx: RowBalancedSparse, xs, sh: RowBalancedSparse,
                         h0, bias, c0, *, pwl: bool = False,
                         backend: str | None = None):
    """T decode steps of one layer in one launch: c stays with the block
    that owns its hidden units, h crosses blocks through ``hs`` and one
    grid barrier per step. Bitwise equal to T ``fused_brds_lstm_step``s.

    xs (T, B, X); h0/c0 (B, H). Returns (hs (T, B, H), c_T)."""
    if _resolve(backend, xs) == "ref":
        c, h, hs = c0, h0, []
        for x in xs:
            c, h = _cell_ref(_ref.rb_dual_spmv_ref(sx, x, sh, h, bias), c,
                             pwl)
            hs.append(h)
        return torch.stack(hs), c
    _check_dual(sx, xs, sh, h0)
    if _is_fake(xs):
        T, B = xs.shape[0], xs.shape[1]
        _fake_scan_scratch(sx, sh, xs, h0, False)
        return _faked("fused_brds_lstm_scan",
                      (torch.empty((T, B, h0.shape[1]), dtype=torch.float32,
                                   device=xs.device),
                       torch.empty_like(c0)),
                      fp32=T * (_dual_work(sx, sh, B) + 30 * c0.numel()))
    return _scan_kernel(sx.values, sx.deltas, xs, sh.values, sh.deltas, h0,
                        _fit(bias, sx.rows), c0, pwl=pwl)


def fused_brds_delta_lstm_scan(sx: RowBalancedSparse, xs,
                               sh: RowBalancedSparse, h0, c0, x_ref0,
                               h_ref0, m0, bias, *, theta_x: float,
                               theta_h: float, pwl: bool = False,
                               backend: str | None = None):
    """T temporally-sparse decode steps of one layer in one launch: the
    thresholds, reference tracking, partial-sum memory and cell all
    advance inside it. Bitwise equal to T × (``delta_threshold`` on x and
    on h → ``fused_brds_delta_lstm_step``). Uncapped thresholds only: an
    occupancy cap (a per-row top-k) stays on per-step launches.

    xs (T, B, X); x_ref0/h_ref0 reference states; m0 (B, 4H) float32
    partial sums. Returns (hs, c_T, x_ref_T, h_ref_T, m_T)."""
    if _resolve(backend, xs) == "ref":
        c, h, xr, hr, m = c0, h0, x_ref0, h_ref0, m0
        hs = []
        for x in xs:
            dx, fx, xr = delta_threshold(x, xr, theta_x)
            dh, fh, hr = delta_threshold(h, hr, theta_h)
            m = _ref.delta_rb_dual_spmv_ref(sx, dx, fx.float(), sh, dh,
                                            fh.float(), m)
            c, h = _cell_ref(_plus_bias(m, bias), c, pwl)
            hs.append(h)
        return torch.stack(hs), c, xr, hr, m
    _check_dual(sx, xs, sh, h0)
    if _is_fake(xs):
        T, B, X = xs.shape
        H = h0.shape[1]
        _fake_scan_scratch(sx, sh, xs, h0, True)
        return _faked("fused_brds_delta_lstm_scan",
                      (torch.empty((T, B, H), dtype=torch.float32,
                                   device=xs.device),
                       torch.empty_like(c0), torch.empty_like(x_ref0),
                       torch.empty_like(h_ref0),
                       torch.empty_like(_fit(m0, sx.rows))),
                      fp32=T * (_dual_work(sx, sh, B) + 30 * c0.numel()
                                + 2 * B * sx.rows + 6 * B * (X + H)))
    return _delta_scan_kernel(sx.values, sx.deltas, xs, sh.values, sh.deltas,
                              h0, c0, x_ref0, h_ref0, _fit(m0, sx.rows),
                              _fit(bias, sx.rows), theta_x=theta_x,
                              theta_h=theta_h, pwl=pwl)


# --------------------------------------------------------------- attention

def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, backend: str | None = None,
                    use_kernel: bool | None = None,
                    block_q: int | None = None, block_kv: int | None = None):
    """Blocked causal / windowed GQA attention forward (B15). q (B, Hq, Sq,
    D), k/v (B, Hkv, Sk, D); q rows right-aligned to the kv end; a row with
    no live key gives 0. Returns (B, Hq, Sq, D) in q.dtype."""
    _check_window(window)
    if _pick(backend, use_kernel, q, block_q=block_q,
             block_kv=block_kv) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if _is_fake(q):
        B, Hq, Sq, D = q.shape
        o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
        return _faked("flash_attention", o.transpose(1, 2),
                      **_attn_flops(q.dtype, 4 * D * B * Hq * live_pairs(
                          Sq, k.shape[2], causal, window)))
    return _flash_attn_kernel(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths, *, window: int | None = None,
                     lse: torch.Tensor | None = None,
                     start: torch.Tensor | None = None,
                     backend: str | None = None,
                     use_kernel: bool | None = None,
                     block_kv: int | None = None):
    """Single-query GQA attention over a KV cache (B14). q (B, Hq, D), k/v
    (B, Hkv, S, D), lengths (B,) valid rows (the last ``window`` of them
    with a window); a row with length 0 gives 0. Returns (B, Hq, D) in
    q.dtype. ``lse``: a (B, Hq) float32 tensor on q's device that takes
    each row's log-sum-exp (-inf for a row with no live key), for a
    split-KV combine. ``start``: a (B,) int tensor, each row's first live
    key (a split-KV rank's first key of the window in its segment); a row
    whose start is at or past its length has no live key."""
    _check_window(window)
    if lse is not None and (lse.dtype != torch.float32
                            or tuple(lse.shape) != tuple(q.shape[:2])
                            or not lse.is_contiguous()):
        raise ValueError(f"lse: a contiguous float32 {tuple(q.shape[:2])} "
                         f"tensor, got {lse.dtype} {tuple(lse.shape)}")
    if _pick(backend, use_kernel, q, block_kv=block_kv) == "ref":
        return _ref.decode_attention_window_ref(q, k, v, lengths,
                                                window=window, lse=lse,
                                                start=start)
    if _is_fake(q):
        B, Hq, D = q.shape
        keys = min(k.shape[2], window or k.shape[2])
        return _faked("decode_attention",
                      torch.empty((B, Hq, D), dtype=q.dtype, device=q.device),
                      **_attn_flops(q.dtype, 4 * B * Hq * keys * D))
    if start is not None:
        start = start.to(torch.int32).contiguous()
    return _decode_attn_kernel(q, k, v, lengths.to(torch.int32),
                               window=window, lse=lse, start=start)
