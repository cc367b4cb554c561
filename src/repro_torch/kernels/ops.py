"""Public wrappers around the kernels, with backend selection.

The backend (``repro_torch.sparse.backend``) resolves per call: "cuda"
launches the hand-written kernel, "ref" runs the plain PyTorch version, and
"auto" picks by where the operands lie. A CUDA tensor never falls back to
the plain version.

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
"""
from __future__ import annotations

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
from ..core.packing import RowBalancedSparse
from ..quant.scheme import f32_scalar, quantize
from ..sparse import backend as _backend
from ..sparse.temporal import delta_threshold

__all__ = ["LAUNCHES", "rb_spmv", "rb_dual_spmv", "lstm_gates",
           "brds_lstm_step", "fused_brds_lstm_step", "delta_rb_spmv",
           "delta_rb_dual_spmv", "brds_delta_lstm_step",
           "fused_brds_delta_lstm_step", "rb_spmv_q8", "rb_dual_spmv_q8",
           "delta_rb_dual_spmv_q8", "brds_lstm_step_q8",
           "brds_delta_lstm_step_q8", "fused_brds_lstm_step_q8",
           "fused_brds_delta_lstm_step_q8", "fused_brds_lstm_scan",
           "fused_brds_delta_lstm_scan", "flash_attention",
           "decode_attention"]


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

def rb_spmv(s: RowBalancedSparse, x, *, backend: str | None = None):
    """y = S@x — the packed row-balanced SpMV; x (B, ncols) → (B, rows)
    in x.dtype."""
    if _backend.resolve(backend, x) == "ref":
        return _ref.rb_spmv_ref(s, x)
    _check_cols(s, x)
    return _rb_kernel(s.values, s.deltas, x, s.rows)


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
    return _gates(z, c_prev, pwl, backend)


def fused_brds_lstm_step(sx: RowBalancedSparse, x, sh: RowBalancedSparse,
                         h_prev, bias, c_prev, *, pwl: bool = False,
                         backend: str | None = None):
    """``brds_lstm_step`` in one kernel launch, bitwise equal to the
    chained form. Returns (c, h)."""
    if _backend.resolve(backend, x) == "ref":
        return _cell_ref(_ref.rb_dual_spmv_ref(sx, x, sh, h_prev, bias),
                         c_prev, pwl)
    _check_dual(sx, x, sh, h_prev)
    return _fused_kernel(sx.values, sx.deltas, x, sh.values, sh.deltas,
                         h_prev, _fit(bias, sx.rows), c_prev, pwl=pwl)


# ---------------------------------------------------------- temporal delta

def delta_rb_spmv(s: RowBalancedSparse, d, fired, *,
                  backend: str | None = None):
    """y = S@(fired·d) — the temporal-delta SpMV: ``d`` (B, ncols) raw
    activation deltas, ``fired`` their bool or 0/1 threshold mask; an
    unfired column contributes an exact 0. Returns (B, rows) in d.dtype."""
    fired = fired.float()
    if _backend.resolve(backend, d) == "ref":
        return _ref.delta_rb_spmv_ref(s, d, fired)
    _check_cols(s, d)
    return _delta_kernel(s.values, s.deltas, d, fired, s.rows)


def delta_rb_dual_spmv(sx: RowBalancedSparse, dx, fx, sh: RowBalancedSparse,
                       dh, fh, m, *, backend: str | None = None):
    """m' = m + Sx@(fx·dx) + Sh@(fh·dh) — the temporal-delta gate
    accumulation (partial-sum memory update). fx, fh: bool or 0/1 fired
    masks."""
    fx, fh = fx.float(), fh.float()
    if _backend.resolve(backend, dx) == "ref":
        return _ref.delta_rb_dual_spmv_ref(sx, dx, fx, sh, dh, fh, m)
    _check_dual(sx, dx, sh, dh)
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
    if _backend.resolve(backend, dx) == "ref":
        m = _ref.delta_rb_dual_spmv_ref(sx, dx, fx, sh, dh, fh, m_prev)
        c, h = _cell_ref(_plus_bias(m, bias), c_prev, pwl)
        return c, h, m
    _check_dual(sx, dx, sh, dh)
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
    if _backend.resolve(backend, x) == "ref":
        return _ref.rb_spmv_q8_ref(s, qx, sa)
    _check_cols(s, qx)
    return _rb_q8_kernel(s.values, s.deltas, s.scales * sa, qx, s.rows)


def _dual_parts_q8(sx, qx, sax, sh, qh, sah):
    """(zx, zh): the two families' dequantized partial sums, (B, rows)
    float32, from the q8 kernel."""
    _check_dual(sx, qx, sh, qh)
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
    if _backend.resolve(backend, x) == "ref":
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
    if _backend.resolve(backend, dx) == "ref":
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
    if _backend.resolve(backend, x) == "ref":
        z = _ref.rb_dual_spmv_q8_ref(sx, qx, sax, sh, qh, sah, bias)
        return _cell_ref(z, c_prev, pwl)
    _check_dual(sx, qx, sh, qh)
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
    if _backend.resolve(backend, dx) == "ref":
        m = _ref.delta_rb_dual_spmv_q8_ref(sx, qdx, sax, sh, qdh, sah,
                                           m_prev)
        c, h = _cell_ref(_plus_bias(m, bias), c_prev, pwl)
        return c, h, m
    _check_dual(sx, qdx, sh, qdh)
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
    if _backend.resolve(backend, xs) == "ref":
        c, h, hs = c0, h0, []
        for x in xs:
            c, h = _cell_ref(_ref.rb_dual_spmv_ref(sx, x, sh, h, bias), c,
                             pwl)
            hs.append(h)
        return torch.stack(hs), c
    _check_dual(sx, xs, sh, h0)
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
    if _backend.resolve(backend, xs) == "ref":
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
    return _delta_scan_kernel(sx.values, sx.deltas, xs, sh.values, sh.deltas,
                              h0, c0, x_ref0, h_ref0, _fit(m0, sx.rows),
                              _fit(bias, sx.rows), theta_x=theta_x,
                              theta_h=theta_h, pwl=pwl)


# --------------------------------------------------------------- attention

def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, backend: str | None = None):
    """Blocked causal / windowed GQA attention forward (B15). q (B, Hq, Sq,
    D), k/v (B, Hkv, Sk, D); q rows right-aligned to the kv end; a row with
    no live key gives 0. Returns (B, Hq, Sq, D) in q.dtype."""
    _check_window(window)
    if _backend.resolve(backend, q) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash_attn_kernel(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths, *, window: int | None = None,
                     lse: torch.Tensor | None = None,
                     backend: str | None = None):
    """Single-query GQA attention over a KV cache (B14). q (B, Hq, D), k/v
    (B, Hkv, S, D), lengths (B,) valid rows (the last ``window`` of them
    with a window); a row with length 0 gives 0. Returns (B, Hq, D) in
    q.dtype. ``lse``: a (B, Hq) float32 tensor on q's device that takes
    each row's log-sum-exp (-inf for a row with no live key), for a
    split-KV combine."""
    _check_window(window)
    if lse is not None and (lse.dtype != torch.float32
                            or tuple(lse.shape) != tuple(q.shape[:2])
                            or not lse.is_contiguous()):
        raise ValueError(f"lse: a contiguous float32 {tuple(q.shape[:2])} "
                         f"tensor, got {lse.dtype} {tuple(lse.shape)}")
    if _backend.resolve(backend, q) == "ref":
        return _ref.decode_attention_window_ref(q, k, v, lengths,
                                                window=window, lse=lse)
    return _decode_attn_kernel(q, k, v, lengths.to(torch.int32),
                               window=window, lse=lse)
