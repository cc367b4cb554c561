"""Plain PyTorch versions of every ported kernel.

These are the semantics contracts: the CPU path runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.packing import RowBalancedSparse


# ---------------------------------------------------------------- rb_spmv

def rb_spmv_ref(s: RowBalancedSparse, x: torch.Tensor) -> torch.Tensor:
    """y[b, r] = sum_k vals[r, k] * x[b, cols[r, k]].  x: (B, ncols)."""
    s = s.logical()          # the plain versions compute logical rows only
    cols = s.col_indices().long()                          # (R, K)
    g = x[:, cols].float()                                 # (B, R, K)
    # an explicit product and sum, not a matmul: no TF32 path can reach it
    return (g * s.values.float()[None]).sum(-1).to(x.dtype)


def rb_dual_spmv_ref(sx: RowBalancedSparse, x: torch.Tensor,
                     sh: RowBalancedSparse, h: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """The LSTM gate preactivation: z = Sx@x + Sh@h (+ bias)."""
    z = rb_spmv_ref(sx, x).float() + rb_spmv_ref(sh, h).float()
    if bias is not None:
        z = z + bias[:z.shape[-1]].float()[None, :]
    return z.to(x.dtype)


# ----------------------------------------------------------- delta_rb_spmv

def delta_rb_spmv_ref(s: RowBalancedSparse, d: torch.Tensor,
                      fired: torch.Tensor) -> torch.Tensor:
    """Temporal-delta SpMV: y[b, r] = Σ_k vals[r, k] · fired[b, c] · d[b, c];
    columns that did not fire contribute an exact 0."""
    return rb_spmv_ref(s, (d.float() * fired.float()).to(d.dtype))


def delta_rb_dual_spmv_ref(sx: RowBalancedSparse, dx, fx,
                           sh: RowBalancedSparse, dh, fh,
                           m: torch.Tensor) -> torch.Tensor:
    """The partial-sum memory update m' = m + Sx@(fx·dx) + Sh@(fh·dh), m
    added first; the bias is not folded in."""
    z = (m.float() + delta_rb_spmv_ref(sx, dx, fx).float()
         + delta_rb_spmv_ref(sh, dh, fh).float())
    return z.to(m.dtype)


# ------------------------------------------------------------ quantized

def rb_spmv_q8_ref(s, qx: torch.Tensor, act_scale) -> torch.Tensor:
    """Quantized packed SpMV: integer products accumulated in int32
    (wrapping), then one dequant multiply per row by the combined scale
    ``scales * act_scale``. ``s`` a RowBalancedSparseQ8, ``qx`` (B, ncols)
    integer codes. Returns (B, rows) float32."""
    s = s.logical()
    cols = s.col_indices().long()
    g = qx[:, cols].to(torch.int32)                         # (B, R, K)
    acc = (g * s.values.to(torch.int32)[None]).sum(-1, dtype=torch.int32)
    return acc.float() * (s.scales * act_scale)[None, :]


def rb_dual_spmv_q8_ref(sx, qx, ax, sh, qh, ah,
                        bias: torch.Tensor) -> torch.Tensor:
    """z = dq(Sx@qx) + dq(Sh@qh) + bias, each family dequantized by its
    own combined scales. Returns (B, rows) float32."""
    z = rb_spmv_q8_ref(sx, qx, ax) + rb_spmv_q8_ref(sh, qh, ah)
    return z + bias[:z.shape[-1]].float()[None, :]


def delta_rb_dual_spmv_q8_ref(sx, qdx, ax, sh, qdh, ah,
                              m: torch.Tensor) -> torch.Tensor:
    """m' = m + dq(Sx@qdx) + dq(Sh@qdh) over the codes of the masked
    deltas (exact 0 where unfired); the bias is not folded in."""
    return (m.float() + rb_spmv_q8_ref(sx, qdx, ax)
            + rb_spmv_q8_ref(sh, qdh, ah))


# ---------------------------------------------------------------- lstm cell

def pwl_tables(n_seg: int = 16, lo: float = -8.0, hi: float = 8.0):
    """Piecewise-linear coefficient tables (a, b per segment) for sigmoid and
    tanh — the paper's LUT-based activation (§4: out = a*x + b per segment),
    by endpoint interpolation per segment. Built in numpy, as the reference
    builds them, so both frameworks use the same float32 coefficients."""
    xs = np.linspace(lo, hi, n_seg + 1)

    def mk(f):
        y = f(xs)
        a = (y[1:] - y[:-1]) / (xs[1:] - xs[:-1])
        b = y[:-1] - a * xs[:-1]
        return a.astype(np.float32), b.astype(np.float32)

    a_s, b_s = mk(lambda v: 1.0 / (1.0 + np.exp(-v)))
    a_t, b_t = mk(np.tanh)
    return dict(lo=lo, hi=hi, n_seg=n_seg, sig=(a_s, b_s), tanh=(a_t, b_t))


def _pwl_apply(x, a, b, lo, hi, n_seg, sat_lo, sat_hi):
    xc = torch.clamp(x, lo, hi - 1e-6)
    idx = torch.floor((xc - lo) / (hi - lo) * n_seg).to(torch.int32)
    idx = torch.clamp(idx, 0, n_seg - 1).long()
    y = a[idx] * xc + b[idx]
    y = torch.where(x < lo, torch.full_like(y, sat_lo), y)
    return torch.where(x >= hi, torch.full_like(y, sat_hi), y)


def _pwl(x, key: str, sat_lo: float, tables=None):
    t = tables or pwl_tables()
    a, b = (torch.as_tensor(v, device=x.device) for v in t[key])
    return _pwl_apply(x.float(), a, b, t["lo"], t["hi"], t["n_seg"], sat_lo,
                      1.0)


def pwl_sigmoid_ref(x, tables=None):
    return _pwl(x, "sig", 0.0, tables)


def pwl_tanh_ref(x, tables=None):
    return _pwl(x, "tanh", -1.0, tables)


def lstm_cell_ref(zf, zi, zg, zo, c_prev, *, pwl: bool = False):
    """Paper eq. (1)-(2) elementwise part, from gate preactivations.

    c = sig(zf) * c_prev + sig(zi) * tanh(zg);  h = sig(zo) * tanh(c)

    Each product is its own eager op, so it rounds on its own before the
    add, as the kernels' cell does.
    """
    if pwl:
        sig, th = pwl_sigmoid_ref, pwl_tanh_ref
    else:
        sig = lambda v: torch.sigmoid(v.float())
        th = lambda v: torch.tanh(v.float())
    f, i, g, o = sig(zf), sig(zi), th(zg), sig(zo)
    c = f * c_prev.float() + i * g
    h = o * th(c)
    return c.to(c_prev.dtype), h.to(c_prev.dtype)
