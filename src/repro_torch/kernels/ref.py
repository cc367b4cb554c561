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


def _sigmoid(v):
    """σ(v) as the kernels' cell computes it, 1 / (1 + exp(-v)). On the
    CPU ``torch.sigmoid``'s vector body and scalar tail round differently,
    so its bits depend on where an element falls in a row, and a rank's
    slice of H/n units would differ from the same units of the whole
    cell; this form rounds alike everywhere. Under autograd,
    ``torch.sigmoid`` and its own backward."""
    v = v.float()
    if v.requires_grad:
        return torch.sigmoid(v)
    return 1.0 / (1.0 + torch.exp(-v))


def lstm_cell_ref(zf, zi, zg, zo, c_prev, *, pwl: bool = False):
    """Paper eq. (1)-(2) elementwise part, from gate preactivations.

    c = sig(zf) * c_prev + sig(zi) * tanh(zg);  h = sig(zo) * tanh(c)

    Each product is its own eager op, so it rounds on its own before the
    add, as the kernels' cell does.
    """
    if pwl:
        sig, th = pwl_sigmoid_ref, pwl_tanh_ref
    else:
        sig = _sigmoid
        th = lambda v: torch.tanh(v.float())
    f, i, g, o = sig(zf), sig(zi), th(zg), sig(zo)
    c = f * c_prev.float() + i * g
    h = o * th(c)
    return c.to(c_prev.dtype), h.to(c_prev.dtype)


# ---------------------------------------------------------------- attention

NEG = -1e30     # the reference's mask value


def mha_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
            window: int | None = None) -> torch.Tensor:
    """Reference attention, copied from ``repro/kernels/ref.py::mha_ref``.
    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), Hq a multiple of Hkv; q rows
    right-aligned to the kv end; window: keys in [qpos-window+1, qpos]."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_attention_ref(q, k, v, lengths) -> torch.Tensor:
    """Single-token decode attention, copied from
    ``repro/kernels/ref.py::decode_attention_ref``. q (B, Hq, D); k, v
    (B, Hkv, S, D); lengths (B,). A length-0 row gets the mean of V (its
    softmax is uniform over -1e30)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float() * D ** -0.5, kf)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            < lengths.to(q.device)[:, None, None])
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vf).to(q.dtype)


def _grouped_softmax_av(qf, k, v, mask, lse: bool = False):
    """The online-softmax kernels' function on grouped heads: qf (B, Hkv,
    G, Sq, D) scaled float32, k/v (B, Hkv, Sk, D), mask broadcast to
    (..., Sq, Sk). Masked scores weigh exactly 0 (``p = s > NEG/2 ?
    exp(s - m) : 0``) and out = acc / max(l, 1e-30), so a row with no live
    key gives 0. ``lse``: also the rows' log-sum-exp m + log(l), -inf
    where no key is live."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    s = torch.where(mask, s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG / 2, torch.exp(s - m), 0.0)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    l = p.sum(-1, keepdim=True)
    out = acc / l.clamp_min(1e-30)
    if lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """What ``flash_attention`` computes (B15): blocked causal / windowed
    GQA attention forward. q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D); q rows
    right-aligned to the kv end (q row i sits at Sk - Sq + i); fp32 math,
    output in q.dtype. Equals ``mha_ref`` except on rows with no live key,
    which give 0 here."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    out = _grouped_softmax_av(qf, k, v, mask)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def decode_attention_window_ref(q, k, v, lengths, *,
                                window: int | None = None,
                                lse: torch.Tensor | None = None,
                                start: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """What ``decode_attention`` computes (B14): one query per sequence
    against its first ``lengths[b]`` cache rows (the last ``window`` of
    them when a window is given: ``kpos > length - 1 - window``). q (B, Hq,
    D), k/v (B, Hkv, S, D), lengths (B,) int; fp32 math, output in q.dtype.
    Equals ``decode_attention_ref`` for lengths ≥ 1; a length-0 row gives
    0, as the Pallas kernel does. ``lse`` (B, Hq) float32, when given,
    takes each row's log-sum-exp of its scaled scores (m + log l; -inf for
    a row with no live key): what a split-KV combine weighs partials by.
    ``start`` (B,) int, when given: each row's keys begin there too
    (``kpos >= start``)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, 1, D) * D ** -0.5
    n = lengths.to(q.device).reshape(B, 1, 1, 1, 1)
    kpos = torch.arange(S, device=q.device)
    mask = kpos < n
    if window is not None:
        mask = mask & (kpos > n - 1 - window)
    if start is not None:
        mask = mask & (kpos >= start.to(q.device).reshape(B, 1, 1, 1, 1))
    if lse is None:
        out = _grouped_softmax_av(qf, k, v, mask)
    else:
        out, rows = _grouped_softmax_av(qf, k, v, mask, lse=True)
        lse.copy_(rows.reshape(B, Hq))
    return out.reshape(B, Hq, D).to(q.dtype)
