"""Recurrent sequence mixers: RG-LRU (RecurrentGemma / Griffin) and RWKV6.

The port of ``repro/models/recurrent.py``, op for op in plain PyTorch
(the reference has no kernel here). Both are the paper's W_h analogue made
modern: data-dependent diagonal / low-rank recurrences with O(1) state.
Prefill and training take the parallel forms, decode the one-token
updates:

- RG-LRU's recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth scan
  over the sequence (``associative_scan``: the reference's
  ``jax.lax.associative_scan``, its odd/even recursion step for step), so
  a prompt costs ~2 log2(S) levels of whole-tensor ops, not S steps;
- RWKV6's time mix runs chunk by chunk (``rwkv_time_mix``): within a chunk
  the pairwise-decayed attention form, across chunks the carried (Dk, Dk)
  state, one Python iteration a chunk as the reference's ``lax.scan``.

The functions take the product hooks a tensor-parallel rank needs
(``dist.tensor_parallel``: ``gate_pre``, the gates' preactivations over
every rank's rows; ``reduce``, a row-parallel product's partial sums), so a
rank runs the same math on its slice of ``d_rnn`` or of the heads; left
out, they are the one-device products.

The state functions return new tensors and never write their inputs: the
serving loop copies a step's state into its static buffers (``runtime.
assign``), and the speculative verify chain keeps each step's state as a
rollback checkpoint (``spec.verify``). State leaves carry the reference's
logical axes (no ``cache_seq``), so ``spec.verify`` reads them as state.
"""
from __future__ import annotations

import math

import torch

from .layers import PSpec
from ..core.packing import RowBalancedSparse

F = torch.nn.functional


def _proj(x, w):
    """y = x @ W for dense (d_in, *out) weights or a BRDS-packed
    ``RowBalancedSparse`` (rows = the flattened out dim, cols = d_in).
    The packed form is the reference's gather form of the row-balanced
    product: the running sum of the deltas gives each row's K columns, x
    is gathered at them and multiplied with the values in float32.
    Returns (B, S, F) with F = prod(out dims)."""
    B, S, d = x.shape
    if isinstance(w, RowBalancedSparse):
        cols = torch.cumsum(w.deltas.to(torch.int32), dim=1).long()  # (R, K)
        g = x.reshape(B * S, d)[:, cols]                             # (BS,R,K)
        y = torch.einsum("brk,rk->br", g.float(), w.values.float())
        return y.reshape(B, S, w.rows).to(x.dtype)
    return torch.matmul(x, w.reshape(w.shape[0], -1))


def associative_scan(fn, elems: tuple, dim: int = 1) -> tuple:
    """Inclusive scan of ``fn`` (associative, over tuples of tensors) along
    ``dim``: the recursion of ``jax.lax.associative_scan``. Adjacent
    pairs combine, the halved sequence scans recursively (the odd
    outputs), the even outputs combine each odd result with the element
    after it, and the two interleave: log2(S) levels of whole-tensor ops,
    each differentiable."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, e.shape[dim] - 1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _interleave(a, b, dim: int):
    """a's entries at the even positions along ``dim``, b's at the odd;
    a has as many entries as b or one more."""
    nb = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, nb), b], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if a.shape[dim] > nb:
        out = torch.cat([out, a.narrow(dim, nb, 1)], dim=dim)
    return out


# ================================================================= RG-LRU

RG_C = 8.0  # Griffin's fixed temperature on the recurrence gate


def rglru_defs(d_model: int, d_rnn: int, conv_width: int, dtype) -> dict:
    return {
        "w_in_gelu": PSpec((d_model, d_rnn), dtype=dtype,
                           axes=("embed", "mlp")),
        "w_in_rec": PSpec((d_model, d_rnn), dtype=dtype,
                          axes=("embed", "mlp")),
        "conv_w": PSpec((conv_width, d_rnn), scale=0.3, dtype=dtype,
                        axes=("conv", "mlp")),
        "conv_b": PSpec((d_rnn,), init="zeros", dtype=dtype, axes=("mlp",)),
        "w_gate_a": PSpec((d_rnn, d_rnn), dtype=dtype, axes=("mlp", "embed")),
        "w_gate_x": PSpec((d_rnn, d_rnn), dtype=dtype, axes=("mlp", "embed")),
        "lam": PSpec((d_rnn,), init="ones", dtype=torch.float32,
                     axes=("mlp",)),
        "w_out": PSpec((d_rnn, d_model), dtype=dtype, axes=("mlp", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B, S, D), w (W, D); state (B, W-1, D),
    the previous segment's last W-1 inputs (zeros when None). Returns
    (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+W-1, D)
    S = x.shape[1]
    y = 0
    for i in range(W):
        y = y + xp[:, i:i + S] * w[i][None, None, :]
    y = y + b[None, None, :]
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else None
    return y, new_state


def _gate_pre(p, xr):
    """The gates' preactivations (xr @ w_gate_a, xr @ w_gate_x)."""
    return torch.matmul(xr, p["w_gate_a"]), torch.matmul(xr, p["w_gate_x"])


def _rglru_gates(p, xr, gate_pre=_gate_pre):
    """Gate computations shared by scan and step. xr (..., d_rnn) →
    (log_a, gx), float32."""
    pa, px = gate_pre(p, xr)
    ga = torch.sigmoid(pa.float())
    gx = torch.sigmoid(px.float())
    log_a = -RG_C * F.softplus(p["lam"].float()) * ga  # (..., d_rnn) ≤ 0
    return log_a, gx


def _rglru_inputs(p, x, conv_state, gate_pre=_gate_pre):
    """The gelu branch, the conv'd recurrent input, its new conv state and
    the recurrence's (a, b), all from x (B, S, d_model)."""
    gelu_branch = F.gelu(torch.matmul(x, p["w_in_gelu"]), approximate="tanh")
    xr = torch.matmul(x, p["w_in_rec"])
    xr, new_conv = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    log_a, gx = _rglru_gates(p, xr, gate_pre)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    b = beta * gx * xr.float()
    return gelu_branch, new_conv, a, b


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _no_reduce(y):
    return y


def rglru_apply(p: dict, x, state=None, *, gate_pre=_gate_pre,
                reduce=_no_reduce):
    """Full-sequence RG-LRU block. x (B, S, d_model); state: dict with
    'h' (B, d_rnn) and 'conv' (B, W-1, d_rnn) to chain from (None: zeros).
    Returns (y (B, S, d_model), new_state). ``gate_pre`` / ``reduce``: the
    product hooks (module docstring)."""
    gelu_branch, conv_state, a, b = _rglru_inputs(
        p, x, None if state is None else state["conv"], gate_pre)
    # h_t = a_t h_{t-1} + b_t, a log-depth scan over the sequence
    a_sc, b_sc = associative_scan(_combine, (a, b), dim=1)
    h = b_sc
    if state is not None:
        h = h + a_sc * state["h"].float()[:, None, :]
    h = h.to(x.dtype)
    y = reduce(torch.matmul(gelu_branch * h, p["w_out"]))
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_step(p: dict, x, state, *, gate_pre=_gate_pre, reduce=_no_reduce):
    """Single-token decode. x (B, 1, d_model) → (y (B, 1, d), new_state)."""
    gelu_branch, conv_state, a, b = _rglru_inputs(p, x, state["conv"],
                                                  gate_pre)
    h = (a[:, 0] * state["h"].float() + b[:, 0]).to(x.dtype)
    y = reduce(torch.matmul(gelu_branch[:, 0] * h, p["w_out"]))[:, None]
    return y, {"h": h, "conv": conv_state}


def rglru_state_defs(batch: int, d_rnn: int, conv_width: int, dtype) -> dict:
    return {
        "h": PSpec((batch, d_rnn), init="zeros", dtype=dtype,
                   axes=("batch", "mlp")),
        "conv": PSpec((batch, conv_width - 1, d_rnn), init="zeros",
                      dtype=dtype, axes=("batch", "conv", "mlp")),
    }


# ================================================================== RWKV6

def rwkv_defs(d_model: int, num_heads: int, head_dim: int, d_ff: int,
              dtype) -> dict:
    H, Dk = num_heads, head_dim
    hd = ("embed", "heads", "head_dim")
    return {
        # token-shift lerp coefficients (r, k, v, w, g)
        "mu": PSpec((5, d_model), init="zeros", dtype=torch.float32,
                    axes=(None, "embed")),
        "w_r": PSpec((d_model, H, Dk), dtype=dtype, axes=hd),
        "w_k": PSpec((d_model, H, Dk), dtype=dtype, axes=hd),
        "w_v": PSpec((d_model, H, Dk), dtype=dtype, axes=hd),
        "w_g": PSpec((d_model, H, Dk), dtype=dtype, axes=hd),
        # data-dependent decay: w_t = exp(-exp(w0 + x @ w_w))
        "w0": PSpec((H, Dk), init="zeros", dtype=torch.float32,
                    axes=("heads", "head_dim")),
        "w_w": PSpec((d_model, H, Dk), scale=0.01, dtype=dtype, axes=hd),
        "u": PSpec((H, Dk), init="zeros", dtype=torch.float32,
                   axes=("heads", "head_dim")),
        "gn": PSpec((H, Dk), init="zeros", dtype=torch.float32,
                    axes=("heads", "head_dim")),   # per-head group-norm scale
        "w_out": PSpec((H, Dk, d_model), dtype=dtype,
                       axes=("heads", "head_dim", "embed")),
        # channel-mix
        "mu_cm": PSpec((d_model,), init="zeros", dtype=torch.float32,
                       axes=("embed",)),
        "w_cm1": PSpec((d_model, d_ff), dtype=dtype, axes=("embed", "mlp")),
        "w_cm2": PSpec((d_ff, d_model), dtype=dtype, axes=("mlp", "embed")),
    }


def _token_shift(x, x_prev_last):
    """x (B, S, d); x_prev_last (B, d), the last token of the previous
    segment. Returns the x_{t-1} sequence aligned with x."""
    prev = x_prev_last[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_projections(p, x, x_shift):
    mu = p["mu"].float()
    xf = x.float()
    sf = x_shift.float()
    B, S = x.shape[:2]
    H, Dk = p["u"].shape

    def mix(i):
        return (xf + mu[i] * (sf - xf)).to(x.dtype)

    def hd(y):
        return y.reshape(B, S, H, Dk)

    r = hd(_proj(mix(0), p["w_r"]))
    k = hd(_proj(mix(1), p["w_k"]))
    v = hd(_proj(mix(2), p["w_v"]))
    wraw = hd(_proj(mix(3), p["w_w"])).float()
    g = F.silu(hd(_proj(mix(4), p["w_g"])))
    # log decay in [-~20, -1e-4]; clamped for numerical sanity
    log_w = -torch.exp(torch.clamp(p["w0"].float() + wraw, -8.0, 4.0))
    return r, k, v, g, log_w


def _chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S at most ``chunk`` (the reference's)."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def _chunk_step(S_prev, rb, kb, vb, lwb, u):
    """One chunk: (B, H, L, Dk) float32 r, k, v and log decays against the
    carried state S_prev (B, H, Dk, Dk). Returns (S_new, o (B, H, L, Dk))."""
    L = rb.shape[2]
    logc = torch.cumsum(lwb, dim=2)           # inclusive per-channel decay
    logc_excl = logc - lwb                    # exclusive (up to t-1)
    # inter-chunk: r_t ⊙ c_{t-1} applied to the carried state
    q_in = rb * torch.exp(logc_excl)
    o_inter = torch.einsum("bhld,bhde->bhle", q_in, S_prev)
    # intra-chunk, strict lower triangle with pairwise decay:
    # decay3[t, s, d] = exp(logc_excl[t] - logc[s]) for s < t. The sum
    # over d is an elementwise product and a reduction: as one einsum of
    # the three it becomes a batch of tiny products (a GEMV a row on the
    # card, 2.4x slower)
    # (the upper triangle's exponents are sums of -log decays, past exp's
    # range at full width: masked before exp, so that the backward of the
    # mask sees 0 there, not 0 * inf = NaN; the reference's where after exp
    # gives NaN gradients once a chunk's decays sum past ~88)
    idx = torch.arange(L, device=rb.device)
    tri = idx[:, None] > idx[None, :]
    decay3 = torch.exp(torch.where(
        tri[None, None, :, :, None],
        logc_excl[:, :, :, None, :] - logc[:, :, None, :, :], -math.inf))
    att = (decay3 * rb[:, :, :, None, :] * kb[:, :, None, :, :]).sum(-1)
    del decay3
    o_intra = torch.einsum("bhts,bhse->bhte", att, vb)
    # current-token bonus: (r_t · u ⊙ k_t) v_t
    bonus = torch.einsum("bhld,bhld->bhl", rb, u[None, :, None, :] * kb)
    o_bonus = bonus[..., None] * vb
    o = o_inter + o_intra + o_bonus
    # S = exp(logc_L) ⊙ S_prev + Σ_s exp(logc_L - logc_s) k_s v_sᵀ
    c_end = torch.exp(logc[:, :, -1])         # (B, H, Dk)
    k_sc = kb * torch.exp(logc[:, :, -1:, :] - logc)
    S_new = c_end[..., None] * S_prev + torch.einsum("bhld,bhle->bhde",
                                                     k_sc, vb)
    return S_new, o


def rwkv_time_mix(p: dict, x, state, *, chunk: int = 128,
                  reduce=_no_reduce):
    """Chunked-parallel RWKV6 time mix. x (B, S, d); state dict with 'S'
    (B, H, Dk, Dk) and 'x_tm' (B, d). Returns (y, new_state). The heads
    are ``p["u"]``'s (a rank's, with ``reduce`` summing the output
    projection's partial products)."""
    B, S, d = x.shape
    H, Dk = p["u"].shape
    L = _chunk_len(S, chunk)
    nc = S // L

    x_shift = _token_shift(x, state["x_tm"])
    r, k, v, g, log_w = _rwkv_projections(p, x, x_shift)
    u = p["u"].float()

    def chunks(t):      # (B, S, H, Dk) → (nc, B, H, L, Dk) float32
        return t.reshape(B, nc, L, H, Dk).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(log_w)
    S_state = state["S"].float()
    outs = []
    for c in range(nc):
        S_state, o = _chunk_step(S_state, rc[c], kc[c], vc[c], wc[c], u)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, Dk)
    return reduce(_rwkv_out(p, o, g)), {"S": S_state, "x_tm": x[:, -1]}


def _rwkv_out(p, o, g):
    """Per-head RMS group-norm, gate, output projection (of the heads
    given: a rank's partial products)."""
    of = o.float()
    var = torch.mean(of * of, dim=-1, keepdim=True)
    of = of * torch.rsqrt(var + 1e-6) * (1.0 + p["gn"].float())
    of = of * g.float()
    B, S = of.shape[:2]
    w = p["w_out"]
    if not isinstance(w, RowBalancedSparse):
        w = w.reshape(-1, w.shape[-1])
    return _proj(of.to(g.dtype).reshape(B, S, -1), w)


def rwkv_time_mix_step(p: dict, x, state, *, reduce=_no_reduce):
    """Single-token decode. x (B, 1, d)."""
    x_shift = state["x_tm"][:, None, :].to(x.dtype)
    r, k, v, g, log_w = _rwkv_projections(p, x, x_shift)
    rb = r[:, 0].float()                      # (B, H, Dk)
    kb = k[:, 0].float()
    vb = v[:, 0].float()
    w = torch.exp(log_w[:, 0])                # (B, H, Dk)
    u = p["u"].float()
    S_prev = state["S"].float()               # (B, H, Dk, Dk)
    kv = kb[..., :, None] * vb[..., None, :]  # (B, H, Dk, Dk)
    o = torch.einsum("bhd,bhde->bhe", rb, S_prev + u[None, :, :, None] * kv)
    S_new = w[..., None] * S_prev + kv
    o = reduce(_rwkv_out(p, o[:, None], g))   # (B,1,H,Dk) → (B,1,d)
    return o, {"S": S_new, "x_tm": x[:, -1]}


def rwkv_channel_mix(p: dict, x, state_x, *, reduce=_no_reduce):
    """x (B, S, d); state_x (B, d), the last token of the previous
    segment. Returns (y, the new state: x's last token). ``reduce``: the
    second product's partial sums over a rank's hidden rows."""
    x_shift = _token_shift(x, state_x)
    mu = p["mu_cm"].float()
    xf = x.float()
    mixed = (xf + mu * (x_shift.float() - xf)).to(x.dtype)
    h = F.relu(_proj(mixed, p["w_cm1"]))
    y = reduce(_proj(h * h, p["w_cm2"]))
    return y, x[:, -1]


def rwkv_state_defs(batch: int, num_heads: int, head_dim: int, d_model: int,
                    dtype) -> dict:
    return {
        "S": PSpec((batch, num_heads, head_dim, head_dim), init="zeros",
                   dtype=torch.float32,
                   axes=("batch", "heads", "head_dim", None)),
        "x_tm": PSpec((batch, d_model), init="zeros", dtype=dtype,
                      axes=("batch", "embed")),
        "x_cm": PSpec((batch, d_model), init="zeros", dtype=dtype,
                      axes=("batch", "embed")),
    }
