"""The arithmetic of the redesigned delta scan (``csrc/fused_scan.cu``,
``fused_scan_kernel`` with its delta policy; B13
``fused_brds_delta_lstm_scan``), modelled in numpy on the CPU:

- the threshold pass: a thread a (b, c) of x walks t = 0 .. T-1 in order
  (d = v - ref, fired = |d| > Θ, the masked delta d·fired, ref moved to v
  where fired), so every step's masked x delta exists before the
  recurrence; the same pass thresholds h0 against h_ref0;
- the hoisted projection ax[t] = Sx@dxm[t]: 32 / NB steps a pass staged
  as one 128-byte bank row a column (piece tt·NB/4 + q holds step tt's
  batch rows 4q .. 4q+3), lane l reading piece (j + l) % 8 into its
  registers, put back in order once a row, then the xor butterfly;
- the recurrence: the masked h deltas as h's planes (NB/4 pieces repeated
  over the row), ah = Sh@dhm in the same lane order, m' = (m + ax) + ah,
  z = m' + bias, the cell, and the owner's threshold of the h it made,
  except at the last step (the chain thresholds h0 .. h_{T-2}).

The model is held against the JAX package's ``fused_brds_delta_lstm_scan``
(Pallas in interpret mode, and its plain reference) and the port's plain
version within the scans' tolerance. The kernel itself runs only on the
card (``chip_smoke.py`` holds it bitwise against T × (thresholds →
fused delta step))."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.plan import scan_plan
from repro_torch.kernels.ref import lstm_cell_ref
from repro_torch.models import packed_from_numpy
from repro_torch.sparse.temporal import delta_threshold

from test_torch_delta_layout import WARP, _fma32, row_sums
from test_torch_plan import _unrotate

PIECES = 8        # fused_scan.cu kPieces: 16-byte pieces a staged column
# the scans' tolerance (tests/test_torch_scan.py): m is a running float32
# sum over T steps, each step's products added in another order than the
# reference's, and the cell and h_ref read it
DELTA_ATOL = 5e-6
T = 6


def threshold(v, ref, theta):
    """fused_scan.cu ``threshold``: (the masked delta __fmul_rn(d, fired),
    the moved reference), in float32 as delta_threshold computes them."""
    d = v - ref
    fired = np.abs(d) > np.float32(theta)
    return d * fired.astype(np.float32), np.where(fired, v, ref)


def threshold_walk(xs, ref, theta):
    """The threshold pass over x: each column walks t = 0 .. T-1 in order.
    Returns (dxm (T, B, X), x_ref_T)."""
    out = np.empty_like(xs)
    for t in range(xs.shape[0]):
        out[t], ref = threshold(xs[t], ref, theta)
    return out, ref


def _lanes(vals, cols):
    """Lane l's entries l, l+32, ... of each row in order: (value, column,
    live), each (rows, steps, 32)."""
    rows, K = vals.shape
    n = max(1, -(-K // WARP)) * WARP
    v = np.zeros((rows, n), np.float32)
    c = np.zeros((rows, n), np.int64)
    v[:, :K], c[:, :K] = vals, cols
    live = (np.arange(n) < K).reshape(-1, WARP)
    return (v.reshape(rows, -1, WARP), c.reshape(rows, -1, WARP),
            np.broadcast_to(live, (rows,) + live.shape))


def _unrotated_butterfly(acc, nq):
    """A row's lane registers (rows, 32, 4 nq) in rotated piece order
    (lane l's slot j holds piece (j + l) % nq's four values): each lane's
    pieces put back in order (``unrotate``, rotation l & 7), then the xor
    butterfly; every lane ends with the total."""
    rows = acc.shape[0]
    for lane in range(WARP):
        pieces = list(acc[:, lane].reshape(rows, nq, 4).transpose(1, 0, 2))
        acc[:, lane] = np.stack(_unrotate(pieces, lane & (PIECES - 1)),
                                1).reshape(rows, 4 * nq)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(WARP) ^ o]
    assert (acc == acc[:, :1]).all()
    return acc[:, 0]


def staged_sums(vals, cols, planes, nq):
    """Sum of v · planes[col] over lane l's entries in order, one float32
    fma a value, where lane l's j-th load of a column takes piece (j + l)
    % 8 of its 8 (``fma_pieces``: j < nq), then ``_unrotated_butterfly``.
    planes: (ncols, 8, 4). Returns (rows, 4 nq)."""
    v, c, live = _lanes(vals, cols)
    rows = vals.shape[0]
    lanes = np.arange(WARP)
    take = (np.arange(nq)[None, :] + lanes[:, None]) % PIECES   # (32, nq)
    acc = np.zeros((rows, WARP, 4 * nq), np.float32)
    for s in range(v.shape[1]):
        a = planes[c[:, s][:, :, None], take[None]]   # (rows, 32, nq, 4)
        new = _fma32(acc, v[:, s, :, None], a.reshape(rows, WARP, 4 * nq))
        acc = np.where(live[:, s, :, None], new, acc)
    return _unrotated_butterfly(acc, nq)


def project(vals, cols, dxm, nb):
    """The hoisted projection: ax (T, rows, B) = Sx@dxm[t], 32 / NB steps a
    pass, step tt's batch rows 4q .. 4q+3 in piece tt·NB/4 + q of each
    staged column (zero past B and past the pass's steps)."""
    Tn, B, X = dxm.shape
    nq, pt = nb // 4, 32 // nb
    ax = np.empty((Tn, vals.shape[0], B), np.float32)
    for t0 in range(0, Tn, pt):
        tn = min(pt, Tn - t0)
        planes = np.zeros((X, PIECES, 4), np.float32)
        for p in range(PIECES):
            tt, q = divmod(p, nq)
            if tt < tn:
                rows_q = dxm[t0 + tt, 4 * q:4 * q + 4].T   # (X, <= 4)
                planes[:, p, :rows_q.shape[1]] = rows_q
        acc = staged_sums(vals, cols, planes, PIECES)   # (rows, 32)
        for tt in range(tn):
            ax[t0 + tt] = acc[:, tt * nb:tt * nb + B]
    return ax


def h_planes(dh, nb):
    """h's masked delta (B, H) as the recurrence stages it: column c's
    NB/4 pieces (batch rows 4q .. 4q+3, zero past B) repeated over the 8."""
    B, H = dh.shape
    nq = nb // 4
    g = np.zeros((H, nb), np.float32)
    g[:, :B] = dh.T
    return np.tile(g.reshape(H, nq, 4), (1, PIECES // nq, 1))


def _cell(z, c, H, pwl):
    """The kernels' cell in float32 (the port's plain version of
    brds::lstm_cell, each product rounded on its own)."""
    cn, hn = lstm_cell_ref(*(torch.from_numpy(z[:, i * H:(i + 1) * H])
                             for i in range(4)), torch.from_numpy(c),
                           pwl=pwl)
    return cn.numpy(), hn.numpy()


def model_scan(sx, sh, a, theta, pwl=False):
    """The modelled delta scan: returns (hs, c_T, x_ref_T, h_ref_T, m_T)
    and the number of h thresholds taken."""
    xs, h, c, m = a["xs"], a["h"], a["c"], a["m"]
    Tn, B, X = xs.shape
    H = h.shape[1]
    R = 4 * H
    nb = scan_plan(X=X, H=H, T=Tn, B=B, Kx=sx.values.shape[1],
                   Kh=sh.values.shape[1], delta=True).nb
    cols = [np.cumsum(np.asarray(s.deltas)[:R].astype(np.int64), 1)
            for s in (sx, sh)]
    vals = [np.asarray(s.values)[:R] for s in (sx, sh)]
    dxm, x_ref = threshold_walk(xs, a["xr"], theta)
    dh, h_ref = threshold(h, a["hr"], theta)        # the pass's h0
    ax = project(vals[0], cols[0], dxm, nb)
    hs, nh = [], 1
    for t in range(Tn):
        ah = staged_sums(vals[1], cols[1], h_planes(dh, nb), nb // 4)[:, :B]
        m = (m + ax[t].T) + ah.T                    # delta_update
        c, h = _cell(m + a["b"][None, :], c, H, pwl)
        hs.append(h)
        if t + 1 < Tn:                              # the owner's threshold
            dh, h_ref = threshold(h, h_ref, theta)
            nh += 1
    return (np.stack(hs), c, x_ref, h_ref, m), nh


def _case(seed, B, X, H, pad):
    rng = np.random.default_rng(seed)
    arr = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    sx = pack_from_dense(jnp.asarray(arr(4 * H, X, sc=X ** -0.5)), 0.75)
    sh = pack_from_dense(jnp.asarray(arr(4 * H, H, sc=H ** -0.5)), 0.5)
    if pad:
        sx, sh = pad_packed(sx), pad_packed(sh)
    a = dict(xs=arr(T, B, X), h=arr(B, H), c=arr(B, H),
             b=arr(4 * H, sc=0.1), xr=arr(B, X, sc=0.5),
             hr=arr(B, H, sc=0.5), m=arr(B, 4 * H))
    return sx, sh, a


def _jax(sx, sh, a, theta, jbackend, pwl=False):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return [np.asarray(o) for o in jops.fused_brds_delta_lstm_scan(
        sx, j["xs"], sh, j["h"], j["c"], j["xr"], j["hr"], j["m"], j["b"],
        theta_x=theta, theta_h=theta, pwl=pwl, backend=jbackend)]


def _plain(sx, sh, a, theta, pwl=False):
    tsx, tsh = (packed_from_numpy(s.values, s.deltas, s.ncols, s.pad,
                                  s.block_rows) for s in (sx, sh))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return [o.numpy() for o in ops.fused_brds_delta_lstm_scan(
        tsx, t["xs"], tsh, t["h"], t["c"], t["xr"], t["hr"], t["m"], t["b"],
        theta_x=theta, theta_h=theta, pwl=pwl, backend="ref")]


def _close(got, want):
    for g, w in zip(got, want):     # hs, c, x_ref, h_ref, m
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=DELTA_ATOL)


# (X, H, pad): packed rows padded to the reference's 256-row block, and
# unpadded with an odd H; int8 deltas at these widths
SCAN_SHAPES = [(100, 96, True), (48, 33, False)]


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("theta", [0.0, 0.05])
@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("X,H,pad", SCAN_SHAPES)
def test_modelled_delta_scan_matches_jax(X, H, pad, B, theta, jbackend):
    """The modelled B13 (threshold pass, staged projection of dxm, the
    recurrence on h's masked deltas, m' = (m + ax) + ah, the owner's h
    thresholds) against the JAX package's delta scan and the port's plain
    version, every output within the scans' tolerance; h is thresholded T
    times."""
    sx, sh, a = _case(100 * B + H, B, X, H, pad)
    got, nh = model_scan(sx, sh, a, theta)
    assert nh == T
    _close(got, _jax(sx, sh, a, theta, jbackend))
    _close(got, _plain(sx, sh, a, theta))


@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_one_step_thresholds_h0_once(theta):
    """At T = 1 the pass thresholds h0 and the cell makes h without a
    threshold: h_ref_T is h_ref0 moved by h0 alone, as the reference's."""
    sx, sh, a = _case(7, 3, 48, 33, False)
    a["xs"] = a["xs"][:1]
    got, nh = model_scan(sx, sh, a, theta)
    assert nh == 1
    _, want = threshold(a["h"], a["hr"], theta)
    np.testing.assert_array_equal(got[3], want)
    _close(got, _jax(sx, sh, a, theta, "ref"))


@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_threshold_pass_is_T_chained_thresholds(theta):
    """Each column's walk over t gives, bit for bit, the masked deltas and
    the reference that T calls of the port's delta_threshold give (d·fired
    with -0 for an unfired negative delta, NaN for an unfired infinity)."""
    rng = np.random.default_rng(3)
    xs = (rng.normal(size=(T, 4, 50)) * 0.1).astype(np.float32)
    xs[0, 0, :3] = (-0.0, np.inf, -1e-3)
    ref0 = (rng.normal(size=(4, 50)) * 0.1).astype(np.float32)
    with np.errstate(invalid="ignore"):
        dxm, ref = threshold_walk(xs, ref0, theta)
    r = torch.from_numpy(ref0)
    for t in range(T):
        d, f, r = delta_threshold(torch.from_numpy(xs[t]), r, theta)
        want = (d * f.float()).numpy()
        np.testing.assert_array_equal(dxm[t].view(np.uint32),
                                      want.view(np.uint32))
    np.testing.assert_array_equal(ref.view(np.uint32),
                                  r.numpy().view(np.uint32))


@pytest.mark.parametrize("B,nb", [(1, 4), (3, 4), (8, 8), (12, 16),
                                  (16, 16)])
def test_staged_projection_is_row_dots_order(B, nb):
    """The projection's rotated pieces, 32 / NB steps a pass, give each
    (t, row, b) sum bit for bit as row_dot's order does on dxm[t] gathered
    in column order (lane l: entries l, l+32, ..., then the butterfly),
    T not a multiple of the pass."""
    rng = np.random.default_rng(B)
    X, K, rows = 120, 30, 24
    vals = rng.normal(size=(rows, K)).astype(np.float32)
    cols = np.sort(np.stack([rng.choice(X, K, replace=False)
                             for _ in range(rows)]), 1)
    dxm = rng.normal(size=(5, B, X)).astype(np.float32)
    dxm[rng.random(dxm.shape) < 0.3] = 0.0
    ax = project(vals, cols, dxm, nb)
    deltas = np.diff(cols, axis=1, prepend=0)
    for t in range(5):
        S = np.zeros((X, nb), np.float32)
        S[:, :B] = dxm[t].T
        want = row_sums(vals, deltas, K, S, 0, 0, nb, 8, rotate=False)
        np.testing.assert_array_equal(ax[t].view(np.uint32),
                                      want[:, :B].view(np.uint32))


@pytest.mark.parametrize("B,nb", [(3, 4), (8, 8), (16, 16)])
def test_staged_recurrence_is_row_dots_order(B, nb):
    """h's planes (NB/4 pieces repeated over the bank row), read a piece
    (j + lane) % 8 at a time and unrotated, give Sh@dhm bit for bit as
    row_dot's order on dhm gathered in column order."""
    rng = np.random.default_rng(20 + B)
    H, K, rows = 64, 32, 16
    vals = rng.normal(size=(rows, K)).astype(np.float32)
    cols = np.sort(np.stack([rng.choice(H, K, replace=False)
                             for _ in range(rows)]), 1)
    dh = rng.normal(size=(B, H)).astype(np.float32)
    got = staged_sums(vals, cols, h_planes(dh, nb), nb // 4)[:, :B]
    S = np.zeros((H, nb), np.float32)
    S[:, :B] = dh.T
    want = row_sums(vals, np.diff(cols, axis=1, prepend=0), K, S, 0, 0, nb,
                    8, rotate=False)[:, :B]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
