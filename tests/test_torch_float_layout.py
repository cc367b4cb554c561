"""The arithmetic of the staged float kernels on x and h (B3
``fused_brds_lstm_step``, B1 ``rb_dual_spmv`` and the single-family B11
``rb_spmv``: ``csrc/brds_common.cuh`` ``stream_rows_block`` with the
``F32Src`` operand, ``stage_family``, ``row_dot_stream``), modelled in
numpy on the CPU with the float delta steps' model
(``test_torch_delta_layout``): x and h staged as they are, a column's NB
floats at ``stage_pos`` (a family too wide to stage gathered in batch
order), a warp's rows streamed as groups of G chunks of 32 entries, each
chunk's columns by a warp scan of its deltas, a lane's staged loads in
NB/4 16-byte pieces rotated by its lane index and put back once a row, and
row_dot's sums (lane l: entries l, l+32, ... in order, one fma a batch
row, then the xor butterfly), ax and ah apart, then z = (ax + ah) + bias;
B11 the same stream over x alone. The columns must be the JAX packing's,
each staged position the bits of its column of x or h, and z and, through
the cell, (c, h) the JAX package's ``rb_dual_spmv`` and
``fused_brds_lstm_step``, and y its ``rb_spmv`` (Pallas in interpret mode,
and its plain reference) within their tolerance. The kernels themselves
run only on the card (``chip_smoke.py`` holds B3 bitwise against B1 ->
lstm_gates, B12 against B3, and B11's two sums plus the bias against
B1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import (RowBalancedSparse, _delta_dtype,
                                pack_from_dense, pad_packed)
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.plan import stage_pos, staged_cols, stream_plan
from repro_torch.models import packed_from_numpy

from test_torch_delta_layout import (WARP, _cell, _packed, chunks_of,
                                     decode, row_sums)

ATOL = 1e-5        # z: float32 sums in the warp's order vs the reference's
CELL_ATOL = 1e-5   # c, h: the cell's inputs differ by at most z's rounding


def stage_f32(a, nb: int, shift: int, slot_bits: int, npad: int):
    """stage_family on F32Src: column c's NB values a[b, c] (zero past B)
    at stage_pos(c), the bits as they are."""
    B, n = a.shape
    S = np.zeros((npad, nb), np.float32)
    S[stage_pos(np.arange(n), shift, slot_bits), :B] = a.T
    return S


def staged_columns(n: int, nb: int, aligned: bool, threads: int = 512):
    """The columns each thread of stage_family writes: four a thread
    (16-byte loads of each batch row) up to 8 batch rows when n is a
    multiple of 4 and the rows are 16-byte aligned, else one."""
    if nb <= 8 and n % 4 == 0 and aligned:
        return [[4 * c4 + i for c4 in range(t, n // 4, threads)
                 for i in range(4)] for t in range(threads)]
    return [list(range(t, n, threads)) for t in range(threads)]


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16])
def test_staged_positions_hold_each_columns_bits(B):
    """Each staged position holds the bits of x (or h) at its column:
    -0, infinities and NaN as they are (a copy, not a product), zero past
    B; positions are distinct and within the plan's padded count, for x
    and for h."""
    rng = np.random.default_rng(B)
    X, H = 300, 160
    p = stream_plan(X=X, H=H, R=4 * H, B=B, Kx=75, Kh=80, fused=True)
    for a, shift, npad in ((rng.normal(size=(B, X)), p.shift_x, p.xpad),
                           (rng.normal(size=(B, H)), p.shift_h, p.hpad)):
        a = a.astype(np.float32)
        a[0, :4] = (-0.0, np.inf, -np.inf, np.nan)
        n = a.shape[1]
        pos = stage_pos(np.arange(n), shift, p.slot_bits)
        assert len(set(pos.tolist())) == n and pos.max() < npad
        S = stage_f32(a, p.nb, shift, p.slot_bits, npad)
        np.testing.assert_array_equal(S[pos, :B].T.view(np.uint32),
                                      a.view(np.uint32))
        assert not S[pos, B:].any()


@pytest.mark.parametrize("n,nb,aligned", [(1500, 8, True), (1500, 4, True),
                                          (1500, 16, True), (1500, 8, False),
                                          (97, 8, True), (64, 4, True),
                                          (70000, 4, True)])
def test_staging_writes_every_column_once(n, nb, aligned):
    """Four columns a thread with 16-byte loads (NB ≤ 8, n a multiple of
    4, aligned rows: lstm_ptb's x and h at B ≤ 8) or one column a thread
    (NB = 16, an odd width, an embedding row handed in as a misaligned
    slice): every column written exactly once, so a misaligned x stages
    the same bits as an aligned one."""
    cols = [c for t in staged_columns(n, nb, aligned) for c in t]
    assert sorted(cols) == list(range(n))
    four = nb <= 8 and n % 4 == 0 and aligned
    assert max(map(len, staged_columns(n, nb, aligned))) == (
        4 * -(-n // 2048) if four else -(-n // 512))


# (K, ncols): the float kernels' families at chip_smoke's shapes: lstm_ptb
# (W_x 375, W_h 750 of 1500), the tall shape's W_x (16 of 64, int8
# deltas) and W_h (2000 of 4000), the small one (25 of 100, 48 of 97)
FLOAT_LAYOUTS = [(375, 1500), (750, 1500), (16, 64), (2000, 4000),
                 (25, 100), (48, 97)]


@pytest.mark.parametrize("K,ncols", FLOAT_LAYOUTS)
def test_columns_and_lane_order_at_the_float_shapes(K, ncols):
    """At the float kernels' shapes, with the group size of each batch
    tier: every live entry's column is the JAX packing's index, and lane l
    takes exactly entries l, l+32, ... of its row, in order."""
    rng = np.random.default_rng(K + ncols)
    s = _packed(rng, 48, ncols, K)
    deltas = np.asarray(s.deltas)
    want = np.asarray(s.col_indices())
    for nb in (4, 8, 16):
        entry, live, col = decode(deltas, K, chunks_of(nb))
        got = np.zeros((48, K), np.int64)
        got[:, entry[0][live[0]]] = col[:, live[0]]
        np.testing.assert_array_equal(got, want)
        for lane in range(WARP):
            seq = entry[0, :, lane][live[0, :, lane]]
            assert seq.tolist() == list(range(lane, K, WARP))


def test_rotated_reads_give_the_unrotated_sums():
    """A staged family read in lane-rotated pieces and put back once a row
    sums to exactly what the same family read in batch order gives (the
    gathered form): the rotation moves registers, not the order of any
    batch row's adds."""
    rng = np.random.default_rng(5)
    B, n, K = 16, 300, 75
    s = _packed(rng, 24, n, K)
    a = rng.normal(size=(B, n)).astype(np.float32)
    p = stream_plan(X=n, H=n, R=4 * n, B=B, Kx=K, Kh=K, fused=True)
    vals, deltas = np.asarray(s.values), np.asarray(s.deltas)
    G = chunks_of(p.nb)
    staged = row_sums(vals, deltas, K, stage_f32(a, p.nb, p.shift_x,
                                                 p.slot_bits, p.xpad),
                      p.shift_x, p.slot_bits, p.nb, G)
    gathered = row_sums(vals, deltas, K, stage_f32(a, p.nb, 0, 0, n), 0, 0,
                        p.nb, G, rotate=False)
    np.testing.assert_array_equal(staged.view(np.uint32),
                                  gathered.view(np.uint32))


def _halved(rng, rows: int, ncols: int, scale: float):
    """A JAX packing of K = ncols / 2 entries a row, one of each pair of
    columns (2i, 2i + 1) at random, built without the dense matrix (which
    at the tall shape, 16000 x 4000, takes the reference's prune a
    minute)."""
    K = ncols // 2
    cols = 2 * np.arange(K) + rng.integers(0, 2, (rows, K))
    deltas = np.diff(cols, axis=1, prepend=0)
    return RowBalancedSparse(
        values=jnp.asarray((rng.normal(size=(rows, K)) * scale)
                           .astype(np.float32)),
        deltas=jnp.asarray(deltas.astype(_delta_dtype(ncols, K))),
        ncols=ncols)


def _case(seed, B, X, H):
    rng = np.random.default_rng(seed)
    arr = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    sx = pad_packed(pack_from_dense(jnp.asarray(arr(4 * H, X, sc=X ** -0.5)),
                                    0.75))
    sh = pad_packed(
        _halved(rng, 4 * H, H, H ** -0.5) if H > 1000 else
        pack_from_dense(jnp.asarray(arr(4 * H, H, sc=H ** -0.5)), 0.5))
    return sx, sh, dict(x=arr(B, X), h=arr(B, H), b=arr(4 * H, sc=0.1),
                        c=arr(B, H))


def model_z(sx, sh, a, fused: bool, units):
    """The modelled kernel's z = (ax + ah) + bias at the plan's layout,
    each family staged or gathered as the plan says, over the four gate
    rows of hidden units ``units`` (B, 4 len(units)) grouped [f; i; g;
    o]."""
    B, X = a["x"].shape
    H = a["h"].shape[1]
    R = 4 * H
    Kx, Kh = sx.values.shape[1], sh.values.shape[1]
    p = stream_plan(X=X, H=H, R=R, B=B, Kx=Kx, Kh=Kh, fused=fused)
    G = chunks_of(p.nb)
    rows = np.concatenate([g * H + units for g in range(4)])
    sums = []
    for s, K, v, staged, shift, npad in (
            (sx, Kx, a["x"], p.stage_x, p.shift_x, p.xpad),
            (sh, Kh, a["h"], p.stage_h, p.shift_h, p.hpad)):
        n = v.shape[1]
        if staged:
            S = stage_f32(v, p.nb, shift, p.slot_bits, npad)
            layout = (shift, p.slot_bits)
        else:
            S = stage_f32(v, p.nb, 0, 0, n)
            layout = (0, 0)
        sums.append(row_sums(np.asarray(s.values)[rows],
                             np.asarray(s.deltas)[rows], K, S, *layout,
                             p.nb, G, rotate=staged,
                             narrow=n < 65536)[:, :B].T)
    return (sums[0] + sums[1]) + a["b"][None, rows], p


# (B, X, H): NB = 4, 8, 16; int8 deltas (X, H ≤ 128) and int16; the tall
# shape (h too wide to stage at NB = 16: gathered)
SHAPES = [(1, 100, 96), (3, 100, 96), (8, 300, 160), (12, 200, 130),
          (16, 64, 100), (12, 64, 4000)]


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("B,X,H", SHAPES)
def test_modelled_sums_match_jax(B, X, H, jbackend):
    """The modelled B1 (z) and B3 (z, then the cell) against the JAX
    package's rb_dual_spmv and fused_brds_lstm_step and the port's plain
    version; the modelled fused step's z is the modelled chained one's
    bit for bit (one routine, the same rows). Every hidden unit is
    modelled, but at the tall shape one in 101 (its 16000 rows of 2000
    entries would take minutes in numpy), whose W_h is built without the
    dense matrix (``_halved``)."""
    sx, sh, a = _case(B + X + H, B, X, H)
    units = np.arange(0, H, 101 if H > 1000 else 1)
    rows = np.concatenate([g * H + units for g in range(4)])
    z1, p1 = model_z(sx, sh, a, False, units)
    z3, p3 = model_z(sx, sh, a, True, units)
    np.testing.assert_array_equal(z1.view(np.uint32), z3.view(np.uint32))
    assert (p1.stage_x, p1.stage_h) == (p3.stage_x, p3.stage_h)
    if H == 4000:
        assert p3.stage_x and not p3.stage_h
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = np.asarray(jops.rb_dual_spmv(sx, j["x"], sh, j["h"], j["b"],
                                        backend=jbackend))
    np.testing.assert_allclose(z1, want[:, rows], rtol=0, atol=ATOL)
    tsx, tsh = (packed_from_numpy(s.values, s.deltas, s.ncols, s.pad,
                                  s.block_rows) for s in (sx, sh))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plain = ops.rb_dual_spmv(tsx, t["x"], tsh, t["h"], t["b"], backend="ref")
    np.testing.assert_allclose(z1, plain.numpy()[:, rows], rtol=0,
                               atol=ATOL)
    jc, jh = jops.fused_brds_lstm_step(sx, j["x"], sh, j["h"], j["b"],
                                       j["c"], backend=jbackend)
    cn, hn = _cell(z3, a["c"][:, units], len(units))
    np.testing.assert_allclose(cn, np.asarray(jc)[:, units], rtol=0,
                               atol=CELL_ATOL)
    np.testing.assert_allclose(hn, np.asarray(jh)[:, units], rtol=0,
                               atol=CELL_ATOL)


def model_y(s, v, rows):
    """The modelled single-family kernel (B11 rb_spmv) y = S@v over packed
    rows ``rows`` of s (B, len(rows)) at the single-family plan's layout:
    v staged or gathered as the plan says, one stream of Sx segments."""
    B, n = v.shape
    vals, deltas = np.asarray(s.values), np.asarray(s.deltas)
    K = vals.shape[1]
    p = stream_plan(X=n, R=s.rows, B=B, Kx=K)
    assert p.families == 1 and not p.stage_h
    if p.stage_x:
        S, layout = stage_f32(v, p.nb, p.shift_x, p.slot_bits, p.xpad), (
            p.shift_x, p.slot_bits)
    else:
        S, layout = stage_f32(v, p.nb, 0, 0, n), (0, 0)
    y = row_sums(vals[rows], deltas[rows], K, S, *layout, p.nb,
                 chunks_of(p.nb), rotate=p.stage_x, narrow=n < 65536)
    return y[:, :B].T, p


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("B,X,H", SHAPES)
def test_modelled_single_family_sums_match_jax(B, X, H, jbackend):
    """The modelled B11 on W_x at x and on W_h at h against the JAX
    package's rb_spmv (Pallas, interpret mode, and its plain reference)
    and the port's plain version; and the two modelled sums plus the bias,
    added in that order, equal the modelled B1's z bit for bit (one
    routine, row_dot's order, whichever family is staged). At the tall
    shape one hidden unit in 101 is modelled, W_h is gathered."""
    sx, sh, a = _case(B + X + H, B, X, H)
    units = np.arange(0, H, 101 if H > 1000 else 1)
    rows = np.concatenate([g * H + units for g in range(4)])
    ys = []
    for s, v in ((sx, a["x"]), (sh, a["h"])):
        y, p = model_y(s, v, rows)
        if H == 4000:
            assert p.stage_x == (v.shape[1] == 64)
        want = np.asarray(jops.rb_spmv(s, jnp.asarray(v), backend=jbackend))
        np.testing.assert_allclose(y, want[:, rows], rtol=0, atol=ATOL)
        ts = packed_from_numpy(s.values, s.deltas, s.ncols, s.pad,
                               s.block_rows)
        plain = ops.rb_spmv(ts, torch.from_numpy(v), backend="ref")
        np.testing.assert_allclose(y, plain.numpy()[:, rows], rtol=0,
                                   atol=ATOL)
        ys.append(y)
    z1, _ = model_z(sx, sh, a, False, units)
    np.testing.assert_array_equal(
        ((ys[0] + ys[1]) + a["b"][None, rows]).view(np.uint32),
        z1.view(np.uint32))


def test_wide_input_is_gathered_and_scanned_a_chunk_a_word():
    """chip_smoke's very wide shape (B=3, X=70000, H=64): x's 70000
    columns do not fit beside the sums, so they are gathered, and past
    65535 columns a chunk's scan takes a whole word; the modelled sums of
    a wide row still match the unpacked product."""
    p = stream_plan(X=70000, H=64, R=256, B=3, Kx=17500, Kh=32, fused=True)
    assert not p.stage_x and p.stage_h
    assert p.smem == p.hpad * 16 + 2 * p.rows * 16
    assert p.hpad == staged_cols(64, p.shift_h, p.slot_bits)
    rng = np.random.default_rng(70)
    cols = np.sort(rng.choice(70000, 40, replace=False))
    deltas = np.diff(cols, prepend=0)[None, :]
    vals = rng.normal(size=(1, 40)).astype(np.float32)
    x = rng.normal(size=(3, 70000)).astype(np.float32)
    got = row_sums(vals, deltas, 40, stage_f32(x, 4, 0, 0, 70000), 0, 0, 4,
                   chunks_of(4), rotate=False, narrow=False)[0, :3]
    np.testing.assert_allclose(got, x[:, cols] @ vals[0], rtol=0, atol=ATOL)
