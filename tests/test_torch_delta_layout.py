"""The arithmetic of the float delta steps' row routine
(``csrc/brds_common.cuh``: ``stream_rows_block``, ``row_dot_stream``,
``f32_consume``; B4 ``delta_rb_dual_spmv`` and B5
``fused_brds_delta_lstm_step``), modelled in numpy on the CPU: a warp's
rows streamed as groups of G chunks of 32 entries across family and row
boundaries, each chunk's columns by a five-step warp scan of its deltas
plus the carry of the chunks before it, the masked deltas d·f staged at
``stage_pos`` as a column's NB floats, read by a lane in NB/4 16-byte
pieces rotated by its lane index and put back in order once a row, and
row_dot's sums (lane l: entries l, l+32, ... in order, one fma a batch
row, then the xor butterfly). The columns must be the JAX packing's
(``repro.core.packing``), each staged position the bits of its column's
d·f, and the sums, through m' = (m + ax) + ah, z = m' + bias and the cell,
the JAX package's delta kernels (Pallas in interpret mode, and its plain
reference) within their tolerance. The kernels themselves run only on the
card (``chip_smoke.py`` holds them bitwise against their chain and the
delta scan)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack, pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.plan import stage_pos, stream_plan
from repro_torch.models import packed_from_numpy

from test_torch_plan import _unrotate

WARP = 32
KERNEL_ATOL = 2e-5   # the reference's own delta-kernel tolerance
CELL_ATOL = 1e-5


def chunks_of(nb: int) -> int:
    """brds_common.cuh kStreamChunks: chunks a group, by accumulators."""
    return {4: 8, 8: 8, 16: 4}[nb]


def stream_order(nrows: int, K: tuple, G: int, warp: int = 0,
                 nwarps: int = 16):
    """row_dot_stream's control flow for one warp: the (row, family,
    first chunk) of each group it consumes, in order, and for each the
    group it loads before consuming it (None at the end)."""
    K = tuple(K)
    i, part, c0 = warp, 0, 0
    out = []
    if i >= nrows:
        return out
    while True:
        nchunks = -(-K[part] // WARP)
        i2, part2, c2 = i, part, c0 + G
        if c2 >= nchunks:
            c2, part2 = 0, part ^ 1
            if part:
                i2 += nwarps
        more = i2 < nrows
        out.append(((i, part, c0), (i2, part2, c2) if more else None))
        if not more:
            return out
        i, part, c0 = i2, part2, c2


def decode(deltas, K: int, G: int, narrow: bool = True):
    """f32_columns' columns for rows of K entries ((rows, K) deltas):
    (entry, live, col), each (rows, chunks, 32): chunk c, lane l takes entry
    32 c + l (delta 0 past K); a group past K is skipped; a group's chunks
    are scanned (shfl_up, offsets 1-16), ``narrow``: chunks 2q and 2q + 1 in
    one 32-bit word (2q low), then chunk by chunk col = scan + carry and
    the carry grows by lane 31's scan."""
    rows = deltas.shape[0]
    nch = max(1, -(-K // WARP))
    C = -(-nch // G) * G
    d = np.zeros((rows, C * WARP), np.int64)
    d[:, :K] = deltas
    d = d.reshape(rows, C, WARP)
    entry = np.arange(C * WARP).reshape(C, WARP)
    live = entry < K
    col = np.zeros_like(d)
    carry = np.zeros((rows, 1), np.int64)

    def scan(s, mask):
        for o in (1, 2, 4, 8, 16):
            up = np.zeros_like(s)
            up[..., o:] = s[..., :-o]
            s = (s + up) & mask
        return s

    for c0 in range(0, C, G):
        if c0 * WARP >= K:
            continue
        if narrow:
            s = scan(d[:, c0:c0 + G:2] | d[:, c0 + 1:c0 + G:2] << 16,
                     0xFFFFFFFF)
            halves = [s & 0xFFFF, s >> 16]
            for u in range(G):
                h = halves[u % 2][:, u // 2]
                col[:, c0 + u] = h + carry
                carry = carry + h[:, -1:]
        else:
            s = scan(d[:, c0:c0 + G], -1)
            for u in range(G):
                col[:, c0 + u] = s[:, u] + carry
                carry = carry + s[:, u, -1:]
    return (np.broadcast_to(entry, d.shape), np.broadcast_to(live, d.shape),
            col)


def _packed(rng, rows, ncols, K):
    """The JAX package's packing of a random row-balanced pattern with K
    entries a row."""
    mask = np.zeros((rows, ncols), bool)
    for r in range(rows):
        mask[r, rng.choice(ncols, K, replace=False)] = True
    w = rng.normal(size=(rows, ncols)).astype(np.float32)
    return pack(jnp.asarray(w), jnp.asarray(mask))


# (K, ncols): rows of one entry, K below, at and past a chunk and a group,
# not a multiple of 32; int8 deltas (ncols ≤ 128) and int16; lstm_ptb's
# W_x and W_h rows (375 and 750 of 1500)
LAYOUTS = [(1, 4), (1, 300), (25, 100), (32, 100), (48, 96), (75, 300),
           (257, 600), (375, 1500), (750, 1500)]


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("K,ncols", LAYOUTS)
def test_stream_columns_equal_the_unpacked_indices(K, ncols, G, narrow):
    """Every live entry's column is the JAX packing's index, each entry is
    taken by exactly one lane, with two chunks scanned in one word (a
    narrow family) or one a word, for lstm_ptb's 6000-row families too
    (fewer rows for the small ones)."""
    rng = np.random.default_rng(K * 7 + ncols)
    rows = 6000 if ncols == 1500 else 24
    s = _packed(rng, rows, ncols, K)
    deltas = np.asarray(s.deltas)
    assert deltas.dtype == (np.int8 if ncols <= 128 else np.int16)
    entry, live, col = decode(deltas, K, G, narrow)
    want = np.asarray(s.col_indices())
    assert (np.bincount(entry[0][live[0]], minlength=K) == 1).all()
    got = np.zeros((rows, K), np.int64)
    got[:, entry[0][live[0]]] = col[:, live[0]]
    np.testing.assert_array_equal(got, want)


def test_wide_families_scan_one_chunk_a_word():
    """Columns past 65535 would carry out of a word's low half: the kernels
    scan two chunks in one word only for families of fewer than 65536
    columns (``delta_rows_block``'s narrow flag), one a word beyond."""
    deltas = np.array([[3, 69997] + [1] * 40], np.int64)   # up to 70040
    want = np.cumsum(deltas, axis=1)
    for G in (4, 8):
        entry, live, col = decode(deltas, 42, G, narrow=False)
        np.testing.assert_array_equal(col[0][live[0]], want[0])
        entry, live, col = decode(deltas, 42, G, narrow=True)
        assert (col[0][live[0]] != want[0]).any()


@pytest.mark.parametrize("K", [1, 31, 33, 375, 750])
def test_each_lane_takes_its_entries_in_order(K):
    """Lane l of the warp that owns a row takes exactly entries l, l+32,
    ... of it, in that order (the order row_dot's sums need), whatever the
    group size."""
    for G in (4, 8):
        entry, live, _ = decode(np.zeros((1, K), np.int64), K, G)
        for lane in range(WARP):
            seq = entry[0, :, lane][live[0, :, lane]]
            assert seq.tolist() == list(range(lane, K, WARP))


@pytest.mark.parametrize("nrows,K", [(48, (375, 750)), (3, (25, 48)),
                                     (124, (16, 2000)), (4, (8250, 49)),
                                     (20, (0, 0)), (7, (1, 1))])
def test_stream_visits_every_group_once_across_rows_and_families(nrows, K):
    """A warp's stream (rows w, w + 16, ...; each row's Sx segment, then
    its Sh segment) consumes every group of its rows exactly once, in row,
    family, chunk order, and each group's loads are those the step before
    issued: a warp always has the next group in flight, across segment and
    row boundaries. Families of no entries still take one (empty) group, so
    every row is emitted."""
    for G in (4, 8):
        for warp in range(16):
            got = stream_order(nrows, K, G, warp)
            want = [(i, part, c0) for i in range(warp, nrows, 16)
                    for part in (0, 1)
                    for c0 in range(0, max(1, -(-K[part] // WARP)), G)]
            assert [g for g, _ in got] == want
            assert [n for _, n in got[:-1]] == want[1:]
            assert not got or got[-1][1] is None


def stage(d, f, nb: int, shift: int, slot_bits: int, npad: int):
    """stage_delta: column c's NB products d[b, c] * f[b, c] (float32,
    correctly rounded as __fmul_rn; zero past B) at stage_pos(c)."""
    B, n = d.shape
    S = np.zeros((npad, nb), np.float32)
    S[stage_pos(np.arange(n), shift, slot_bits), :B] = (d * f).T
    return S


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16])
def test_staged_positions_hold_each_columns_masked_delta_bits(B):
    """Each column's staged vector holds the bits of d·f, DeltaAct's
    operand (-0 where a negative delta did not fire, NaN for an unfired
    infinity), not those of ``f ? d : 0``; positions are distinct and
    within the plan's padded count."""
    rng = np.random.default_rng(B)
    X = 300
    d = rng.normal(size=(B, X)).astype(np.float32)
    d[0, :4] = (-0.0, -1.5, np.inf, -np.inf)
    f = (rng.random((B, X)) < 0.5).astype(np.float32)
    f[0, :4] = 0.0
    p = stream_plan(X=X, H=X, R=4 * X, B=B, Kx=75, Kh=150, fused=True)
    pos = stage_pos(np.arange(X), p.shift_x, p.slot_bits)
    assert len(set(pos.tolist())) == X and pos.max() < p.xpad
    with np.errstate(invalid="ignore"):   # inf * 0
        S = stage(d, f, p.nb, p.shift_x, p.slot_bits, p.xpad)
        want = (d * f).view(np.uint32)
    np.testing.assert_array_equal(S[pos, :B].T.view(np.uint32), want)
    assert not S[pos, B:].any()
    select = np.where(f != 0, d, np.float32(0)).view(np.uint32)
    assert (want[0, :4] != select[0, :4]).all()


@pytest.mark.parametrize("nb", [4, 8, 16])
def test_rotated_pieces_come_back_in_batch_order(nb):
    """A lane's j-th load of a staged column takes piece (j + lane) % (NB /
    4); its accumulators in that order, unrotated once a row, are in batch
    order for every lane."""
    nq = nb // 4
    for lane in range(WARP):
        rot = lane & (nq - 1)
        held = [(j + rot) % nq for j in range(nq)]
        assert _unrotate(held, rot) == list(range(nq))


def _fma32(acc, v, a):
    """float32 fmaf, emulated: the product exact in float64, one rounding
    of the sum to float32 after float64's (a double rounding in rare
    ties: the model is held to tolerances, not bits)."""
    return (v.astype(np.float64) * a + acc).astype(np.float32)


def row_sums(vals, deltas, K, S, shift, slot_bits, nb, G, rotate=True,
             narrow=True):
    """The (rows, NB) sums row_dot_stream leaves for one family: lane l's
    accumulators over its entries in order (staged activations read in
    rotated pieces, unrotated at the row's end; ``rotate=False``: a
    gathered family, read in batch order from S in column order), then the
    xor butterfly."""
    rows = vals.shape[0]
    nq = nb // 4
    entry, live, col = decode(deltas, K, G, narrow)
    v = np.zeros((rows,) + entry.shape[1:], np.float32)
    v.reshape(rows, -1)[:, :K] = vals
    rot = (np.arange(WARP) & (nq - 1)) * rotate
    acc = np.zeros((rows, WARP, nb), np.float32)   # rotated order
    for c in range(entry.shape[1]):
        on = live[0, c]
        pos = stage_pos(col[:, c], shift, slot_bits)        # (rows, 32)
        a = S[pos].reshape(rows, WARP, nq, 4)
        a = a[:, np.arange(WARP)[:, None],
              (np.arange(nq)[None, :] + rot[:, None]) % nq]
        new = _fma32(acc, v[:, c, :, None], a.reshape(rows, WARP, nb))
        acc = np.where(on[None, :, None], new, acc)
    for lane in range(WARP):
        pieces = acc[:, lane].reshape(rows, nq, 4).transpose(1, 0, 2)
        acc[:, lane] = np.stack(_unrotate(list(pieces), rot[lane]),
                                1).reshape(rows, nb)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(WARP) ^ o]
    assert (acc == acc[:, :1]).all()   # every lane, one total
    return acc[:, 0]


def _case(seed, B, X, H):
    rng = np.random.default_rng(seed)
    arr = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    sx = pad_packed(pack_from_dense(jnp.asarray(arr(4 * H, X, sc=X ** -0.5)),
                                    0.75))
    sh = pad_packed(pack_from_dense(jnp.asarray(arr(4 * H, H, sc=H ** -0.5)),
                                    0.5))
    a = dict(dx=arr(B, X, sc=0.5), dh=arr(B, H, sc=0.3),
             fx=(rng.random((B, X)) < 0.5).astype(np.float32),
             fh=(rng.random((B, H)) < 0.5).astype(np.float32),
             m=arr(B, 4 * H), b=arr(4 * H, sc=0.1), c=arr(B, H))
    return sx, sh, a


def model_m(sx, sh, a, fused: bool):
    """The modelled kernel's m' = (m + ax) + ah at the plan's layout."""
    B, X = a["dx"].shape
    H = a["dh"].shape[1]
    R = 4 * H
    Kx, Kh = sx.values.shape[1], sh.values.shape[1]
    p = stream_plan(X=X, H=H, R=R, B=B, Kx=Kx, Kh=Kh, fused=fused)
    G = chunks_of(p.nb)
    sums = []
    for s, K, d, f, shift, npad in (
            (sx, Kx, a["dx"], a["fx"], p.shift_x, p.xpad),
            (sh, Kh, a["dh"], a["fh"], p.shift_h, p.hpad)):
        S = stage(d, f, p.nb, shift, p.slot_bits, npad)
        sums.append(row_sums(np.asarray(s.values)[:R],
                             np.asarray(s.deltas)[:R], K, S, shift,
                             p.slot_bits, p.nb, G)[:, :B].T)
    return (a["m"] + sums[0]) + sums[1]


def _cell(z, c, H):
    """The exact cell on z (B, 4H) grouped [f; i; g; o], in float64."""
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    zf, zi, zg, zo = (z[:, i * H:(i + 1) * H].astype(np.float64)
                      for i in range(4))
    cn = sig(zf) * c + sig(zi) * np.tanh(zg)
    return cn, sig(zo) * np.tanh(cn)


# (B, X, H): NB = 4, 8, 16; int8 deltas (X, H ≤ 128) and int16
SHAPES = [(3, 100, 96), (8, 100, 96), (12, 300, 160), (16, 200, 130)]


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("B,X,H", SHAPES)
def test_modelled_sums_match_jax(B, X, H, jbackend):
    """The modelled B4 (m') and B5 (m', then z = m' + bias and the cell)
    against the JAX package's delta_rb_dual_spmv and
    fused_brds_delta_lstm_step, and against the port's plain version; the
    model of B4 and of B5 give the same m' (one routine)."""
    sx, sh, a = _case(B + X + H, B, X, H)
    m4 = model_m(sx, sh, a, fused=False)
    m5 = model_m(sx, sh, a, fused=True)
    np.testing.assert_array_equal(m4, m5)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jargs = (sx, j["dx"], j["fx"], sh, j["dh"], j["fh"], j["m"])
    want = np.asarray(jops.delta_rb_dual_spmv(*jargs, backend=jbackend))
    np.testing.assert_allclose(m4, want, rtol=0, atol=KERNEL_ATOL)
    tsx, tsh = (packed_from_numpy(s.values, s.deltas, s.ncols, s.pad,
                                  s.block_rows) for s in (sx, sh))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plain = ops.delta_rb_dual_spmv(tsx, t["dx"], t["fx"], tsh, t["dh"],
                                   t["fh"], t["m"], backend="ref")
    np.testing.assert_allclose(m4, plain.numpy(), rtol=0, atol=KERNEL_ATOL)
    jc, jh, jm = jops.fused_brds_delta_lstm_step(*jargs, j["b"], j["c"],
                                                 backend=jbackend)
    np.testing.assert_allclose(m5, np.asarray(jm), rtol=0, atol=KERNEL_ATOL)
    cn, hn = _cell(m5 + a["b"][None, :], a["c"], H)
    np.testing.assert_allclose(cn, np.asarray(jc), rtol=0, atol=CELL_ATOL)
    np.testing.assert_allclose(hn, np.asarray(jh), rtol=0, atol=CELL_ATOL)
