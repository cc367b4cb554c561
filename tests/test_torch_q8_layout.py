"""The index and sum arithmetic of the staged q8 kernels' row routine
(``csrc/brds_common.cuh``: ``row_dot_q8x4``, ``q8_rows_stream``,
``q8_rows_block``; B8, B9, B7 ``rb_dual_parts_q8`` and, in the routine's
single-family form, B10 ``rb_spmv_q8``), modelled in numpy on
the CPU: four consecutive entries a lane counted from the 4-aligned element
at or before a row's start (the head of an unaligned row and the tail past
K count as code 0, delta 0), the in-register prefix of a lane's four
deltas, the warp's shuffle scan of the 32 chunk sums, the 4x4 byte
transpose that pairs the entries' activation codes with their weights, and
``__dp4a``'s wrapping int32 sums (IMADs for int16 codes); and B7's block:
contiguous rows a block, warp w taking rows w, w+16, ..., each row's Sx
then Sh segment one stream of chunk groups, zx and zh dequantized apart and
written out coalesced; and B10's block, the same with the Sx family and
its codes alone; and the staging of the codes, four columns a thread
(one load of four codes a batch row, byte transposes) or one. The
columns must equal the JAX package's unpacked indices
(``repro.core.packing``), and the sums, dequantized, the port's plain
version (``kernels/ref.py::rb_spmv_q8_ref``) and the JAX
``rb_dual_parts_q8`` and ``rb_spmv_q8`` bit for bit; with the delta-q8
step's epilogue, m' and the cell the JAX package's fused delta-q8 step. The kernels themselves run
only on the card (``chip_smoke.py`` holds them exact against the same
plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack, pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.quant import formats as jqf
from repro_torch.kernels import ref
from repro_torch.kernels.plan import q8_plan, stage_pos, staged_cols
from repro_torch.models import packed_from_numpy
from repro_torch.quant import quantize_packed

WARP = 32
M32 = 0xFFFFFFFF


def _packed(rng, rows, ncols, K):
    """The JAX package's packing of a random row-balanced pattern with K
    entries a row."""
    mask = np.zeros((rows, ncols), bool)
    for r in range(rows):
        mask[r, rng.choice(ncols, K, replace=False)] = True
    w = rng.normal(size=(rows, ncols)).astype(np.float32)
    return pack(jnp.asarray(w), jnp.asarray(mask))


def layout(deltas, offs, K):
    """row_dot_q8x4's chunks for rows starting at elements ``offs`` of the
    flat delta array: (entry, live, col), each (rows, windows, 32 lanes,
    4): a chunk's row-relative entries, which of them lie in the row, and
    the column the lane computes for each (its in-register prefix plus the
    warp scan's exclusive offset plus the carry of earlier windows)."""
    offs = np.asarray(offs, np.int64)
    heads = offs % 4
    nch = (heads + K + 3) >> 2
    W = max(1, -(-int(nch.max()) // WARP))
    chunk = np.arange(W * WARP).reshape(W, WARP)
    e = (4 * chunk[None, :, :, None] - heads[:, None, None, None]
         + np.arange(4))
    live = (e >= 0) & (e < K)
    at = offs[:, None, None, None] + np.clip(e, 0, max(K - 1, 0))
    d = np.where(live, deltas[np.minimum(at, deltas.size - 1)], 0)
    d = d.astype(np.int64)
    p = np.cumsum(d, axis=-1)                 # the lane's own prefix
    s = p[..., 3]
    incl = s.copy()
    for o in (1, 2, 4, 8, 16):                # __shfl_up_sync, lane >= o
        up = np.zeros_like(incl)
        up[..., o:] = incl[..., :-o]
        incl = incl + up
    carry = np.cumsum(incl[..., -1], axis=-1) - incl[..., -1]
    base = carry[..., None] + incl - s
    return e, live, base[..., None] + p


def byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on uint32 arrays."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def transpose4x4(w0, w1, w2, w3):
    t0, t1 = byte_perm(w0, w1, 0x5140), byte_perm(w0, w1, 0x7362)
    t2, t3 = byte_perm(w2, w3, 0x5140), byte_perm(w2, w3, 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def _sbytes(w):
    b = ((w[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF)
    return b.astype(np.int64) - 256 * (b >= 128)


def dp4a(a, b, c):
    """``__dp4a`` signed x signed: c + the four byte products, mod 2^32."""
    return (c.astype(np.int64) + (_sbytes(a) * _sbytes(b)).sum(-1)) & M32


def q8x4_lanes(codes, deltas, offs, K, q, shift=0, slot_bits=0):
    """Each lane's wrapping int32 sums (rows, windows, 32 lanes, NB) over
    the windows of 32 chunks of rows starting at ``offs`` (codes and
    deltas flat, q (B, ncols) activation codes of the same type), its
    activation codes fetched from the staged vectors: column c's NB codes
    (zero past B) at stage_pos(c, shift, slot_bits)."""
    B, n = q.shape
    nb = 4 if B <= 4 else 8 if B <= 8 else 16
    e, live, col = layout(deltas, offs, K)
    at = np.asarray(offs)[:, None, None, None] + np.clip(e, 0, max(K - 1, 0))
    w = np.where(live, codes[np.minimum(at, codes.size - 1)], 0)
    w = w.astype(np.int64)
    qq = np.zeros((nb, staged_cols(n, shift, slot_bits)), np.int64)
    qq[:B, stage_pos(np.arange(n), shift, slot_bits)] = q
    col = stage_pos(col, shift, slot_bits)
    acc = np.zeros(w.shape[:3] + (nb,), np.int64)   # (rows, windows, lane)
    if codes.dtype == np.int8:
        # the staged vector of a column: word g holds rows 4g..4g+3
        u8 = (qq & 0xFF).astype(np.uint64)
        words = [u8[4 * g] | u8[4 * g + 1] << 8 | u8[4 * g + 2] << 16
                 | u8[4 * g + 3] << 24 for g in range(nb // 4)]
        wu = (w & 0xFF).astype(np.uint64)
        wword = (wu[..., 0] | wu[..., 1] << 8 | wu[..., 2] << 16
                 | wu[..., 3] << 24)
        for g in range(nb // 4):
            o = transpose4x4(*(words[g][col[..., i]] for i in range(4)))
            for j in range(4):
                acc[..., 4 * g + j] = dp4a(wword, o[j], acc[..., 4 * g + j])
    else:
        for i in range(4):
            acc = (acc + w[..., i, None] * qq.T[col[..., i]]) & M32
    return acc


def warp_total(lanes, B):
    """The xor butterfly over lanes (..., 32, NB): every lane's total, as
    int32, of batch rows b < B."""
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(WARP) ^ o, :]) & M32
    assert (lanes == lanes[..., :1, :]).all()        # every lane, one total
    s = lanes[..., 0, :B]
    return (s - (1 << 32) * (s >= 1 << 31)).astype(np.int32)


def q8x4_sums(codes, deltas, offs, K, q):
    """The int32 sums (rows, B) row_dot_q8x4 leaves in every lane: codes
    and deltas flat, q (B, ncols) activation codes of the same type."""
    lanes = q8x4_lanes(codes, deltas, offs, K, q).sum(axis=1) & M32
    return warp_total(lanes, q.shape[0])


# (K, ncols): K not a multiple of 4, one entry, a whole chunk, one past
# it; int8 deltas (ncols ≤ 128) and int16; lstm_ptb's W_x and W_h rows
LAYOUTS = [(1, 7), (3, 10), (4, 100), (5, 120), (5, 300), (375, 1500),
           (750, 1500)]


@pytest.mark.parametrize("K,ncols", LAYOUTS)
def test_q8x4_columns_equal_the_unpacked_indices(K, ncols):
    """Every row of a packing with K entries a row, at every row offset
    r * K (heads 0-3 when K is odd), and at offsets 1-3 into the array:
    the live entries' columns are the JAX packing's indices, each entry
    taken by exactly one lane, and a dead entry's column is a real one
    (its gather stays inside the staged array)."""
    rng = np.random.default_rng(K * 1000 + ncols)
    rows = 9
    s = _packed(rng, rows, ncols, K)
    want = np.asarray(s.col_indices())
    deltas = np.asarray(s.deltas)
    assert deltas.dtype == (np.int8 if ncols <= 128 else np.int16)
    for shift in (0, 1, 3):
        flat = np.concatenate([np.zeros(shift, deltas.dtype),
                               deltas.ravel()])
        offs = shift + np.arange(rows) * K
        e, live, col = layout(flat, offs, K)
        for r in range(rows):
            got = np.full(K, -1)
            cnt = np.zeros(K, int)
            np.add.at(cnt, e[r][live[r]], 1)
            got[e[r][live[r]]] = col[r][live[r]]
            assert (cnt == 1).all()
            np.testing.assert_array_equal(got, want[r])
            assert ((col[r] >= 0) & (col[r] < ncols)).all()


def _q8_case(rng, rows, ncols, K, spec):
    s = _packed(rng, rows, ncols, K)
    t = packed_from_numpy(s.values, s.deltas, s.ncols, s.pad, s.block_rows)
    q = quantize_packed(t, spec)
    return q


# name: (rows, ncols, K, B): lstm_ptb's W_x and W_h families (6000 gate
# rows of 375 and 750 entries over 1500 columns, B=8), and small ones
# (int8 deltas, K = 5; int16, K = 3) at B = 1 and 16
SUMS = {"lstm_ptb W_x": (6000, 1500, 375, 8),
        "lstm_ptb W_h": (6000, 1500, 750, 8),
        "small int8 deltas": (12, 100, 5, 1),
        "small int16 deltas": (12, 300, 3, 16)}


@pytest.mark.parametrize("spec", ["int8", "q1.11"])
@pytest.mark.parametrize("name", list(SUMS))
def test_q8x4_sums_equal_the_plain_version(name, spec):
    """The modelled kernel's int32 sums, dequantized as the kernel does
    (float32(sum) * scale * act_scale), equal rb_spmv_q8_ref's bit for
    bit; q1.11 activations span all of int16."""
    rows, ncols, K, B = SUMS[name]
    rng = np.random.default_rng(rows + K + B)
    q8 = _q8_case(rng, rows, ncols, K, spec)
    codes = q8.values.numpy().ravel()
    deltas = q8.deltas.numpy().ravel()
    info = np.iinfo(codes.dtype)
    acts = rng.integers(info.min + 1, info.max + 1, size=(B, ncols))
    acts = acts.astype(codes.dtype)
    sums = q8x4_sums(codes, deltas, np.arange(rows) * K, K, acts)
    act_scale = np.float32(0.0123)
    comb = q8.scales.numpy() * act_scale
    got = sums.T.astype(np.float32) * comb[None, :]
    want = ref.rb_spmv_q8_ref(q8, torch.from_numpy(acts), torch.tensor(
        act_scale))
    np.testing.assert_array_equal(got, want.numpy())


def test_transpose_and_dp4a_pair_each_entry_with_its_weight():
    """transpose4x4 turns four entries' code vectors (batch row j in byte
    j) into four batch rows' words (entry i in byte i), the layout of the
    weight word, so one __dp4a adds the four products of one batch row."""
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(4, 4))          # a[entry, batch]
    w = rng.integers(-128, 128, size=4)
    pack = lambda v: np.uint64(sum((int(x) & 0xFF) << (8 * i)
                                   for i, x in enumerate(v)))
    o = transpose4x4(*(np.array([pack(a[i])], np.uint64) for i in range(4)))
    for j in range(4):
        assert int(o[j][0]) == int(pack(a[:, j]))
        got = dp4a(np.array([pack(w)], np.uint64), o[j], np.zeros(1))
        assert int(got[0]) == (int((w * a[:, j]).sum()) & M32)


@pytest.mark.parametrize("shift,slot_bits", [(0, 3), (1, 3), (2, 3), (3, 4),
                                             (4, 4), (4, 5)])
def test_stage_pos_is_a_permutation_that_spreads_lanes(shift, slot_bits):
    """stage_pos permutes each run of 2^(shift + slot_bits) columns (so a
    staged array padded to whole runs holds every column once), and
    columns 2^shift apart, as neighbouring lanes' entries are, land on
    distinct slots of a bank row."""
    n = staged_cols(1500, shift, slot_bits)
    assert n % (1 << (shift + slot_bits)) == 0 and n >= 1500
    pos = stage_pos(np.arange(n), shift, slot_bits)
    assert sorted(pos.tolist()) == list(range(n))
    lanes = 7 + (np.arange(1 << slot_bits) << shift)
    slots = stage_pos(lanes, shift, slot_bits) % (1 << slot_bits)
    assert len(set(slots.tolist())) == 1 << slot_bits


def _cell(z, c, H):
    """The exact cell on z (B, 4H) grouped [f; i; g; o], in float64."""
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    zf, zi, zg, zo = (z[:, i * H:(i + 1) * H].astype(np.float64)
                      for i in range(4))
    cn = sig(zf) * c + sig(zi) * np.tanh(zg)
    return cn, sig(zo) * np.tanh(cn)


@pytest.mark.parametrize("spec", ["int8", "q1.11"])
@pytest.mark.parametrize("B", [3, 8])
def test_delta_q8_epilogue_matches_jax(spec, B):
    """The fused delta-q8 step's lane model: the modelled int32 sums of the
    masked deltas' codes (the JAX package's own codes and packing),
    dequantized per row, then the epilogue's m' = (m + zx) + zh in float32
    and z = m' + bias: m' equals the JAX fused_brds_delta_lstm_step_q8's
    (Pallas, interpret mode) exactly, and the cell on z its c and h within
    1e-5."""
    X, H = 100, 96
    R = 4 * H
    rng = np.random.default_rng(B + len(spec))
    arr = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    jsx = pad_packed(jqf.quantize_packed(pack_from_dense(
        jnp.asarray(arr(R, X, sc=X ** -0.5)), 0.75), spec))
    jsh = pad_packed(jqf.quantize_packed(pack_from_dense(
        jnp.asarray(arr(R, H, sc=H ** -0.5)), 0.5), spec))
    dx, dh = arr(B, X, sc=0.5), arr(B, H, sc=0.3)
    fx, fh = rng.random((B, X)) < 0.5, rng.random((B, H)) < 0.5
    m, bias, c = arr(B, R), arr(R, sc=0.1), arr(B, H)
    scales = (0.05, 0.04)
    jc, jh, jm = jops.fused_brds_delta_lstm_step_q8(
        jsx, jnp.asarray(dx), jnp.asarray(fx), jsh, jnp.asarray(dh),
        jnp.asarray(fh), jnp.asarray(m), jnp.asarray(bias), jnp.asarray(c),
        act_scale_x=scales[0], act_scale_h=scales[1], backend="pallas")
    z = []
    for s, d, f, sc in ((jsx, dx, fx, scales[0]), (jsh, dh, fh, scales[1])):
        codes, act = jops._quant_act(
            jnp.where(jnp.asarray(f), jnp.asarray(d), 0), s, sc)
        K = s.values.shape[1]
        sums = q8x4_sums(np.asarray(s.values)[:R].ravel(),
                         np.asarray(s.deltas)[:R].ravel(), np.arange(R) * K,
                         K, np.asarray(codes))
        comb = np.asarray(s.scales)[:R] * np.float32(act)
        z.append(sums.T.astype(np.float32) * comb[None, :])
    mn = (m + z[0]) + z[1]
    np.testing.assert_array_equal(mn, np.asarray(jm))
    cn, hn = _cell(mn + bias[None, :], c, H)
    np.testing.assert_allclose(cn, np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(hn, np.asarray(jh), atol=1e-5)


def q8_stream_order(nrows, nchunks, G, warp=0, nwarps=16, families=2):
    """q8_rows_stream's control flow for one warp: the (row, family, first
    chunk) of each group of G x 32 chunks it consumes, in order, and the
    group it loads before consuming it (None at the end); nchunks(i,
    part) is row i's chunk count in family part (q8x4_chunks: its head
    peel counted). ``families`` 1 (NF = 1): the Sx segments alone."""
    i, part, c0 = warp, 0, 0
    out = []
    if i >= nrows:
        return out
    while True:
        i2, part2, c2 = i, part, c0 + G * WARP
        if c2 >= nchunks(i, part):
            c2, part2 = 0, (part ^ 1 if families == 2 else 0)
            if families == 1 or part:
                i2 += nwarps
        more = i2 < nrows
        out.append(((i, part, c0), (i2, part2, c2) if more else None))
        if not more:
            return out
        i, part, c0 = i2, part2, c2


def q8_rows_order(nrows, nchunks, warp=0, nwarps=16, families=2):
    """q8_rows' order for one warp (deltas not all int16): row i's Sx row
    through row_dot_q8x4 (groups of 4 x 32 chunks), then its Sh row
    (``families`` 2), then row i + 16's."""
    return [(i, part, c0) for i in range(warp, nrows, nwarps)
            for part in range(families)
            for c0 in range(0, nchunks(i, part), 4 * WARP)]


def chunks_of_row(K, r0):
    """nchunks(i, part) of a block whose local row i is packed row r0 + i
    of families with K[part] entries a row (element offset row * K)."""
    return lambda i, part: (((r0 + i) * K[part]) % 4 + K[part] + 3) >> 2


@pytest.mark.parametrize("K", [(375, 750), (5, 3), (1, 1), (0, 0),
                               (600, 7)])
def test_q8_stream_visits_every_group_once(K):
    """A warp's q8 stream (rows w, w + 16, ...; each row's Sx segment, then
    its Sh segment) consumes every group of G x 32 chunks of its rows once,
    in row, family, chunk order, and each group's loads are those the step
    before issued, across segment and row boundaries; a row's chunk count
    follows its head peel (odd K: rows start at every offset mod 4), and
    an empty family still takes one (empty) group, so every row is
    emitted."""
    for G in (4, 8):
        for r0, nrows in ((0, 48), (48 * 7, 48), (5952, 48), (0, 5)):
            nch = chunks_of_row(K, r0)
            for warp in range(16):
                got = q8_stream_order(nrows, nch, G, warp)
                want = [(i, part, c0) for i in range(warp, nrows, 16)
                        for part in (0, 1)
                        for c0 in range(0, max(1, nch(i, part)), G * WARP)]
                assert [g for g, _ in got] == want
                assert [n for _, n in got[:-1]] == want[1:]
                assert not got or got[-1][1] is None


def model_dual_parts(sx, sh, qx, qh, cx, cy, R):
    """B7's kernel, modelled: the plan's blocks of contiguous rows (block
    k owns rows k x rows ..), warp w of a block taking its local rows w,
    w + 16, ...; the tile's codes staged at the plan's layout; the rows a
    stream of chunk groups (both families with int16 deltas: G = 8 for int8
    codes, 4 for int16) or a row at a time (row_dot_q8x4, G = 4); each
    segment's lanes summed over its groups, the xor butterfly, zx and zh
    dequantized apart into the block's shared arrays (local row i, batch
    row b) and written out batch row by batch row. sx, sh: (values,
    deltas) numpy arrays (≥ R rows); cx, cy: combined scales."""
    B, X = qx.shape
    H = qh.shape[1]
    fam = [(np.asarray(v), np.asarray(d)) for v, d in (sx, sh)]
    K = (fam[0][0].shape[1], fam[1][0].shape[1])
    code_bytes = fam[0][0].dtype.itemsize
    p = q8_plan(X=X, H=H, B=B, Kx=K[0], Kh=K[1], code_bytes=code_bytes, R=R)
    stream = all(d.dtype == np.int16 for _, d in fam)
    G = (8 if code_bytes == 1 else 4) if stream else 4
    lanes = []
    for (v, d), q, k, shift in ((fam[0], qx, K[0], p.shift_x),
                                (fam[1], qh, K[1], p.shift_h)):
        layout_ = (shift, p.slot_bits) if p.staged else (0, 0)
        lanes.append(q8x4_lanes(v[:R].ravel(), d[:R].ravel(),
                                np.arange(R) * k, k, q, *layout_))
    comb = (np.asarray(cx, np.float32), np.asarray(cy, np.float32))
    zx, zh = (np.zeros((B, R), np.float32) for _ in range(2))
    for r0 in range(0, R, p.rows):
        nrows = min(p.rows, R - r0)
        nch = chunks_of_row(K, r0)
        smem = np.zeros((2, nrows, p.nb), np.float32)
        for warp in range(16):
            order = ([g for g, _ in q8_stream_order(nrows, nch, G, warp)]
                     if stream else q8_rows_order(nrows, nch, warp))
            segs = {}
            for i, part, c0 in order:
                w0 = c0 // WARP   # a group: windows w0 .. w0 + G - 1
                acc = segs.get((i, part), np.zeros((WARP, p.nb), np.int64))
                segs[(i, part)] = (acc + lanes[part][r0 + i, w0:w0 + G]
                                   .sum(0)) & M32
            for i in range(warp, nrows, 16):
                for part in (0, 1):
                    acc = segs.get((i, part), np.zeros((WARP, p.nb),
                                                       np.int64))
                    tot = warp_total(acc, p.nb)
                    smem[part, i] = tot.astype(np.float32) \
                        * comb[part][r0 + i]
        for t in range(nrows * B):
            b, i = t // nrows, t % nrows
            zx[b, r0 + i] = smem[0, i, b]
            zh[b, r0 + i] = smem[1, i, b]
    return zx, zh, p


@pytest.mark.parametrize("K", [375, 750, 5, 3, 1, 0])
def test_single_q8_stream_visits_every_group_once(K):
    """B10's stream (NF = 1: rows w, w + 16, ..., the Sx segment alone)
    consumes every group of G x 32 chunks of its rows once, in row then
    chunk order, each group's loads those the step before issued, across
    row boundaries; an empty row still takes one (empty) group, so every
    row is emitted."""
    for G in (4, 8):
        for r0, nrows in ((0, 48), (48 * 7, 48), (5952, 48), (0, 5)):
            nch = chunks_of_row((K,), r0)
            for warp in range(16):
                got = q8_stream_order(nrows, nch, G, warp, families=1)
                want = [(i, 0, c0) for i in range(warp, nrows, 16)
                        for c0 in range(0, max(1, nch(i, 0)), G * WARP)]
                assert [g for g, _ in got] == want
                assert [n for _, n in got[:-1]] == want[1:]
                assert not got or got[-1][1] is None


def model_single(s, q, comb, R):
    """B10's kernel, modelled: q8_plan's single-family blocks of contiguous
    rows, warp w of a block taking its local rows w, w + 16, ...; q's
    codes staged at the plan's layout (or gathered: column order); the
    rows a stream of chunk groups (int16 deltas: G = 8 for int8 codes, 4
    for int16) or a row at a time (row_dot_q8x4, G = 4); each row's lanes
    summed over its groups, the xor butterfly, the sum dequantized into
    the block's shared array (local row i, batch row b) and written out
    batch row by batch row. s: (values, deltas) numpy arrays (≥ R rows);
    comb: combined scales."""
    v, d = (np.asarray(t) for t in s)
    B, X = q.shape
    K = v.shape[1]
    code_bytes = v.dtype.itemsize
    p = q8_plan(X=X, B=B, Kx=K, code_bytes=code_bytes, R=R)
    assert p.families == 1 and p.hpad == 0
    stream = d.dtype == np.int16
    G = (8 if code_bytes == 1 else 4) if stream else 4
    layout_ = (p.shift_x, p.slot_bits) if p.staged else (0, 0)
    lanes = q8x4_lanes(v[:R].ravel(), d[:R].ravel(), np.arange(R) * K, K,
                       q, *layout_)
    comb = np.asarray(comb, np.float32)
    y = np.zeros((B, R), np.float32)
    for r0 in range(0, R, p.rows):
        nrows = min(p.rows, R - r0)
        nch = chunks_of_row((K,), r0)
        smem = np.zeros((nrows, p.nb), np.float32)
        for warp in range(16):
            order = ([g for g, _ in q8_stream_order(nrows, nch, G, warp,
                                                    families=1)]
                     if stream else q8_rows_order(nrows, nch, warp,
                                                  families=1))
            rows = {}
            for i, _, c0 in order:
                w0 = c0 // WARP
                acc = rows.get(i, np.zeros((WARP, p.nb), np.int64))
                rows[i] = (acc + lanes[r0 + i, w0:w0 + G].sum(0)) & M32
            for i in range(warp, nrows, 16):
                tot = warp_total(rows.get(i, np.zeros((WARP, p.nb),
                                                      np.int64)), p.nb)
                smem[i] = tot.astype(np.float32) * comb[r0 + i]
        for t in range(nrows * B):
            b, i = t // nrows, t % nrows
            y[b, r0 + i] = smem[i, b]
    return y, p


def test_modelled_single_q8_gathers_a_wide_input_exactly():
    """X too wide to stage beside the sums (33000 columns at B = 12, int16
    deltas): the modelled B10 gathers q in column order and still equals
    rb_spmv_q8_ref bit for bit."""
    rng = np.random.default_rng(5)
    R, X, K, B = 20, 33000, 8250, 12
    f = _packed(rng, R, X, K)
    ts = quantize_packed(packed_from_numpy(f.values, f.deltas, f.ncols,
                                           f.pad, f.block_rows), "int8")
    q = rng.integers(-127, 128, size=(B, X)).astype(np.int8)
    sa = np.float32(0.01)
    comb = ts.scales.numpy() * sa
    y, p = model_single((ts.values.numpy(), ts.deltas.numpy()), q, comb, R)
    assert not p.staged
    plain = ref.rb_spmv_q8_ref(ts, torch.from_numpy(q), torch.tensor(sa))
    np.testing.assert_array_equal(y.view(np.uint32),
                                  plain.numpy().view(np.uint32))


def _u32(x):
    return np.asarray(x, np.uint64) & M32


def staged_words(q, nb, four):
    """stage_codes, modelled: each column's staged vector (n, kW) uint32
    words (batch row b in byte / half-word b % per of word b // per, zero
    past B), four columns a thread (each batch row's four codes loaded as
    one word per 4 bytes, then transpose4x4 for int8 or __byte_perm for
    int16) or one column a thread; and how many times each column was
    written."""
    B, n = q.shape
    cb = q.dtype.itemsize
    per, bits, kW = 4 // cb, 8 * cb, nb * cb // 4
    u = q.view(np.uint8 if cb == 1 else np.uint16).astype(np.uint64)
    out = np.zeros((n, kW), np.uint64)
    writes = np.zeros(n, int)
    if not four:
        for c in range(n):
            for b in range(B):
                out[c, b // per] |= u[b, c] << (bits * (b % per))
            writes[c] += 1
        return out, writes
    for c4 in range(n // 4):
        cols = u[:, 4 * c4:4 * c4 + 4]            # (B, 4)
        raw = np.zeros((nb, cb), np.uint64)       # a row's words (Codes4)
        for b in range(B):
            for i in range(4):
                raw[b, i // per] |= cols[b, i] << (bits * (i % per))
        for g in range(kW):
            if cb == 1:
                o = transpose4x4(*(raw[4 * g + k, 0:1] for k in range(4)))
                for i in range(4):
                    out[4 * c4 + i, g] = o[i][0]
            else:
                for i in range(4):
                    out[4 * c4 + i, g] = byte_perm(
                        raw[2 * g, i >> 1:(i >> 1) + 1],
                        raw[2 * g + 1, i >> 1:(i >> 1) + 1],
                        0x7632 if i & 1 else 0x5410)[0]
        writes[4 * c4:4 * c4 + 4] += 1
    return _u32(out), writes


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
@pytest.mark.parametrize("B", [1, 3, 8, 12, 16])
@pytest.mark.parametrize("n", [1500, 64, 100])
def test_staging_four_columns_a_thread_equals_one(dtype, B, n):
    """The staged q8 kernels' codes staging: four columns a thread (widths
    a multiple of 4) writes every column once, and each column's vector
    the one-column form writes: batch row b's code in byte (int8) or
    half-word (int16) b of the NB-row vector, zeros past B; so the rows
    read the same codes whichever form staged them."""
    rng = np.random.default_rng(B * 10 + n)
    info = np.iinfo(dtype)
    q = rng.integers(info.min, info.max + 1, size=(B, n)).astype(dtype)
    nb = 4 if B <= 4 else 8 if B <= 8 else 16
    one, w1 = staged_words(q, nb, four=False)
    four, w4 = staged_words(q, nb, four=True)
    assert (w1 == 1).all() and (w4 == 1).all()
    np.testing.assert_array_equal(four, one)
    per, bits = 4 // q.itemsize, 8 * q.itemsize
    for b in range(nb):   # each batch row's codes read back from the words
        field = (one[:, b // per] >> (bits * (b % per))) & ((1 << bits) - 1)
        want = (q[b].view(np.uint8 if bits == 8 else np.uint16)
                if b < B else np.zeros(n))
        np.testing.assert_array_equal(field, want)
