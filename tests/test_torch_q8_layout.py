"""The index and sum arithmetic of the fused q8 step's row routine
(``csrc/brds_common.cuh::row_dot_q8x4``), modelled in numpy on the CPU:
four consecutive entries a lane counted from the 4-aligned element at or
before a row's start (the head of an unaligned row and the tail past K
count as code 0, delta 0), the in-register prefix of a lane's four
deltas, the warp's shuffle scan of the 32 chunk sums, the 4x4 byte
transpose that pairs the entries' activation codes with their weights, and
``__dp4a``'s wrapping int32 sums (IMADs for int16 codes). The columns must
equal the JAX package's unpacked indices (``repro.core.packing``), and the
sums, dequantized, the port's plain version (``kernels/ref.py::
rb_spmv_q8_ref``) bit for bit; with the delta-q8 step's epilogue, m' and
the cell the JAX package's fused delta-q8 step. The kernel itself runs only
on the card (``chip_smoke.py`` holds it exact against the same plain
version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack, pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.quant import formats as jqf
from repro_torch.kernels import ref
from repro_torch.kernels.plan import stage_pos, staged_cols
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


def q8x4_sums(codes, deltas, offs, K, q):
    """The int32 sums (rows, B) row_dot_q8x4 leaves in every lane: codes
    and deltas flat, q (B, ncols) activation codes of the same type."""
    B = q.shape[0]
    nb = 4 if B <= 4 else 8 if B <= 8 else 16
    e, live, col = layout(deltas, offs, K)
    at = np.asarray(offs)[:, None, None, None] + np.clip(e, 0, max(K - 1, 0))
    w = np.where(live, codes[np.minimum(at, codes.size - 1)], 0)
    w = w.astype(np.int64)
    qq = np.zeros((nb, q.shape[1]), np.int64)
    qq[:B] = q
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
    lanes = acc.sum(axis=1) & M32                    # a lane's windows
    for o in (16, 8, 4, 2, 1):                        # the xor butterfly
        lanes = (lanes + lanes[:, np.arange(WARP) ^ o]) & M32
    assert (lanes == lanes[:, :1]).all()             # every lane, one total
    s = lanes[:, 0, :B]
    return (s - (1 << 32) * (s >= 1 << 31)).astype(np.int32)


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
