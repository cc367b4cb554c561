"""The launch plans of the float scan, the staged q8 kernels (the fused
q8 steps, the q8 dual SpMV and the single-family q8 SpMV), the staged
float kernels (the steps, the dual SpMVs and the single-family SpMV) and
the LSTM cell (``kernels/plan.py``) on the CPU: the occupancy arithmetic
(blocks an SM from registers, threads and shared memory; whether one
kernel's block fits beside another's; waves of a grid), each plan's fit on
the card at
lstm_ptb's serve shapes, the staged layout's addressing, the scan's
scratch, the cell's index map, and the alignment of the packed q8
arrays. The kernels run only
on the card, where ``chip_smoke.py`` prints the occupancy the runtime
reports for the same plans."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_scan as kscan
from repro_torch.kernels import plan as P

# lstm_ptb: X = H = 1500, lstm_policy(0.75, 0.5): 375 and 750 entries a row
PTB = dict(X=1500, H=1500, Kx=375, Kh=750)


@pytest.mark.parametrize("regs,per_sm,waves", [(48, 5, 2), (40, 6, 1),
                                               (32, 8, 1), (64, 4, 2)])
def test_blocks_per_sm_and_waves_of_a_750_block_grid(regs, per_sm, waves):
    """256 threads a block (the single-step kernels): 48 registers leave
    room for 5 blocks an SM, 660 on 132 SMs, so 750 blocks (a 1500-wide
    layer, two hidden units a block) take two waves; 40 registers give 6
    blocks an SM and one wave."""
    assert P.blocks_per_sm(regs, 256) == per_sm
    assert P.waves(750, per_sm) == waves


def test_blocks_per_sm_limits():
    assert P.blocks_per_sm(32, 1024) == 2                    # warps
    assert P.blocks_per_sm(128, 512) == 1                    # registers
    assert P.blocks_per_sm(32, 128, smem=100 * 1024) == 2    # shared memory
    assert P.blocks_per_sm(32, 512, smem=P.SMEM_PER_BLOCK) == 1
    assert P.blocks_per_sm(255, 1024) == 0
    with pytest.raises(ValueError):
        P.waves(10, 0)


@pytest.mark.parametrize("B", [1, 8, 16])
def test_scan_plan_fits_the_card(B):
    """At lstm_ptb's shapes the scan stages xs and h (a 128-byte bank row
    a column), its shared memory fits one block an SM at up to 128
    registers (its launch bounds), and its grid of ceil(H / units) blocks
    is one wave, as a cooperative launch needs."""
    p = P.scan_plan(T=32, B=B, **PTB)
    assert p.stage_x and p.stage_h and p.col_bytes == (2, 2)
    assert p.smem <= P.SMEM_PER_BLOCK
    per_sm = P.blocks_per_sm(128, P.SCAN_THREADS, p.smem)
    assert per_sm == 1 and P.waves(p.grid, per_sm) == 1
    assert p.grid <= P.SMS and p.units * p.grid >= PTB["H"]
    assert p.units * (p.grid - 1) < PTB["H"]
    assert p.ax_shape == (32, 4 * PTB["H"], p.nb)
    assert p.hx_shape == (2, p.nb // 4, PTB["H"], 4)
    assert p.smem == 1500 * P.SCAN_COLUMN + 5 * p.units * p.nb * 4


def test_scan_plan_gathers_what_does_not_fit():
    """A 33000-wide input (chip_smoke's wide case) cannot be staged: the
    prologue gathers xs from global memory with int32 columns; h, 97 wide,
    is staged. A 4000-wide hidden state (chip_smoke's tall case) is
    gathered in the recurrence."""
    p = P.scan_plan(X=33000, H=97, T=32, B=12, Kx=8250, Kh=49)
    assert not p.stage_x and p.stage_h and p.col_bytes == (4, 2)
    assert p.smem == 97 * P.SCAN_COLUMN + 5 * p.units * p.nb * 4
    p = P.scan_plan(X=64, H=4000, T=32, B=12, Kx=16, Kh=2000)
    assert p.stage_x and not p.stage_h and p.col_bytes == (2, 4)
    assert p.smem <= P.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        P.scan_plan(T=4, B=17, **PTB)


@pytest.mark.parametrize("B,code_bytes,tiles", [(1, 1, 1), (8, 1, 1),
                                                (8, 2, 1), (16, 1, 1),
                                                (64, 1, 4)])
def test_q8_plan_is_one_wave_a_batch_tile(B, code_bytes, tiles):
    """The fused q8 step stages its tile's codes at every serve batch and
    takes one block an SM, so a tile is one wave (the int8 form's two
    waves at 48 registers are gone)."""
    p = P.q8_plan(B=B, code_bytes=code_bytes, **PTB)
    assert p.staged and p.tiles == tiles
    per_sm = P.blocks_per_sm(128, P.Q8_THREADS, p.smem)
    assert per_sm >= 1
    assert P.waves(p.grid * p.tiles, per_sm) == tiles
    assert p.smem == (p.xpad + p.hpad) * p.nb * code_bytes \
        + 4 * p.units * p.nb * 4
    # neighbouring lanes' entries lie 4 x ncols / K columns apart
    assert (p.shift_x, p.shift_h) == (4, 3)


def test_q8_plan_gathers_a_very_wide_input():
    p = P.q8_plan(X=33000, H=97, B=12, Kx=8250, Kh=49, code_bytes=2)
    assert not p.staged and p.smem == 4 * p.units * p.nb * 4


# the fused q8 steps' plans at lstm_ptb before the dual SpMV shared
# q8_plan: (code bytes, delta step, B) -> (nb, tiles, units, grid, staged,
# slot_bits, shift_x, shift_h, xpad, hpad, smem)
FUSED_Q8 = {
    (1, False, 1): (4, 1, 12, 125, True, 5, 4, 3, 1536, 1536, 13056),
    (1, False, 8): (8, 1, 12, 125, True, 4, 4, 3, 1536, 1536, 26112),
    (1, False, 16): (16, 1, 12, 125, True, 3, 4, 3, 1536, 1536, 52224),
    (1, False, 64): (16, 4, 12, 125, True, 3, 4, 3, 1536, 1536, 52224),
    (1, True, 8): (8, 1, 12, 125, True, 4, 4, 3, 1536, 1536, 27648),
    (1, True, 64): (16, 4, 12, 125, True, 3, 4, 3, 1536, 1536, 55296),
    (2, False, 8): (8, 1, 12, 125, True, 3, 4, 3, 1536, 1536, 50688),
    (2, False, 16): (16, 1, 12, 125, True, 2, 4, 3, 1536, 1504, 100352),
    (2, True, 1): (4, 1, 12, 125, True, 4, 4, 3, 1536, 1536, 26112),
    (2, True, 8): (8, 1, 12, 125, True, 3, 4, 3, 1536, 1536, 52224),
    (2, True, 16): (16, 1, 12, 125, True, 2, 4, 3, 1536, 1504, 103424)}


@pytest.mark.parametrize("key", list(FUSED_Q8))
def test_q8_plan_of_the_fused_steps_is_unchanged(key):
    """B8's and B9's plans at lstm_ptb are what they were before B7 took a
    form of the same plan: the same units, grid, staged layout and
    shared memory."""
    cb, delta, B = key
    p = P.q8_plan(B=B, code_bytes=cb, delta=delta, **PTB)
    assert (p.nb, p.tiles, p.units, p.grid, p.staged, p.slot_bits,
            p.shift_x, p.shift_h, p.xpad, p.hpad, p.smem) == FUSED_Q8[key]
    assert p.rows == 4 * p.units


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16, 32, 64])
@pytest.mark.parametrize("code_bytes", [1, 2])
def test_q8_dual_plan_is_one_wave_a_batch_tile(B, code_bytes):
    """B7 at lstm_ptb (R = 6000): its tile's int8 or q1.11 codes staged at
    every batch tier beside zx and zh (2 x 48 rows x NB float32), one
    512-thread block an SM at up to 128 registers (its launch bounds), 125
    blocks of 48 contiguous rows, so one wave a 16-row tile; at R = 4H the
    delta-q8 step's plan, which keeps zx and zh apart too."""
    p = P.q8_plan(B=B, code_bytes=code_bytes, R=6000, **PTB)
    tiles = -(-B // P.TILE)
    assert p.staged and p.tiles == tiles and p.nb == P.tier(min(B, P.TILE))
    assert (p.rows, p.grid) == (48, 125)
    assert (p.shift_x, p.shift_h) == (4, 3)
    assert p.smem == (p.xpad + p.hpad) * p.nb * code_bytes \
        + 2 * p.rows * p.nb * 4 <= P.SMEM_PER_BLOCK
    per_sm = P.blocks_per_sm(128, P.Q8_THREADS, p.smem)
    assert per_sm >= 1 and P.waves(p.grid * p.tiles, per_sm) == tiles
    assert p == P.q8_plan(B=B, code_bytes=code_bytes, delta=True, **PTB)


@pytest.mark.parametrize("R", [1, 5, 388, 6000, 6001, 16000])
def test_q8_dual_plan_rows_cover_any_R(R):
    """B7 takes any R (the format API's row_balanced_q8 dual matvec):
    4 x ceil(R / 4 SMs) contiguous rows a block, at most one block an SM,
    every row owned once, the last block partial."""
    p = P.q8_plan(B=8, code_bytes=1, R=R, **PTB)
    assert p.rows % 4 == 0 and p.grid <= P.SMS
    assert p.rows * p.grid >= R > p.rows * (p.grid - 1)
    with pytest.raises(ValueError):
        P.q8_plan(B=8, code_bytes=1, R=0, **PTB)


@pytest.mark.parametrize("X,B,code_bytes", [(33000, 12, 1), (33000, 12, 2),
                                            (70000, 3, 1), (70000, 3, 2)])
def test_q8_dual_plan_gathers_codes_too_wide_to_stage(X, B, code_bytes):
    """chip_smoke's wide (X=33000, B=12) and very wide (X=70000, B=3)
    shapes: the codes do not fit beside the sums, so B7 gathers them from
    global memory and its shared memory holds zx and zh alone."""
    p = P.q8_plan(X=X, H=97, B=B, Kx=X // 4, Kh=49, code_bytes=code_bytes,
                  R=388)
    assert not p.staged and p.smem == 2 * p.rows * p.nb * 4


def _unrotate(a, r):
    """fused_scan.cu ``unrotate`` on a list of pieces: for each set bit s
    of r, every cycle j, j + s, ... shifts by one in place."""
    a, n, s = list(a), len(a), 1
    while s < n:
        if r & s:
            for c in range(s):
                last = c + n - s
                t = a[last]
                for m in range(last, c, -s):
                    a[m] = a[m - s]
                a[c] = t
        s <<= 1
    return a


@pytest.mark.parametrize("nb", [4, 8, 16])
def test_rotated_pieces_meet_no_bank_conflict_and_unrotate(nb):
    """The scan's staged column is one 128-byte bank row of 8 float4
    pieces (prologue: step tt's rows 4q..4q+3 in piece tt * NB/4 + q;
    recurrence: h's NB/4 pieces repeated). A lane's j-th load takes piece
    (j + lane) % 8, so the 8 lanes of a 16-byte load's phase meet 8
    distinct slots; unrotate puts each lane's registers back in piece
    order, and the recurrence's NB/4 loads reach every batch group."""
    nq = nb // 4
    for j in range(8):
        assert sorted((j + lane) % 8 for lane in range(8)) == list(range(8))
    for n in (1, 2, 4, 8):
        for lane in range(32):
            rot = lane & 7
            # register slot j holds piece (j + rot) % n (n | 8)
            regs = [(j + rot) % n for j in range(n)]
            assert _unrotate(regs, rot) == list(range(n))
    for lane in range(8):
        groups = {((j + lane) % 8) % nq for j in range(nq)}
        assert groups == set(range(nq))
    # the prologue's pieces: 32 / NB steps of NB rows
    pieces = [(p // nq, p % nq) for p in range(8)]
    assert len(set(pieces)) == 8
    assert max(tt for tt, _ in pieces) == 32 // nb - 1


@pytest.mark.parametrize("kw,cols", [
    (dict(T=5, B=3, **PTB), (torch.int16, torch.int16)),
    (dict(X=33000, H=97, T=4, B=12, Kx=8250, Kh=49),
     (torch.int32, torch.int16)),
    (dict(X=64, H=4000, T=4, B=12, Kx=16, Kh=2000),
     (torch.int16, torch.int32))])
def test_scan_scratch_shape_checks(kw, cols):
    """The scan's scratch, allocated by its wrapper from the plan: ax
    (T, 4H, NB) float32, the decoded columns (4H, K) in uint16 storage
    where that family is staged (int32 where it is gathered), hx in the
    staged layout; all contiguous on the asked device."""
    p = P.scan_plan(**kw)
    ax, colx, colh, hx = kscan.scan_scratch(p, kw["Kx"], kw["Kh"], "cpu")
    R = 4 * kw["H"]
    assert ax.shape == (kw["T"], R, p.nb) and ax.dtype == torch.float32
    assert colx.shape == (R, kw["Kx"]) and colx.dtype == cols[0]
    assert colh.shape == (R, kw["Kh"]) and colh.dtype == cols[1]
    assert [t.element_size() for t in (colx, colh)] == list(p.col_bytes)
    assert hx.shape == p.hx_shape == (2, p.nb // 4, kw["H"], 4)
    assert hx.dtype == torch.float32
    assert all(t.is_contiguous() and t.device.type == "cpu"
               for t in (ax, colx, colh, hx))


def test_aligned_arrays_only():
    """The fused q8 step loads four codes and four deltas at once, so its
    wrapper refuses packed arrays that do not start on 16 bytes."""
    t = torch.zeros(64, dtype=torch.int8)
    _build.require_aligned(t, "codes")
    with pytest.raises(ValueError, match="16-byte"):
        _build.require_aligned(t[1:], "codes")


@pytest.mark.parametrize("hidden", [64, 96])
@pytest.mark.parametrize("spec", ["int8", "q1.11"])
def test_packed_q8_arrays_start_aligned(hidden, spec):
    """What the serve path hands the fused q8 step meets its wrapper's
    16-byte check: ``LSTMModel.pack`` with a quant scheme (what
    ``ServeEngine.prepare`` packs) gives codes and deltas that start their
    own storage, contiguous, whether ``pad_packed`` appends rows (4H =
    384) or passes the packed deltas through (4H = 256). A fresh
    allocation starts on 512 bytes on the card (PyTorch's caching
    allocator), on 64 on the CPU."""
    from repro_torch.models import LSTMConfig, LSTMModel
    cfg = LSTMConfig("t", input_size=48, hidden=hidden, num_layers=2,
                     vocab_size=11)
    model = LSTMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pruned, masks = model.prune(params, 0.75, 0.5)
    for layer in model.pack(pruned, masks, quant=spec):
        for key in ("sx", "sh"):
            s = layer[key]
            assert s.values.dtype == (torch.int8 if spec == "int8"
                                      else torch.int16)
            for name, t in (("codes", s.values), ("deltas", s.deltas)):
                assert t.storage_offset() == 0 and t.is_contiguous(), name
                _build.require_aligned(t, f"{key} {name}")


def _bank_load(ncols, K, per_lane, lanes, slot_bits, shift, rows=48,
               pieces=1, rotate=False):
    """Mean over a warp's shared loads of the largest number of lanes of
    one phase (``lanes`` lanes) on one slot of a bank row (2^slot_bits
    slots of ``pieces`` load-wide pieces), gathering the staged
    activations of random row-balanced rows (K of ncols columns) at
    stage_pos(col, shift): the wavefronts a load takes, 1 at best. Lane l
    takes entries l, l+32, ... (per_lane 1: the float scan and delta steps)
    or chunks of four consecutive entries (per_lane 4: the fused q8 step,
    one load a chunk entry). A column of several pieces (the delta steps'
    NB floats, NB/4 16-byte pieces) takes one load a piece, lane l's j-th
    load piece (j + l) % pieces when ``rotate``, else piece j."""
    rng = np.random.default_rng(0)
    loads = []
    lane = np.arange(32)
    for _ in range(rows):
        cols = np.sort(rng.choice(ncols, K, replace=False))
        step = 32 * per_lane
        for u in range(K // step):
            block = cols[u * step:(u + 1) * step].reshape(32, per_lane)
            for i in range(per_lane):
                pos = P.stage_pos(block[:, i], shift, slot_bits)
                for j in range(pieces):
                    piece = (j + lane * rotate) % pieces
                    slot = (pos * pieces + piece) % (pieces << slot_bits)
                    for ph in range(0, 32, lanes):
                        loads.append(np.bincount(slot[ph:ph + lanes]).max())
    return float(np.mean(loads))


def test_stage_pos_spreads_the_q8_steps_gathers():
    """The q8 step's lanes take entries four apart, so neighbouring lanes'
    columns lie about 4 x ncols / K apart and the plan's stage_pos shift
    spreads them over the slots (int8 codes at B=8: 8-byte vectors, phases
    of 16 lanes, 16 slots). The float scan's lanes take consecutive
    entries of random columns: staged in column order, about two of a
    phase's 8 lanes meet on a slot and no shift does better, which is why
    the scan rotates the pieces of a 128-byte column instead (one lane a
    slot, test above)."""
    p = P.q8_plan(B=8, code_bytes=1, **PTB)
    for K, ncols, shift in ((PTB["Kh"], PTB["H"], p.shift_h),
                            (PTB["Kx"], PTB["X"], p.shift_x)):
        ident = _bank_load(ncols, K, 4, 16, p.slot_bits, 0)
        assert _bank_load(ncols, K, 4, 16, p.slot_bits, shift) < 0.8 * ident
    for K in (PTB["Kh"], PTB["Kx"]):
        ident = _bank_load(1500, K, 1, 8, 3, 0)
        assert 1.9 < ident < 2.5
        assert min(_bank_load(1500, K, 1, 8, 3, s) for s in (1, 2, 3)) \
            > 0.97 * ident


@pytest.mark.parametrize("nb", [4, 8, 16])
def test_delta_plan_stages_both_families_with_the_fitting_layout(nb):
    """The float delta steps' staged layout (a column's NB float32 at
    stage_pos, NB/4 16-byte pieces, 16-byte loads in phases of 8 lanes)
    at lstm_ptb's rows: reading piece (j + lane) % (NB/4), with the plan's
    shift, meets about two lanes a slot (random columns: no layout reaches
    one) against three to five unrotated in column order; at NB=4 (one
    piece) the plan keeps columns in order, which no shift beats."""
    B = {4: 4, 8: 8, 16: 16}[nb]
    p = P.stream_plan(B=B, R=4 * PTB["H"], fused=True, **PTB)
    nq = nb // 4
    assert p.nb == nb and (8 // nq) == 1 << p.slot_bits
    for K, shift in ((PTB["Kx"], p.shift_x), (PTB["Kh"], p.shift_h)):
        load = lambda s, rot: _bank_load(1500, K, 1, 8, p.slot_bits, s,
                                         rows=16, pieces=nq, rotate=rot)
        got = load(shift, True)
        assert got < 2.5
        if nb > 4:
            assert got < 0.7 * load(0, False)
            assert shift == P.spacing_shift(1500, K)
        else:
            assert shift == 0
            assert got <= min(load(s, True) for s in (1, 2))


@pytest.mark.parametrize("B,tiles", [(1, 1), (3, 1), (8, 1), (12, 1),
                                     (16, 1), (64, 4)])
@pytest.mark.parametrize("fused", [True, False])
def test_delta_plan_is_one_wave_a_batch_tile(B, tiles, fused):
    """The fused delta step (B5) and the delta dual SpMV (B4) at lstm_ptb's
    shapes: both families staged at every batch tier (NB 4, 8, 16), within
    227 KB, one block an SM at up to 128 registers (the kernels' launch
    bounds), so a batch tile is one wave; 48 gate rows a block (12 hidden
    units, 125 blocks) for both, B4 owning contiguous rows."""
    p = P.stream_plan(B=B, R=4 * PTB["H"], fused=fused, **PTB)
    assert p.stage_x and p.stage_h and p.tiles == tiles
    assert p.nb == P.tier(min(B, P.TILE))
    assert p.smem <= P.SMEM_PER_BLOCK
    assert p.smem == (p.xpad + p.hpad) * p.nb * 4 + 2 * p.rows * p.nb * 4
    per_sm = P.blocks_per_sm(128, P.STREAM_THREADS, p.smem)
    assert per_sm >= 1 and P.waves(p.grid * p.tiles, per_sm) == tiles
    assert (p.rows, p.units, p.grid) == (48, 12, 125)
    assert p.xpad >= PTB["X"] and p.hpad >= PTB["H"]


def test_delta_plan_gathers_the_family_that_does_not_fit():
    """chip_smoke's tall shape (B=12, X=64, H=4000): 4000 columns of 64
    bytes do not fit, so h is gathered from global memory and x staged;
    the wide one (X=33000, H=97) gathers x and stages h. A family is never
    staged past the block's limit, and the one with more entries a row
    takes the room first."""
    p = P.stream_plan(X=64, H=4000, R=16000, B=12, Kx=16, Kh=2000,
                     fused=True)
    assert p.stage_x and not p.stage_h and p.nb == 16
    assert p.smem == p.xpad * 64 + 2 * p.rows * 64 <= P.SMEM_PER_BLOCK
    p = P.stream_plan(X=33000, H=97, R=388, B=12, Kx=8250, Kh=49,
                     fused=False)
    assert not p.stage_x and p.stage_h
    # room for one 1500-wide family at NB=16 but not two: Sh (750 a row)
    p = P.stream_plan(B=16, R=6000, fused=True, smem_limit=120000, **PTB)
    assert p.stage_h and not p.stage_x and p.smem <= 120000


@pytest.mark.parametrize("R", [1, 4, 97, 388, 1000, 6000, 6001, 16000])
def test_delta_dual_plan_rows_cover_any_R(R):
    """B4 takes any R: 4 x ceil(R / 4 SMs) contiguous rows a block, at most
    one block an SM, the last block partial."""
    p = P.stream_plan(X=300, H=200, R=R, B=8, Kx=75, Kh=100, fused=False)
    assert p.rows % 4 == 0 and p.grid <= P.SMS
    assert p.rows * p.grid >= R > p.rows * (p.grid - 1)
    with pytest.raises(ValueError):
        P.stream_plan(X=300, H=200, R=R, B=8, Kx=75, Kh=100,
                     fused=True)   # the fused step has R = 4H = 800


@pytest.mark.parametrize("nb", [4, 8, 16])
@pytest.mark.parametrize("fused", [True, False])
def test_float_plan_stages_x_and_h_at_lstm_ptb(nb, fused):
    """The float step (B3) and dual SpMV (B1) stage x and h as they are, a
    column's NB float32, as the delta pair stages d·f: at lstm_ptb both
    families fit at every tier, about 96 KB at NB=8 and 192 KB at NB=16,
    plus the sums (ax, ah: 2 x 48 rows x NB), within 227 KB."""
    p = P.stream_plan(B=nb, R=4 * PTB["H"], fused=fused, **PTB)
    assert p.nb == nb and p.stage_x and p.stage_h
    staged = (p.xpad + p.hpad) * nb * 4
    assert staged == {4: 3008 * 16, 8: 3008 * 32, 16: 3004 * 64}[nb]
    assert p.smem == staged + 2 * p.rows * nb * 4 <= P.SMEM_PER_BLOCK
    assert (p.rows, p.grid) == (48, 125)


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16, 32, 64])
@pytest.mark.parametrize("fused", [True, False])
def test_float_plan_is_one_wave_a_batch_tile(B, fused):
    """B3 and B1 at lstm_ptb: one 512-thread block an SM at up to 128
    registers (their launch bounds), 125 blocks a 16-row tile, so one wave
    a tile (B=32: two tiles, 250 blocks in two waves)."""
    p = P.stream_plan(B=B, R=4 * PTB["H"], fused=fused, **PTB)
    tiles = -(-B // P.TILE)
    per_sm = P.blocks_per_sm(128, P.STREAM_THREADS, p.smem)
    assert p.tiles == tiles and per_sm == 1
    assert P.waves(p.grid * p.tiles, per_sm) == tiles
    if fused:
        assert p.units * p.grid >= PTB["H"] > p.units * (p.grid - 1)


@pytest.mark.parametrize("R", [1, 5, 388, 1500, 6000, 6001, 16000])
def test_float_dual_plan_rows_cover_any_R(R):
    """B1 serves the format API's dual matvec, any R over lstm_ptb's
    families: 4 x ceil(R / 4 SMs) contiguous rows a block, at most one
    block an SM, every row owned once."""
    p = P.stream_plan(B=8, R=R, fused=False, **PTB)
    assert p.rows % 4 == 0 and p.grid <= P.SMS
    assert p.rows * p.grid >= R > p.rows * (p.grid - 1)
    with pytest.raises(ValueError):
        P.stream_plan(B=8, R=0, fused=False, **PTB)


def test_float_plan_gathers_the_family_that_does_not_fit():
    """chip_smoke's float shapes: the tall one (B=12, X=64, H=4000) stages
    x and gathers h (4000 columns of 64 bytes do not fit), the very wide
    one (B=3, X=70000, H=64) gathers x and stages h, for the fused step
    and the dual SpMV alike."""
    for fused in (True, False):
        p = P.stream_plan(X=64, H=4000, R=16000, B=12, Kx=16, Kh=2000,
                          fused=fused)
        assert p.stage_x and not p.stage_h
        p = P.stream_plan(X=70000, H=64, R=256, B=3, Kx=17500, Kh=32,
                          fused=fused)
        assert not p.stage_x and p.stage_h and p.smem <= P.SMEM_PER_BLOCK


@pytest.mark.parametrize("nb", [4, 8, 16])
def test_single_plan_stages_x_beside_its_sums(nb):
    """B11 (rb_spmv, one family) at lstm_ptb's W_h and W_x: x staged as the
    dual SpMV stages it (the same shift and padding), beside one family's
    sums (48 rows x NB float32), no h family; 125 blocks of 48 rows."""
    for K in (PTB["Kx"], PTB["Kh"]):
        p = P.stream_plan(X=1500, R=6000, B=nb, Kx=K)
        d = P.stream_plan(X=1500, H=1500, R=6000, B=nb, Kx=K, Kh=K,
                          fused=False)
        assert p.families == 1 and p.stage_x and not p.stage_h
        assert (p.shift_x, p.xpad, p.slot_bits) == (d.shift_x, d.xpad,
                                                    d.slot_bits)
        assert p.hpad == 0 and p.shift_h == 0
        assert p.smem == (p.xpad + p.rows) * nb * 4
        assert (p.rows, p.grid) == (48, 125)


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16, 32, 64])
def test_single_plan_is_one_wave_a_batch_tile(B):
    """B11 at lstm_ptb: one 512-thread block an SM at up to 128 registers,
    125 blocks a 16-row tile, one wave a tile."""
    p = P.stream_plan(X=1500, R=6000, B=B, Kx=750)
    tiles = -(-B // P.TILE)
    per_sm = P.blocks_per_sm(128, P.STREAM_THREADS, p.smem)
    assert p.tiles == tiles and per_sm == 1 and p.stage_x
    assert P.waves(p.grid * p.tiles, per_sm) == tiles


@pytest.mark.parametrize("R", [1, 5, 388, 1500, 6000, 6001, 16000])
def test_single_plan_rows_cover_any_R(R):
    """B11 takes any R (the format API's matvec): 4 x ceil(R / 4 SMs)
    contiguous rows a block, every row owned once."""
    p = P.stream_plan(X=1500, R=R, B=8, Kx=375)
    assert p.rows % 4 == 0 and p.grid <= P.SMS
    assert p.rows * p.grid >= R > p.rows * (p.grid - 1)
    with pytest.raises(ValueError):
        P.stream_plan(X=1500, R=0, B=8, Kx=375)
    with pytest.raises(ValueError):
        P.stream_plan(X=1500, R=R, B=8, Kx=375, fused=True)


@pytest.mark.parametrize("X,K,B,staged", [(70000, 17500, 3, False),
                                          (33000, 8250, 12, False),
                                          (4000, 2000, 12, False),
                                          (4000, 2000, 8, True),
                                          (64, 16, 12, True)])
def test_single_plan_gathers_an_input_too_wide_to_stage(X, K, B, staged):
    """chip_smoke's single-family shapes: x of 70000 or 33000 columns, or
    the tall shape's h (4000 columns of 64 bytes at NB=16), does not fit
    beside the sums and is gathered; 4000 columns at NB=8 and the tall
    shape's 64-wide x are staged."""
    p = P.stream_plan(X=X, R=4 * 97, B=B, Kx=K)
    assert p.stage_x == staged and p.smem <= P.SMEM_PER_BLOCK
    assert p.smem == ((p.xpad if staged else 0) + p.rows) * p.nb * 4


def test_stream_plan_for_reads_the_operands_and_is_cached(monkeypatch):
    """The wrappers' plan: X, H and B from the operands (x and h, or the
    deltas), Kx and Kh from the packed values, the card's SMs; the same
    object at every launch of a shape (an lru_cache lookup: no host time
    to speak of in a host-bound decode loop)."""
    from repro_torch.kernels import rb_spmv as krb
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    vx, vh = torch.zeros(6000, 375), torch.zeros(6000, 750)
    x, h = torch.zeros(8, 1500), torch.zeros(8, 1500)
    p = krb.stream_plan_for(vx, vh, x, h, 6000, fused=True)
    assert p == P.stream_plan(X=1500, H=1500, R=6000, B=8, Kx=375, Kh=750,
                              fused=True)
    assert krb.stream_plan_for(vx, vh, x, h, 6000, fused=True) is p
    assert krb.stream_args(p) == (1, 1, p.shift_x, p.shift_h, p.slot_bits,
                                  p.xpad, p.hpad, p.smem)
    s = krb.single_plan_for(vh, x, 6000)
    assert s == P.stream_plan(X=1500, R=6000, B=8, Kx=750)
    assert krb.single_plan_for(vh, x, 6000) is s


def test_q8_plan_for_reads_the_operands_and_is_cached(monkeypatch):
    """The staged q8 wrappers' plan: X, H and B from the activation codes,
    Kx and Kh from the packed codes, the code width from qx; the fused
    steps' (no R) or the dual SpMV's (R), the same object at every launch
    of a shape."""
    from repro_torch.kernels import rb_spmv_q8 as kq8
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    vx = torch.zeros(6000, 375, dtype=torch.int16)
    vh = torch.zeros(6000, 750, dtype=torch.int16)
    qx = qh = torch.zeros(8, 1500, dtype=torch.int16)
    fused = kq8.q8_plan_for(vx, vh, qx, qh, delta=True)
    dual = kq8.q8_plan_for(vx, vh, qx, qh, R=6000)
    assert fused == P.q8_plan(B=8, code_bytes=2, delta=True, **PTB)
    assert dual == P.q8_plan(B=8, code_bytes=2, R=6000, **PTB)
    assert kq8.q8_plan_for(vx, vh, qx, qh, R=6000) is dual
    assert kq8.q8_args(dual) == (1, 4, 3, dual.slot_bits, dual.xpad,
                                 dual.hpad, dual.smem)


@pytest.mark.parametrize("B,nb", [(4, 4), (8, 8), (16, 16)])
def test_delta_scan_plan_fits_the_card(B, nb):
    """The delta scan (B13) at lstm_ptb: the float scan's grid (125 blocks
    of 12 units, one an SM, one wave, as a cooperative launch needs), xs's
    masked deltas and h's staged, beside c, z and also m (4 units x NB) and
    the h reference (units x NB): 192,000 + 10 x 12 x NB x 4 bytes; the
    float scan's plan unchanged."""
    p = P.scan_plan(T=32, B=B, delta=True, **PTB)
    f = P.scan_plan(T=32, B=B, **PTB)
    assert p.nb == nb and p.delta and not f.delta
    assert (p.units, p.grid) == (f.units, f.grid) == (12, 125)
    assert p.stage_x and p.stage_h and p.col_bytes == (2, 2)
    assert p.smem == 1500 * P.SCAN_COLUMN + 10 * 12 * nb * 4
    assert f.smem == 1500 * P.SCAN_COLUMN + 5 * 12 * nb * 4
    assert p.smem <= P.SMEM_PER_BLOCK
    per_sm = P.blocks_per_sm(128, P.SCAN_THREADS, p.smem)
    assert per_sm == 1 and P.waves(p.grid, per_sm) == 1
    assert p.dxm_shape == (32, B, 1500) and f.dxm_shape == ()
    assert p.ax_shape == f.ax_shape and p.hx_shape == f.hx_shape


@pytest.mark.parametrize("kw,staged", [
    (dict(X=33000, H=97, T=32, B=12, Kx=8250, Kh=49), (False, True)),
    (dict(X=64, H=4000, T=32, B=12, Kx=16, Kh=2000), (True, False)),
    (dict(X=100, H=97, T=32, B=3, Kx=25, Kh=49), (True, True))])
def test_delta_scan_plan_gathers_what_does_not_fit(kw, staged):
    """chip_smoke's wide shape gathers dxm in the projection (int32
    columns), its tall shape gathers h's masked deltas from the planes in
    the recurrence; the small shape stages both; every plan's shared
    memory fits one block."""
    p = P.scan_plan(delta=True, **kw)
    assert (p.stage_x, p.stage_h) == staged
    assert p.col_bytes == tuple(2 if s else 4 for s in staged)
    assert p.smem <= P.SMEM_PER_BLOCK
    assert p.smem == (max(kw["X"] if staged[0] else 0,
                          kw["H"] if staged[1] else 0) * P.SCAN_COLUMN
                      + 10 * p.units * p.nb * 4)
    assert p.dxm_shape == (kw["T"], kw["B"], kw["X"])
    with pytest.raises(ValueError):
        P.scan_plan(T=4, B=17, delta=True, **PTB)


@pytest.mark.parametrize("kw", [dict(T=5, B=3, **PTB),
                                dict(X=64, H=4000, T=4, B=12, Kx=16,
                                     Kh=2000)])
def test_delta_scan_scratch_shapes(kw):
    """The delta scan's scratch: the float scan's ax, decoded columns and
    planes (h's masked deltas, read at every step whether h is staged or
    gathered), and dxm (T, B, X) float32, every step's masked x delta."""
    p = P.scan_plan(delta=True, **kw)
    ax, colx, colh, hx = kscan.scan_scratch(p, kw["Kx"], kw["Kh"], "cpu")
    R = 4 * kw["H"]
    assert ax.shape == (kw["T"], R, p.nb)
    assert colx.shape == (R, kw["Kx"]) and colh.shape == (R, kw["Kh"])
    assert hx.shape == (2, p.nb // 4, kw["H"], 4)
    dxm = torch.empty(p.dxm_shape, dtype=torch.float32)
    assert dxm.numel() == kw["T"] * kw["B"] * kw["X"]


def test_delta_scan_plan_for_reads_the_operands(monkeypatch):
    """The delta scan's wrapper plans from the operands with ``delta``:
    the same cached object at every launch of a shape."""
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    vx, vh = torch.zeros(6000, 375), torch.zeros(6000, 750)
    xs, h0 = torch.zeros(32, 8, 1500), torch.zeros(8, 1500)
    p = kscan.plan_for(vx, vh, xs, h0, delta=True)
    assert p == P.scan_plan(T=32, B=8, delta=True, **PTB)
    assert kscan.plan_for(vx, vh, xs, h0, delta=True) is p
    assert kscan.plan_for(vx, vh, xs, h0) == P.scan_plan(T=32, B=8, **PTB)


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16, 32, 64])
def test_delta_single_plan_is_one_wave_a_batch_tile(B):
    """B6 (delta_rb_spmv) plans as B11 does, d·f staged in x's place:
    125 blocks of 48 rows a 16-row tile at lstm_ptb, one 512-thread block
    an SM at up to 128 registers, one wave a tile; its occupancy comes from
    delta_rb_spmv.cu's own info entry."""
    from repro_torch.kernels import rb_spmv as krb
    p = P.stream_plan(X=1500, R=6000, B=B, Kx=375)
    per_sm = P.blocks_per_sm(128, P.STREAM_THREADS, p.smem)
    assert p.families == 1 and p.stage_x and (p.rows, p.grid) == (48, 125)
    assert per_sm == 1 and P.waves(p.grid * p.tiles, per_sm) == p.tiles
    assert p.tiles == -(-B // P.TILE)
    source, entry = krb._STREAM_INFO[1, False, True]
    assert (source, entry) == ("delta_rb_spmv", "brds_delta_rb_spmv_info")
    assert _build.SIGNATURES[source][entry] == _build.SIGNATURES[
        "rb_spmv"]["brds_rb_spmv_info"]


@pytest.mark.parametrize("R", [1, 5, 388, 6000, 6001, 16000])
def test_delta_single_plan_rows_cover_any_R(R, monkeypatch):
    """B6's wrapper plans from the deltas d (B, X) and the packed values:
    4 x ceil(R / 4 SMs) contiguous rows a block, every row owned once."""
    from repro_torch.kernels import delta_rb_spmv as kdelta
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    vals, d = torch.zeros(max(R, 1), 375), torch.zeros(8, 1500)
    p = kdelta.single_plan_for(vals, d, R)
    assert p == P.stream_plan(X=1500, R=R, B=8, Kx=375)
    assert p.rows % 4 == 0 and p.rows * p.grid >= R > p.rows * (p.grid - 1)


@pytest.mark.parametrize("X,K,B,staged", [(70000, 17500, 3, False),
                                          (33000, 8250, 12, False),
                                          (4000, 2000, 12, False),
                                          (1500, 750, 16, True)])
def test_delta_single_plan_gathers_deltas_too_wide_to_stage(X, K, B, staged):
    """chip_smoke's single-family shapes for B6: d·f of 70000 or 33000
    columns, or 4000 at NB=16, does not fit beside the sums and is gathered
    (DeltaAct's products); lstm_ptb's 1500 columns at NB=16 are staged."""
    p = P.stream_plan(X=X, R=4 * 97, B=B, Kx=K)
    assert p.stage_x == staged and p.smem <= P.SMEM_PER_BLOCK
    assert p.smem == ((p.xpad if staged else 0) + p.rows) * p.nb * 4


# qwen3-0.6b's decode: B=8, 16 q / 8 kv heads of 128, bf16, max_len 1024
DEC_SERVE = dict(B=8, Hkv=8, G=2, S=1024, D=128, elem_bytes=2)


def test_decode_plan_at_the_serve_shape():
    """Two slices a (b, kv head) pair, one cluster each; 128 blocks, one
    wave at one an SM; a ring of two 16 KB stages (32 KB in flight a
    block); the shared memory is the ring plus sixteen (m, l, acc) partials
    of two heads (eight warps, eight cluster ranks)."""
    p = P.decode_plan(**DEC_SERVE)
    assert (p.heads, p.groups, p.splits, p.stages) == (2, 1, 2, 2)
    assert p.stage_bytes == P.DEC_STREAMS * P.DEC_KEYS * 2 * 128 * 2
    assert p.stages * p.stage_bytes == P.DEC_RING
    assert p.smem == p.stages * p.stage_bytes + 4 * 16 * 2 * (128 + 2)
    assert p.grid == 128 and p.per_sm >= 1
    assert P.waves(p.grid, 1) == 1


@pytest.mark.parametrize("D", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("B,Hkv,G,S", [(8, 8, 2, 1024), (2, 8, 2, 32768),
                                       (5, 1, 8, 700), (3, 2, 4, 600),
                                       (64, 8, 2, 4096), (1, 1, 1, 8),
                                       (4, 2, 3, 96)])
def test_decode_plan_fits_the_card(B, Hkv, G, S, D, elem_bytes):
    """Every plan: 1-8 slices (the grid's x is the cluster, so clusters
    divide it), at least DEC_MIN_KEYS cache rows a slice, heads a block a
    power of two covering the group in ``groups`` blocks within the
    register budget (heads * D <= 512, or one head), 1-8 ring stages of at
    least DEC_RING bytes where a slice fills them, shared memory within a
    block's limit and at least one block an SM."""
    p = P.decode_plan(B=B, Hkv=Hkv, G=G, S=S, D=D, elem_bytes=elem_bytes)
    assert 1 <= p.splits <= P.DEC_MAX_SPLITS
    assert p.splits == 1 or S // p.splits >= P.DEC_MIN_KEYS
    assert p.heads in (1, 2, 4, 8) and p.heads * p.groups >= G
    assert p.heads * (p.groups - 1) < G
    assert p.heads == 1 or p.heads * D <= 512
    assert p.heads <= max(1, 1 << (G - 1).bit_length())
    assert 1 <= p.stages <= P.DEC_MAX_STAGES
    tiles = -(-(-(-S // p.splits)) // (P.DEC_STREAMS * P.DEC_KEYS))
    assert (p.stages == min(tiles, P.DEC_MAX_STAGES)
            or p.stages * p.stage_bytes >= P.DEC_RING)
    assert p.smem <= P.SMEM_PER_BLOCK and p.per_sm >= 1
    assert p.grid == B * Hkv * p.groups * p.splits
    # enough blocks for one an SM where the pairs and S allow it
    pairs = B * Hkv * p.groups
    if p.splits < P.DEC_MAX_SPLITS and p.splits < S // P.DEC_MIN_KEYS:
        assert pairs * (p.splits + 1) > P.SMS


def test_decode_plan_long_cache_uses_the_largest_cluster():
    """B=2 over a 32768-row cache (chip_smoke's long shape): 16 pairs take
    eight slices each, 128 blocks on 132 SMs; a slice of 4096 rows passes
    through the ring many times over."""
    p = P.decode_plan(B=2, Hkv=8, G=2, S=32768, D=128, elem_bytes=2)
    assert p.splits == 8 and p.grid == 128
    assert P.waves(p.grid, p.per_sm) == 1
    assert p.stages * P.DEC_STREAMS * P.DEC_KEYS < 32768 // 8


@pytest.mark.parametrize("B", [1, 3, 8, 12, 16, 32, 64])
@pytest.mark.parametrize("code_bytes", [1, 2])
def test_q8_single_plan_is_one_wave_a_batch_tile(B, code_bytes):
    """B10 (rb_spmv_q8, one family) at lstm_ptb's W_x and W_h (R = 6000):
    q's int8 or q1.11 codes staged as the dual SpMV stages qx (the same
    shift and padding) beside one family's sums (48 rows x NB float32), no
    h family; one 512-thread block an SM at up to 128 registers, 125
    blocks of 48 contiguous rows, one wave a 16-row tile."""
    for K in (PTB["Kx"], PTB["Kh"]):
        p = P.q8_plan(X=1500, B=B, Kx=K, code_bytes=code_bytes, R=6000)
        d = P.q8_plan(X=1500, H=1500, B=B, Kx=K, Kh=K,
                      code_bytes=code_bytes, R=6000)
        tiles = -(-B // P.TILE)
        assert p.families == 1 and d.families == 2
        assert p.staged and p.tiles == tiles and p.nb == d.nb
        assert (p.rows, p.grid) == (d.rows, d.grid) == (48, 125)
        assert (p.shift_x, p.xpad, p.slot_bits) == (d.shift_x, d.xpad,
                                                    d.slot_bits)
        assert p.hpad == 0 and p.shift_h == 0
        assert p.smem == p.xpad * p.nb * code_bytes + p.rows * p.nb * 4
        per_sm = P.blocks_per_sm(128, P.Q8_THREADS, p.smem)
        assert per_sm >= 1 and P.waves(p.grid * p.tiles, per_sm) == tiles


@pytest.mark.parametrize("R", [1, 5, 388, 1500, 6000, 6001, 16000])
def test_q8_single_plan_rows_cover_any_R(R):
    """B10 takes any R (the format API's row_balanced_q8 matvec):
    4 x ceil(R / 4 SMs) contiguous rows a block, at most one block an SM,
    every row owned once; without R there is no single-family plan."""
    p = P.q8_plan(X=1500, B=8, Kx=375, code_bytes=1, R=R)
    assert p.rows % 4 == 0 and p.grid <= P.SMS
    assert p.rows * p.grid >= R > p.rows * (p.grid - 1)
    with pytest.raises(ValueError):
        P.q8_plan(X=1500, B=8, Kx=375, code_bytes=1, R=0)
    with pytest.raises(ValueError):
        P.q8_plan(X=1500, B=8, Kx=375, code_bytes=1)


@pytest.mark.parametrize("X,B,code_bytes,staged", [
    (33000, 12, 1, False), (33000, 12, 2, False), (70000, 3, 1, False),
    (70000, 3, 2, False), (4000, 12, 2, True), (64, 12, 1, True)])
def test_q8_single_plan_gathers_codes_too_wide_to_stage(X, B, code_bytes,
                                                        staged):
    """chip_smoke's single-family q8 shapes: q of 33000 or 70000 columns
    does not fit beside the sums, so B10 gathers it from global memory
    (GlobalCodes) and its shared memory holds the sums alone; the tall
    shape's 4000-wide h at NB=16 in q1.11 (128 KB) and its 64-wide x are
    staged."""
    p = P.q8_plan(X=X, B=B, Kx=X // 4, code_bytes=code_bytes, R=4 * 97)
    assert p.staged == staged and p.smem <= P.SMEM_PER_BLOCK
    codes = p.xpad * p.nb * code_bytes if staged else 0
    assert p.smem == codes + p.rows * p.nb * 4


def test_single_q8_plan_for_reads_the_operands_and_is_cached(monkeypatch):
    """B10's plan: X and B from the activation codes, K from the packed
    codes, the code width from q; the same object at every launch of a
    shape."""
    from repro_torch.kernels import rb_spmv_q8 as kq8
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    v = torch.zeros(6000, 750, dtype=torch.int8)
    q = torch.zeros(8, 1500, dtype=torch.int8)
    p = kq8.single_q8_plan_for(v, q, 6000)
    assert p == P.q8_plan(X=1500, B=8, Kx=750, code_bytes=1, R=6000)
    assert kq8.single_q8_plan_for(v, q, 6000) is p


def _gates_units(plan, B, H, ldz, threads=P.GATES_THREADS):
    """lstm_gates_kernel's index map, modelled: each thread of each block
    takes items t = block x threads + thread, t + grid x threads, ... <
    items, item t unit j of batch row b (b = t // H, j = t - b H), z read
    at b x ldz + j. Returns the times each (b, j) is taken and the z
    offsets read."""
    seen = np.zeros((B, H), int)
    zo = []
    for blk in range(plan.grid):
        for th in range(threads):
            t = blk * threads + th
            while t < plan.items:
                b = t // H
                j = t - b * H
                seen[b, j] += 1
                zo.append(b * ldz + j)
                t += plan.grid * threads
    return seen, np.asarray(zo)


@pytest.mark.parametrize("H", [96, 97, 98, 99, 1500])
@pytest.mark.parametrize("ldz", ["4H", "4H+1", "4H+4"])
@pytest.mark.parametrize("B,sms", [(1, 132), (8, 132), (64, 1)])
def test_gates_index_map_covers_each_unit_once(H, ldz, B, sms):
    """B2's blocks (at most one wave: 16 of 128 threads an SM, striding
    when the units outnumber them, as at B = 64 on one SM) take each
    (b, j) exactly once, for H % 4 of 0-3 and a row stride of z that is
    or is not a multiple of 4 (the chained step's (B, 4H) z, or a wider
    one), and read z inside its B rows of ldz."""
    ldz = {"4H": 4 * H, "4H+1": 4 * H + 1, "4H+4": 4 * H + 4}[ldz]
    p = P.gates_plan(B=B, H=H, sms=sms)
    assert p.items == B * H and p.smem == 0
    assert 1 <= p.grid <= sms * 16
    seen, zo = _gates_units(p, B, H, ldz)
    assert (seen == 1).all()
    assert zo.min() >= 0 and zo.max() < B * ldz
    assert (zo % ldz < H).all()


def test_gates_plan_at_the_serve_shape():
    """lstm_ptb at B = 8: 12000 units in 94 blocks of 128, one wave."""
    p = P.gates_plan(B=8, H=1500)
    assert (p.items, p.grid) == (12000, 94)
    assert P.waves(p.grid, P.blocks_per_sm(40, P.GATES_THREADS)) == 1


@pytest.mark.parametrize("a,b,fits", [
    ((128, 512, 0), (32, 128, 0), False),          # registers
    ((96, 512, 100000), (32, 128, 0), True),
    ((64, 1024, 0), (32, 128, 0), False),          # warps
    ((64, 512, 200000), (32, 128, 40000), False),  # shared memory
    ((80, 512, 49664), (40, 128, 0), True)])
def test_fits_beside(a, b, fits):
    """One block of b beside one of a on an SM: warps, registers (a warp's
    in 256s) and shared memory (with the runtime's 1 KB a block) add."""
    assert P.fits_beside(a, b) == fits


@pytest.mark.parametrize("D", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 8, 16])
def test_flash_tc_block_fits_and_spills_nowhere(D, G):
    """B15's tensor-core block (``attention.cu`` tc_smem): two consumer
    warpgroups for an even group, one for an odd one, and one at head_dim
    256 whatever the group (two spill there); Q tiles of 64 rows, three
    K / V stages of 64 keys (32 at D=256), columns padded to a 64-column
    atom; within a block's shared memory at every head dim."""
    wg = P.flash_warpgroups(G, D)
    assert wg == (2 if G % 2 == 0 and D < 256 else 1)
    dp, bk = max(D, 64), (32 if D == 256 else 64)
    assert P.flash_smem(G, D) == (1024 + wg * 64 * dp * 2
                                  + 2 * 3 * bk * dp * 2 + 7 * 8)
    assert P.flash_smem(G, D) <= P.SMEM_PER_BLOCK


def test_decode_plan_at_recurrentgemma_local_attention():
    """recurrentgemma-9b's decode: B=4, 16 q heads on one kv head of 256,
    bf16, a 2624-row cache. One q head a block (two spill at D=256), so
    16 head groups x 2 slices x 4 rows: 128 blocks, one wave at two an
    SM; a ring of two 32 KB stages."""
    assert P.decode_heads(16, 256) == 1 and P.decode_heads(16, 128) == 4
    p = P.decode_plan(B=4, Hkv=1, G=16, S=2624, D=256, elem_bytes=2)
    assert (p.heads, p.groups, p.splits, p.stages) == (1, 16, 2, 2)
    assert p.grid == 128 and p.smem <= P.SMEM_PER_BLOCK
    assert P.waves(p.grid, p.per_sm) == 1
