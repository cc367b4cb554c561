"""Launch plans of the persistent scans, float and temporal delta
(``csrc/fused_scan.cu``, ``fused_scan_kernel``), the staged q8 kernels
(the fused q8 steps, ``csrc/fused_step.cu`` ``fused_step_q8_kernel``; the
dual SpMV, ``csrc/rb_spmv_q8.cu`` ``rb_dual_parts_staged_kernel``; the
single-family q8 SpMV, ``rb_spmv_q8_staged_kernel``), the
staged float kernels (the float and temporal-delta steps,
``fused_staged_kernel``; the dual SpMVs, ``csrc/rb_spmv.cu``
``rb_dual_staged_kernel`` and ``csrc/delta_rb_spmv.cu``
``delta_dual_staged_kernel``; the single-family SpMVs,
``rb_spmv_staged_kernel`` and ``delta_spmv_staged_kernel``), the LSTM
cell (``csrc/lstm_gates.cu``, ``lstm_gates_kernel``) and decode
attention (``csrc/attention.cu``, ``decode_cluster_kernel``): grid,
hidden units or rows a block, the shared-memory layout of the staged
activations and the scratch they need, the slices, clusters and copy ring
of decode attention, from the card's limits in plain arithmetic, so the
CPU tests hold it. Also the occupancy arithmetic (blocks an SM from
registers, threads and shared memory; whether a block of one kernel fits
beside another's) and the waves a grid takes.

The wrappers pass the card's SM count; the other limits are Hopper's
(H100: 65536 registers and 228 KB of shared memory an SM, 227 KB a
block).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

from .. import hw

SMS = hw.SMS                # H100 SXM
REGS_PER_SM = 65536
REG_UNIT = 256              # registers are allocated to a warp in 256s
WARP_GRANULE = 4            # ... and warps by fours
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
SMEM_PER_SM = 233472        # 228 KB
SMEM_PER_BLOCK = hw.SMEM_PER_BLOCK  # 227 KB, the opt-in limit of a block
SMEM_RESERVED = 1024        # the runtime's own shared memory a block
TILE = 16                   # batch rows a launch's tile (brds::kMaxBatch)

SCAN_THREADS = 512          # fused_scan.cu kScanThreads
SCAN_COLUMN = 128           # bytes a staged column takes (8 float4 pieces)
Q8_THREADS = 512            # brds_common.cuh kQ8Threads (staged q8)
STREAM_THREADS = 512        # brds_common.cuh kStreamThreads (staged float)
GATES_THREADS = 128         # lstm_gates.cu kThreads
DEC_THREADS = 256           # attention.cu kDecThreads
DEC_STREAMS = 16            # ... kStreams: key streams (half-warps) a block
DEC_KEYS = 2                # ... kDecU: keys a stream takes a stage
DEC_MAX_STAGES = 8          # ... kMaxStages
DEC_MAX_SPLITS = 8          # ... kMaxCluster: the portable cluster size
DEC_MIN_KEYS = 64           # cache rows a slice at least
DEC_RING = 32768            # bytes in flight a block at least (the ring)
DEC_REGS = 128              # __launch_bounds__(256, 2): two blocks an SM


def blocks_per_sm(regs: int, threads: int, smem: int = 0) -> int:
    """Blocks of ``threads`` an SM holds at ``regs`` registers a thread and
    ``smem`` bytes of shared memory a block (the occupancy calculator's
    arithmetic)."""
    warps = -(-threads // 32)
    by_warps = MAX_WARPS_PER_SM // warps
    regs_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    warps_by_regs = (REGS_PER_SM // regs_warp) // WARP_GRANULE * WARP_GRANULE
    by_regs = warps_by_regs // warps
    by_smem = SMEM_PER_SM // (smem + SMEM_RESERVED)
    return max(0, min(by_warps, by_regs, by_smem, MAX_BLOCKS_PER_SM))


def fits_beside(a: tuple, b: tuple) -> bool:
    """Whether one block of kernel ``b`` fits on an SM that holds one
    block of kernel ``a``, each given as (registers a thread, threads,
    shared bytes a block): their warps, registers (a warp's in 256s) and
    shared memory (each block's plus the runtime's own) together."""
    warps = [-(-threads // 32) for _, threads, _ in (a, b)]
    regs = sum(-(-r * 32 // REG_UNIT) * REG_UNIT * w
               for (r, _, _), w in zip((a, b), warps))
    smem = sum(s + SMEM_RESERVED for _, _, s in (a, b))
    return (sum(warps) <= MAX_WARPS_PER_SM and regs <= REGS_PER_SM
            and smem <= SMEM_PER_SM)


def waves(blocks: int, per_sm: int, sms: int = SMS) -> int:
    """Waves a grid of ``blocks`` takes at ``per_sm`` blocks an SM."""
    if per_sm < 1:
        raise ValueError("no block of this kernel fits on an SM")
    return -(-blocks // (per_sm * sms))


def tier(B: int) -> int:
    """The accumulator count a batch of B ≤ 16 rows runs at (by_batch)."""
    if not 1 <= B:
        raise ValueError(f"batch {B}: need at least one row")
    return 4 if B <= 4 else 8 if B <= 8 else TILE


def spacing_shift(ncols: int, K: int, per_lane: int = 1) -> int:
    """log2 of the columns between neighbouring lanes' entries (each lane
    taking ``per_lane`` consecutive entries of a row of K over ``ncols``),
    rounded: the bits ``stage_pos`` moves to the bottom."""
    if K <= 0 or ncols <= 0:
        return 0
    return max(0, min(10, round(math.log2(per_lane * ncols / K))))


def stage_pos(c, shift: int, slot_bits: int):
    """brds::stage_pos: column c's position in a staged array (numpy
    arrays or ints)."""
    m = shift + slot_bits
    return (((c >> m) << m) | ((c & ((1 << shift) - 1)) << slot_bits)
            | ((c >> shift) & ((1 << slot_bits) - 1)))


def staged_cols(n: int, shift: int, slot_bits: int) -> int:
    """n columns padded to whole runs of stage_pos's permutation."""
    run = 1 << (shift + slot_bits)
    return -(-n // run) * run


@dataclass(frozen=True)
class ScanPlan:
    """One launch of the float or the delta scan over at most 16 batch
    rows."""
    nb: int           # accumulators a lane (4, 8, 16)
    units: int        # hidden units a block
    grid: int         # blocks, one an SM
    stage_x: bool     # xs (dxm) staged in shared memory (else gathered)
    stage_h: bool     # h (its masked delta) staged (else gathered)
    smem: int         # dynamic shared memory a block
    ax_shape: tuple   # (T, 4H, nb) float32
    hx_shape: tuple   # (2, nb / 4, H, 4) float32: h, staged layout
    col_bytes: tuple  # decoded-column element size of Sx, Sh (2 or 4)
    delta: bool       # the delta scan's plan
    dxm_shape: tuple  # the delta scan's (T, B, X) float32; () for the float


@lru_cache(maxsize=256)
def scan_plan(*, X: int, H: int, T: int, B: int, Kx: int, Kh: int,
              delta: bool = False, sms: int = SMS,
              smem_limit: int = SMEM_PER_BLOCK) -> ScanPlan:
    """The scans' plan: ceil(H / sms) units a block (one block an SM, all
    co-resident); xs (32 / NB steps a pass) and h staged when their
    columns, one 128-byte bank row each (fused_scan.cu kPieces), fit
    beside c and z (``delta``: also m, 4 units x NB, and the h reference,
    units x NB); they share the space (the prologue ends before the first
    h is staged). The delta scan stages the masked deltas in their place
    and writes every step's masked x delta to a (T, B, X) scratch first.
    Kx and Kh do not change the plan."""
    if B > TILE:
        raise ValueError(f"a scan launch takes at most {TILE} batch rows")
    nb = tier(B)
    units = -(-H // sms)
    grid = -(-H // units)
    # c (units x NB) and z (4 units x NB); m and h_ref as many again
    fixed = (10 if delta else 5) * units * nb * 4
    room = smem_limit - fixed
    stage_x = X * SCAN_COLUMN <= room
    stage_h = H * SCAN_COLUMN <= room
    staged = max(X if stage_x else 0, H if stage_h else 0)
    return ScanPlan(nb=nb, units=units, grid=grid, stage_x=stage_x,
                    stage_h=stage_h, smem=staged * SCAN_COLUMN + fixed,
                    ax_shape=(T, 4 * H, nb), hx_shape=(2, nb // 4, H, 4),
                    col_bytes=(2 if stage_x else 4, 2 if stage_h else 4),
                    delta=delta, dxm_shape=(T, B, X) if delta else ())


@dataclass(frozen=True)
class DecodePlan:
    """One launch of decode attention: grid (splits, B * Hkv, groups),
    clusters of ``splits`` blocks."""
    heads: int        # q heads a block (GM)
    groups: int       # blocks a kv group's q heads take (gridDim.z)
    splits: int       # slices of a (b, kv head) pair: the cluster size
    stages: int       # stages of the copy ring
    stage_bytes: int  # a stage: DEC_STREAMS x DEC_KEYS keys' K and V rows
    smem: int         # dynamic shared memory a block
    per_sm: int       # blocks an SM at DEC_REGS registers
    grid: int         # blocks


def decode_heads(G: int, D: int) -> int:
    """attention.cu by_decode's GM: the least power of two >= G, at most
    8 and at most 512 / D (the register budget), one at D = 256 (two
    spill)."""
    cap = 1 if D >= 256 else 512 // D
    cap = 8 if cap >= 8 else 4 if cap >= 4 else 2 if cap >= 2 else 1
    return min(1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8, cap)


def flash_warpgroups(G: int, D: int) -> int:
    """attention.cu dispatch_flash_tc's consumer warpgroups a block of
    B15's tensor-core body (q heads a block): two when the group size G is
    even, else one, and one at D = 256, where two spill (tc_pairs)."""
    return 2 if G % 2 == 0 and D < 256 else 1


def flash_smem(G: int, D: int) -> int:
    """attention.cu tc_smem: the tensor-core body's dynamic shared memory
    at head dim D and group size G: the warpgroups' 64-row Q tiles, three
    K and V stages of 64 keys (32 at D = 256), the mbarriers and slack to
    align the base to 1024 bytes (columns padded to a 64-column atom)."""
    dp = max(D, 64)
    bk = 32 if D > 192 else 64
    return (1024 + flash_warpgroups(G, D) * 64 * dp * 2 + 2 * 3 * bk * dp * 2
            + (2 * 3 + 1) * 8)


def decode_smem(D: int, elem_bytes: int, heads: int, stages: int) -> tuple:
    """attention.cu decode_smem: (a stage's bytes, the block's dynamic
    shared memory): the ring, then (m, l, acc) of each warp and of each
    rank of a cluster (rank 0 gathers them)."""
    stage = DEC_KEYS * 2 * (D // DEC_STREAMS * elem_bytes) * DEC_THREADS
    merge = 4 * (DEC_THREADS // 32 + DEC_MAX_SPLITS) * heads * (D + 2)
    return stage, stages * stage + merge


@lru_cache(maxsize=256)
def decode_plan(*, B: int, Hkv: int, G: int, S: int, D: int,
                elem_bytes: int, sms: int = SMS) -> DecodePlan:
    """Decode attention's plan for a (B, Hkv, S, D) cache and G q heads a
    kv head: enough (pair, slice) blocks for one an SM, at most
    DEC_MAX_SPLITS slices (one cluster) and at least DEC_MIN_KEYS of the
    cache's S rows a slice; a ring of at least two stages and DEC_RING
    bytes, no more stages than a slice of S / splits rows fills. The live
    length is on the card and is not read here. (On the H100 at qwen3-0.6b's
    decode shape, two slices and two stages beat one slice, four, eight,
    and rings of four or six stages: PERF.md.)"""
    gm = decode_heads(G, D)
    groups = -(-G // gm)
    pairs = B * Hkv * groups
    splits = max(1, min(DEC_MAX_SPLITS, sms // pairs, S // DEC_MIN_KEYS))
    rows = -(-S // splits)                  # a slice's rows at most
    tiles = -(-rows // (DEC_STREAMS * DEC_KEYS))
    stage = decode_smem(D, elem_bytes, gm, 0)[0]
    stages = max(1, min(tiles, DEC_MAX_STAGES,
                        max(2, -(-DEC_RING // stage))))
    smem = decode_smem(D, elem_bytes, gm, stages)[1]
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"decode attention at D={D} needs {smem} bytes of "
                         "shared memory a block")
    return DecodePlan(heads=gm, groups=groups, splits=splits, stages=stages,
                      stage_bytes=stage, smem=smem,
                      per_sm=blocks_per_sm(DEC_REGS, DEC_THREADS, smem),
                      grid=pairs * splits)


@dataclass(frozen=True)
class Q8Plan:
    """One launch of a staged q8 kernel (every batch tile of it): the
    fused q8 or delta-q8 step (B8, B9), the dual SpMV (B7) or the
    single-family SpMV (B10; ``families`` 1: qx alone)."""
    nb: int
    tiles: int        # batch tiles of 16 rows (gridDim.y)
    rows: int         # rows a block (the fused steps: 4 x units)
    grid: int         # blocks a tile (gridDim.x)
    staged: bool      # qx, qh staged in shared memory (else global gathers)
    slot_bits: int
    shift_x: int
    shift_h: int
    xpad: int
    hpad: int
    smem: int
    families: int     # packed families a row: 2 (x and h) or 1 (x)

    @property
    def units(self) -> int:
        """Hidden units a block of a fused step."""
        return self.rows // 4


@lru_cache(maxsize=256)
def q8_plan(*, X: int, B: int, Kx: int, code_bytes: int,
            H: int | None = None, Kh: int = 0, delta: bool = False,
            R: int | None = None, sms: int = SMS,
            smem_limit: int = SMEM_PER_BLOCK) -> Q8Plan:
    """The plan of the staged q8 kernels: the fused q8 step (``delta``:
    the delta-q8 step's, which keeps zx and zh apart, twice z's room), a
    block owning the four gate rows of ceil(H / sms) hidden units, or,
    given ``R``, the dual SpMV rb_dual_parts_q8 over any R rows, a block
    owning 4 x ceil(R / 4 sms) contiguous rows and keeping zx and zh apart
    (the fused step's count and room at R = 4H); without H, the
    single-family SpMV rb_spmv_q8 (qx alone, Kx entries a row, the dual
    SpMV's rows a block, one family's sums). One block an SM, so one wave
    a batch tile; the tile's codes staged as (xpad + hpad) vectors of NB
    codes when they fit beside the sums, else gathered from global
    memory. A lane takes four consecutive entries, so neighbouring lanes'
    entries lie about 4 x ncols / K columns apart."""
    nb = tier(min(B, TILE))
    tiles = -(-B // TILE)
    families = 1 if H is None else 2
    if R is None:
        if H is None:
            raise ValueError("a single-family q8 SpMV needs R")
        rows = 4 * -(-H // sms)
        grid = -(-H // (rows // 4))
        sums = (2 if delta else 1) * rows
    else:
        if R < 1:
            raise ValueError(f"R={R}: a launch needs at least one row")
        rows = 4 * -(-R // (4 * sms))
        grid = -(-R // rows)
        sums = families * rows
    vec = nb * code_bytes
    slot_bits = int(math.log2(128 // min(vec, 32)))
    shift_x = spacing_shift(X, Kx, 4)
    shift_h = 0 if H is None else spacing_shift(H, Kh, 4)
    xpad = staged_cols(X, shift_x, slot_bits)
    hpad = 0 if H is None else staged_cols(H, shift_h, slot_bits)
    zs = sums * nb * 4
    codes = (xpad + hpad) * vec
    staged = codes + zs <= smem_limit
    return Q8Plan(nb=nb, tiles=tiles, rows=rows, grid=grid, staged=staged,
                  slot_bits=slot_bits, shift_x=shift_x, shift_h=shift_h,
                  xpad=xpad, hpad=hpad,
                  smem=(codes if staged else 0) + zs, families=families)


@dataclass(frozen=True)
class StreamPlan:
    """One launch of a staged float kernel (every batch tile): the float
    step (B3) or dual SpMV (B1), their temporal-delta forms (B5, B4), or
    the single-family SpMV (B11, or B6 on d·f; ``families`` 1: x
    alone)."""
    nb: int
    tiles: int        # batch tiles of 16 rows (gridDim.y)
    rows: int         # gate rows a block (the fused step: 4 x units)
    grid: int         # blocks a tile (gridDim.x)
    stage_x: bool     # x (or dx * fx) staged in shared memory, else gathered
    stage_h: bool     # h (or dh * fh) staged
    slot_bits: int
    shift_x: int
    shift_h: int
    xpad: int
    hpad: int
    smem: int
    families: int     # packed families a row: 2 (x and h) or 1 (x)

    @property
    def units(self) -> int:
        """Hidden units a block of the fused step."""
        return self.rows // 4


@lru_cache(maxsize=256)
def stream_plan(*, X: int, R: int, B: int, Kx: int, H: int | None = None,
                Kh: int = 0, fused: bool = False, sms: int = SMS,
                smem_limit: int = SMEM_PER_BLOCK) -> StreamPlan:
    """The plan of the staged float kernels, whose operands are x and h
    (the float step B3 and dual SpMV B1) or the masked deltas d·f (their
    temporal-delta forms B5 and B4), both NB float32 a column: a fused
    step (``fused``: R = 4H gate rows, a block owns the four rows of
    ceil(H / sms) hidden units) or a dual SpMV (any R, a block owns
    4 x ceil(R / 4 sms) contiguous rows, the fused step's count at R = 4H);
    without H, the single-family SpMV (B11, or B6 on d·f: x alone, Kx
    entries a row, the dual SpMV's rows a block). One block an SM, so one
    wave a batch tile. The layout depends only on the shapes. A staged
    column is NB float32 (NB/4 16-byte pieces), 8 / (NB/4) columns a
    128-byte bank row (``slot_bits``); lane l takes entries l, l+32, ...
    of a row, so neighbouring lanes' columns lie about ncols / K apart,
    the bits ``stage_pos`` moves down (``shift``; 0 at NB=4, where one piece a
    column and no shift spreads random columns better than column order).
    Each family is staged if it fits beside the sums (rows x NB float32 a
    family), the one with more entries a row first; the other is gathered
    from global memory."""
    if R < 1:
        raise ValueError(f"R={R}: a launch needs at least one row")
    nb = tier(min(B, TILE))
    tiles = -(-B // TILE)
    if fused:
        if H is None or R != 4 * H:
            raise ValueError(f"a fused step has R = 4H rows, got "
                             f"R={R}, H={H}")
        rows = 4 * -(-H // sms)
    else:
        rows = 4 * -(-R // (4 * sms))
    grid = -(-R // rows)
    nq = nb // 4
    slot_bits = int(math.log2(8 // nq))
    fams = [("x", X, Kx)] + ([] if H is None else [("h", H, Kh)])
    shift = {f: spacing_shift(n, K) if nb > 4 else 0 for f, n, K in fams}
    pad = {f: staged_cols(n, shift[f], slot_bits) for f, n, _ in fams}
    vec = nb * 4
    smem = len(fams) * rows * vec   # ax (and ah)
    staged = set()
    for fam, _, K in sorted(fams, key=lambda f: -f[2]):
        if smem + pad[fam] * vec <= smem_limit:
            staged.add(fam)
            smem += pad[fam] * vec
    return StreamPlan(nb=nb, tiles=tiles, rows=rows, grid=grid,
                      stage_x="x" in staged, stage_h="h" in staged,
                      slot_bits=slot_bits, shift_x=shift["x"],
                      shift_h=shift.get("h", 0), xpad=pad["x"],
                      hpad=pad.get("h", 0), smem=smem, families=len(fams))


@dataclass(frozen=True)
class GatesPlan:
    """One launch of the LSTM cell (B2): one (b, j) unit a thread, the
    B x H ``items`` strided over ``grid`` blocks of GATES_THREADS."""
    items: int
    grid: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block: none."""
        return 0


@lru_cache(maxsize=256)
def gates_plan(*, B: int, H: int, sms: int = SMS) -> GatesPlan:
    """The cell's plan: a block a GATES_THREADS units, at most one wave of
    blocks (as many as the SMs hold by warps), striding beyond."""
    if B < 1 or H < 1:
        raise ValueError(f"B={B}, H={H}: the cell needs a unit")
    items = B * H
    wave = sms * (MAX_WARPS_PER_SM // (GATES_THREADS // 32))
    return GatesPlan(items=items,
                     grid=min(-(-items // GATES_THREADS), wave))
