// The multi-token BRDS-LSTM scans: T fused layer steps in one persistent,
// cooperative launch.
//
//  - fused_brds_lstm_scan: for t < T, z = Sx@xs[t] + Sh@h + bias, then the
//    cell; hs[t] = h. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_lstm_scan.
//  - fused_brds_delta_lstm_scan: for t < T, the uncapped temporal-delta
//    threshold of xs[t] and h against their references, m' = m +
//    Sx@(fx*dx) + Sh@(fh*dh), z = m' + bias, then the cell. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_delta_lstm_scan.
//
// The TPU kernels walk a sequential (T, row-block) grid and keep c, h (and
// the references and m) in VMEM scratch from one grid step to the next.
// Blocks on a GPU run concurrently and in no order, so here the grid is
// persistent: it is co-resident and launched with
// cudaLaunchCooperativeKernel, each block owns a fixed set of hidden units
// for all T steps, c (and m) never leave their block, and only h crosses
// blocks: step t writes hs[t], the grid synchronises, and step t+1 reads
// hs[t] (h0 at t = 0) with loads that go through L2 (the read-only path is
// not coherent with stores made in the same launch).
//
// fused_brds_lstm_scan, one block per SM. A block owns `units` consecutive
// hidden units and their 4 * units gate rows (j, H+j, 2H+j, 3H+j), spread
// over its 16 warps, a warp per row at a time; a row stays with one warp
// and each entry with one lane through every phase:
//  1. decode: each row's delta-coded columns are summed once into a
//     scratch of absolute columns (as their positions in the staged
//     activations), not once per step;
//  2. input projection: ax[t] = Sx@xs[t] does not depend on h, so it is
//     computed for every t up front, out of the recurrence: 32 / NB steps
//     of xs at a time are staged in shared memory, each packed entry is
//     read once a pass and applied to 32 activations, and the sums go to
//     a (T, 4H, NB) scratch;
//  3. recurrence, per step: h is staged in shared memory, a column's NB
//     values side by side (repeated to fill a 128-byte bank row, see
//     kPieces), so an entry's NB activations are NB/4 shared loads that
//     meet no bank conflict; only Sh@h, the cell and one grid barrier
//     remain. The cells also write h in that layout (hx) for the next
//     step's staging, a straight copy.
// Activations too wide for shared memory (stage_x / stage_h false: 128
// bytes a column, so beyond about 1750 columns) are gathered from global
// memory instead, one lane an entry, as the single-step kernel does.
//
// fused_brds_delta_lstm_scan keeps the first design (not redesigned yet):
// blocks sized to be co-resident (occupancy x SMs), each owning tiles of
// kJT hidden units with one warp per gate row (the first single-step
// design, since replaced in fused_step.cu), and a threshold phase per
// step, one column per thread over the whole grid, which writes the
// masked deltas to global scratch and updates the references in place; a
// second grid barrier separates it from the gate phase.
//
// Each step is bitwise equal to one launch of the single-step kernel
// (fused_step.cu fused_staged_kernel, float or delta): every (row, batch)
// sum keeps brds::row_dot's order (lane l takes entries l, l+32, ... in order
// with fmaf, then the xor butterfly; ax and ah apart), z = (ax + ah) +
// bias (or delta_update, then + bias), and the cell is brds::lstm_cell;
// staging, streaming and hoisting (here, and in the step kernels'
// brds::row_dot_stream) change where the operands come from, not that
// order. The masked delta is the same __fmul_rn(d, fired) that DeltaAct
// forms, and the threshold the same float32 ops as
// sparse/temporal.py::delta_threshold (d = v - ref, |d| > theta strictly,
// ref' = fired ? v : ref).
//
// Bound: operations. Over T steps every packed entry takes B fp32 FMAs a
// step (3.46 GFLOP for a 1500-wide layer, B=8, T=32: 0.052 ms at 67
// TFLOP/s), while the packed weights (40.5 MB with int16 deltas) need be
// read from device memory only once (0.013 ms at 3.35 TB/s). What binds
// the redesign is shared-memory bandwidth: each FMA reads its own 4-byte
// activation from shared memory (no two entries of a row share a column),
// 128 bytes a clock an SM, a quarter of the FMA rate; PERF.md has the
// card's times.
#include <cooperative_groups.h>

#include "brds_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------- the delta scan (B13)

constexpr int kJT = 2;                            // hidden units per tile
constexpr int kThreads = kJT * 4 * brds::kWarp;   // one warp per gate row
// Blocks per SM asked of ptxas for the 4- and 8-accumulator tiers: at six
// (40 registers a thread), the 750 tiles of a 1500-wide layer are all
// co-resident on 132 SMs, one tile per block, as the single-step kernel's
// one wave; at the registers ptxas would pick alone (48-58), blocks loop
// over two tiles a step. The 16-accumulator tier is left to ptxas.
template <int NB>
constexpr int kMinBlocks = NB <= 8 ? 6 : 1;

// z += v * act[b, col] where act was written earlier in this launch by
// other blocks, before the grid barrier: a plain (weak) load, which the
// memory model orders after the barrier, and never the read-only path
// (__ldg, ld.global.nc), which is not coherent with stores made in the same
// launch. The pointer is not __restrict__, so the compiler cannot turn the
// load into a read-only one.
struct F32ActSynced {
  using W = float;
  using Acc = float;
  const float* act;
  int ld;
  __device__ __forceinline__ float mac(float acc, float v, int b,
                                       int col) const {
    return fmaf(v, act[b * ld + col], acc);
  }
};

template <typename IX, typename IH>
struct DeltaScanArgs {
  const float* vx;
  const IX* ix;
  int kx;
  const float* xs;   // (T, B, X)
  int X;
  const float* vh;
  const IH* ih;
  int kh;
  const float* h0;   // (B, H)
  int H;
  const float* bias;
  const float* c0;
  const float* m0;   // (B, 4H)
  float* x_ref;      // (B, X), updated in place
  float* h_ref;      // (B, H), updated in place
  float* dxm;        // (B, X) scratch: the step's masked x deltas
  float* dhm;        // (B, H) scratch: the step's masked h deltas
  float* hs;         // (T, B, H)
  float* c_out;
  float* m_out;
  float theta_x, theta_h;
  int T, B, tiles_per_block;
  brds::Act act;
};

// The block's k-th tile, or -1 past the last tile (block-uniform).
__device__ __forceinline__ int tile_of(int k, int ntiles) {
  const int tile = blockIdx.x + k * gridDim.x;
  return tile < ntiles ? tile : -1;
}

// Closes the cells of one tile from zs: thread t < kJT * B takes (unit
// t / B, batch t % B); its c lives in cs[t / B][b] across steps.
template <int NB>
__device__ __forceinline__ void close_tile(const float (&zs)[kJT][4][NB],
                                           float* cs, int tile, int H, int B,
                                           float* __restrict__ h_out,
                                           const brds::Act& act) {
  const int t = threadIdx.x;
  if (t < kJT * B) {
    const int jl = t / B, b = t % B;
    const int j = tile * kJT + jl;
    if (j < H) {
      float c, h;
      brds::lstm_cell(zs[jl][0][b], zs[jl][1][b], zs[jl][2][b], zs[jl][3][b],
                      cs[jl * NB + b], act, &c, &h);
      cs[jl * NB + b] = c;
      h_out[(size_t)b * H + j] = h;
    }
  }
}

// c of every tile the block owns: load from c0, or store into c_out.
template <int NB>
__device__ __forceinline__ void move_c(float* cs, float* __restrict__ c_g,
                                       int ntiles, int tpb, int H, int B,
                                       bool load) {
  const int t = threadIdx.x;
  if (t >= kJT * B) return;
  const int jl = t / B, b = t % B;
  for (int k = 0; k < tpb; ++k) {
    const int tile = tile_of(k, ntiles);
    const int j = tile * kJT + jl;
    if (tile < 0 || j >= H) continue;
    float& s = cs[(k * kJT + jl) * NB + b];
    if (load) s = c_g[(size_t)b * H + j];
    else c_g[(size_t)b * H + j] = s;
  }
}

// The threshold phase: over n = B * N columns, one per thread of the
// grid (the same thread each step, so ref[i] is only ever touched by it):
// d = v - ref, fired = |d| > theta, dm = d * fired, ref' = fired ? v : ref.
__device__ __forceinline__ void threshold(const float* v, float* ref,
                                          float* dm, int n, float theta) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float vi = __ldcg(v + i);
    const float r = ref[i];
    const float d = __fsub_rn(vi, r);
    const bool fired = fabsf(d) > theta;
    dm[i] = __fmul_rn(d, fired ? 1.0f : 0.0f);
    ref[i] = fired ? vi : r;
  }
}

template <typename IX, typename IH, int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NB>)
fused_delta_scan_kernel(const DeltaScanArgs<IX, IH> a) {
  // [tiles_per_block][kJT][NB] c, then [tiles_per_block][kJT][4][NB] m
  extern __shared__ float smem[];
  __shared__ float zs[kJT][4][NB];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int H = a.H, B = a.B, R = 4 * H;
  const int ntiles = (H + kJT - 1) / kJT;
  float* cs = smem;
  float* ms = smem + a.tiles_per_block * kJT * NB;
  move_c<NB>(cs, const_cast<float*>(a.c0), ntiles, a.tiles_per_block, H, B,
             true);
  // m of each of the block's rows lives with the lane that updates it
  for (int k = 0; k < a.tiles_per_block; ++k) {
    const int tile = tile_of(k, ntiles);
    const int j = tile * kJT + jl;
    if (tile >= 0 && j < H && lane < B)
      ms[((k * kJT + jl) * 4 + gate) * NB + lane] =
          a.m0[(size_t)lane * R + gate * H + j];
  }
  for (int t = 0; t < a.T; ++t) {
    const float* h = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * B * H;
    float* h_out = a.hs + (size_t)t * B * H;
    threshold(a.xs + (size_t)t * B * a.X, a.x_ref, a.dxm, B * a.X,
              a.theta_x);
    threshold(h, a.h_ref, a.dhm, B * H, a.theta_h);
    grid.sync();         // the step's masked deltas are complete
    for (int k = 0; k < a.tiles_per_block; ++k) {
      const int tile = tile_of(k, ntiles);
      if (tile < 0) break;
      const int j = tile * kJT + jl;
      if (j < H) {
        const int row = gate * H + j;
        float ax[NB] = {}, ah[NB] = {};
        brds::row_dot<IX, NB>(a.vx + (size_t)row * a.kx,
                              a.ix + (size_t)row * a.kx, a.kx,
                              F32ActSynced{a.dxm, a.X}, B, ax);
        brds::row_dot<IH, NB>(a.vh + (size_t)row * a.kh,
                              a.ih + (size_t)row * a.kh, a.kh,
                              F32ActSynced{a.dhm, H}, B, ah);
        const float bb = a.bias[row];
        float* mrow = ms + ((k * kJT + jl) * 4 + gate) * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b)   // the fused delta step's m', z
          if (b < B && b == lane) {
            const float mn = brds::delta_update(mrow[b], ax[b], ah[b]);
            mrow[b] = mn;
            zs[jl][gate][b] = __fadd_rn(mn, bb);
          }
      }
      __syncthreads();
      close_tile<NB>(zs, cs + k * kJT * NB, tile, H, B, h_out, a.act);
      __syncthreads();
    }
    grid.sync();         // hs[t] complete; dxm, dhm free for step t + 1
  }
  move_c<NB>(cs, a.c_out, ntiles, a.tiles_per_block, H, B, false);
  for (int k = 0; k < a.tiles_per_block; ++k) {
    const int tile = tile_of(k, ntiles);
    const int j = tile * kJT + jl;
    if (tile >= 0 && j < H && lane < B)
      a.m_out[(size_t)lane * R + gate * H + j] =
          ms[((k * kJT + jl) * 4 + gate) * NB + lane];
  }
}

// Sizes the persistent grid: as many blocks as tiles when they can all be
// co-resident, else every block the card holds at once, each looping over
// ceil(tiles / grid) tiles with shared memory for their state. Fails when
// not even one block per SM fits.
template <typename Kern>
cudaError_t plan_grid(Kern kern, int ntiles, size_t bytes_per_tile,
                      int* grid, int* tpb, size_t* smem) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *grid = ntiles;
  for (;;) {
    *tpb = (ntiles + *grid - 1) / *grid;
    *smem = *tpb * bytes_per_tile;
    if (*smem > 48 * 1024) return cudaErrorInvalidValue;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, *smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
    if (*grid <= per_sm * sms) return cudaSuccess;
    *grid = per_sm * sms;
  }
}

template <typename Args, typename Kern>
cudaError_t launch(Kern kern, Args& a, int ntiles, size_t bytes_per_tile,
                   void* stream) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = plan_grid(kern, ntiles, bytes_per_tile, &grid,
                            &a.tiles_per_block, &smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------- the float scan (B12)

constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / brds::kWarp;
// t steps a prologue pass applies an entry to: 32 accumulators a lane,
// one 128-byte staged column an entry
template <int NB>
constexpr int kPassT = 32 / NB;

struct ScanArgs {
  const float* vx;
  const void* dx;    // Sx's deltas, dxb bytes each
  int dxb, kx;
  const float* xs;   // (T, B, X)
  int X;
  const float* vh;
  const void* dh;
  int dhb, kh;
  const float* h0;   // (B, H)
  int H;
  const float* bias;
  const float* c0;
  float* hs;         // (T, B, H)
  float* c_out;
  float* ax;         // (T, 4H, NB) scratch: Sx@xs[t] of every gate row
  void* colx;        // (4H, kx) scratch: Sx's columns, decoded
  void* colh;        // (4H, kh) scratch: Sh's columns, decoded
  float4* hx;        // (2, NB/4, H) scratch: h as staged planes, by t & 1
  int T, B, units;
  brds::Act act;
};

// A lane's next kAhead entries (k0, k0 + 32, ...; past K: 0) and their
// decoded columns, loaded before any is used: a row's loads from L2 are
// then in flight together instead of one round trip an entry.
constexpr int kAhead = 8;
template <typename P>
__device__ __forceinline__ void load_ahead(const float* vals, const P* cols,
                                           int k0, int K,
                                           float (&v)[kAhead],
                                           int (&p)[kAhead]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int k = k0 + u * brds::kWarp;
    v[u] = k < K ? __ldg(vals + k) : 0.0f;
    p[u] = k < K ? static_cast<int>(cols[k]) : 0;
  }
}

// Column positions: uint16 staged positions, or int32 columns when the
// activations are gathered from global memory.
template <bool kStaged>
using ColT = std::conditional_t<kStaged, uint16_t, int32_t>;

// Decodes one packed row's deltas into absolute columns with row_dot's
// scan (lane l takes entries l, l+32, ...). A lane loads its next kAhead
// deltas before it scans any of them.
template <bool kStaged>
__device__ __forceinline__ void decode_row(const void* deltas, int bytes,
                                           size_t off, int K,
                                           ColT<kStaged>* out) {
  const int lane = threadIdx.x & (brds::kWarp - 1);
  int carry = 0;
  for (int g0 = 0; g0 < K; g0 += kAhead * brds::kWarp) {
    int d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = g0 + u * brds::kWarp + lane;
      d[u] = k < K ? brds::load_delta(deltas, bytes, off + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (g0 + u * brds::kWarp >= K) break;   // warp-uniform
      int v = d[u];
#pragma unroll
      for (int o = 1; o < brds::kWarp; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      const int col = carry + v;
      carry = __shfl_sync(0xffffffffu, col, brds::kWarp - 1);
      const int k = g0 + u * brds::kWarp + lane;
      if (k < K) out[off + k] = static_cast<ColT<kStaged>>(col);
    }
  }
}

// A staged column fills one 128-byte row of the 32 shared-memory banks:
// kPieces float4 pieces. In the prologue, piece tt * NB/4 + q holds step
// tt's batch rows 4q..4q+3 (zero past B or past the pass's steps); in the
// recurrence, h's NB/4 pieces repeat 8 / (NB/4) times. A lane's j-th load
// of a column takes piece (j + lane) % 8, so the eight lanes of a phase of
// a 16-byte shared load meet eight distinct bank slots whatever their
// columns (the random columns of consecutive entries, staged in column
// order, met about two lanes on a slot). The lane's registers then hold
// the pieces rotated by its lane index, and `brds::unrotate` puts them back
// before the warp adds its partial sums.
constexpr int kPieces = 8;

// The prologue's pass: steps t0 .. t0 + tn - 1 of xs (T, B, X) as
// planes[c][piece], a thread a column, its pieces written in the rotated
// order too, so the stores meet distinct slots.
template <int NB>
__device__ __forceinline__ void stage_x(const float* xs, int tn, int X,
                                        int B, float4* planes) {
  constexpr int NQ = NB / 4;
  for (int c = threadIdx.x; c < X; c += kScanThreads) {
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int p = (j + c) & (kPieces - 1);
      const int tt = p / NQ, q = p % NQ;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = 4 * q + i;
        v[i] = tt < tn && b < B ? __ldg(xs + ((size_t)tt * B + b) * X + c)
                                : 0.0f;
      }
      planes[(size_t)c * kPieces + p] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// h's column c as planes[c][piece]: g[q] (batch rows 4q..4q+3) in pieces
// q, q + NB/4, ...; the copies are written in an order rotated by the
// column, so the stores of neighbouring columns spread over the slots.
// g is only ever indexed by a constant (a run-time index, even one the
// compiler derives from a chain of selects, puts it in local memory).
template <int NB>
__device__ __forceinline__ void put_h(float4* planes, int c,
                                      const float4 (&g)[NB / 4]) {
  constexpr int NQ = NB / 4, copies = kPieces / NQ;
#pragma unroll
  for (int k = 0; k < copies; ++k) {
    const int r = (k + c) % copies;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      planes[(size_t)c * kPieces + r * NQ + q] = g[q];
  }
}

// acc[j * 4 + i] = fmaf(v, piece (j + rot) % 8 of the column, ...) for
// j < N: row_dot's per-entry step with the operands from shared memory.
template <int N>
__device__ __forceinline__ void fma_pieces(float (&acc)[4 * N], float v,
                                           const float4* col, int rot) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float4 s = col[(j + rot) & (kPieces - 1)];
    acc[j * 4] = fmaf(v, s.x, acc[j * 4]);
    acc[j * 4 + 1] = fmaf(v, s.y, acc[j * 4 + 1]);
    acc[j * 4 + 2] = fmaf(v, s.z, acc[j * 4 + 2]);
    acc[j * 4 + 3] = fmaf(v, s.w, acc[j * 4 + 3]);
  }
}

template <int N>
__device__ __forceinline__ void butterfly(float (&acc)[N]) {
#pragma unroll
  for (int b = 0; b < N; ++b) {
    float s = acc[b];
#pragma unroll
    for (int o = brds::kWarp / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    acc[b] = s;
  }
}

template <int NB, bool kStageX, bool kStageH>
__global__ void __launch_bounds__(kScanThreads, 1)
fused_scan_kernel(const ScanArgs a) {
  constexpr int NQ = NB / 4, PT = kPassT<NB>;
  extern __shared__ float4 scan_smem[];
  // [staged columns: xs or h, kPieces float4 each][cs: units x NB][zs:
  // 4 units x NB]
  const int staged = max(kStageX ? a.X : 0, kStageH ? a.H : 0);
  float4* planes = scan_smem;
  float* cs = reinterpret_cast<float*>(scan_smem + (size_t)staged * kPieces);
  float* zs = cs + a.units * NB;
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int rot = lane & (kPieces - 1);
  const int H = a.H, B = a.B, R = 4 * H, X = a.X;
  const int j0 = blockIdx.x * a.units;
  const int nrows = 4 * min(a.units, H - j0);   // row i: unit i/4, gate i%4
  auto* colx = static_cast<ColT<kStageX>*>(a.colx);
  auto* colh = static_cast<ColT<kStageH>*>(a.colh);
  auto row_of = [&](int i) { return (i & 3) * H + j0 + (i >> 2); };

  // 1. decode the block's rows
  for (int i = warp; i < nrows; i += kScanWarps) {
    const int row = row_of(i);
    decode_row<kStageX>(a.dx, a.dxb, (size_t)row * a.kx, a.kx, colx);
    decode_row<kStageH>(a.dh, a.dhb, (size_t)row * a.kh, a.kh, colh);
  }
  for (int u = threadIdx.x; u < nrows / 4 * B; u += kScanThreads)
    cs[(u / B) * NB + u % B] = a.c0[(size_t)(u % B) * H + j0 + u / B];

  // 2. ax[t] = Sx@xs[t] for every t, PT steps a pass; acc[tt * NB + b]
  for (int t0 = 0; t0 < a.T; t0 += PT) {
    const int tn = min(PT, a.T - t0);
    if constexpr (kStageX) {
      __syncthreads();   // the previous pass is done with the planes
      stage_x<NB>(a.xs + (size_t)t0 * B * X, tn, X, B, planes);
      __syncthreads();
    }
    for (int i = warp; i < nrows; i += kScanWarps) {
      const int row = row_of(i);
      const size_t off = (size_t)row * a.kx;
      float acc[PT * NB];
#pragma unroll
      for (int k = 0; k < PT * NB; ++k) acc[k] = 0.0f;
      for (int k0 = lane; k0 < a.kx; k0 += kAhead * brds::kWarp) {
        float v[kAhead];
        int p[kAhead];
        load_ahead(a.vx + off, colx + off, k0, a.kx, v, p);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k0 + u * brds::kWarp >= a.kx) break;
          if constexpr (kStageX) {
            fma_pieces<kPieces>(acc, v[u], planes + (size_t)p[u] * kPieces,
                                rot);
          } else {
#pragma unroll
            for (int tt = 0; tt < PT; ++tt) {
              if (tt >= tn) break;
              const float* x = a.xs + (size_t)(t0 + tt) * B * X + p[u];
#pragma unroll
              for (int b = 0; b < NB; ++b)
                if (b < B)
                  acc[tt * NB + b] = fmaf(v[u], __ldg(x + (size_t)b * X),
                                          acc[tt * NB + b]);
            }
          }
        }
      }
      if constexpr (kStageX) brds::unrotate<kPieces>(acc, rot);
      butterfly<PT * NB>(acc);
#pragma unroll
      for (int k = 0; k < PT * NB; ++k)
        if (k / NB < tn && lane == k)
          a.ax[((size_t)(t0 + k / NB) * R + row) * NB + k % NB] = acc[k];
    }
  }
  __syncthreads();   // ax and the decoded columns written; planes free

  // 3. the recurrence: Sh@h, z, the cell; one grid barrier a step
  for (int t = 0; t < a.T; ++t) {
    const float* h = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * B * H;
    float* h_out = a.hs + (size_t)t * B * H;
    if constexpr (kStageH) {
      // h0, or the planes the cells of step t - 1 wrote to hx[(t-1) & 1]
      const float4* prev = a.hx + (size_t)((t - 1) & 1) * NQ * H;
      for (int c = threadIdx.x; c < H; c += kScanThreads) {
        float4 g[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (t > 0) {
            g[q] = __ldcg(prev + (size_t)q * H + c);
          } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = 4 * q + i < B ? __ldg(h + (size_t)(4 * q + i) * H + c)
                                   : 0.0f;
            g[q] = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        put_h<NB>(planes, c, g);
      }
      __syncthreads();
    }
    for (int i = warp; i < nrows; i += kScanWarps) {
      const int row = row_of(i);
      const size_t off = (size_t)row * a.kh;
      // z's other terms, loaded while the row's products run
      const float axb = lane < NB ? a.ax[((size_t)t * R + row) * NB + lane]
                                  : 0.0f;
      const float bb = a.bias[row];
      float acc[NB] = {};
      for (int g0 = 0; g0 < a.kh; g0 += kAhead * brds::kWarp) {
        float v[kAhead];
        int p[kAhead];
        load_ahead(a.vh + off, colh + off, g0 + lane, a.kh, v, p);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (g0 + u * brds::kWarp + lane >= a.kh) break;
          if constexpr (kStageH) {
            fma_pieces<NQ>(acc, v[u], planes + (size_t)p[u] * kPieces, rot);
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b)   // plain loads: h is this launch's
              if (b < B) acc[b] = fmaf(v[u], h[(size_t)b * H + p[u]], acc[b]);
          }
        }
      }
      if constexpr (kStageH) brds::unrotate<NQ>(acc, rot);
      butterfly<NB>(acc);
#pragma unroll
      for (int b = 0; b < NB; ++b)   // fused_step_kernel's z
        if (b < B && b == lane) zs[i * NB + b] = axb + acc[b] + bb;
    }
    __syncthreads();
    // the cells; h goes to hs[t] and, as planes for the next step's
    // staging, to hx[t & 1] (zero past B)
    float* hx = reinterpret_cast<float*>(a.hx + (size_t)(t & 1) * NQ * H);
    for (int u = threadIdx.x; u < nrows / 4 * NB; u += kScanThreads) {
      const int jl = u / NB, b = u % NB;
      float hv = 0.0f;
      if (b < B) {
        const float* z = zs + jl * 4 * NB + b;
        float c;
        brds::lstm_cell(z[0], z[NB], z[2 * NB], z[3 * NB], cs[jl * NB + b],
                        a.act, &c, &hv);
        cs[jl * NB + b] = c;
        h_out[(size_t)b * H + j0 + jl] = hv;
      }
      if constexpr (kStageH)
        hx[((size_t)(b / 4) * H + j0 + jl) * 4 + b % 4] = hv;
    }
    if (t + 1 < a.T) grid.sync();   // hs[t], hx[t & 1] complete and visible
  }
  __syncthreads();
  for (int u = threadIdx.x; u < nrows / 4 * B; u += kScanThreads)
    a.c_out[(size_t)(u % B) * H + j0 + u / B] = cs[(u / B) * NB + u % B];
}

}  // namespace

// Runs `body(kern)` with the float scan instantiation for batch B (at most
// kMaxBatch: the co-resident grid takes one batch tile a launch) and the
// staging of x and h.
template <typename F>
cudaError_t by_scan_kernel(int B, int stage_x, int stage_h, F&& body) {
  if (B > brds::kMaxBatch) return cudaErrorInvalidValue;
  return brds::by_batch(B, [&](auto nb, auto) {
    constexpr int NB = decltype(nb)::value;
    void (*kern)(const ScanArgs) = fused_scan_kernel<NB, false, false>;
    if (stage_x && stage_h) kern = fused_scan_kernel<NB, true, true>;
    if (stage_x && !stage_h) kern = fused_scan_kernel<NB, true, false>;
    if (!stage_x && stage_h) kern = fused_scan_kernel<NB, false, true>;
    return body(kern);
  });
}

// The plan (units a block, which activations are staged, smem) and the scratch
// (ax, colx, colh) come from kernels/plan.py; the grid is ceil(H / units)
// blocks, which must all be co-resident.
extern "C" int brds_fused_lstm_scan(
    const void* vx, const void* dx, int dx_bytes, int kx, const void* xs,
    int X, const void* vh, const void* dh, int dh_bytes, int kh,
    const void* h0, int H, const void* bias, const void* c0, void* hs,
    void* c_out, void* ax, void* colx, void* colh, void* hx, int T, int B,
    int units, int stage_x, int stage_h, int smem,
    const void* lut, float lo, float hi, float hic, void* stream) {
  if (H <= 0 || T <= 0 || units <= 0)
    return cudaErrorInvalidValue;
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  ScanArgs a{static_cast<const float*>(vx), dx, dx_bytes, kx,
             static_cast<const float*>(xs), X, static_cast<const float*>(vh),
             dh, dh_bytes, kh, static_cast<const float*>(h0), H,
             static_cast<const float*>(bias), static_cast<const float*>(c0),
             static_cast<float*>(hs), static_cast<float*>(c_out),
             static_cast<float*>(ax), colx, colh, static_cast<float4*>(hx),
             T, B, units, act};
  const int grid = (H + units - 1) / units;
  return by_scan_kernel(B, stage_x, stage_h, [&](auto kern) {
    const void* k = reinterpret_cast<const void*>(kern);
    cudaError_t e = brds::allow_smem(k);
    if (e != cudaSuccess) return e;
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kScanThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

// For the float scan instantiation of (B, stage_x, stage_h): out[0..3] as
// brds::kernel_info gives them (registers, spill bytes, static shared
// bytes, blocks an SM with `smem` bytes of dynamic shared memory).
extern "C" int brds_fused_lstm_scan_info(int B, int stage_x, int stage_h,
                                         int smem, int* out) {
  return by_scan_kernel(B, stage_x, stage_h, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             kScanThreads, smem, out);
  });
}

extern "C" int brds_fused_delta_lstm_scan(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* xs,
    int X, const void* vh, const void* ih, int ih_bytes, int kh,
    const void* h0, int H, const void* bias, const void* c0, const void* m0,
    void* x_ref, void* h_ref, void* dxm, void* dhm, void* hs, void* c_out,
    void* m_out, float theta_x, float theta_h, int T, int B, const void* lut,
    float lo, float hi, float hic, void* stream) {
  if (H <= 0 || T <= 0 || B > brds::kMaxBatch) return cudaErrorInvalidValue;
  const int ntiles = (H + kJT - 1) / kJT;
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  return brds::by_delta(ix_bytes, [&](auto ixt) {
    using IX = decltype(ixt);
    return brds::by_delta(ih_bytes, [&](auto iht) {
      using IH = decltype(iht);
      return brds::by_batch(B, [&](auto nb, auto) {
        constexpr int NB = decltype(nb)::value;
        DeltaScanArgs<IX, IH> a{
            static_cast<const float*>(vx), static_cast<const IX*>(ix), kx,
            static_cast<const float*>(xs), X, static_cast<const float*>(vh),
            static_cast<const IH*>(ih), kh, static_cast<const float*>(h0), H,
            static_cast<const float*>(bias), static_cast<const float*>(c0),
            static_cast<const float*>(m0), static_cast<float*>(x_ref),
            static_cast<float*>(h_ref), static_cast<float*>(dxm),
            static_cast<float*>(dhm), static_cast<float*>(hs),
            static_cast<float*>(c_out), static_cast<float*>(m_out), theta_x,
            theta_h, T, B, 0, act};
        return launch(fused_delta_scan_kernel<IX, IH, NB>, a, ntiles,
                      kJT * NB * 5 * sizeof(float), stream);
      });
    });
  });
}
