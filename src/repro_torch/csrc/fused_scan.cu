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
// cudaLaunchCooperativeKernel, one 512-thread block an SM. A block owns
// `units` consecutive hidden units and their 4 * units gate rows (j, H+j,
// 2H+j, 3H+j) for all T steps, c (and m, and the h reference) never leave
// its shared memory, and only h (or its masked delta) crosses blocks: step
// t's cells write it, the grid synchronises once, and step t+1 reads it
// with plain or L2 loads, never the read-only path, which is not coherent
// with stores made in the same launch. The rows are spread over the block's 16
// warps, a warp per row at a time; a row stays with one warp and each
// entry with one lane through every phase:
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
// fused_brds_delta_lstm_scan is the same kernel (kDelta) with the masked
// deltas as the operands:
//  0. thresholds, before 2: the x thresholds read only xs and the x
//     reference, so one grid-wide pass, a thread a (b, c) walking t = 0 ..
//     T-1 in order, writes every step's masked x delta to a (T, B, X)
//     scratch (dxm) and x_ref_T; the same pass thresholds h0 against
//     h_ref0 into hx's planes (step 0's operand) and the h reference. One
//     grid barrier a launch follows; 2 then projects dxm instead of xs;
//  3. the cell that owns (b, j) thresholds the h it just made against the
//     reference it keeps in shared memory and writes the masked delta to hx
//     in place of h, except at the last step (the chain thresholds h0 ..
//     h_{T-2}: T times); z = m' + bias with m' = (m + ax) + ah, m kept in
//     shared memory. Still one grid barrier a step.
//
// Each step is bitwise equal to one launch of the single-step kernel
// (fused_step.cu fused_staged_kernel, float or delta): every (row, batch)
// sum keeps row_dot's order (lane l takes entries l, l+32, ... in order
// with fmaf, then the xor butterfly; ax and ah apart), z = (ax + ah) +
// bias (or delta_update, then + bias), and the cell is brds::lstm_cell;
// staging, streaming and hoisting (here, and in the step kernels'
// brds::row_dot_stream) change where the operands come from, not that
// order. The masked delta is the same __fmul_rn(d, fired) that DeltaSrc
// forms, and the threshold the same float32 ops as
// sparse/temporal.py::delta_threshold (d = v - ref, |d| > theta strictly,
// ref' = fired ? v : ref).
//
// Bound: operations. Over T steps every packed entry takes B fp32 FMAs a
// step (3.46 GFLOP for a 1500-wide layer, B=8, T=32: 0.052 ms at 67
// TFLOP/s), while the packed weights (40.5 MB with int16 deltas) need be
// read from device memory only once (0.013 ms at 3.35 TB/s); the delta
// scan's thresholds add T x B x (X + H) compares and products. What binds
// the design is shared-memory bandwidth: each FMA reads its own 4-byte
// activation from shared memory (no two entries of a row share a column),
// 128 bytes a clock an SM, a quarter of the FMA rate; PERF.md has the
// card's times.
#include <cooperative_groups.h>

#include "brds_common.cuh"

namespace cg = cooperative_groups;

namespace {

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
  float4* hx;        // (2, NB/4, H) scratch: h (the delta scan: its masked
                     // delta) as staged planes, by t & 1
  int T, B, units;
  brds::Act act;
  // the delta scan's own (unused by the float scan)
  const float* m0;       // (B, 4H)
  const float* x_ref0;   // (B, X)
  const float* h_ref0;   // (B, H)
  float* m_out;
  float* x_ref;          // (B, X): x_ref_T
  float* h_ref;          // (B, H): moved by h0, then each owner's h_ref_T
  float* dxm;            // (T, B, X) scratch: every step's masked x delta
  float theta_x, theta_h;
};

// A load of data that this launch may have written (kFresh: a plain load,
// which the memory model orders after grid.sync; never the read-only path,
// which is not coherent within a launch), or of an input (__ldg). __ldcg
// in the delta scan's staging of dxm cost it 0.12 ms at lstm_ptb on the
// H100 (PERF.md).
template <bool kFresh>
__device__ __forceinline__ float load_in(const float* p) {
  if constexpr (kFresh) return *p;
  else return __ldg(p);
}

// One temporal-delta decision in sparse/temporal.py::delta_threshold's
// float32 ops: d = v - ref, fired = |d| > theta; moves ref to v where fired
// and returns the masked delta __fmul_rn(d, fired), DeltaSrc's product.
__device__ __forceinline__ float threshold(float v, float& ref, float theta) {
  const float d = __fsub_rn(v, ref);
  const bool fired = fabsf(d) > theta;
  ref = fired ? v : ref;
  return __fmul_rn(d, fired ? 1.0f : 0.0f);
}

// The delta scan's threshold pass over the whole grid, a thread a column:
// for each (b, c) of x, every step's masked delta (to dxm, xs's layout) in
// t order, then x_ref_T; for each (b, c) of h0 (b < NB), its masked delta
// against h_ref0 in hx[1]'s planes (step 0 reads hx[(0 - 1) & 1]; zero past
// B) and the moved reference in h_ref.
template <int NB>
__device__ __forceinline__ void threshold_pass(const ScanArgs& a) {
  const int nx = a.B * a.X, n = nx + NB * a.H;
  const size_t step = (size_t)a.B * a.X;
  float* planes = reinterpret_cast<float*>(a.hx + (size_t)NB / 4 * a.H);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (i < nx) {
      float ref = __ldg(a.x_ref0 + i);
      for (int t = 0; t < a.T; ++t)
        a.dxm[t * step + i] =
            threshold(__ldg(a.xs + t * step + i), ref, a.theta_x);
      a.x_ref[i] = ref;
    } else {
      const int k = i - nx, b = k / a.H, c = k % a.H;
      float dm = 0.0f;
      if (b < a.B) {
        float ref = __ldg(a.h_ref0 + k);
        dm = threshold(__ldg(a.h0 + k), ref, a.theta_h);
        a.h_ref[k] = ref;
      }
      planes[((size_t)(b / 4) * a.H + c) * 4 + b % 4] = dm;
    }
  }
}

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

// The prologue's pass: steps t0 .. t0 + tn - 1 of xs (T, B, X) (the delta
// scan: of dxm, this launch's, kFresh) as planes[c][piece], a thread a
// column, its pieces written in the rotated order too, so the stores meet
// distinct slots.
template <int NB, bool kFresh>
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
        v[i] = tt < tn && b < B
                   ? load_in<kFresh>(xs + ((size_t)tt * B + b) * X + c)
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

template <int NB, bool kStageX, bool kStageH, bool kDelta>
__global__ void __launch_bounds__(kScanThreads, 1)
fused_scan_kernel(const ScanArgs a) {
  constexpr int NQ = NB / 4, PT = kPassT<NB>;
  extern __shared__ float4 scan_smem[];
  // [staged columns: xs or h, kPieces float4 each][cs: units x NB][zs:
  // 4 units x NB]; the delta scan's [ms: 4 units x NB][hr: units x NB]
  const int staged = max(kStageX ? a.X : 0, kStageH ? a.H : 0);
  float4* planes = scan_smem;
  float* cs = reinterpret_cast<float*>(scan_smem + (size_t)staged * kPieces);
  float* zs = cs + a.units * NB;
  float* ms = zs + 4 * a.units * NB;
  float* hr = ms + 4 * a.units * NB;
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

  // 1. decode the block's rows; c (and m) from their inputs
  for (int i = warp; i < nrows; i += kScanWarps) {
    const int row = row_of(i);
    decode_row<kStageX>(a.dx, a.dxb, (size_t)row * a.kx, a.kx, colx);
    decode_row<kStageH>(a.dh, a.dhb, (size_t)row * a.kh, a.kh, colh);
  }
  for (int u = threadIdx.x; u < nrows / 4 * B; u += kScanThreads)
    cs[(u / B) * NB + u % B] = a.c0[(size_t)(u % B) * H + j0 + u / B];
  if constexpr (kDelta) {
    for (int u = threadIdx.x; u < nrows * B; u += kScanThreads) {
      const int b = u / nrows, i = u % nrows;
      ms[i * NB + b] = __ldg(a.m0 + (size_t)b * R + row_of(i));
    }
    // 0. the thresholds of every x and of h0; the owner's h references
    threshold_pass<NB>(a);
    grid.sync();
    for (int u = threadIdx.x; u < nrows / 4 * B; u += kScanThreads)
      hr[(u / B) * NB + u % B] =
          load_in<true>(a.h_ref + (size_t)(u % B) * H + j0 + u / B);
  }
  const float* xin = kDelta ? a.dxm : a.xs;

  // 2. ax[t] = Sx@xs[t] (Sx@dxm[t]) for every t, PT steps a pass;
  // acc[tt * NB + b]
  for (int t0 = 0; t0 < a.T; t0 += PT) {
    const int tn = min(PT, a.T - t0);
    if constexpr (kStageX) {
      __syncthreads();   // the previous pass is done with the planes
      stage_x<NB, kDelta>(xin + (size_t)t0 * B * X, tn, X, B, planes);
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
              const float* x = xin + (size_t)(t0 + tt) * B * X + p[u];
#pragma unroll
              for (int b = 0; b < NB; ++b)
                if (b < B)
                  acc[tt * NB + b] = fmaf(
                      v[u], load_in<kDelta>(x + (size_t)b * X),
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

  // 3. the recurrence: Sh@h (Sh@dhm), z, the cell; one grid barrier a step
  for (int t = 0; t < a.T; ++t) {
    const float* h = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * B * H;
    float* h_out = a.hs + (size_t)t * B * H;
    // the planes the cells of step t - 1 wrote (the delta scan: the
    // threshold pass's at t = 0)
    const float4* prev = a.hx + (size_t)((t - 1) & 1) * NQ * H;
    if constexpr (kStageH) {
      // h0, or the previous step's planes
      for (int c = threadIdx.x; c < H; c += kScanThreads) {
        float4 g[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (kDelta || t > 0) {
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
    const float* dprev = reinterpret_cast<const float*>(prev);
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
          } else if constexpr (kDelta) {
#pragma unroll
            for (int b = 0; b < NB; ++b)   // the planes, this launch's
              if (b < B)
                acc[b] = fmaf(v[u],
                              load_in<true>(dprev + ((size_t)(b / 4) * H
                                                     + p[u]) * 4 + b % 4),
                              acc[b]);
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
      for (int b = 0; b < NB; ++b) {
        if (b >= B || b != lane) continue;
        if constexpr (kDelta) {   // the fused delta step's m', z
          float& m = ms[i * NB + b];
          m = brds::delta_update(m, axb, acc[b]);
          zs[i * NB + b] = __fadd_rn(m, bb);
        } else {                  // fused_step_kernel's z
          zs[i * NB + b] = axb + acc[b] + bb;
        }
      }
    }
    __syncthreads();
    // the cells; h goes to hs[t] and, as planes for the next step's
    // staging, to hx[t & 1] (zero past B); the delta scan writes there h's
    // masked delta against the reference it keeps, but at the last step
    float* hx = reinterpret_cast<float*>(a.hx + (size_t)(t & 1) * NQ * H);
    const bool next = t + 1 < a.T;
    for (int u = threadIdx.x; u < nrows / 4 * NB; u += kScanThreads) {
      const int jl = u / NB, b = u % NB;
      float hv = 0.0f, dm = 0.0f;
      if (b < B) {
        const float* z = zs + jl * 4 * NB + b;
        float c;
        brds::lstm_cell(z[0], z[NB], z[2 * NB], z[3 * NB], cs[jl * NB + b],
                        a.act, &c, &hv);
        cs[jl * NB + b] = c;
        h_out[(size_t)b * H + j0 + jl] = hv;
        if (kDelta && next) dm = threshold(hv, hr[jl * NB + b], a.theta_h);
      }
      float* o = hx + ((size_t)(b / 4) * H + j0 + jl) * 4 + b % 4;
      if constexpr (kDelta) {
        if (next) *o = dm;
      } else if constexpr (kStageH) {
        *o = hv;
      }
    }
    if (next) grid.sync();   // hs[t], hx[t & 1] complete and visible
  }
  __syncthreads();
  for (int u = threadIdx.x; u < nrows / 4 * B; u += kScanThreads) {
    const size_t o = (size_t)(u % B) * H + j0 + u / B;
    a.c_out[o] = cs[(u / B) * NB + u % B];
    if constexpr (kDelta) a.h_ref[o] = hr[(u / B) * NB + u % B];
  }
  if constexpr (kDelta) {
    for (int u = threadIdx.x; u < nrows * B; u += kScanThreads) {
      const int b = u / nrows, i = u % nrows;
      a.m_out[(size_t)b * R + row_of(i)] = ms[i * NB + b];
    }
  }
}

}  // namespace

// Runs `body(kern)` with the scan instantiation for batch B (at most
// kMaxBatch: the co-resident grid takes one batch tile a launch), the
// staging of x and h, and the float (delta 0) or delta scan.
template <typename F>
cudaError_t by_scan_kernel(int B, int stage_x, int stage_h, int delta,
                           F&& body) {
  if (B > brds::kMaxBatch) return cudaErrorInvalidValue;
  return brds::by_batch(B, [&](auto nb, auto) {
    constexpr int NB = decltype(nb)::value;
    auto pick = [&](auto d) {
      constexpr bool D = decltype(d)::value;
      void (*kern)(const ScanArgs) = fused_scan_kernel<NB, false, false, D>;
      if (stage_x && stage_h) kern = fused_scan_kernel<NB, true, true, D>;
      if (stage_x && !stage_h) kern = fused_scan_kernel<NB, true, false, D>;
      if (!stage_x && stage_h) kern = fused_scan_kernel<NB, false, true, D>;
      return body(kern);
    };
    return delta ? pick(std::true_type{}) : pick(std::false_type{});
  });
}

// One cooperative launch of ceil(H / units) blocks, which must all be
// co-resident.
static cudaError_t launch_scan(ScanArgs& a, int stage_x, int stage_h,
                               int delta, int smem, void* stream) {
  if (a.H <= 0 || a.T <= 0 || a.units <= 0) return cudaErrorInvalidValue;
  const int grid = (a.H + a.units - 1) / a.units;
  return by_scan_kernel(a.B, stage_x, stage_h, delta, [&](auto kern) {
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

// The plan (units a block, which activations are staged, smem) and the
// scratch (ax, colx, colh, hx; the delta scan's dxm) come from
// kernels/plan.py::scan_plan.
extern "C" int brds_fused_lstm_scan(
    const void* vx, const void* dx, int dx_bytes, int kx, const void* xs,
    int X, const void* vh, const void* dh, int dh_bytes, int kh,
    const void* h0, int H, const void* bias, const void* c0, void* hs,
    void* c_out, void* ax, void* colx, void* colh, void* hx, int T, int B,
    int units, int stage_x, int stage_h, int smem,
    const void* lut, float lo, float hi, float hic, void* stream) {
  ScanArgs a{static_cast<const float*>(vx), dx, dx_bytes, kx,
             static_cast<const float*>(xs), X, static_cast<const float*>(vh),
             dh, dh_bytes, kh, static_cast<const float*>(h0), H,
             static_cast<const float*>(bias), static_cast<const float*>(c0),
             static_cast<float*>(hs), static_cast<float*>(c_out),
             static_cast<float*>(ax), colx, colh, static_cast<float4*>(hx),
             T, B, units, {static_cast<const float*>(lut), lo, hi, hic}};
  return launch_scan(a, stage_x, stage_h, 0, smem, stream);
}

extern "C" int brds_fused_delta_lstm_scan(
    const void* vx, const void* dx, int dx_bytes, int kx, const void* xs,
    int X, const void* vh, const void* dh, int dh_bytes, int kh,
    const void* h0, int H, const void* bias, const void* c0, const void* m0,
    const void* x_ref0, const void* h_ref0, void* hs, void* c_out,
    void* m_out, void* x_ref, void* h_ref, void* ax, void* colx, void* colh,
    void* hx, void* dxm, float theta_x, float theta_h, int T, int B,
    int units, int stage_x, int stage_h, int smem, const void* lut, float lo,
    float hi, float hic, void* stream) {
  ScanArgs a{static_cast<const float*>(vx), dx, dx_bytes, kx,
             static_cast<const float*>(xs), X, static_cast<const float*>(vh),
             dh, dh_bytes, kh, static_cast<const float*>(h0), H,
             static_cast<const float*>(bias), static_cast<const float*>(c0),
             static_cast<float*>(hs), static_cast<float*>(c_out),
             static_cast<float*>(ax), colx, colh, static_cast<float4*>(hx),
             T, B, units, {static_cast<const float*>(lut), lo, hi, hic},
             static_cast<const float*>(m0), static_cast<const float*>(x_ref0),
             static_cast<const float*>(h_ref0), static_cast<float*>(m_out),
             static_cast<float*>(x_ref), static_cast<float*>(h_ref),
             static_cast<float*>(dxm), theta_x, theta_h};
  return launch_scan(a, stage_x, stage_h, 1, smem, stream);
}

// For the scan instantiation of (B, stage_x, stage_h, delta): out[0..3] as
// brds::kernel_info gives them (registers, spill bytes, static shared
// bytes, blocks an SM with `smem` bytes of dynamic shared memory).
extern "C" int brds_fused_lstm_scan_info(int B, int stage_x, int stage_h,
                                         int delta, int smem, int* out) {
  return by_scan_kernel(B, stage_x, stage_h, delta, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             kScanThreads, smem, out);
  });
}
