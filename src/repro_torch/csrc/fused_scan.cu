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
// persistent: it is sized to be co-resident (occupancy x SMs) and launched
// with cudaLaunchCooperativeKernel, and each block owns a fixed set of
// tiles of kJT hidden units for all T steps, with their four gate rows j,
// H+j, 2H+j, 3H+j (one warp per row), as the single-step kernels of
// fused_step.cu. c (and m) never leave their block: they stay in shared
// memory across steps. Only h crosses blocks: step t writes hs[t] and the
// grid synchronises; step t+1 reads hs[t] (h0 at t = 0) with plain loads
// (the read-only path is not coherent with stores made in the same
// launch). The delta scan has a threshold phase per step, one column per
// thread over the whole grid, which writes the masked deltas to global
// scratch and updates the references in place; a second grid barrier
// separates it from the gate phase.
//
// Each step is bitwise equal to one launch of the single-step kernel
// (fused_step_kernel, fused_delta_step_kernel): the same brds::row_dot on x
// and h, the same z = (ax + ah) + bias (or delta_update, then + bias), the
// same brds::lstm_cell; the masked delta is the same __fmul_rn(d, fired)
// that DeltaAct forms, and the threshold the same float32 ops as
// sparse/temporal.py::delta_threshold (d = v - ref, |d| > theta strictly,
// ref' = fired ? v : ref).
//
// Bound: operations. Over T steps every packed entry takes B fp32 FMAs a
// step (3.46 GFLOP for a 1500-wide layer, B=8, T=32: 0.052 ms at 67
// TFLOP/s), while the packed weights (40.5 MB with int16 deltas) need be
// read from device memory only once (0.013 ms at 3.35 TB/s): they fit the
// 50 MB L2, and steps after the first may find them there. The blocks
// gather activations one lane per entry, as the single-step kernels do, so
// this first version sits far above either bound.
#include <cooperative_groups.h>

#include "brds_common.cuh"

namespace cg = cooperative_groups;

namespace {

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

template <typename DX, typename DH>
struct ScanArgs {
  const float* vx;
  const DX* dx;
  int kx;
  const float* xs;   // (T, B, X)
  int X;
  const float* vh;
  const DH* dh;
  int kh;
  const float* h0;   // (B, H)
  int H;
  const float* bias;
  const float* c0;
  float* hs;         // (T, B, H)
  float* c_out;
  int T, B, tiles_per_block;
  brds::Act act;
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

template <typename DX, typename DH, int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NB>)
fused_scan_kernel(const ScanArgs<DX, DH> a) {
  extern __shared__ float cs[];   // [tiles_per_block][kJT][NB]
  __shared__ float zs[kJT][4][NB];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int H = a.H, B = a.B;
  const int ntiles = (H + kJT - 1) / kJT;
  move_c<NB>(cs, const_cast<float*>(a.c0), ntiles, a.tiles_per_block, H, B,
             true);
  for (int t = 0; t < a.T; ++t) {
    const float* x = a.xs + (size_t)t * B * a.X;
    const float* h = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * B * H;
    float* h_out = a.hs + (size_t)t * B * H;
    for (int k = 0; k < a.tiles_per_block; ++k) {
      const int tile = tile_of(k, ntiles);
      if (tile < 0) break;
      const int j = tile * kJT + jl;
      if (j < H) {
        const int row = gate * H + j;
        float ax[NB] = {}, ah[NB] = {};
        brds::row_dot<DX, NB>(a.vx + (size_t)row * a.kx,
                              a.dx + (size_t)row * a.kx, a.kx,
                              brds::F32Act{x, a.X}, B, ax);
        brds::row_dot<DH, NB>(a.vh + (size_t)row * a.kh,
                              a.dh + (size_t)row * a.kh, a.kh,
                              F32ActSynced{h, H}, B, ah);
        const float bb = a.bias[row];
#pragma unroll
        for (int b = 0; b < NB; ++b)   // fused_step_kernel's z
          if (b < B && b == lane) zs[jl][gate][b] = ax[b] + ah[b] + bb;
      }
      __syncthreads();
      close_tile<NB>(zs, cs + k * kJT * NB, tile, H, B, h_out, a.act);
      __syncthreads();   // zs is rewritten by the next tile
    }
    grid.sync();         // hs[t] complete and visible before step t + 1
  }
  move_c<NB>(cs, a.c_out, ntiles, a.tiles_per_block, H, B, false);
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
        for (int b = 0; b < NB; ++b)   // fused_delta_step_kernel's m', z
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

}  // namespace

extern "C" int brds_fused_lstm_scan(const void* vx, const void* dx,
                                    int dx_bytes, int kx, const void* xs,
                                    int X, const void* vh, const void* dh,
                                    int dh_bytes, int kh, const void* h0,
                                    int H, const void* bias, const void* c0,
                                    void* hs, void* c_out, int T, int B,
                                    const void* lut, float lo, float hi,
                                    float hic, void* stream) {
  // one batch tile a launch: the grid is sized to be co-resident
  if (H <= 0 || T <= 0 || B > brds::kMaxBatch) return cudaErrorInvalidValue;
  const int ntiles = (H + kJT - 1) / kJT;
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  return brds::by_delta(dx_bytes, [&](auto dxt) {
    using DX = decltype(dxt);
    return brds::by_delta(dh_bytes, [&](auto dht) {
      using DH = decltype(dht);
      return brds::by_batch(B, [&](auto nb, auto) {
        constexpr int NB = decltype(nb)::value;
        ScanArgs<DX, DH> a{
            static_cast<const float*>(vx), static_cast<const DX*>(dx), kx,
            static_cast<const float*>(xs), X, static_cast<const float*>(vh),
            static_cast<const DH*>(dh), kh, static_cast<const float*>(h0), H,
            static_cast<const float*>(bias), static_cast<const float*>(c0),
            static_cast<float*>(hs), static_cast<float*>(c_out), T, B, 0,
            act};
        return launch(fused_scan_kernel<DX, DH, NB>, a, ntiles,
                      kJT * NB * sizeof(float), stream);
      });
    });
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
