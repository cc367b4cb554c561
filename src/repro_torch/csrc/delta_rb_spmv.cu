// The temporal-delta row-balanced SpMVs over packed values and delta-coded
// columns; d are raw activation deltas and f their 0/1 fired masks, all
// float32:
//  - delta_rb_spmv: y = S@(f*d) over one packed family S (R, K). Replaces
//    src/repro/kernels/delta_rb_spmv.py::delta_rb_spmv.
//  - delta_rb_dual_spmv: the partial-sum memory update
//    m' = m + Sx@(fx*dx) + Sh@(fh*dh) over Sx (R, Kx) and Sh (R, Kh).
//    Replaces src/repro/kernels/delta_rb_spmv.py::delta_rb_dual_spmv.
//
// The Pallas kernels mask the deltas in VMEM and stream (block_rows, K)
// tiles on the TPU's sequential grid. Here one warp owns one packed row,
// as in rb_spmv.cu: brds::row_dot with the DeltaAct policy gathers d*f for
// each entry, so an unfired column adds an exact zero, and the dual kernel
// ends the row with brds::delta_update, m first, as the reference adds.
//
// Bound: bytes. The packed values and deltas are read once and used for
// all B batch rows; d and f (B x 1500 floats each at full width) stay in
// the read-only cache; m is read and m' written once. Unfired columns save
// no bytes here: every packed value is still read.
#include "brds_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / brds::kWarp;

template <typename IX, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
delta_rb_spmv_kernel(const float* __restrict__ vals,
                     const IX* __restrict__ ix, int K,
                     const float* __restrict__ d,
                     const float* __restrict__ f, int X,
                     float* __restrict__ y, int B, int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    d = brds::tile_rows(d, X);
    f = brds::tile_rows(f, X);
    y = brds::tile_rows(y, R);
    B = brds::tile_batch(B);
  }
  float acc[NB] = {};
  brds::row_dot<IX, NB>(vals + (size_t)row * K, ix + (size_t)row * K, K,
                        brds::DeltaAct{d, f, X}, B, acc);
  const int lane = threadIdx.x % brds::kWarp;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) y[(size_t)b * R + row] = acc[b];
}

template <typename IX, typename IH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
delta_rb_dual_spmv_kernel(const float* __restrict__ vx,
                          const IX* __restrict__ ix, int kx,
                          const float* __restrict__ dx,
                          const float* __restrict__ fx, int X,
                          const float* __restrict__ vh,
                          const IH* __restrict__ ih, int kh,
                          const float* __restrict__ dh,
                          const float* __restrict__ fh, int H,
                          const float* __restrict__ m,
                          float* __restrict__ m_out, int B, int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    dx = brds::tile_rows(dx, X);
    fx = brds::tile_rows(fx, X);
    dh = brds::tile_rows(dh, H);
    fh = brds::tile_rows(fh, H);
    m = brds::tile_rows(m, R);
    m_out = brds::tile_rows(m_out, R);
    B = brds::tile_batch(B);
  }
  float ax[NB] = {}, ah[NB] = {};
  brds::row_dot<IX, NB>(vx + (size_t)row * kx, ix + (size_t)row * kx, kx,
                        brds::DeltaAct{dx, fx, X}, B, ax);
  brds::row_dot<IH, NB>(vh + (size_t)row * kh, ih + (size_t)row * kh, kh,
                        brds::DeltaAct{dh, fh, H}, B, ah);
  const int lane = threadIdx.x % brds::kWarp;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) {
      const size_t o = (size_t)b * R + row;
      m_out[o] = brds::delta_update(m[o], ax[b], ah[b]);
    }
}

}  // namespace

extern "C" int brds_delta_rb_spmv(const void* vals, const void* ix,
                                  int ix_bytes, int K, const void* d,
                                  const void* f, int X, void* y, int B,
                                  int R, void* stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_delta(ix_bytes, [&](auto ixt) {
    using IX = decltype(ixt);
    return brds::by_batch(B, [&](auto nb, auto tiled) {
      constexpr int NB = decltype(nb)::value;
      delta_rb_spmv_kernel<IX, NB, decltype(tiled)::value>
          <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const float*>(vals), static_cast<const IX*>(ix), K,
              static_cast<const float*>(d), static_cast<const float*>(f), X,
              static_cast<float*>(y), B, R);
      return cudaSuccess;
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_delta_rb_dual_spmv(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* dx,
    const void* fx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* dh, const void* fh, int H, const void* m,
    void* m_out, int B, int R, void* stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_delta(ix_bytes, [&](auto ixt) {
    using IX = decltype(ixt);
    return brds::by_delta(ih_bytes, [&](auto iht) {
      using IH = decltype(iht);
      return brds::by_batch(B, [&](auto nb, auto tiled) {
        constexpr int NB = decltype(nb)::value;
        delta_rb_dual_spmv_kernel<IX, IH, NB, decltype(tiled)::value>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(vx), static_cast<const IX*>(ix),
                kx, static_cast<const float*>(dx),
                static_cast<const float*>(fx), X,
                static_cast<const float*>(vh), static_cast<const IH*>(ih),
                kh, static_cast<const float*>(dh),
                static_cast<const float*>(fh), H,
                static_cast<const float*>(m), static_cast<float*>(m_out), B,
                R);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}
