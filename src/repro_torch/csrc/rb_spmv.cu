// The float row-balanced SpMVs over packed values and delta-coded columns:
//  - rb_spmv: y = S@x over one packed family S (R, K). Replaces
//    src/repro/kernels/rb_spmv.py::rb_spmv.
//  - rb_dual_spmv: z = Sx@x + Sh@h + bias over Sx (R, Kx) and Sh (R, Kh).
//    Replaces src/repro/kernels/rb_spmv.py::rb_dual_spmv.
//
// The Pallas kernels stream (block_rows, K) tiles through VMEM on the TPU's
// sequential grid. Here one warp owns one packed row (brds::row_dot): it
// rebuilds the columns with an int32 warp scan of the deltas and gathers x
// and h through the read-only cache, which holds them (B x 1500 floats at
// full width). Both kernels share that routine, so rb_spmv(Sx, x) +
// rb_spmv(Sh, h) + bias, added in that order, equals rb_dual_spmv.
//
// Bound: bytes. Each packed value (4 B) and delta (1-4 B) is read once and
// used for all B batch rows, so at B <= 16 the weight stream dominates and
// the least time is (values + deltas) / memory rate.
#include "brds_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / brds::kWarp;

template <typename DT, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
rb_spmv_kernel(const float* __restrict__ vals, const DT* __restrict__ deltas,
               int K, const float* __restrict__ x, int X,
               float* __restrict__ y, int B, int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    x = brds::tile_rows(x, X);
    y = brds::tile_rows(y, R);
    B = brds::tile_batch(B);
  }
  float acc[NB] = {};
  brds::row_dot<DT, NB>(vals + (size_t)row * K, deltas + (size_t)row * K, K,
                        brds::F32Act{x, X}, B, acc);
  const int lane = threadIdx.x % brds::kWarp;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) y[(size_t)b * R + row] = acc[b];
}

template <typename DX, typename DH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
rb_dual_spmv_kernel(const float* __restrict__ vx, const DX* __restrict__ dx,
                    int kx, const float* __restrict__ x, int X,
                    const float* __restrict__ vh, const DH* __restrict__ dh,
                    int kh, const float* __restrict__ h, int H,
                    const float* __restrict__ bias, float* __restrict__ z,
                    int B, int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    x = brds::tile_rows(x, X);
    h = brds::tile_rows(h, H);
    z = brds::tile_rows(z, R);
    B = brds::tile_batch(B);
  }
  float ax[NB] = {}, ah[NB] = {};
  brds::row_dot<DX, NB>(vx + (size_t)row * kx, dx + (size_t)row * kx, kx,
                        brds::F32Act{x, X}, B, ax);
  brds::row_dot<DH, NB>(vh + (size_t)row * kh, dh + (size_t)row * kh, kh,
                        brds::F32Act{h, H}, B, ah);
  const int lane = threadIdx.x % brds::kWarp;
  const float bb = bias[row];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) z[(size_t)b * R + row] = ax[b] + ah[b] + bb;
}

}  // namespace

extern "C" int brds_rb_spmv(const void* vals, const void* deltas,
                            int d_bytes, int K, const void* x, int X,
                            void* y, int B, int R, void* stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_delta(d_bytes, [&](auto dt) {
    using DT = decltype(dt);
    return brds::by_batch(B, [&](auto nb, auto tiled) {
      constexpr int NB = decltype(nb)::value;
      rb_spmv_kernel<DT, NB, decltype(tiled)::value>
          <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const float*>(vals), static_cast<const DT*>(deltas),
              K, static_cast<const float*>(x), X, static_cast<float*>(y), B,
              R);
      return cudaSuccess;
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_rb_dual_spmv(const void* vx, const void* dx, int dx_bytes,
                                 int kx, const void* x, int X, const void* vh,
                                 const void* dh, int dh_bytes, int kh,
                                 const void* h, int H, const void* bias,
                                 void* z, int B, int R, void* stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_delta(dx_bytes, [&](auto dxt) {
    using DX = decltype(dxt);
    return brds::by_delta(dh_bytes, [&](auto dht) {
      using DH = decltype(dht);
      return brds::by_batch(B, [&](auto nb, auto tiled) {
        constexpr int NB = decltype(nb)::value;
        rb_dual_spmv_kernel<DX, DH, NB, decltype(tiled)::value>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(vx), static_cast<const DX*>(dx), kx,
                static_cast<const float*>(x), X,
                static_cast<const float*>(vh), static_cast<const DH*>(dh), kh,
                static_cast<const float*>(h), H,
                static_cast<const float*>(bias), static_cast<float*>(z), B,
                R);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}
