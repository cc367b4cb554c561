// The quantized row-balanced SpMVs over packed integer codes and
// delta-coded columns, with integer activation codes:
//  - rb_spmv_q8: y = dq(S@q) over one packed family S (R, K). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_spmv_q8.
//  - rb_dual_parts_q8: (zx, zh) = (dq(Sx@qx), dq(Sh@qh)) over Sx (R, Kx)
//    and Sh (R, Kh). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_dual_parts_q8.
//
// The Pallas kernels stream (block_rows, K) code tiles through VMEM. Here
// one warp owns one packed row, as in rb_spmv.cu: brds::row_dot with the
// CodeAct policy accumulates code products in 32-bit two's complement
// (exact, and wrapping as the plain version's int32 sum does), and each
// family is dequantized once per row by brds::dequant with its combined
// (row x activation) scale. zx and zh are written apart, as the TPU kernel
// writes them, so no dequant multiply can be contracted into an add: the
// results equal the plain version bit for bit.
//
// Bound: bytes. Codes (1 B for int8, 2 B for qM.N) and deltas are read
// once and used for all B batch rows; the activation codes stay in the
// read-only cache.
#include "brds_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / brds::kWarp;

template <typename CT, typename IX, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
rb_spmv_q8_kernel(const CT* __restrict__ vals, const IX* __restrict__ ix,
                  int K, const float* __restrict__ comb,
                  const CT* __restrict__ q, int X, float* __restrict__ y,
                  int B, int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    q = brds::tile_rows(q, X);
    y = brds::tile_rows(y, R);
    B = brds::tile_batch(B);
  }
  uint32_t acc[NB] = {};
  brds::row_dot<IX, NB>(vals + (size_t)row * K, ix + (size_t)row * K, K,
                        brds::CodeAct<CT>{q, X}, B, acc);
  const int lane = threadIdx.x % brds::kWarp;
  const float cs = comb[row];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) y[(size_t)b * R + row] = brds::dequant(acc[b], cs);
}

template <typename CT, typename IX, typename IH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
rb_dual_parts_q8_kernel(const CT* __restrict__ vx, const IX* __restrict__ ix,
                        int kx, const float* __restrict__ comb_x,
                        const CT* __restrict__ qx, int X,
                        const CT* __restrict__ vh, const IH* __restrict__ ih,
                        int kh, const float* __restrict__ comb_h,
                        const CT* __restrict__ qh, int H,
                        float* __restrict__ zx, float* __restrict__ zh, int B,
                        int R) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / brds::kWarp;
  if (row >= R) return;   // uniform across the warp
  if constexpr (kTiled) {
    qx = brds::tile_rows(qx, X);
    qh = brds::tile_rows(qh, H);
    zx = brds::tile_rows(zx, R);
    zh = brds::tile_rows(zh, R);
    B = brds::tile_batch(B);
  }
  uint32_t ax[NB] = {}, ah[NB] = {};
  brds::row_dot<IX, NB>(vx + (size_t)row * kx, ix + (size_t)row * kx, kx,
                        brds::CodeAct<CT>{qx, X}, B, ax);
  brds::row_dot<IH, NB>(vh + (size_t)row * kh, ih + (size_t)row * kh, kh,
                        brds::CodeAct<CT>{qh, H}, B, ah);
  const int lane = threadIdx.x % brds::kWarp;
  const float cx = comb_x[row], ch = comb_h[row];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B && b == lane) {
      const size_t o = (size_t)b * R + row;
      zx[o] = brds::dequant(ax[b], cx);
      zh[o] = brds::dequant(ah[b], ch);
    }
}

}  // namespace

extern "C" int brds_rb_spmv_q8(const void* vals, const void* ix, int ix_bytes,
                               int K, const void* comb, const void* q, int X,
                               int code_bytes, void* y, int B, int R,
                               void* stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_delta(ix_bytes, [&](auto ixt) {
      using IX = decltype(ixt);
      return brds::by_batch(B, [&](auto nb, auto tiled) {
        constexpr int NB = decltype(nb)::value;
        rb_spmv_q8_kernel<CT, IX, NB, decltype(tiled)::value>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const CT*>(vals), static_cast<const IX*>(ix), K,
                static_cast<const float*>(comb), static_cast<const CT*>(q), X,
                static_cast<float*>(y), B, R);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_rb_dual_parts_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    void* zx, void* zh, int B, int R, void* stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  brds::batch_tiles(B));
  cudaError_t st = brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_delta(ix_bytes, [&](auto ixt) {
      using IX = decltype(ixt);
      return brds::by_delta(ih_bytes, [&](auto iht) {
        using IH = decltype(iht);
        return brds::by_batch(B, [&](auto nb, auto tiled) {
          constexpr int NB = decltype(nb)::value;
          rb_dual_parts_q8_kernel<CT, IX, IH, NB, decltype(tiled)::value>
              <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  static_cast<const CT*>(vx), static_cast<const IX*>(ix), kx,
                  static_cast<const float*>(comb_x),
                  static_cast<const CT*>(qx), X, static_cast<const CT*>(vh),
                  static_cast<const IH*>(ih), kh,
                  static_cast<const float*>(comb_h),
                  static_cast<const CT*>(qh), H, static_cast<float*>(zx),
                  static_cast<float*>(zh), B, R);
          return cudaSuccess;
        });
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}
