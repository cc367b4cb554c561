// delta_rb_dual_spmv: the temporal-delta partial-sum memory update
// m' = m + Sx@(fx*dx) + Sh@(fh*dh) over packed row-balanced Sx (R, Kx) and
// Sh (R, Kh); dx, dh are raw activation deltas and fx, fh their 0/1 fired
// masks, all float32.
//
// Replaces src/repro/kernels/delta_rb_spmv.py::delta_rb_dual_spmv (the
// Pallas kernel that masks the deltas in VMEM and streams (block_rows, K)
// tiles on the TPU's sequential grid). Here one warp owns one packed row,
// as in rb_dual_spmv: brds::row_dot with the DeltaAct policy gathers
// d*f for each entry, so an unfired column adds an exact zero, and the row
// ends with brds::delta_update, m first, as the reference adds.
//
// Bound: bytes. The packed values and deltas are read once and used for
// all B batch rows; d and f (B x 1500 floats each at full width) stay in
// the read-only cache; m is read and m' written once. Unfired columns save
// no bytes here: every packed value is still read.
#include "brds_common.cuh"

namespace {

template <typename IX, typename IH, int NB>
__global__ void __launch_bounds__(256)
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

extern "C" int brds_delta_rb_dual_spmv(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* dx,
    const void* fx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* dh, const void* fh, int H, const void* m,
    void* m_out, int B, int R, void* stream) {
  constexpr int kThreads = 256;
  const int rows_per_block = kThreads / brds::kWarp;
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block);
  cudaError_t st = brds::by_delta(ix_bytes, [&](auto ixt) {
    using IX = decltype(ixt);
    return brds::by_delta(ih_bytes, [&](auto iht) {
      using IH = decltype(iht);
      return brds::by_batch(B, [&](auto nb) {
        constexpr int NB = decltype(nb)::value;
        delta_rb_dual_spmv_kernel<IX, IH, NB>
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
