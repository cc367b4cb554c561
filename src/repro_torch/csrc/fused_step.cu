// fused_brds_lstm_step: one BRDS-LSTM layer step in one launch — the
// dual-ratio SpMV, bias, gate nonlinearities and cell update.
//
// Replaces src/repro/kernels/fused_step.py::fused_brds_lstm_step. The TPU
// kernel writes each row block's z into VMEM scratch and closes the cell on
// the last step of its sequential grid (pl.when(i == nblk - 1)). Blocks on
// a GPU run in no order, so here each block owns kJT hidden units j and
// computes their four gate rows j, H+j, 2H+j, 3H+j (one warp per row, the
// same brds::row_dot as rb_dual_spmv), keeps z in shared memory, and closes
// the cell in-block with the same brds::lstm_cell as lstm_gates. The result
// is bitwise equal to the chained rb_dual_spmv -> lstm_gates pair.
//
// Bound: bytes, as rb_dual_spmv: the packed weights are read once; z, c and
// h never round-trip through device memory between the two stages.
#include "brds_common.cuh"

namespace {

constexpr int kJT = 2;                            // hidden units per block
constexpr int kThreads = kJT * 4 * brds::kWarp;   // one warp per gate row

template <typename DX, typename DH, int NB>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const float* __restrict__ vx, const DX* __restrict__ dx,
                  int kx, const float* __restrict__ x, int X,
                  const float* __restrict__ vh, const DH* __restrict__ dh,
                  int kh, const float* __restrict__ h, int H,
                  const float* __restrict__ bias,
                  const float* __restrict__ c_prev, float* __restrict__ c_out,
                  float* __restrict__ h_out, int B, brds::Act act) {
  __shared__ float zs[kJT][4][NB];
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int j = blockIdx.x * kJT + jl;
  if (j < H) {
    const int row = gate * H + j;
    float ax[NB] = {}, ah[NB] = {};
    brds::row_dot<DX, NB>(vx + (size_t)row * kx, dx + (size_t)row * kx, kx,
                          x, X, B, ax);
    brds::row_dot<DH, NB>(vh + (size_t)row * kh, dh + (size_t)row * kh, kh,
                          h, H, B, ah);
    const float bb = bias[row];
    // z would round through x's dtype here, as the chained path stores it;
    // x is float32, so that is the identity
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B && b == lane) zs[jl][gate][b] = ax[b] + ah[b] + bb;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kJT * B) {
    const int jl2 = t / B, b = t % B;
    const int j2 = blockIdx.x * kJT + jl2;
    if (j2 < H) {
      const size_t o = (size_t)b * H + j2;
      brds::lstm_cell(zs[jl2][0][b], zs[jl2][1][b], zs[jl2][2][b],
                      zs[jl2][3][b], c_prev[o], act, c_out + o, h_out + o);
    }
  }
}

}  // namespace

extern "C" int brds_fused_lstm_step(const void* vx, const void* dx,
                                    int dx_bytes, int kx, const void* x,
                                    int X, const void* vh, const void* dh,
                                    int dh_bytes, int kh, const void* h,
                                    int H, const void* bias,
                                    const void* c_prev, void* c_out,
                                    void* h_out, int B, const void* lut,
                                    float lo, float hi, float hic,
                                    void* stream) {
  if (H <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H + kJT - 1) / kJT);
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = brds::by_delta(dx_bytes, [&](auto dxt) {
    using DX = decltype(dxt);
    return brds::by_delta(dh_bytes, [&](auto dht) {
      using DH = decltype(dht);
      return brds::by_batch(B, [&](auto nb) {
        constexpr int NB = decltype(nb)::value;
        fused_step_kernel<DX, DH, NB>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(vx), static_cast<const DX*>(dx), kx,
                static_cast<const float*>(x), X,
                static_cast<const float*>(vh), static_cast<const DH*>(dh), kh,
                static_cast<const float*>(h), H,
                static_cast<const float*>(bias),
                static_cast<const float*>(c_prev), static_cast<float*>(c_out),
                static_cast<float*>(h_out), B, act);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}
