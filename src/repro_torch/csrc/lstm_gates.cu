// lstm_gates: (c, h) from the four gate preactivations and c_prev.
//
// Replaces src/repro/kernels/lstm_gates.py::lstm_gates (the Pallas kernel
// that tiles (B, block) through VMEM and stages the two cell products in
// scratch so they round on their own). Here one thread owns one (b, j) and
// runs brds::lstm_cell, whose explicit _rn intrinsics pin that rounding.
//
// Bound: bytes (5 reads and 2 writes of 4 B per element against a few
// dozen flops). The four z inputs may be column slices of one (B, ldz)
// matrix, as the chained step passes them, so no copy is made.
#include "brds_common.cuh"

namespace {

__global__ void __launch_bounds__(256)
lstm_gates_kernel(const float* __restrict__ zf, const float* __restrict__ zi,
                  const float* __restrict__ zg, const float* __restrict__ zo,
                  int ldz, const float* __restrict__ c_prev,
                  float* __restrict__ c_out, float* __restrict__ h_out, int B,
                  int H, brds::Act act) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * H) return;
  const int b = idx / H, j = idx % H;
  const size_t zo_ = (size_t)b * ldz + j;
  brds::lstm_cell(zf[zo_], zi[zo_], zg[zo_], zo[zo_], c_prev[idx], act,
                  c_out + idx, h_out + idx);
}

}  // namespace

extern "C" int brds_lstm_gates(const void* zf, const void* zi, const void* zg,
                               const void* zo, int ldz, const void* c_prev,
                               void* c_out, void* h_out, int B, int H,
                               const void* lut, float lo, float hi, float hic,
                               void* stream) {
  constexpr int kThreads = 256;
  const int n = B * H;
  if (n <= 0) return cudaErrorInvalidValue;
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  lstm_gates_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zf), static_cast<const float*>(zi),
      static_cast<const float*>(zg), static_cast<const float*>(zo), ldz,
      static_cast<const float*>(c_prev), static_cast<float*>(c_out),
      static_cast<float*>(h_out), B, H, act);
  return cudaGetLastError();
}
