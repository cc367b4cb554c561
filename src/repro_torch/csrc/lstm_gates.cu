// lstm_gates: (c, h) from the four gate preactivations and c_prev.
//
// Replaces src/repro/kernels/lstm_gates.py::lstm_gates (the Pallas kernel
// that tiles (B, block) through VMEM and stages the two cell products in
// scratch so they round on their own). One thread owns one (b, j) and runs
// brds::lstm_cell, whose explicit _rn intrinsics pin that rounding, so the
// cell here is bitwise the fused steps' cell.
//
// Bound: bytes (5 reads and 2 writes of 4 B per element against a few
// dozen flops), but at the serve shape (B=8, H=1500: 0.34 MB) a launch is
// mostly latency: the launch itself, one round trip of loads, the cell's
// dependent math. So it is a programmatic dependent launch
// (cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization): its blocks may
// start while the kernel before it in the stream still runs (the dual
// SpMV rb_dual_spmv on the chained float step, which triggers once its
// rows are summed), do their index arithmetic, and wait in
// brds::wait_for_producer until that kernel's memory is visible; only
// then do they load z, c_prev or the LUT. c_prev may have been written by
// the kernel just before, like z, so every global read comes after the
// wait, through coherent loads. The grid is at most one wave
// (kernels/plan.py::gates_plan) and strides over larger batches. (Four
// units a thread with 16-byte accesses was slower on the H100: fewer
// threads to hide the cell's math; PERF.md §6.)
//
// The four z inputs may be column slices of one (B, ldz) matrix, as the
// chained step passes them, so no copy is made.
#include "brds_common.cuh"

namespace {

constexpr int kThreads = 128;   // kernels/plan.py GATES_THREADS

struct GatesArgs {
  const float* z[4];    // f, i, g, o: (B, H) slices, row stride ldz
  const float* c_prev;  // (B, H)
  float* c;
  float* h;
  int ldz, B, H;
  brds::Act act;
};

__global__ void __launch_bounds__(kThreads) lstm_gates_kernel(GatesArgs a) {
  const int n = a.B * a.H;
  const int step = gridDim.x * kThreads;
  int t = blockIdx.x * kThreads + threadIdx.x;
  brds::wait_for_producer();
  for (; t < n; t += step) {
    const int b = t / a.H, j = t - b * a.H;
    const size_t zo = (size_t)b * a.ldz + j;
    brds::lstm_cell(a.z[0][zo], a.z[1][zo], a.z[2][zo], a.z[3][zo],
                    a.c_prev[t], a.act, a.c + t, a.h + t);
  }
}

}  // namespace

// One launch of `grid` blocks (kernels/plan.py::gates_plan); `pdl` 0
// launches it plainly, after the kernel before it has drained.
extern "C" int brds_lstm_gates(const void* zf, const void* zi, const void* zg,
                               const void* zo, int ldz, const void* c_prev,
                               void* c_out, void* h_out, int B, int H,
                               int grid, int pdl, const void* lut, float lo,
                               float hi, float hic, void* stream) {
  if (B <= 0 || H <= 0 || grid <= 0) return cudaErrorInvalidValue;
  const GatesArgs a{{static_cast<const float*>(zf),
                     static_cast<const float*>(zi),
                     static_cast<const float*>(zg),
                     static_cast<const float*>(zo)},
                    static_cast<const float*>(c_prev),
                    static_cast<float*>(c_out),
                    static_cast<float*>(h_out),
                    ldz, B, H,
                    {static_cast<const float*>(lut), lo, hi, hic}};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lstm_gates_kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// out[0..3] as brds::kernel_info gives them.
extern "C" int brds_lstm_gates_info(int* out) {
  return brds::kernel_info(reinterpret_cast<const void*>(lstm_gates_kernel),
                           kThreads, 0, out);
}
