// The float row-balanced SpMVs over packed values and delta-coded columns:
//  - rb_spmv: y = S@x over one packed family S (R, K). Replaces
//    src/repro/kernels/rb_spmv.py::rb_spmv.
//  - rb_dual_spmv: z = Sx@x + Sh@h + bias over Sx (R, Kx) and Sh (R, Kh).
//    Replaces src/repro/kernels/rb_spmv.py::rb_dual_spmv.
//
// The Pallas kernels stream (block_rows, K) tiles through VMEM on the TPU's
// sequential grid. Here one block an SM owns a contiguous range of `rows`
// rows (kernels/plan.py::stream_plan); it stages its operands in shared
// memory once (a column's NB floats at stage_pos; a family too wide to
// stage is gathered from global memory) and streams its warps' rows
// with their loads in flight (brds::stream_rows_block, the fused float
// step's routine, in row_dot's order: lane l takes entries l, l+32, ...,
// one fmaf a batch row, then the xor butterfly).
//  - rb_spmv (rb_spmv_staged_kernel): the routine's single-family form, x
//    alone, y written through shared memory so each batch row's outputs
//    leave coalesced (brds::single_rows_block, B6's body too).
//  - rb_dual_spmv (rb_dual_staged_kernel): x and h, then z = (ax + ah) +
//    bias, with the bias read there only. Once its rows are summed, a
//    block lets the kernel after it in the stream launch early
//    (brds::trigger_dependents): on the chained float step that is
//    lstm_gates, a programmatic dependent launch, so the cell's launch
//    latency hides behind this kernel's epilogue and tail. The two
//    kernels' sums are the same bits, so rb_spmv(Sx, x) + rb_spmv(Sh, h)
//    + bias, added in that order, equals rb_dual_spmv, and the fused step
//    equals rb_dual_spmv -> lstm_gates.
//
// Bound: bytes. Each packed value (4 B) and delta (1-4 B) is read once and
// used for all B batch rows, so at B <= 16 the weight stream dominates and
// the least time is (values + deltas) / memory rate. What the staged
// design pays beyond the bytes: each block stages all of its operands
// before its first product, and shared loads of random columns meet about
// two lanes on a bank slot (tests/test_torch_plan.py).
#include "brds_common.cuh"

namespace {

template <int NB, bool kTiled>
__global__ void __launch_bounds__(brds::kStreamThreads, 1)
rb_spmv_staged_kernel(brds::SingleArgs<brds::F32Src> a) {
  extern __shared__ float4 stream_smem[];
  brds::single_rows_block<NB, kTiled>(a, stream_smem);
}

// Runs `body(kern)` with the single-family float instantiation for batch B.
template <typename F>
cudaError_t by_single_kernel(int B, F&& body) {
  return brds::by_batch(B, [&](auto nb, auto tiled) {
    return body(rb_spmv_staged_kernel<decltype(nb)::value,
                                      decltype(tiled)::value>);
  });
}

struct DualArgs {
  brds::StreamIn<brds::F32Src> in;
  const float* bias;  // (R,)
  float* z;           // (B, R)
  int R, rows;        // rows of the output; rows a block
};

template <int NB, bool kTiled>
__global__ void __launch_bounds__(brds::kStreamThreads, 1)
rb_dual_staged_kernel(DualArgs a) {
  const int R = a.R;
  if constexpr (kTiled) {
    brds::tile_stream_in(a.in);
    a.z = brds::tile_rows(a.z, R);
  }
  extern __shared__ float4 stream_smem[];
  float* zx = reinterpret_cast<float*>(stream_smem +
                                       brds::staged_float4s(a.in, NB));
  float* zh = zx + a.rows * NB;
  const int B = a.in.B, r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, R - r0);
  brds::stream_rows_block<NB>(a.in, stream_smem, nrows,
                              [&](int i) { return r0 + i; }, zx, zh);
  // every weight load of the block issued: the cell (lstm_gates, launched
  // as a programmatic dependent) may start its blocks
  brds::trigger_dependents();
  for (int t = threadIdx.x; t < nrows * B; t += brds::kStreamThreads) {
    const int b = t / nrows, i = t % nrows;
    a.z[(size_t)b * R + r0 + i] = __fadd_rn(
        __fadd_rn(zx[i * NB + b], zh[i * NB + b]), a.bias[r0 + i]);
  }
}

// Runs `body(kern)` with the dual float instantiation for batch B.
template <typename F>
cudaError_t by_dual_kernel(int B, F&& body) {
  return brds::by_batch(B, [&](auto nb, auto tiled) {
    return body(rb_dual_staged_kernel<decltype(nb)::value,
                                      decltype(tiled)::value>);
  });
}

}  // namespace

// One launch on kernels/plan.py::stream_plan's single-family arguments
// (rows a block, x's staged layout, the dynamic shared memory).
extern "C" int brds_rb_spmv(const void* vals, const void* deltas,
                            int d_bytes, int K, const void* x, int X,
                            void* y, int B, int R, int rows, int stage_x,
                            int shift_x, int slot_bits, int xpad, int smem,
                            void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows, brds::batch_tiles(B));
  const brds::SingleArgs<brds::F32Src> a{
      {static_cast<const float*>(vals), deltas, d_bytes, K,
       {static_cast<const float*>(x)}, X, nullptr, nullptr, 0, 0, {nullptr},
       0, B, stage_x, 0, shift_x, 0, slot_bits, xpad, 0},
      static_cast<float*>(y), R, rows};
  cudaError_t st = by_single_kernel(B, [&](auto kern) {
    cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
    if (e != cudaSuccess) return e;
    kern<<<grid, brds::kStreamThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
    return cudaSuccess;
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// For the single-family float instantiation of batch B: out[0..3] as
// brds::kernel_info gives them, with `smem` bytes of dynamic shared memory.
extern "C" int brds_rb_spmv_info(int B, int smem, int* out) {
  return by_single_kernel(B, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kStreamThreads, smem, out);
  });
}

// One launch on kernels/plan.py::stream_plan's arguments (rows a block,
// the staged layout, the dynamic shared memory).
extern "C" int brds_rb_dual_spmv(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* x,
    int X, const void* vh, const void* ih, int ih_bytes, int kh,
    const void* h, int H, const void* bias, void* z, int B, int R, int rows,
    int stage_x, int stage_h, int shift_x, int shift_h, int slot_bits,
    int xpad, int hpad, int smem, void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows, brds::batch_tiles(B));
  const DualArgs a{
      {static_cast<const float*>(vx), ix, ix_bytes, kx,
       {static_cast<const float*>(x)}, X, static_cast<const float*>(vh), ih,
       ih_bytes, kh, {static_cast<const float*>(h)}, H, B, stage_x, stage_h,
       shift_x, shift_h, slot_bits, xpad, hpad},
      static_cast<const float*>(bias), static_cast<float*>(z), R, rows};
  cudaError_t st = by_dual_kernel(B, [&](auto kern) {
    cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
    if (e != cudaSuccess) return e;
    kern<<<grid, brds::kStreamThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
    return cudaSuccess;
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// For the dual float instantiation of batch B: out[0..3] as
// brds::kernel_info gives them, with `smem` bytes of dynamic shared memory.
extern "C" int brds_rb_dual_spmv_info(int B, int smem, int* out) {
  return by_dual_kernel(B, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kStreamThreads, smem, out);
  });
}
