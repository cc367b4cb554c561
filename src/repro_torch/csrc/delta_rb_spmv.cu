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
// tiles on the TPU's sequential grid.
//  - delta_rb_spmv (delta_spmv_staged_kernel): rb_spmv.cu's single-family
//    kernel (brds::single_rows_block) with the masked deltas as the
//    operand: one block an SM owns a contiguous range of rows
//    (kernels/plan.py::stream_plan without H), stages d*f once (DeltaSrc,
//    16-byte loads of d and f where they allow it; gathered by DeltaAct
//    when too wide), streams its warps' rows in row_dot's order, and writes
//    y through shared memory, coalesced. An unfired column adds an exact
//    zero product; its sums are the dual kernel's family sums bit for bit,
//    so delta_update(m, y(Sx), y(Sh)) is delta_rb_dual_spmv.
//  - delta_rb_dual_spmv (delta_dual_staged_kernel): one block an SM owns a
//    contiguous range of `rows` rows (kernels/plan.py::stream_plan); it
//    stages the masked deltas d*f of both families in shared memory once
//    (the product DeltaAct forms, bit for bit; a family too wide to stage
//    is gathered as DeltaAct gathers it) and streams its warps' rows with
//    their loads in flight (brds::stream_rows_block, rb_dual_spmv's
//    routine with the masked deltas as the operand: row_dot's order, so
//    the sums are those of the fused delta step's routine, the same one);
//    then m' = brds::delta_update(m, ax, ah), m first, as the reference
//    adds, with m read there only.
//
// Bound: bytes. The packed values and deltas are read once and used for
// all B batch rows; d and f are read once a block from L2; m is read and
// m' written once. Unfired columns save no bytes here: every packed value
// is still read. What the staged design pays beyond the bytes: shared
// loads of random columns meet about two lanes on a bank slot
// (tests/test_torch_plan.py), and each block stages all of d*f.
#include "brds_common.cuh"

namespace {

template <int NB, bool kTiled>
__global__ void __launch_bounds__(brds::kStreamThreads, 1)
delta_spmv_staged_kernel(brds::SingleArgs<brds::DeltaSrc> a) {
  extern __shared__ float4 stream_smem[];
  brds::single_rows_block<NB, kTiled>(a, stream_smem);
}

// Runs `body(kern)` with the single-family delta instantiation for batch B.
template <typename F>
cudaError_t by_single_kernel(int B, F&& body) {
  return brds::by_batch(B, [&](auto nb, auto tiled) {
    return body(delta_spmv_staged_kernel<decltype(nb)::value,
                                         decltype(tiled)::value>);
  });
}

struct DeltaDualArgs {
  brds::StreamIn<brds::DeltaSrc> in;
  const float* m;     // (B, R)
  float* m_out;
  int R, rows;        // rows of the output; rows a block
};

template <int NB, bool kTiled>
__global__ void __launch_bounds__(brds::kStreamThreads, 1)
delta_dual_staged_kernel(DeltaDualArgs a) {
  const int R = a.R;
  if constexpr (kTiled) {
    brds::tile_stream_in(a.in);
    a.m = brds::tile_rows(a.m, R);
    a.m_out = brds::tile_rows(a.m_out, R);
  }
  extern __shared__ float4 delta_smem[];
  float* zx = reinterpret_cast<float*>(delta_smem +
                                       brds::staged_float4s(a.in, NB));
  float* zh = zx + a.rows * NB;
  const int B = a.in.B, r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, R - r0);
  brds::stream_rows_block<NB>(a.in, delta_smem, nrows,
                              [&](int i) { return r0 + i; }, zx, zh);
  for (int t = threadIdx.x; t < nrows * B; t += brds::kStreamThreads) {
    const int b = t / nrows, i = t % nrows;
    const size_t o = (size_t)b * R + r0 + i;
    a.m_out[o] = brds::delta_update(a.m[o], zx[i * NB + b], zh[i * NB + b]);
  }
}

// Runs `body(kern)` with the dual delta instantiation for batch B.
template <typename F>
cudaError_t by_dual_kernel(int B, F&& body) {
  return brds::by_batch(B, [&](auto nb, auto tiled) {
    return body(delta_dual_staged_kernel<decltype(nb)::value,
                                         decltype(tiled)::value>);
  });
}

}  // namespace

// One launch on kernels/plan.py::stream_plan's single-family arguments
// (rows a block, d*f's staged layout, the dynamic shared memory).
extern "C" int brds_delta_rb_spmv(const void* vals, const void* deltas,
                                  int d_bytes, int K, const void* d,
                                  const void* f, int X, void* y, int B, int R,
                                  int rows, int stage_x, int shift_x,
                                  int slot_bits, int xpad, int smem,
                                  void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows, brds::batch_tiles(B));
  const brds::SingleArgs<brds::DeltaSrc> a{
      {static_cast<const float*>(vals), deltas, d_bytes, K,
       {static_cast<const float*>(d), static_cast<const float*>(f)}, X,
       nullptr, nullptr, 0, 0, {nullptr, nullptr}, 0, B, stage_x, 0, shift_x,
       0, slot_bits, xpad, 0},
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

// For the single-family delta instantiation of batch B: out[0..3] as
// brds::kernel_info gives them, with `smem` bytes of dynamic shared memory.
extern "C" int brds_delta_rb_spmv_info(int B, int smem, int* out) {
  return by_single_kernel(B, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kStreamThreads, smem, out);
  });
}

// One launch on kernels/plan.py::stream_plan's arguments (rows a block,
// the staged layout, the dynamic shared memory).
extern "C" int brds_delta_rb_dual_spmv(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* dx,
    const void* fx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* dh, const void* fh, int H, const void* m,
    void* m_out, int B, int R, int rows, int stage_x, int stage_h,
    int shift_x, int shift_h, int slot_bits, int xpad, int hpad, int smem,
    void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows, brds::batch_tiles(B));
  DeltaDualArgs a{
      {static_cast<const float*>(vx), ix, ix_bytes, kx,
       {static_cast<const float*>(dx), static_cast<const float*>(fx)}, X,
       static_cast<const float*>(vh), ih, ih_bytes, kh,
       {static_cast<const float*>(dh), static_cast<const float*>(fh)}, H, B,
       stage_x, stage_h, shift_x, shift_h, slot_bits, xpad, hpad},
      static_cast<const float*>(m), static_cast<float*>(m_out), R, rows};
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

// For the dual delta instantiation of batch B: out[0..3] as
// brds::kernel_info gives them, with `smem` bytes of dynamic shared memory.
extern "C" int brds_delta_rb_dual_spmv_info(int B, int smem, int* out) {
  return by_dual_kernel(B, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kStreamThreads, smem, out);
  });
}
