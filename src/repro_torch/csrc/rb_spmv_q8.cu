// The quantized row-balanced SpMVs over packed integer codes and
// delta-coded columns, with integer activation codes:
//  - rb_spmv_q8: y = dq(S@q) over one packed family S (R, K). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_spmv_q8.
//  - rb_dual_parts_q8: (zx, zh) = (dq(Sx@qx), dq(Sh@qh)) over Sx (R, Kx)
//    and Sh (R, Kh). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_dual_parts_q8.
//
// The Pallas kernels stream (block_rows, K) code tiles through VMEM on the
// TPU's sequential grid. Here one block an SM owns a contiguous range of
// `rows` rows (kernels/plan.py::q8_plan); it stages the tile's activation
// codes in shared memory once (gathered from global memory when too wide)
// and runs its rows with the fused q8 steps' routine, brds::q8_rows_block:
// four entries a lane, __dp4a for int8 codes, a warp's rows streamed with
// their loads in flight when every family has int16 deltas, a row at a
// time otherwise. Integer sums are exact in any order and each family is
// dequantized by the same brds::dequant, so every output equals the plain
// version bit for bit. The outputs go through shared memory, so each
// batch row's leave coalesced.
//  - rb_spmv_q8 (rb_spmv_q8_staged_kernel): the routine's single-family
//    form (NF = 1), q's codes alone staged.
//  - rb_dual_parts_q8 (rb_dual_parts_staged_kernel): both families, zx
//    and zh written apart, as the TPU kernel writes them (no dequant
//    multiply can be contracted into an add).
//
// Bound: bytes. Codes (1 B for int8, 2 B for qM.N) and deltas are read
// once and used for all B batch rows. What the staged design pays beyond
// the bytes: each block stages all of its activation codes before its
// first product, and its shared loads of random columns meet on bank
// slots (tests/test_torch_plan.py).
#include "brds_common.cuh"

namespace {

// A staged q8 SpMV's arguments: the staged q8 routine's inputs (the
// single-family form: the Sx family and qx alone) and the outputs zx and,
// for the dual form, zh (B, R).
template <typename CT>
struct Q8SpmvArgs {
  brds::Q8In<CT> in;
  float* zx;
  float* zh;          // null in the single-family form
  int R, rows;        // rows of the output; rows a block
};

// A staged q8 SpMV's body (NF families) over the block's rows r0 .. r0 +
// rows - 1: q8_rows_block leaves each row's sums in shared memory (after
// the staged codes), then they are written out batch row by batch row.
template <int NF, typename CT, int NB, bool kTiled, bool kStaged>
__device__ __forceinline__ void q8_spmv_block(Q8SpmvArgs<CT> a) {
  const int R = a.R;
  if constexpr (kTiled) {
    brds::tile_q8_in<NF>(a.in);
    a.zx = brds::tile_rows(a.zx, R);
    if constexpr (NF == 2) a.zh = brds::tile_rows(a.zh, R);
  }
  extern __shared__ uint4 q8_smem[];
  uint32_t* codes = reinterpret_cast<uint32_t*>(q8_smem);
  float* zx = reinterpret_cast<float*>(
      codes + brds::q8_staged_words<NB, kStaged>(a.in));
  float* zh = zx + a.rows * NB;
  const int B = a.in.B, r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, R - r0);
  auto row_of = [&](int i) { return r0 + i; };
  if constexpr (NF == 2)
    brds::q8_rows_block<NB, kStaged>(a.in, codes, nrows, row_of,
                                     brds::Q8Apart{zx, zh, NB, B});
  else
    brds::q8_rows_block<NB, kStaged, 1>(a.in, codes, nrows, row_of,
                                        brds::Q8One{zx, NB, B});
  __syncthreads();
  for (int t = threadIdx.x; t < nrows * B; t += brds::kQ8Threads) {
    const int b = t / nrows, i = t % nrows;
    const size_t o = (size_t)b * R + r0 + i;
    a.zx[o] = zx[i * NB + b];
    if constexpr (NF == 2) a.zh[o] = zh[i * NB + b];
  }
}

template <typename CT, int NB, bool kTiled, bool kStaged>
__global__ void __launch_bounds__(brds::kQ8Threads, 1)
rb_spmv_q8_staged_kernel(Q8SpmvArgs<CT> a) {
  q8_spmv_block<1, CT, NB, kTiled, kStaged>(a);
}

template <typename CT, int NB, bool kTiled, bool kStaged>
__global__ void __launch_bounds__(brds::kQ8Threads, 1)
rb_dual_parts_staged_kernel(Q8SpmvArgs<CT> a) {
  q8_spmv_block<2, CT, NB, kTiled, kStaged>(a);
}

// Runs `body(kern, CT{})` with the q8 SpMV instantiation of NF families
// for the code width, batch and staging (brds::by_batch's tiers).
template <int NF, typename F>
cudaError_t by_q8_kernel(int code_bytes, int B, int staged, F&& body) {
  return brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_batch(B, [&](auto nb, auto tiled) {
      constexpr int NB = decltype(nb)::value;
      constexpr bool kT = decltype(tiled)::value;
      void (*kern)(Q8SpmvArgs<CT>);
      if constexpr (NF == 1)
        kern = staged ? rb_spmv_q8_staged_kernel<CT, NB, kT, true>
                      : rb_spmv_q8_staged_kernel<CT, NB, kT, false>;
      else
        kern = staged ? rb_dual_parts_staged_kernel<CT, NB, kT, true>
                      : rb_dual_parts_staged_kernel<CT, NB, kT, false>;
      return body(kern, CT{});
    });
  });
}

// One launch of `kern` on q8_plan's grid and shared memory.
template <typename CT>
cudaError_t launch_q8(void (*kern)(Q8SpmvArgs<CT>), const Q8SpmvArgs<CT>& a,
                      int smem, void* stream) {
  cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.R + a.rows - 1) / a.rows, brds::batch_tiles(a.in.B));
  kern<<<grid, brds::kQ8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaSuccess;
}

}  // namespace

// One launch on kernels/plan.py::q8_plan's single-family arguments (rows a
// block, q's staged layout, the dynamic shared memory).
extern "C" int brds_rb_spmv_q8(const void* vals, const void* ix, int ix_bytes,
                               int K, const void* comb, const void* q, int X,
                               int code_bytes, void* y, int B, int R,
                               int rows, int staged, int shift_x,
                               int slot_bits, int xpad, int smem,
                               void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  cudaError_t st = by_q8_kernel<1>(
      code_bytes, B, staged, [&](auto kern, auto ct) {
        using CT = decltype(ct);
        const Q8SpmvArgs<CT> a{
            {static_cast<const CT*>(vals), ix, ix_bytes, K,
             static_cast<const float*>(comb), static_cast<const CT*>(q), X,
             nullptr, nullptr, 0, 0, nullptr, nullptr, 0, B, shift_x, 0,
             slot_bits, xpad, 0},
            static_cast<float*>(y), nullptr, R, rows};
        return launch_q8(kern, a, smem, stream);
      });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// One launch on kernels/plan.py::q8_plan's arguments (rows a block, the
// staged layout, the dynamic shared memory).
extern "C" int brds_rb_dual_parts_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    void* zx, void* zh, int B, int R, int rows, int staged, int shift_x,
    int shift_h, int slot_bits, int xpad, int hpad, int smem, void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  cudaError_t st = by_q8_kernel<2>(
      code_bytes, B, staged, [&](auto kern, auto ct) {
        using CT = decltype(ct);
        const Q8SpmvArgs<CT> a{
            {static_cast<const CT*>(vx), ix, ix_bytes, kx,
             static_cast<const float*>(comb_x), static_cast<const CT*>(qx), X,
             static_cast<const CT*>(vh), ih, ih_bytes, kh,
             static_cast<const float*>(comb_h), static_cast<const CT*>(qh), H,
             B, shift_x, shift_h, slot_bits, xpad, hpad},
            static_cast<float*>(zx), static_cast<float*>(zh), R, rows};
        return launch_q8(kern, a, smem, stream);
      });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// For the q8 SpMV instantiation of (families, code bytes, B, staged):
// out[0..3] as brds::kernel_info gives them, with `smem` bytes of dynamic
// shared memory.
extern "C" int brds_rb_spmv_q8_info(int families, int code_bytes, int B,
                                    int staged, int smem, int* out) {
  auto info = [&](auto kern, auto) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kQ8Threads, smem, out);
  };
  if (families == 1) return by_q8_kernel<1>(code_bytes, B, staged, info);
  if (families == 2) return by_q8_kernel<2>(code_bytes, B, staged, info);
  return cudaErrorInvalidValue;
}
