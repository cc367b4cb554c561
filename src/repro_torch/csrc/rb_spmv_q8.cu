// The quantized row-balanced SpMVs over packed integer codes and
// delta-coded columns, with integer activation codes:
//  - rb_spmv_q8: y = dq(S@q) over one packed family S (R, K). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_spmv_q8.
//  - rb_dual_parts_q8: (zx, zh) = (dq(Sx@qx), dq(Sh@qh)) over Sx (R, Kx)
//    and Sh (R, Kh). Replaces
//    src/repro/kernels/rb_spmv_q8.py::rb_dual_parts_q8.
//
// The Pallas kernels stream (block_rows, K) code tiles through VMEM on the
// TPU's sequential grid.
//  - rb_spmv_q8: one warp owns one packed row, as rb_spmv did before its
//    redesign: brds::row_dot with the CodeAct policy accumulates code
//    products in 32-bit two's complement (exact, and wrapping as the plain
//    version's int32 sum does), dequantized once per row by brds::dequant
//    with the combined (row x activation) scale.
//  - rb_dual_parts_q8 (rb_dual_parts_staged_kernel): one block an SM owns
//    a contiguous range of `rows` rows (kernels/plan.py::q8_plan); it
//    stages the tile's activation codes in shared memory once (gathered
//    from global memory when too wide) and runs its rows with the fused q8
//    steps' routine, brds::q8_rows_block: four entries a lane, __dp4a for
//    int8 codes, a warp's rows streamed with their loads in flight when
//    both families have int16 deltas. Integer sums are exact in any order
//    and each family is dequantized by the same brds::dequant, so zx and
//    zh equal the plain version bit for bit; they are written apart, as
//    the TPU kernel writes them (no dequant multiply can be contracted
//    into an add), through shared memory, so each batch row's outputs
//    leave coalesced.
//
// Bound: bytes. Codes (1 B for int8, 2 B for qM.N) and deltas are read
// once and used for all B batch rows. What the staged design pays beyond
// the bytes: each block stages all of qx and qh before its first product,
// and its shared loads of random columns meet on bank slots
// (tests/test_torch_plan.py).
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

// rb_dual_parts_q8's arguments: the staged q8 routine's inputs and the
// outputs zx, zh (B, R).
template <typename CT>
struct DualQ8Args {
  brds::Q8In<CT> in;
  float* zx;
  float* zh;
  int R, rows;        // rows of the output; rows a block
};

template <typename CT, int NB, bool kTiled, bool kStaged>
__global__ void __launch_bounds__(brds::kQ8Threads, 1)
rb_dual_parts_staged_kernel(DualQ8Args<CT> a) {
  const int R = a.R;
  if constexpr (kTiled) {
    brds::tile_q8_in(a.in);
    a.zx = brds::tile_rows(a.zx, R);
    a.zh = brds::tile_rows(a.zh, R);
  }
  extern __shared__ uint4 q8_smem[];
  uint32_t* codes = reinterpret_cast<uint32_t*>(q8_smem);
  float* zx = reinterpret_cast<float*>(
      codes + brds::q8_staged_words<NB, kStaged>(a.in));
  float* zh = zx + a.rows * NB;
  const int B = a.in.B, r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, R - r0);
  brds::q8_rows_block<NB, kStaged>(a.in, codes, nrows,
                                   [&](int i) { return r0 + i; },
                                   brds::Q8Apart{zx, zh, NB, B});
  __syncthreads();
  for (int t = threadIdx.x; t < nrows * B; t += brds::kQ8Threads) {
    const int b = t / nrows, i = t % nrows;
    const size_t o = (size_t)b * R + r0 + i;
    a.zx[o] = zx[i * NB + b];
    a.zh[o] = zh[i * NB + b];
  }
}

// Runs `body(kern, CT{})` with the dual q8 instantiation for the code
// width, batch and staging (brds::by_batch's tiers).
template <typename F>
cudaError_t by_dual_q8_kernel(int code_bytes, int B, int staged, F&& body) {
  return brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_batch(B, [&](auto nb, auto tiled) {
      constexpr int NB = decltype(nb)::value;
      constexpr bool kT = decltype(tiled)::value;
      void (*kern)(DualQ8Args<CT>) =
          staged ? rb_dual_parts_staged_kernel<CT, NB, kT, true>
                 : rb_dual_parts_staged_kernel<CT, NB, kT, false>;
      return body(kern, CT{});
    });
  });
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

// One launch on kernels/plan.py::q8_plan's arguments (rows a block, the
// staged layout, the dynamic shared memory).
extern "C" int brds_rb_dual_parts_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    void* zx, void* zh, int B, int R, int rows, int staged, int shift_x,
    int shift_h, int slot_bits, int xpad, int hpad, int smem, void* stream) {
  if (R <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows, brds::batch_tiles(B));
  cudaError_t st = by_dual_q8_kernel(
      code_bytes, B, staged, [&](auto kern, auto ct) {
        using CT = decltype(ct);
        cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
        if (e != cudaSuccess) return e;
        const DualQ8Args<CT> a{
            {static_cast<const CT*>(vx), ix, ix_bytes, kx,
             static_cast<const float*>(comb_x), static_cast<const CT*>(qx), X,
             static_cast<const CT*>(vh), ih, ih_bytes, kh,
             static_cast<const float*>(comb_h), static_cast<const CT*>(qh), H,
             B, shift_x, shift_h, slot_bits, xpad, hpad},
            static_cast<float*>(zx), static_cast<float*>(zh), R, rows};
        kern<<<grid, brds::kQ8Threads, smem,
               static_cast<cudaStream_t>(stream)>>>(a);
        return cudaSuccess;
      });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// For the dual q8 instantiation of (code bytes, B, staged): out[0..3] as
// brds::kernel_info gives them, with `smem` bytes of dynamic shared memory.
extern "C" int brds_rb_dual_parts_q8_info(int code_bytes, int B, int staged,
                                          int smem, int* out) {
  return by_dual_q8_kernel(code_bytes, B, staged, [&](auto kern, auto) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kQ8Threads, smem, out);
  });
}
