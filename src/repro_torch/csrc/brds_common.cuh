// Device routines shared by the BRDS-LSTM kernels (rb_spmv.cu,
// delta_rb_spmv.cu, rb_spmv_q8.cu, lstm_gates.cu, fused_step.cu).
//
// Each fused step must be bitwise equal to its chained pair, so both use
// the same row routine, the same per-row epilogue and the same cell
// function:
//  - row_dot fixes the reduction order of a packed row: lane l of the owning
//    warp takes entries l, l+32, ... and a butterfly over the warp adds the
//    32 partial sums. Float and integer addition commute, so every lane ends
//    with the same total. What a packed entry is multiplied by is a policy
//    (F32Act, DeltaAct, CodeAct): one routine serves the float, the
//    temporal-delta and the quantized kernels.
//  - the epilogues (delta_update, dequant) and lstm_cell round every
//    product and sum on its own (__fmul_rn, __fadd_rn), so the compiler
//    cannot contract a product into the following add in one kernel and
//    not in another.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace brds {

constexpr int kWarp = 32;
// Per-batch accumulators live in registers, at most kMaxBatch of them: a
// larger batch runs in tiles of kMaxBatch rows, one per blockIdx.y (each
// batch row's sums are independent, so a tile's rows are bitwise what the
// whole batch gives them). The scans, whose grid is sized to be
// co-resident, take one tile a launch.
constexpr int kMaxBatch = 16;
constexpr int kSeg = 16;   // PWL segments; LUT rows: a_sig, b_sig, a_tanh, b_tanh

// Gather/multiply policies of row_dot: the packed value type W, the
// accumulator Acc, and mac(acc, v, b, col), which adds the product of one
// packed value with batch row b's activation at column col.

// z += v * x[b, col]
struct F32Act {
  using W = float;
  using Acc = float;
  const float* __restrict__ act;
  int ld;
  __device__ __forceinline__ float mac(float acc, float v, int b,
                                       int col) const {
    return fmaf(v, __ldg(act + b * ld + col), acc);
  }
};

// m += v * (d[b, col] * f[b, col]): a raw activation delta times its 0/1
// fired mask, so an unfired column adds an exact zero product.
struct DeltaAct {
  using W = float;
  using Acc = float;
  const float* __restrict__ d;
  const float* __restrict__ f;
  int ld;
  __device__ __forceinline__ float mac(float acc, float v, int b,
                                       int col) const {
    const int o = b * ld + col;
    return fmaf(v, __fmul_rn(__ldg(d + o), __ldg(f + o)), acc);
  }
};

// acc += code * q[b, col] in 32-bit two's complement: the sum wraps as the
// plain version's int32 sum does (signed overflow is undefined in C++, so
// the accumulator is unsigned and cast back by dequant).
template <typename CT>
struct CodeAct {
  using W = CT;
  using Acc = uint32_t;
  const CT* __restrict__ act;
  int ld;
  __device__ __forceinline__ uint32_t mac(uint32_t acc, CT v, int b,
                                          int col) const {
    const int p = static_cast<int>(v) * static_cast<int>(__ldg(act + b * ld + col));
    return acc + static_cast<uint32_t>(p);
  }
};

// acc[b] += sum_k op(vals[k], b, col[k]) for b < B, where col is the int32
// inclusive running sum of deltas. Called by a whole warp, which owns the
// row. Each value is loaded once and used for all B batch rows: the packed
// weights are the bytes that bound the kernels.
template <typename DT, int NB, typename Op>
__device__ __forceinline__ void row_dot(const typename Op::W* __restrict__ vals,
                                        const DT* __restrict__ deltas, int K,
                                        const Op& op, int B,
                                        typename Op::Acc (&acc)[NB]) {
  const int lane = threadIdx.x & (kWarp - 1);
  int carry = 0;
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    const bool live = k < K;
    int d = live ? static_cast<int>(deltas[k]) : 0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, d, off);
      if (lane >= off) d += t;
    }
    const int col = carry + d;
    carry = __shfl_sync(0xffffffffu, col, kWarp - 1);
    if (live) {
      const typename Op::W v = __ldg(vals + k);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < B) acc[b] = op.mac(acc[b], v, b, col);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    typename Op::Acc s = acc[b];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[b] = s;
  }
}

// The partial-sum memory update m' = (m + ax) + ah, the reference's order;
// ax and ah are the two families' float partial sums (for integer codes,
// after dequant: the raw accumulators are integer sums).
__device__ __forceinline__ float delta_update(float m, float ax, float ah) {
  return __fadd_rn(__fadd_rn(m, ax), ah);
}

// One dequant multiply per row: the int32 sum times the combined
// (row x activation) scale.
__device__ __forceinline__ float dequant(uint32_t acc, float comb) {
  return __fmul_rn(__int2float_rn(static_cast<int>(acc)), comb);
}

// Activation parameters of the cell: exact sigmoid/tanh, or the paper's
// 16-segment piecewise-linear LUT on [lo, hi) that saturates outside it.
struct Act {
  const float* lut;   // (4, kSeg) on the device; null when exact
  float lo, hi;
  float hic;          // float32(hi - 1e-6), the reference's upper clip
};

__device__ __forceinline__ float pwl(float x, const float* a, const float* b,
                                     const Act& p, float sat_lo, float sat_hi) {
  const float xc = fminf(fmaxf(x, p.lo), p.hic);
  // floor((xc - lo) / (hi - lo) * n_seg) in the reference's op order
  const float u = __fmul_rn(__fdiv_rn(__fsub_rn(xc, p.lo),
                                      __fsub_rn(p.hi, p.lo)),
                            static_cast<float>(kSeg));
  int idx = static_cast<int>(floorf(u));
  idx = min(max(idx, 0), kSeg - 1);
  float y = __fadd_rn(__fmul_rn(__ldg(a + idx), xc), __ldg(b + idx));
  y = x < p.lo ? sat_lo : y;
  return x >= p.hi ? sat_hi : y;
}

__device__ __forceinline__ float act_sigmoid(float x, const Act& p) {
  if (p.lut) return pwl(x, p.lut, p.lut + kSeg, p, 0.0f, 1.0f);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float act_tanh(float x, const Act& p) {
  if (p.lut) return pwl(x, p.lut + 2 * kSeg, p.lut + 3 * kSeg, p, -1.0f, 1.0f);
  return tanhf(x);
}

// c = f*c_prev + i*g with each product rounded on its own; h = o*tanh(c).
__device__ __forceinline__ void lstm_cell(float zf, float zi, float zg,
                                          float zo, float c_prev,
                                          const Act& p, float* c_out,
                                          float* h_out) {
  const float f = act_sigmoid(zf, p);
  const float i = act_sigmoid(zi, p);
  const float g = act_tanh(zg, p);
  const float o = act_sigmoid(zo, p);
  const float c = __fadd_rn(__fmul_rn(f, c_prev), __fmul_rn(i, g));
  *c_out = c;
  *h_out = __fmul_rn(o, act_tanh(c, p));
}

// The batch rows of this block's tile (blockIdx.y), and a batch-major
// pointer (leading dim ld) moved to the tile's first row.
__device__ __forceinline__ int tile_batch(int B) {
  return min(B - static_cast<int>(blockIdx.y) * kMaxBatch, kMaxBatch);
}
template <typename T>
__device__ __forceinline__ T* tile_rows(T* p, int ld) {
  return p + static_cast<size_t>(blockIdx.y) * kMaxBatch * ld;
}

// Host side: batch tiles (gridDim.y) for batch B.
inline int batch_tiles(int B) { return (B + kMaxBatch - 1) / kMaxBatch; }

// Host side: run `body` with the accumulator count NB for batch B and
// whether the batch runs in tiles (B > kMaxBatch, gridDim.y > 1). A batch
// of at most kMaxBatch takes the untiled instantiation: moving the
// pointers to a tile holds them in registers, which changes the kernels'
// occupancy at the serve path's batch.
template <typename F>
cudaError_t by_batch(int B, F&& body) {
  if (B <= 0 || batch_tiles(B) > 65535) return cudaErrorInvalidValue;
  if (B <= 4) return body(std::integral_constant<int, 4>{}, std::false_type{});
  if (B <= 8) return body(std::integral_constant<int, 8>{}, std::false_type{});
  if (B <= kMaxBatch)
    return body(std::integral_constant<int, kMaxBatch>{}, std::false_type{});
  return body(std::integral_constant<int, kMaxBatch>{}, std::true_type{});
}

// Host side: run `body` with the delta index type of `bytes`.
template <typename F>
cudaError_t by_delta(int bytes, F&& body) {
  switch (bytes) {
    case 1: return body(int8_t{});
    case 2: return body(int16_t{});
    case 4: return body(int32_t{});
    default: return cudaErrorInvalidValue;
  }
}

// Host side: run `body` with the integer code type of `bytes` (int8 for
// the int8 scheme, int16 for qM.N).
template <typename F>
cudaError_t by_code(int bytes, F&& body) {
  switch (bytes) {
    case 1: return body(int8_t{});
    case 2: return body(int16_t{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace brds
