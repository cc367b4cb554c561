// Device routines shared by the BRDS-LSTM kernels (rb_spmv.cu,
// delta_rb_spmv.cu, rb_spmv_q8.cu, lstm_gates.cu, fused_step.cu,
// fused_scan.cu).
//
// Each fused step must be bitwise equal to its chained pair, so both use
// the same row routine, the same per-row epilogue and the same cell
// function:
//  - the float kernels' sums keep one order, called row_dot's order
//    throughout: lane l of the warp that owns a packed row takes entries
//    l, l+32, ... in order, one fmaf a batch row, and a butterfly over the
//    warp adds the 32 partial sums. Float addition commutes, so every lane
//    ends with the same total. row_dot_stream keeps it with the operands
//    moved (the float steps and dual SpMV, fused_step.cu and rb_spmv.cu,
//    their delta forms, fused_step.cu and delta_rb_spmv.cu, and in its
//    single-family form rb_spmv and delta_rb_spmv: stream_rows_block,
//    single_rows_block): x and h, or the masked deltas, staged in shared
//    memory, a warp's rows streamed with their next loads in flight; a
//    family too wide to stage is gathered from global memory by a gather
//    policy (F32Act, DeltaAct). The scans (fused_scan.cu) keep the same
//    order with columns decoded once and their operands staged.
//  - row_dot_q8x4 is the integer-code row of the staged q8 kernels (the
//    fused q8 and delta-q8 steps, their chained gate kernel
//    rb_dual_parts_q8 and, in its single-family form, rb_spmv_q8:
//    q8_rows_block): each lane takes four consecutive entries (one load of
//    codes, one of deltas), and __dp4a multiplies int8 codes four at a
//    time. Integer sums are exact modulo 2^32 in any order, so this
//    routine may split a row otherwise than row_dot's order and still
//    equal the plain version bit for bit; float sums may not, which is why
//    the float kernels keep that order.
//  - the epilogues (delta_update, dequant) and lstm_cell round every
//    product and sum on its own (__fmul_rn, __fadd_rn), so the compiler
//    cannot contract a product into the following add in one kernel and
//    not in another.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace brds {

constexpr int kWarp = 32;
// Per-batch accumulators live in registers, at most kMaxBatch of them: a
// larger batch runs in tiles of kMaxBatch rows, one per blockIdx.y (each
// batch row's sums are independent, so a tile's rows are bitwise what the
// whole batch gives them). The scans, whose grid is sized to be
// co-resident, take one tile a launch.
constexpr int kMaxBatch = 16;
constexpr int kSeg = 16;   // PWL segments; LUT rows: a_sig, b_sig, a_tanh, b_tanh

// The batch rows of this block's tile (blockIdx.y), and a batch-major
// pointer (leading dim ld) moved to the tile's first row.
__device__ __forceinline__ int tile_batch(int B) {
  return min(B - static_cast<int>(blockIdx.y) * kMaxBatch, kMaxBatch);
}
template <typename T>
__device__ __forceinline__ T* tile_rows(T* p, int ld) {
  return p + static_cast<size_t>(blockIdx.y) * kMaxBatch * ld;
}

// Gather policies of a float family too wide to stage: mac(acc, v, b,
// col) adds the product of one packed value with batch row b's operand at
// column col, read from global memory.

// z += v * x[b, col]
struct F32Act {
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
  const float* __restrict__ d;
  const float* __restrict__ f;
  int ld;
  __device__ __forceinline__ float mac(float acc, float v, int b,
                                       int col) const {
    const int o = b * ld + col;
    return fmaf(v, __fmul_rn(__ldg(d + o), __ldg(f + o)), acc);
  }
};

// Programmatic dependent launch (Hopper). A kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it in the stream still runs: it waits in wait_for_producer until
// that kernel has completed and its memory is visible (at once after a
// plain launch), so it reads nothing global before the wait. The kernel
// before it lets its dependents' blocks launch once each of its own blocks
// has called trigger_dependents or exited (the first call of a block
// counts).
__device__ __forceinline__ void wait_for_producer() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void trigger_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Staged activations. A kernel that gathers activations from shared memory
// keeps each column's batch values together (a 4- to 32-byte vector) at a
// permuted position: the lanes of a warp take entries about 2^shift
// columns apart, and stage_pos moves bits [shift, shift + slot_bits) of the
// column to the bottom, so the lanes of one phase of a shared load fall on
// distinct slots of the 128-byte bank row instead of a few. A permutation
// within each run of 2^(shift + slot_bits) columns, the identity at shift
// 0; the staged arrays are padded to whole runs. kernels/plan.py picks
// shift and slot_bits and sizes the arrays on the host.
__device__ __forceinline__ int stage_pos(int c, int shift, int slot_bits) {
  const int m = shift + slot_bits;
  return ((c >> m) << m) | ((c & ((1 << shift) - 1)) << slot_bits) |
         ((c >> shift) & ((1 << slot_bits) - 1));
}

// One column delta of a delta array of `bytes`-wide integers (1, 2 or 4).
__device__ __forceinline__ int load_delta(const void* d, int bytes, size_t e) {
  if (bytes == 1) return __ldg(static_cast<const int8_t*>(d) + e);
  if (bytes == 2) return __ldg(static_cast<const int16_t*>(d) + e);
  return __ldg(static_cast<const int32_t*>(d) + e);
}

// Four consecutive integer codes of one lane, entry i in byte (int8) or
// half-word (int16) i, little-endian: the pairing __dp4a uses.
template <typename CT>
struct Codes4 {
  static_assert(sizeof(CT) == 1 || sizeof(CT) == 2, "int8 or int16 codes");
  uint32_t w[sizeof(CT)];
  __device__ __forceinline__ int get(int i) const {
    if constexpr (sizeof(CT) == 1)
      return static_cast<int8_t>(w[0] >> (8 * i));
    else
      return i & 1 ? static_cast<int>(w[i >> 1]) >> 16
                   : static_cast<int16_t>(w[i >> 1]);
  }
};

template <typename CT>
__device__ __forceinline__ Codes4<CT> load_codes4(const CT* p) {
  Codes4<CT> c;
  if constexpr (sizeof(CT) == 1) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = v.x;
    c.w[1] = v.y;
  }
  return c;
}

template <typename CT>
__device__ __forceinline__ Codes4<CT> pack_codes4(const int (&q)[4]) {
  Codes4<CT> c;
  constexpr int bits = 8 * sizeof(CT);
  constexpr uint32_t mask = (1u << bits) - 1;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(CT)); ++i) c.w[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c.w[i * bits / 32] |= (static_cast<uint32_t>(q[i]) & mask)
                          << (bits * i % 32);
  return c;
}

// Where row_dot_q8x4 finds a column's NB activation codes, as the words of
// one vector (batch row b in byte / half-word b): staged in shared memory
// at stage_pos, or gathered from global memory (B, ld) when the block's
// activations do not fit in shared memory.
template <typename CTp, int NB>
struct StagedCodes {
  using CT = CTp;
  static constexpr int kWords = NB * static_cast<int>(sizeof(CT)) / 4;
  const uint32_t* s;   // shared, kWords words a position
  int shift, slot_bits;
  __device__ __forceinline__ void fetch(int col,
                                        uint32_t (&v)[kWords]) const {
    const uint32_t* p = s + stage_pos(col, shift, slot_bits) * kWords;
    if constexpr (kWords == 1) {
      v[0] = *p;
    } else if constexpr (kWords == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v[0] = t.x;
      v[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; i += 4) {
        const uint4 t = *reinterpret_cast<const uint4*>(p + i);
        v[i] = t.x;
        v[i + 1] = t.y;
        v[i + 2] = t.z;
        v[i + 3] = t.w;
      }
    }
  }
};

template <typename CTp, int NB>
struct GlobalCodes {
  using CT = CTp;
  static constexpr int kWords = NB * static_cast<int>(sizeof(CT)) / 4;
  const CT* __restrict__ act;
  int ld, B;
  __device__ __forceinline__ void fetch(int col,
                                        uint32_t (&v)[kWords]) const {
    constexpr int per = 4 / sizeof(CT), bits = 8 * sizeof(CT);
    constexpr uint32_t mask = (1u << bits) - 1;
#pragma unroll
    for (int i = 0; i < kWords; ++i) v[i] = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B)
        v[b / per] |= (static_cast<uint32_t>(__ldg(act + b * ld + col)) & mask)
                      << (bits * (b % per));
  }
};

// o[j] = byte j of each of w0..w3, in that order: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);   // w0.0 w1.0 w0.1 w1.1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);   // w0.2 w1.2 w0.3 w1.3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// acc[b] += sum_i w_i * a_i[b] for one lane's four entries, wrapping:
// int8 with one __dp4a per batch row (the four entries' codes of row b
// gathered into one word by transpose4x4), int16 with an IMAD per product.
template <typename CT, int NB, int W>
__device__ __forceinline__ void mac4(uint32_t (&acc)[NB], const Codes4<CT>& w,
                                     const uint32_t (&a)[4][W]) {
  if constexpr (sizeof(CT) == 1) {
#pragma unroll
    for (int g = 0; g < W; ++g) {
      uint32_t o[4];
      transpose4x4(a[0][g], a[1][g], a[2][g], a[3][g], o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[4 * g + j] = static_cast<uint32_t>(
            __dp4a(static_cast<int>(w.w[0]), static_cast<int>(o[j]),
                   static_cast<int>(acc[4 * g + j])));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int wi = w.get(i);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint32_t word = a[i][b >> 1];
        const int ab = b & 1 ? static_cast<int>(word) >> 16
                             : static_cast<int16_t>(word);
        acc[b] += static_cast<uint32_t>(wi * ab);
      }
    }
  }
}

// Every lane ends with the warp's total of each acc[b] (xor butterfly).
template <typename T, int N>
__device__ __forceinline__ void warp_sum(T (&acc)[N]) {
#pragma unroll
  for (int b = 0; b < N; ++b) {
    T s = acc[b];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    acc[b] = s;
  }
}

// acc[lane] (0 for lanes past NB): batch row `lane`'s sum after warp_sum.
template <typename T, int NB>
__device__ __forceinline__ T lane_value(const T (&acc)[NB]) {
  const int lane = threadIdx.x & (kWarp - 1);
  T v = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b)   // acc[lane], without a run-time index
    if (b == lane) v = acc[b];
  return v;
}

// One lane's share of G chunks of a packed integer row (row_dot_q8x4's
// unit of loading): the raw deltas of each chunk and its four codes. DT is
// the delta type, or void for a width known only at run time (`dbytes`),
// whose raw words take the widest (int32) form's four registers.
template <typename DT>
struct DeltaBytes {
  static constexpr int value = sizeof(DT);
};
template <>
struct DeltaBytes<void> {   // known at run time
  static constexpr int value = 0;
};
template <typename DT>
constexpr int kDeltaWords = DeltaBytes<DT>::value ? DeltaBytes<DT>::value : 4;

template <typename CT, typename DT, int G>
struct Q8Group {
  uint32_t d[G][kDeltaWords<DT>];
  Codes4<CT> w[G];
};

// The chunking of a packed integer row of K entries at element `off` of
// the codes and the deltas: chunks of four consecutive elements counted
// from the 4-aligned element at or before `off`; entries outside the row
// (the head peeled off an unaligned row, the tail past K) count as code 0,
// delta 0.
__device__ __forceinline__ int q8x4_chunks(size_t off, int K) {
  return (static_cast<int>(off & 3) + K + 3) >> 2;
}

// The raw words of four deltas at element `at` (a multiple of 4): one 4-,
// 8- or 16-byte load.
template <typename DT>
__device__ __forceinline__ void load_deltas4(const void* deltas, int dbytes,
                                             size_t at,
                                             uint32_t (&d)[kDeltaWords<DT>]) {
  const int w = DeltaBytes<DT>::value ? DeltaBytes<DT>::value : dbytes;
  if (w == 1) {
    d[0] = __ldg(reinterpret_cast<const unsigned int*>(
        static_cast<const int8_t*>(deltas) + at));
  } else if (w == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const int16_t*>(deltas) + at));
    d[0] = v.x;
    d[kDeltaWords<DT> > 1 ? 1 : 0] = v.y;
  } else if constexpr (kDeltaWords<DT> == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const int32_t*>(deltas) + at));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Loads chunks c0 + 32u + lane (u < G) of the row into g: one load of
// four codes and one of four deltas a chunk inside the row; element by
// element at the row's two ends.
template <typename CT, typename DT, int G>
__device__ __forceinline__ void q8x4_load(const CT* __restrict__ codes,
                                          const void* __restrict__ deltas,
                                          int dbytes, size_t off, int K,
                                          int c0, Q8Group<CT, DT, G>& g) {
  constexpr int DW = kDeltaWords<DT>;
  const int lane = threadIdx.x & (kWarp - 1);
  const int bits =
      8 * (DeltaBytes<DT>::value ? DeltaBytes<DT>::value : dbytes);
  const size_t a0 = off & ~static_cast<size_t>(3);
  const int head = static_cast<int>(off - a0);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int c = c0 + u * kWarp + lane;
    const int e = 4 * c - head;   // the chunk's first entry in the row
    if (e >= 0 && e + 4 <= K) {
      const size_t at = a0 + 4 * static_cast<size_t>(c);
      load_deltas4<DT>(deltas, dbytes, at, g.d[u]);
      g.w[u] = load_codes4(codes + at);
    } else {
      int q[4];
#pragma unroll
      for (int i = 0; i < DW; ++i) g.d[u][i] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = e + i;
        const bool live = k >= 0 && k < K;
        const uint32_t dv =
            live ? static_cast<uint32_t>(load_delta(deltas, bits / 8, off + k))
                 : 0u;
        q[i] = live ? static_cast<int>(__ldg(codes + off + k)) : 0;
        // the raw layout a vector load of this width gives (indices known
        // at compile time: a register array indexed at run time would
        // live in local memory)
        if (bits == 8)
          g.d[u][0] |= (dv & 0xffu) << (8 * i);
        else if (bits == 16)
          g.d[u][(i >> 1) % DW] |= (dv & 0xffffu) << (16 * (i & 1));
        else
          g.d[u][i % DW] = dv;
      }
      g.w[u] = pack_codes4<CT>(q);
    }
  }
}

// The four deltas of a chunk from its raw words.
template <typename DT>
__device__ __forceinline__ void q8x4_deltas(
    const uint32_t (&d)[kDeltaWords<DT>], int dbytes, int (&o)[4]) {
  const int w = DeltaBytes<DT>::value ? DeltaBytes<DT>::value : dbytes;
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = static_cast<int8_t>(d[0] >> (8 * i));
  } else if (w == 2) {
    constexpr int k1 = kDeltaWords<DT> > 1 ? 1 : 0;
    o[0] = static_cast<int16_t>(d[0]);
    o[1] = static_cast<int>(d[0]) >> 16;
    o[2] = static_cast<int16_t>(d[k1]);
    o[3] = static_cast<int>(d[k1]) >> 16;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = static_cast<int>(d[i % kDeltaWords<DT>]);
  }
}

// acc[b] += sum of code * act(b, col) over the chunks of g (chunks c0 +
// 32u + lane, those below nchunks), for every batch row the policy holds.
// A lane sums its four deltas in registers and the warp scans the 32
// chunk sums, one scan per 128 entries; `carry` is the row's column before
// chunk c0 (0 at the row's start). The products wrap modulo 2^32.
template <int NB, typename DT, int G, typename Fetch>
__device__ __forceinline__ void q8x4_consume(
    const Q8Group<typename Fetch::CT, DT, G>& g, int dbytes, int c0,
    int nchunks, int& carry, const Fetch& f, uint32_t (&acc)[NB]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    if (c0 + u * kWarp >= nchunks) break;   // warp-uniform
    int p[4];
    q8x4_deltas<DT>(g.d[u], dbytes, p);
#pragma unroll
    for (int i = 1; i < 4; ++i) p[i] += p[i - 1];
    int s = p[3];
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    const int base = carry + s - p[3];
    carry += __shfl_sync(0xffffffffu, s, kWarp - 1);
    uint32_t a[4][Fetch::kWords];
#pragma unroll
    for (int i = 0; i < 4; ++i) f.fetch(base + p[i], a[i]);
    mac4<typename Fetch::CT, NB>(acc, g.w[u], a);
  }
}

// The integer-code row routine of the fused q8 step: acc[b] += sum_k
// codes[off + k] * act(b, col_k) over one packed row of K entries (col_k
// the running sum of deltas), called by a whole warp. Lane l takes chunks
// l, l+32, ... of four consecutive entries (q8x4_chunks): one load of four
// codes and one of four deltas a chunk, G chunks loaded before any is
// used, the sums in another order than row_dot's and, modulo 2^32, equal.
// The staged q8 kernels also chain the loads of a warp's rows
// (q8_rows_stream, for int16 deltas); this single-row form serves any
// delta width.
template <int NB, int G, typename Fetch>
__device__ __forceinline__ void row_dot_q8x4(
    const typename Fetch::CT* __restrict__ codes,
    const void* __restrict__ deltas, int dbytes, size_t off, int K,
    const Fetch& f, uint32_t (&acc)[NB]) {
  const int nchunks = q8x4_chunks(off, K);
  int carry = 0;
  for (int c0 = 0; c0 < nchunks; c0 += G * kWarp) {
    Q8Group<typename Fetch::CT, void, G> g;
    q8x4_load(codes, deltas, dbytes, off, K, c0, g);
    q8x4_consume<NB>(g, dbytes, c0, nchunks, carry, f, acc);
  }
  warp_sum(acc);
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

// ------------------------------------------- the staged q8 rows
//
// The block-level routine of the staged q8 kernels: the fused q8 and
// delta-q8 steps (fused_step.cu, B8 and B9), their chained gate kernel,
// the dual SpMV rb_dual_parts_q8 (rb_spmv_q8.cu, B7), and, with one
// family (NF = 1), the single-family SpMV rb_spmv_q8 (B10). A block
// stages its tile's activation codes (qx, then qh) in shared memory once,
// or gathers them from global memory when they do not fit, then runs its
// rows with row_dot_q8x4's arithmetic (four entries a lane, __dp4a for
// int8 codes); integer sums are exact in any order, so every kernel on it
// equals rb_spmv_q8's plain version bit for bit. What a row's dequantized
// sums become is the emit policy's: zx and zh apart in shared memory (B7,
// B9: Q8Apart), z = (zx + zh) + bias (B8), or the one family's sum (B10:
// Q8One).

constexpr int kQ8Threads = 512;   // one block an SM (kernels/plan.py)
constexpr int kQ8Warps = kQ8Threads / kWarp;

// A staged q8 kernel's inputs: the two packed code families with their
// combined (row x activation) dequant scales, the activation codes qx
// (B, X) and qh (B, H), and the staged layout of kernels/plan.py::q8_plan
// (stage_pos's shifts and slot bits, the padded column counts). The
// single-family form reads the Sx family and qx alone (hpad 0).
template <typename CT>
struct Q8In {
  const CT* vx;
  const void* ix;     // Sx's deltas, ixb bytes each
  int ixb, kx;
  const float* comb_x;
  const CT* qx;       // (B, X)
  int X;
  const CT* vh;
  const void* ih;
  int ihb, kh;
  const float* comb_h;
  const CT* qh;       // (B, H)
  int H;
  int B;
  int shift_x, shift_h, slot_bits, xpad, hpad;
};

// The activation codes moved to the block's batch tile (blockIdx.y); NF =
// 1: qx alone.
template <int NF = 2, typename CT>
__device__ __forceinline__ void tile_q8_in(Q8In<CT>& in) {
  in.qx = tile_rows(in.qx, in.X);
  if constexpr (NF == 2) in.qh = tile_rows(in.qh, in.H);
  in.B = tile_batch(in.B);
}

// 32-bit words of dynamic shared memory the staged codes take (none when
// they are gathered).
template <int NB, bool kStaged, typename CT>
__device__ __forceinline__ size_t q8_staged_words(const Q8In<CT>& in) {
  return kStaged ? (size_t)(in.xpad + in.hpad) * StagedCodes<CT, NB>::kWords
                 : 0;
}

// A row's constants: the families' combined dequant scales (NF = 1: cx
// alone, ch 0) and the emit policy's own (Emit::Row, read by
// Emit::consts), loaded while the row's first loads are in flight.
template <typename Emit>
struct Q8Consts {
  float cx, ch;
  typename Emit::Row e;
};

template <int NF, typename CT, typename Emit>
__device__ __forceinline__ Q8Consts<Emit> q8_consts(const Q8In<CT>& in,
                                                    const Emit& emit,
                                                    int row) {
  return {in.comb_x[row], NF == 2 ? in.comb_h[row] : 0.0f, emit.consts(row)};
}

// The emit policy of B7 and B9: local row i's zx and zh, lane b < B for
// batch row b, apart in shared memory (i * NB + b).
struct Q8Apart {
  struct Row {};
  float* zx;
  float* zh;
  int NB, B;
  __device__ __forceinline__ Row consts(int) const { return {}; }
  __device__ __forceinline__ void operator()(int i, float x, float h,
                                             Row) const {
    const int lane = threadIdx.x & (kWarp - 1);
    if (lane >= B) return;
    zx[i * NB + lane] = x;
    zh[i * NB + lane] = h;
  }
};

// The emit policy of B10 (one family): local row i's sum, lane b < B for
// batch row b, in shared memory (i * NB + b).
struct Q8One {
  struct Row {};
  float* y;
  int NB, B;
  __device__ __forceinline__ Row consts(int) const { return {}; }
  __device__ __forceinline__ void operator()(int i, float x, float,
                                             Row) const {
    const int lane = threadIdx.x & (kWarp - 1);
    if (lane < B) y[i * NB + lane] = x;
  }
};

// The warp's rows i = warp, warp + 16, ... < nrows (packed row row_of(i)
// of each family), each family's row in turn with row_dot_q8x4: any
// delta widths. NF = 1: the Sx rows alone, emitted with zh 0.
template <int NB, int NF, typename CT, typename Fetch, typename RowOf,
          typename Emit>
__device__ __forceinline__ void q8_rows(const Q8In<CT>& in, int nrows,
                                        const RowOf& row_of, const Fetch& fx,
                                        const Fetch& fh, const Emit& emit) {
  for (int i = threadIdx.x / kWarp; i < nrows; i += kQ8Warps) {
    const int row = row_of(i);
    const Q8Consts<Emit> rc = q8_consts<NF>(in, emit, row);
    uint32_t ax[NB] = {}, ah[NB] = {};
    row_dot_q8x4<NB, 4>(in.vx, in.ix, in.ixb, (size_t)row * in.kx, in.kx, fx,
                        ax);
    if constexpr (NF == 2)
      row_dot_q8x4<NB, 4>(in.vh, in.ih, in.ihb, (size_t)row * in.kh, in.kh,
                          fh, ah);
    emit(i, dequant(lane_value(ax), rc.cx),
         NF == 2 ? dequant(lane_value(ah), rc.ch) : 0.0f, rc.e);
  }
}

// The same rows when each family's deltas are of type DT (lstm_ptb's:
// int16), as one stream of G-chunk groups: row i's Sx segment, its Sh
// segment (NF = 2), then row i + 16's, ...; a group's loads are issued
// before the group ahead of it is used, across segment and row
// boundaries, so a warp always has loads in flight.
template <int NB, int NF, typename DT, typename CT, typename Fetch,
          typename RowOf, typename Emit>
__device__ __forceinline__ void q8_rows_stream(const Q8In<CT>& in, int nrows,
                                               const RowOf& row_of,
                                               const Fetch& fx,
                                               const Fetch& fh,
                                               const Emit& emit) {
  constexpr int G = sizeof(CT) == 1 ? 8 : 4;   // chunks a lane loads at once
  int i = threadIdx.x / kWarp;
  if (i >= nrows) return;
  auto off_of = [&](int i, int part) {
    return (size_t)row_of(i) * (part ? in.kh : in.kx);
  };
  auto load = [&](int i, int part, int c0, Q8Group<CT, DT, G>& g) {
    if (part)
      q8x4_load(in.vh, in.ih, in.ihb, off_of(i, 1), in.kh, c0, g);
    else
      q8x4_load(in.vx, in.ix, in.ixb, off_of(i, 0), in.kx, c0, g);
  };
  Q8Group<CT, DT, G> cur, nxt;
  int part = 0, c0 = 0, carry = 0;
  load(i, part, c0, cur);
  Q8Consts<Emit> rc = q8_consts<NF>(in, emit, row_of(i)), rn = rc;
  uint32_t acc[NB] = {};
  float zx = 0.0f;
  for (;;) {
    const int nchunks = q8x4_chunks(off_of(i, part), part ? in.kh : in.kx);
    // the group after this one
    int i2 = i, part2 = part, c2 = c0 + G * kWarp;
    if (c2 >= nchunks) {
      c2 = 0;
      part2 = NF == 2 ? part ^ 1 : 0;
      if (NF == 1 || part) i2 += kQ8Warps;
    }
    const bool more = i2 < nrows;
    if (more) {
      load(i2, part2, c2, nxt);
      if (i2 != i) rn = q8_consts<NF>(in, emit, row_of(i2));
    }
    const Fetch f = part ? fh : fx;   // a copy: no address of either taken
    q8x4_consume<NB>(cur, 0, c0, nchunks, carry, f, acc);
    if (c2 == 0) {   // the segment is complete
      warp_sum(acc);
      const float dq = dequant(lane_value(acc), part ? rc.ch : rc.cx);
      if constexpr (NF == 1)
        emit(i, dq, 0.0f, rc.e);
      else if (part)
        emit(i, zx, dq, rc.e);
      zx = dq;
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0;
      carry = 0;
    }
    if (!more) break;
    if (i2 != i) rc = rn;
    cur = nxt;
    i = i2;
    part = part2;
    c0 = c2;
  }
}

// Stores column `col`'s staged vector (kW words) at its stage_pos.
template <int kW>
__device__ __forceinline__ void put_codes(uint32_t* s, int col, int shift,
                                          int slot_bits,
                                          const uint32_t (&v)[kW]) {
  uint32_t* dst = s + stage_pos(col, shift, slot_bits) * kW;
  if constexpr (kW == 1) {
    dst[0] = v[0];
  } else if constexpr (kW == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kW; i += 4)
      *reinterpret_cast<uint4*>(dst + i) =
          make_uint4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// Stages the tile's activation codes (qx's X columns, then, NF = 2, qh's
// H): column c's NB codes, zero past B, as one vector at stage_pos(c).
// Where the widths are multiples of 4 and the arrays start on
// 4 x sizeof(CT) bytes, a thread takes four columns with one load of
// four codes a batch row and turns the rows' words into the columns'
// vectors with byte permutes (transpose4x4 for int8); else one column
// with one load a batch row.
template <int NB, int NF, typename CT>
__device__ __forceinline__ void stage_codes(const Q8In<CT>& in, uint32_t* sx,
                                            uint32_t* sh) {
  constexpr int kW = StagedCodes<CT, NB>::kWords;
  constexpr int per = 4 / sizeof(CT), bits = 8 * sizeof(CT);
  constexpr uint32_t mask = (1u << bits) - 1;
  constexpr uintptr_t align = 4 * sizeof(CT) - 1;
  const int B = in.B;
  const bool four = (in.X & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(in.qx) & align) == 0 &&
                    (NF == 1 || ((in.H & 3) == 0 &&
                                 (reinterpret_cast<uintptr_t>(in.qh) &
                                  align) == 0));
  if (four) {
    const int nx4 = in.X / 4, n4 = nx4 + (NF == 2 ? in.H / 4 : 0);
    for (int c4 = threadIdx.x; c4 < n4; c4 += kQ8Threads) {
      const bool isx = c4 < nx4;
      const int col0 = 4 * (isx ? c4 : c4 - nx4);
      const CT* q = isx ? in.qx : in.qh;
      const int ld = isx ? in.X : in.H;
      Codes4<CT> raw[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {
          raw[b] = load_codes4(q + (size_t)b * ld + col0);
        } else {
#pragma unroll
          for (int w = 0; w < static_cast<int>(sizeof(CT)); ++w)
            raw[b].w[w] = 0;
        }
      }
      uint32_t v[4][kW];
      if constexpr (sizeof(CT) == 1) {
#pragma unroll
        for (int g = 0; g < kW; ++g) {
          uint32_t o[4];
          transpose4x4(raw[4 * g].w[0], raw[4 * g + 1].w[0],
                       raw[4 * g + 2].w[0], raw[4 * g + 3].w[0], o);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i][g] = o[i];
        }
      } else {
#pragma unroll
        for (int g = 0; g < kW; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i][g] = __byte_perm(raw[2 * g].w[i >> 1],
                                  raw[2 * g + 1].w[i >> 1],
                                  i & 1 ? 0x7632 : 0x5410);
      }
      const int shift = isx ? in.shift_x : in.shift_h;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        put_codes<kW>(isx ? sx : sh, col0 + i, shift, in.slot_bits, v[i]);
    }
    return;
  }
  const int n = in.X + (NF == 2 ? in.H : 0);
#pragma unroll 3
  for (int c = threadIdx.x; c < n; c += kQ8Threads) {
    const bool isx = c < in.X;
    const int col = isx ? c : c - in.X;
    const CT* q = isx ? in.qx : in.qh;
    const int ld = isx ? in.X : in.H;
    uint32_t v[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) v[i] = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B)
        v[b / per] |= (static_cast<uint32_t>(__ldg(q + b * ld + col)) & mask)
                      << (bits * (b % per));
    put_codes<kW>(isx ? sx : sh, col, isx ? in.shift_x : in.shift_h,
                  in.slot_bits, v);
  }
}

// The block's rows (local row i < nrows at packed row row_of(i), warp w
// taking w, w + 16, ...; kQ8Threads threads): stages the tile's codes
// (kStaged: stage_codes, in the kWords words a position after `smem`),
// then streams the rows when every family's deltas are int16, else takes
// them a row at a time; emit(i, zx, zh, row constants) after each row.
// NF = 1: the Sx family and qx alone. Does not end with a barrier.
template <int NB, bool kStaged, int NF = 2, typename CT, typename RowOf,
          typename Emit>
__device__ __forceinline__ void q8_rows_block(const Q8In<CT>& in,
                                              uint32_t* smem, int nrows,
                                              const RowOf& row_of,
                                              const Emit& emit) {
  using Staged = StagedCodes<CT, NB>;
  if constexpr (kStaged) {
    uint32_t* sx = smem;
    uint32_t* sh = sx + (size_t)in.xpad * Staged::kWords;
    stage_codes<NB, NF>(in, sx, sh);
    __syncthreads();
    const Staged fx{sx, in.shift_x, in.slot_bits};
    const Staged fh{sh, in.shift_h, in.slot_bits};
    if (in.ixb == 2 && (NF == 1 || in.ihb == 2))
      q8_rows_stream<NB, NF, int16_t>(in, nrows, row_of, fx, fh, emit);
    else
      q8_rows<NB, NF>(in, nrows, row_of, fx, fh, emit);
  } else {
    using Global = GlobalCodes<CT, NB>;
    q8_rows<NB, NF>(in, nrows, row_of, Global{in.qx, in.X, in.B},
                    Global{in.qh, in.H, in.B}, emit);
  }
}

// ------------------------------------------- row_dot's order, streamed
//
// row_dot_stream is the float row routine (the float steps and dual SpMV,
// B3 and B1, their delta forms, B5 and B4, and the single-family SpMVs B11
// and B6 run on it): the
// operand a packed entry multiplies (x or h, or the masked deltas) comes
// from shared memory, a column's NB floats staged once a block at
// stage_pos, or, for a family too wide to stage, from global memory
// through a gather policy; a warp's rows are one stream of G-chunk groups
// (32 entries a chunk) whose values and deltas are loaded before the group
// ahead of them is used, across family and row boundaries, so a warp
// always has loads in flight. The sums keep row_dot's order bit for bit:
// lane l takes entries l, l+32, ... of a row in order, one fmaf a batch
// row, then the xor butterfly, each family's sum apart. Columns are
// integers, so a group's G column scans run interleaved.

constexpr int kStreamThreads = 512;   // one block an SM (kernels/plan.py)

// The chunks of a group: 8 up to 8 accumulators (4, 10 and 16 were slower
// on the H100, 12 left no register spare: PERF.md), 4 at 16, whose
// accumulators take the registers.
template <int NB>
constexpr int kStreamChunks = NB >= 16 ? 4 : 8;

// Piece (j + r) % N of a lane's staged loads went to a[j * 4 .. j * 4 +
// 3]; afterwards piece j is there (compile-time indices only: a register
// array indexed at run time would live in local memory).
template <int N>
__device__ __forceinline__ void unrotate(float (&a)[4 * N], int r) {
  // shift by s where bit s of r is set: a[j] takes a[j - s], each cycle
  // j, j + s, ... moved in place through one temporary piece (a counted
  // loop over k, so that it unrolls and every index is a constant)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int s = 1 << k;
    if (s >= N) break;
    const bool on = r & s;
#pragma unroll
    for (int c = 0; c < s; ++c) {
      const int last = c + N - s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = a[last * 4 + i];
#pragma unroll
        for (int n = N / s - 1; n >= 1; --n) {
          const int m = c + n * s;
          a[m * 4 + i] = on ? a[(m - s) * 4 + i] : a[m * 4 + i];
        }
        a[c * 4 + i] = on ? t : a[c * 4 + i];
      }
    }
  }
}

// A family's activations staged in shared memory: column c's NB floats as
// NB/4 float4 pieces at stage_pos(c) * NB/4. A lane's j-th load of a
// column takes piece (j + rot) % (NB/4), rot its lane index, so the lanes
// of one phase of a 16-byte load spread over all eight 16-byte slots of a
// bank row, not the 8 / (NB/4) that one piece of every column falls on
// (random columns: about two lanes a slot, against three to five without
// the rotation; tests/test_torch_plan.py). acc is kept in that rotated
// order and `unrotate`d once a row.
template <int NB>
struct StagedF32 {
  static constexpr int kNQ = NB / 4;
  const float4* s;
  int shift, slot_bits;
  __device__ __forceinline__ void mac(float (&acc)[NB], float v, int col,
                                      int rot) const {
    const float4* p = s + stage_pos(col, shift, slot_bits) * kNQ;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const float4 t = p[(j + rot) & (kNQ - 1)];
      acc[j * 4] = fmaf(v, t.x, acc[j * 4]);
      acc[j * 4 + 1] = fmaf(v, t.y, acc[j * 4 + 1]);
      acc[j * 4 + 2] = fmaf(v, t.z, acc[j * 4 + 2]);
      acc[j * 4 + 3] = fmaf(v, t.w, acc[j * 4 + 3]);
    }
  }
};

// A family gathered from global memory by a gather policy (F32Act for x
// and h, DeltaAct for the masked deltas), in row_dot's order.
template <int NB, typename Op>
struct Gathered {
  Op op;
  int B;
  __device__ __forceinline__ void mac(float (&acc)[NB], float v, int col,
                                      int) const {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B) acc[b] = op.mac(acc[b], v, b, col);
  }
};

// The operand of a streamed family's entries, as a policy over its (B, n)
// arrays: the activations themselves (F32Src, x or h: the float steps) or
// the masked deltas (DeltaSrc, __fmul_rn(d, f): the float delta steps).
// Each gives the gather policy that reads it (Gather, `gather(ld)`),
// element i (`at`), elements 4 i4 .. 4 i4 + 3 (`at4`, 16-byte loads, when
// `aligned`; zeros when not `live`), and moves itself to the block's batch
// tile (`tile`).
struct F32Src {
  using Gather = F32Act;
  const float* a;
  __device__ __forceinline__ F32Act gather(int ld) const { return {a, ld}; }
  __device__ __forceinline__ bool aligned() const {
    return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  }
  __device__ __forceinline__ float at(size_t i) const { return __ldg(a + i); }
  __device__ __forceinline__ float4 at4(bool live, size_t i4) const {
    return live ? __ldg(reinterpret_cast<const float4*>(a) + i4)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ __forceinline__ void tile(int ld) { a = tile_rows(a, ld); }
};

struct DeltaSrc {
  using Gather = DeltaAct;
  const float* d;
  const float* f;
  __device__ __forceinline__ DeltaAct gather(int ld) const {
    return {d, f, ld};
  }
  __device__ __forceinline__ bool aligned() const {
    return ((reinterpret_cast<uintptr_t>(d) |
             reinterpret_cast<uintptr_t>(f)) & 15) == 0;
  }
  __device__ __forceinline__ float at(size_t i) const {
    return __fmul_rn(__ldg(d + i), __ldg(f + i));
  }
  // the loads under the branch, the products after it (zeros when not
  // live): forming them inside it compiled to a slower staging on the H100
  __device__ __forceinline__ float4 at4(bool live, size_t i4) const {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), m = a;
    if (live) {
      a = __ldg(reinterpret_cast<const float4*>(d) + i4);
      m = __ldg(reinterpret_cast<const float4*>(f) + i4);
    }
    return make_float4(__fmul_rn(a.x, m.x), __fmul_rn(a.y, m.y),
                       __fmul_rn(a.z, m.z), __fmul_rn(a.w, m.w));
  }
  __device__ __forceinline__ void tile(int ld) {
    d = tile_rows(d, ld);
    f = tile_rows(f, ld);
  }
};

// Stages columns [0, n) of a family's operand (B, n): column c's NB values,
// the gather policy's operand bit for bit (zero past B), at stage_pos(c).
// Up to 8 batch rows a thread takes four columns with one 16-byte load a
// row (of each array the operand reads) where the rows allow it (n a
// multiple of 4, the arrays 16-byte aligned), else one column (16 rows of
// four columns would not leave the registers for it).
template <int NB, typename Src>
__device__ __forceinline__ void stage_family(float4* s, const Src& src,
                                             int n, int B, int shift,
                                             int slot_bits) {
  constexpr int NQ = NB / 4;
  if (NB <= 8 && (n & 3) == 0 && src.aligned()) {
    const int n4 = n / 4;
    for (int c4 = threadIdx.x; c4 < n4; c4 += blockDim.x) {
      float v[4][NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 a = src.at4(b < B, (size_t)b * n4 + c4);
        v[0][b] = a.x;
        v[1][b] = a.y;
        v[2][b] = a.z;
        v[3][b] = a.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* dst = s + (size_t)stage_pos(4 * c4 + i, shift, slot_bits) * NQ;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          dst[q] = make_float4(v[i][4 * q], v[i][4 * q + 1], v[i][4 * q + 2],
                               v[i][4 * q + 3]);
      }
    }
    return;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      v[b] = b < B ? src.at((size_t)b * n + c) : 0.0f;
    float4* dst = s + (size_t)stage_pos(c, shift, slot_bits) * NQ;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                           v[4 * q + 3]);
  }
}

// One packed float family of a row stream: values, deltas (dbytes wide),
// entries a row, and whether its activations are fewer than 65536 columns
// (f32_columns then scans two chunks in one word).
struct F32Family {
  const float* vals;
  const void* deltas;
  int dbytes, K, narrow;
};

// A lane's share of G chunks of a packed float row: entry 32 c + lane of
// chunk c's value and delta (0 past K).
template <int G>
struct F32Group {
  float v[G];
  int d[G];
};

template <typename DT, int G>
__device__ __forceinline__ void f32_load_t(const float* __restrict__ vals,
                                           const DT* __restrict__ deltas,
                                           int K, int c0, F32Group<G>& g) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int k = (c0 + u) * kWarp + lane;
    const bool live = k < K;
    g.v[u] = live ? __ldg(vals + k) : 0.0f;
    g.d[u] = live ? static_cast<int>(__ldg(deltas + k)) : 0;
  }
}

// Loads chunks c0 .. c0 + G - 1 of the row at element `off` of family f.
template <int G>
__device__ __forceinline__ void f32_load(const F32Family& f, size_t off,
                                         int c0, F32Group<G>& g) {
  const float* v = f.vals + off;
  if (f.dbytes == 2)
    f32_load_t(v, static_cast<const int16_t*>(f.deltas) + off, f.K, c0, g);
  else if (f.dbytes == 1)
    f32_load_t(v, static_cast<const int8_t*>(f.deltas) + off, f.K, c0, g);
  else
    f32_load_t(v, static_cast<const int32_t*>(f.deltas) + off, f.K, c0, g);
}

// The columns of a group's chunks: each chunk's inclusive warp scan of its
// deltas (0 past K) plus the carry of the row's chunks before it. The G
// scans are independent and interleave; for a narrow family (fewer than
// 65536 columns) chunks 2q and 2q + 1 share one 32-bit word, 2q in the low
// half: a chunk's partial sums are column differences below 65536 and, a
// packing's deltas being non-negative, never carry across the halves.
template <int G>
__device__ __forceinline__ void f32_columns(const F32Group<G>& g, bool narrow,
                                            int& carry, int (&col)[G]) {
  static_assert(G % 2 == 0, "chunks scan in pairs");
  const int lane = threadIdx.x & (kWarp - 1);
  if (narrow) {
    uint32_t s[G / 2];
#pragma unroll
    for (int q = 0; q < G / 2; ++q)
      s[q] = static_cast<uint32_t>(g.d[2 * q]) |
             static_cast<uint32_t>(g.d[2 * q + 1]) << 16;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int o = 1 << t;
#pragma unroll
      for (int q = 0; q < G / 2; ++q) {
        const uint32_t up = __shfl_up_sync(0xffffffffu, s[q], o);
        if (lane >= o) s[q] += up;
      }
    }
#pragma unroll
    for (int q = 0; q < G / 2; ++q) {
      const uint32_t tot = __shfl_sync(0xffffffffu, s[q], kWarp - 1);
      col[2 * q] = carry + static_cast<int>(s[q] & 0xffffu);
      carry += static_cast<int>(tot & 0xffffu);
      col[2 * q + 1] = carry + static_cast<int>(s[q] >> 16);
      carry += static_cast<int>(tot >> 16);
    }
  } else {
#pragma unroll
    for (int u = 0; u < G; ++u) col[u] = g.d[u];
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int o = 1 << t;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int up = __shfl_up_sync(0xffffffffu, col[u], o);
        if (lane >= o) col[u] += up;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int tot = __shfl_sync(0xffffffffu, col[u], kWarp - 1);
      col[u] += carry;
      carry += tot;
    }
  }
}

// acc[b] += the products of g's chunks (those below K) with the
// activations `act` holds, in row_dot's order; `carry` is the row's column
// before chunk c0 (0 at the row's start). A group past K adds nothing.
template <int NB, int G, typename Act>
__device__ __forceinline__ void f32_consume(const F32Group<G>& g, int c0,
                                            int K, bool narrow, int& carry,
                                            const Act& act, int rot,
                                            float (&acc)[NB]) {
  if (c0 * kWarp >= K) return;   // warp-uniform
  const int lane = threadIdx.x & (kWarp - 1);
  int col[G];
  f32_columns(g, narrow, carry, col);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int k0 = (c0 + u) * kWarp;
    if (k0 >= K) break;   // warp-uniform
    if (k0 + lane < K) act.mac(acc, g.v[u], col[u], rot);
  }
}

// Where a family's activations come from: staged (then `staged`) or
// gathered from global memory (`gather`); a uniform branch a group.
template <int NB, typename Gather>
struct StreamActs {
  StagedF32<NB> staged;
  Gather gather;
  int is_staged;
};

// A warp's rows i = first, first + step, ... < nrows (packed row
// row_of(i) of both families): each row's Sx segment, then its Sh
// segment, as one stream of G-chunk groups (NF = 1: the Sx segments
// alone; fh and ah are not read). `cur` holds the first group (row
// `first`'s Sx chunks 0 .. G-1), loaded by the caller. After each row
// emit(i, ax, ah), lane b holding batch row b's two sums (NF = 1: ah 0).
template <int NB, int G, int NF, typename Acts, typename RowOf, typename Emit>
__device__ __forceinline__ void row_dot_stream(
    const F32Family& fx, const F32Family& fh, const Acts& ax,
    const Acts& ah, int first, int nrows, int step, const RowOf& row_of,
    F32Group<G>& cur, const Emit& emit) {
  int i = first;
  if (i >= nrows) return;
  const int rot = threadIdx.x & (NB / 4 - 1);
  int part = 0, c0 = 0, carry = 0;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
  float sx = 0.0f;
  F32Group<G> nxt;
  for (;;) {
    const F32Family f = part ? fh : fx;   // copies: no address taken
    const int nchunks = (f.K + kWarp - 1) / kWarp;
    // the group after this one
    int i2 = i, part2 = part, c2 = c0 + G;
    if (c2 >= nchunks) {
      c2 = 0;
      part2 = NF == 2 ? part ^ 1 : 0;
      if (NF == 1 || part) i2 += step;
    }
    const bool more = i2 < nrows;
    if (more) {
      const F32Family f2 = part2 ? fh : fx;
      f32_load(f2, (size_t)row_of(i2) * f2.K, c2, nxt);
    }
    const Acts a = part ? ah : ax;
    if (a.is_staged)
      f32_consume<NB>(cur, c0, f.K, f.narrow, carry, a.staged, rot, acc);
    else
      f32_consume<NB>(cur, c0, f.K, f.narrow, carry, a.gather, 0, acc);
    if (c2 == 0) {   // the segment is complete
      if (a.is_staged) unrotate<NB / 4>(acc, rot);
      warp_sum(acc);
      const float v = lane_value(acc);
      if constexpr (NF == 1)
        emit(i, v, 0.0f);
      else if (part)
        emit(i, sx, v);
      sx = v;
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
      carry = 0;
    }
    if (!more) break;
    cur = nxt;
    i = i2;
    part = part2;
    c0 = c2;
  }
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

// A staged float kernel's inputs: the two packed families, the operand of
// each (Src: x (B, X) and h (B, H), or the masked deltas), and the staged
// layout of kernels/plan.py::stream_plan (which families are staged,
// stage_pos's shifts and slot bits, the padded column counts).
template <typename Src>
struct StreamIn {
  const float* vx;
  const void* ix;
  int ixb, kx;
  Src ax;
  int X;
  const float* vh;
  const void* ih;
  int ihb, kh;
  Src ah;
  int H;
  int B;
  int stage_x, stage_h, shift_x, shift_h, slot_bits, xpad, hpad;
};

// The operands moved to the block's batch tile (blockIdx.y); NF = 1: x
// alone.
template <int NF = 2, typename Src>
__device__ __forceinline__ void tile_stream_in(StreamIn<Src>& in) {
  in.ax.tile(in.X);
  if constexpr (NF == 2) in.ah.tile(in.H);
  in.B = tile_batch(in.B);
}

// Float4s of dynamic shared memory the staged families take.
template <typename Src>
__device__ __forceinline__ size_t staged_float4s(const StreamIn<Src>& in,
                                                 int NB) {
  return ((in.stage_x ? (size_t)in.xpad : 0) +
          (in.stage_h ? (size_t)in.hpad : 0)) * (NB / 4);
}

// The gate-stage sums of a staged float kernel over a block's rows: issues
// each warp's first loads, stages the operand of each family the plan
// stages, then runs the warps' rows (local row i < nrows at packed row
// row_of(i), warp w taking w, w + 16, ...) through row_dot_stream and
// leaves row i's sums Sx@ax in zx[i * NB + b] and Sh@ah in zh[i * NB + b]
// for b < B. NF = 1: the single-family form (B11 and B6), Sx@ax alone
// (in's h family is not read, zh not written). Ends with a barrier.
template <int NB, int NF = 2, typename Src, typename RowOf>
__device__ __forceinline__ void stream_rows_block(const StreamIn<Src>& in,
                                                  float4* smem, int nrows,
                                                  const RowOf& row_of,
                                                  float* zx, float* zh) {
  constexpr int G = kStreamChunks<NB>;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  float4* sx = smem;
  float4* sh = sx + (in.stage_x ? (size_t)in.xpad * (NB / 4) : 0);
  const F32Family fx{in.vx, in.ix, in.ixb, in.kx, in.X < 65536};
  const F32Family fh{in.vh, in.ih, in.ihb, in.kh, in.H < 65536};
  F32Group<G> cur;
  if (warp < nrows) f32_load(fx, (size_t)row_of(warp) * in.kx, 0, cur);
  if (in.stage_x)
    stage_family<NB>(sx, in.ax, in.X, in.B, in.shift_x, in.slot_bits);
  if (NF == 2 && in.stage_h)
    stage_family<NB>(sh, in.ah, in.H, in.B, in.shift_h, in.slot_bits);
  __syncthreads();
  using Acts = StreamActs<NB, Gathered<NB, typename Src::Gather>>;
  const Acts ax{StagedF32<NB>{sx, in.shift_x, in.slot_bits},
                {in.ax.gather(in.X), in.B}, in.stage_x};
  const Acts ah{StagedF32<NB>{sh, in.shift_h, in.slot_bits},
                {in.ah.gather(in.H), in.B}, in.stage_h};
  const int B = in.B;
  row_dot_stream<NB, G, NF>(
      fx, fh, ax, ah, warp, nrows, nwarps, row_of, cur,
      [&](int i, float a, float h) {
        const int lane = threadIdx.x & (kWarp - 1);
        if (lane < B) {
          zx[i * NB + lane] = a;
          if constexpr (NF == 2) zh[i * NB + lane] = h;
        }
      });
  __syncthreads();
}

// The single-family SpMV y = S@operand over a block's contiguous rows:
// B11 rb_spmv (F32Src: x) and B6 delta_rb_spmv (DeltaSrc: d·f), the
// operand's family alone in `in` (its h family unused).
template <typename Src>
struct SingleArgs {
  StreamIn<Src> in;
  float* y;           // (B, R)
  int R, rows;        // rows of the output; rows a block
};

// A single-family kernel's body: stream_rows_block's NF = 1 form over the
// block's rows r0 .. r0 + rows - 1, then y written through shared memory
// (after the staged operand in `smem`) so that each batch row's outputs
// leave coalesced.
template <int NB, bool kTiled, typename Src>
__device__ __forceinline__ void single_rows_block(SingleArgs<Src> a,
                                                  float4* smem) {
  const int R = a.R;
  if constexpr (kTiled) {
    tile_stream_in<1>(a.in);
    a.y = tile_rows(a.y, R);
  }
  float* ys = reinterpret_cast<float*>(smem + staged_float4s(a.in, NB));
  const int B = a.in.B, r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, R - r0);
  stream_rows_block<NB, 1>(a.in, smem, nrows, [&](int i) { return r0 + i; },
                           ys, nullptr);
  for (int t = threadIdx.x; t < nrows * B; t += kStreamThreads) {
    const int b = t / nrows, i = t % nrows;
    a.y[(size_t)b * R + r0 + i] = ys[i * NB + b];
  }
}

// Host side: let `kern` take up to the card's opt-in shared memory a block
// (above the default 48 KB), set once per kernel.
inline cudaError_t allow_smem(const void* kern) {
  static std::mutex mu;
  static std::unordered_map<const void*, cudaError_t> done;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = done.find(kern);
  if (it != done.end()) return it->second;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  done[kern] = e;
  return e;
}

// Host side: out[0..3] = registers a thread, local (spill) bytes a
// thread, static shared bytes, and the blocks of `threads` an SM holds
// with `smem` bytes of dynamic shared memory.
inline cudaError_t kernel_info(const void* kern, int threads, int smem,
                               int* out) {
  cudaError_t e = allow_smem(kern);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kern, threads,
                                                       smem);
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
