// Attention for the dense-transformer serving path (the Pallas bodies cast
// to float32 before both products; so do these, and p keeps float32
// accuracy through P.V):
//  - decode_attention (B14): one query per sequence against its KV cache,
//    the G = Hq / Hkv q heads of a kv group sharing one K/V stream.
//    Replaces src/repro/kernels/decode_attention.py::decode_attention.
//  - flash_attention (B15): blocked causal / windowed GQA attention
//    forward, q rows right-aligned to the kv end. Replaces
//    src/repro/kernels/flash_attention.py::flash_attention. bf16 operands
//    run on the tensor cores (flash_tc_kernel); float32 operands keep a
//    SIMT body (flash_attention_kernel).
//
// All read q, k, v (and B15 writes o) through strides with a unit last
// dim, so the model's (B, S, H, D) cache and projections are read in place:
// no head-major copy, and no GQA expansion of the cache. Masked scores
// weigh exactly 0 (p = s > NEG/2 ? exp(s - m) : 0, so a fully dead tile
// cannot poison l), and out = acc / max(l, 1e-30): a row with no live key
// gives 0, as the Pallas kernels do.
//
// decode_attention (decode_cluster_kernel). Bound: bytes (each live K and
// V row is read once and used for 2G flops per element): at the
// qwen3-0.6b serve shape (B=8, 8 kv heads of 128, bf16, ~544 live rows)
// 17.8 MB, 5.3 us at 3.35 TB/s. The one-warp-a-stream kernel it replaces
// (0.0274 ms) kept 8 bytes a lane in flight, used each load before the
// next went out, waited for lengths[b] and then the slice bounds before
// its first K byte, and merged the slices in a second launch through a
// workspace. Here:
//  - A block owns slice `split` of a (b, kv head) pair's live keys and GM
//    of its q heads; its 16 half-warps are key streams (stream s takes
//    keys s, s + 16, ...), lane l of a half-warp holds elements
//    [l D/16, (l+1) D/16) of q, K, V and acc (16 bytes at bf16 D = 128).
//  - As soon as lengths[b] is read, each thread issues cp.async copies of
//    its own pieces of the slice's K and V rows into a ring of `stages`
//    stages of kDecU keys a stream (about 32 KB in flight a block, one
//    block an SM), then loads q. A thread reads back only the pieces it
//    copied, so the ring needs no barrier; a slot is refilled after the
//    thread has used it.
//  - The nsplit slices of a pair are one thread-block cluster. Each block
//    merges its two streams a warp and then its warps in order and stores
//    its (m, l, acc) into rank 0's shared memory (distributed shared
//    memory: stores, no remote loads); after one cluster.sync() rank 0
//    merges the slices in rank (slice) order and writes the outputs. One
//    launch, no workspace, no atomics: deterministic, and nothing to
//    reset between calls. (Every rank reading every partial through
//    distributed shared memory, between two cluster barriers, cost 2-5 us
//    more at each doubling of the cluster, PERF.md.)
// Keys at or past lengths[b] (or before len - window) are never copied;
// the stale slots of a slice's last tile weigh exactly 0. kernels/plan.py
// ::decode_plan picks nsplit, the stages and the shared memory.
//
// flash_attention, bf16 (flash_tc_kernel). Bound at the qwen3-0.6b serve
// shape (B=8, 16 q / 8 kv heads of 128, causal S=512): q, k and v read
// once and o written once are 50.3 MB, 15.02 us at 3.35 TB/s; the tensor
// cores' work, Q.K^T once and P.V three times over the causal half (17.2
// GFLOP), takes 17.4 us at 989 TFLOP/s, so the operations bind. The SIMT
// body it replaces in bf16 (0.514 ms, 3% of the byte bound) was held back
// by four things; what this design does about each:
//  1. float32 FMAs on the SIMT units: both products are wgmma (bf16 in,
//     float32 accumulators). S = Q K^T reads Q and K from shared memory,
//     K-major (D is contiguous); scale multiplies the float32 accumulator.
//     P.V reads P from registers (the S accumulator's fragments are the A
//     operand's, so no shared-memory round trip) and V from shared
//     memory, MN-major. p is split exactly into three bf16 terms (each
//     the top 8 significant bits of what is left, split3), each its own
//     wgmma into one float32 O, so P.V sees p's float32 value. Two rounded
//     terms leave 2^-16 of p, which puts outputs near zero (after
//     cancellation) past the one-bf16-ulp gate (tests/test_torch_attention
//     .py emulates both).
//  2. operands widened to float32 in shared memory (117.8 KB at D=128):
//     Q, K and V stay bf16 in the 128-byte-swizzled layout wgmma reads
//     (wgmma.cuh), 32 + 96 KB at D=128 with three stages.
//  3. each K/V tile loaded once per q head: a block owns (b, kv head, 64
//     positions) and WG consumer warpgroups, one per q head of the group
//     (WG = 2 when G is even, else 1), so a K/V tile is read once per two
//     q heads at G = 2.
//  4. synchronous loads between two __syncthreads: a producer warpgroup
//     fills a ring of NS stages (K and V tiles of BK keys) with 16-byte
//     cp.async copies that arrive on an mbarrier when they land; consumers
//     release a stage on a second mbarrier once their P.V has read it, so
//     loads run up to NS tiles ahead of the tensor cores.
// The two consumer warpgroups take turns at the tensor cores (named
// barriers), so one's softmax and split run while the other's products
// do. A warpgroup issues P.V of the previous tile, waits, then S of the
// next: with both in flight at once (O, S and the three p terms, 144
// registers a thread) ptxas serializes every wgmma at the 168 registers a
// thread that three warps per SM sub-partition leave.
// Key tiles: BK = 64, or 32 at D = 256, where O alone takes 128 registers
// a thread; NS = 3 stages fit shared memory at every D (192 KB at D =
// 192). At D = 192 with two consumer warpgroups ptxas still serializes
// the products (O is 96 registers): right, slower, and on no serve path
// yet. At D = 256 (recurrentgemma-9b's local attention) two warpgroups
// spill, so a block has one (tc_pairs): 196 registers, no spill, 129 KB
// of shared memory, and each K/V tile is loaded once per q head (from L2
// after the first). D = 32 is padded to one 64-column atom of zeros. Only the
// diagonal, window-edge and ragged tiles are masked; tiles the masks leave
// dead are never loaded (the Pallas kernel's block skip). Blocks run
// heaviest first: the q tiles with the most live keys take the lowest
// block indices, so the causal tail does not leave SMs idle. Ragged Sq
// and Sk need no padding (copies past the end zero-fill). No atomics:
// deterministic.
//
// flash_attention, float32 (flash_attention_kernel). Held to 1e-5 of the
// plain version, which neither TF32 (10 mantissa bits) nor a bf16 split of
// float32 Q, K and V can meet, so float32 stays on the SIMT units: a block
// owns one (b, q head, 64-row q tile), Q, the K and V tiles and P^T sit in
// shared memory as float32, each of 256 threads owns a 4 x 4 block of S and
// 4 rows x D/16 columns of the output. No serve path on the card runs
// attention in float32 at full width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements at p into float registers, in the widest loads
// (16, 8, 4 bytes or one element) that divide the N elements' bytes: a
// lane's row of E = D/32 elements starts at a multiple of its own size
// (24 bytes for float32 at D=192, 12 for bf16), and the rows at 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kW = kBytes % 16 == 0 ? 16
                     : kBytes % 8 == 0 ? 8
                     : kBytes % 4 == 0 ? 4
                                       : (int)sizeof(T);
  constexpr int kPer = kW / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < kBytes / kW; ++i) {
    if constexpr (kW == 16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f(e[j]);
    } else if constexpr (kW == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f(e[j]);
    } else if constexpr (kW == 4) {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f(e[j]);
    } else {
      out[i] = to_f(__ldg(p + i));
    }
  }
}

// ------------------------------------------------------- decode attention

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kKeyLanes = 16;                      // a key's lanes: a half-warp
constexpr int kStreams = kDecThreads / kKeyLanes;  // key streams a block
constexpr int kDecU = 2;                           // keys a stream takes a stage
constexpr int kMaxStages = 8;                      // cp_async_wait_pending's
constexpr int kMaxCluster = 8;                     // the portable cluster size

// One lane's share of a K or V row: E = D / 16 elements, copied in pieces
// of kChunk bytes (16 where the share allows; 8 at bf16 D = 192, 4 at bf16
// D = 32). kStage: a stage's bytes a block (16 streams x kDecU keys x K, V).
template <typename T, int D>
struct DecodeLane {
  static constexpr int E = D / kKeyLanes;
  static constexpr int kBytes = E * (int)sizeof(T);
  static constexpr int kChunk = kBytes % 16 == 0 ? 16 : kBytes % 8 == 0 ? 8 : 4;
  static constexpr int kChunks = kBytes / kChunk;
  static constexpr int kPer = kChunk / (int)sizeof(T);   // elements a piece
  static constexpr int kStage = kDecU * 2 * kBytes * kDecThreads;
};

// Dynamic shared memory of a block: the ring of `stages` stages, then
// (m, l, acc) of GM heads for each warp, then one for each rank of the
// cluster, which rank 0 gathers (kernels/plan.py::decode_plan computes the
// same).
template <typename T, int D, int GM>
constexpr int decode_smem(int stages) {
  return stages * DecodeLane<T, D>::kStage +
         (int)sizeof(float) * (kDecWarps + kMaxCluster) * GM * (D + 2);
}

// N bytes (4, 8 or 16) from global `src` to shared `dst`, asynchronously
template <int N>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most n of this thread's cp.async groups are pending; n above 7
// waits for 7 (sooner than asked, so as safe)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
#define BRDS_WAIT(N) \
  case N:            \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break
  switch (n) {
    BRDS_WAIT(0); BRDS_WAIT(1); BRDS_WAIT(2); BRDS_WAIT(3);
    BRDS_WAIT(4); BRDS_WAIT(5); BRDS_WAIT(6);
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
#undef BRDS_WAIT
}

// One piece of kChunk bytes in shared memory into float registers
template <typename T, int N>
__device__ __forceinline__ void smem_piece(const unsigned char* p,
                                           float (&out)[N / sizeof(T)]) {
  constexpr int n = N / (int)sizeof(T);
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < n; ++j) out[j] = to_f(e[j]);
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < n; ++j) out[j] = to_f(e[j]);
  } else {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < n; ++j) out[j] = to_f(e[j]);
  }
}

// A cluster barrier in two halves: arrive (relaxed: orders nothing) and
// wait. Arriving at the start and waiting before the first store into
// another block's shared memory guarantees that block has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kKeyLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
struct DecodeArgs {
  const T* q;
  long long sqb, sqh;
  const T* k;
  long long skb, skh, sks;
  const T* v;
  long long svb, svh, svs;
  const int* lengths;
  const int* start;   // (B,) each row's first live key, or null
  T* out;
  float* lse;   // (B, Hq) log-sum-exp of the scaled scores, or null
  int S, Hq, Hkv, window, nsplit, stages, fixed_len;
  float scale;
};

// m + log(l), the row's log-sum-exp; -inf where no key was live (l = 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

// Block (split, b * Hkv + kv head, q-head group): slice `split` of the
// (b, kv head) pair's live keys, GM of its q heads. The nsplit blocks of a
// pair are one cluster (rank = split).
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kDecThreads, 2)
decode_cluster_kernel(const DecodeArgs<T> a) {
  using L = DecodeLane<T, D>;
  constexpr int E = L::E;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int stream = tid / kKeyLanes, kl = tid % kKeyLanes;
  const int split = blockIdx.x;
  const int b = blockIdx.y / a.Hkv, kh = blockIdx.y % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int g0 = blockIdx.z * GM;
  const int gn = min(GM, G - g0);

  extern __shared__ __align__(16) unsigned char dec_smem[];
  const uint32_t ring = hopper::smem_addr(dec_smem);
  constexpr int kParts = kDecWarps + kMaxCluster;   // warps, then ranks
  float* sm_m = reinterpret_cast<float*>(dec_smem + a.stages * L::kStage);
  float* sm_l = sm_m + kParts * GM;     // [kParts][GM]
  float* sm_acc = sm_l + kParts * GM;   // [kParts][GM][D]

  if (a.nsplit > 1) cluster_arrive_relaxed();
  // the slice: one read of lengths[b], then every copy the ring holds
  const int len = min(max(a.fixed_len >= 0 ? a.fixed_len : a.lengths[b], 0),
                      a.S);
  int lo = a.window > 0 ? max(0, len - a.window) : 0;
  // a split-KV segment's first key of the window: past len, no key
  if (a.start != nullptr) lo = min(max(lo, a.start[b]), len);
  const int chunk = (len - lo + a.nsplit - 1) / a.nsplit;
  const int s0 = lo + split * chunk;
  const int s1 = min(len, s0 + chunk);
  // stream s's keys: s0 + s + kStreams * i for i < keys(s); a warp's
  // even stream has the most, and both of its streams run its tiles (the
  // shuffles need the whole warp)
  auto keys = [&](int s) {
    return s1 - s0 > s ? (s1 - s0 - s + kStreams - 1) / kStreams : 0;
  };
  const int nk = keys(stream);
  const int ntiles = (keys(stream & ~1) + kDecU - 1) / kDecU;
  const T* kb = a.k + b * a.skb + kh * a.skh + kl * E;
  const T* vb = a.v + b * a.svb + kh * a.svh + kl * E;
  // piece c of key u (K or V) of ring slot `slot`, this thread's own:
  // consecutive threads on consecutive pieces, and a thread reads only
  // what it copied (no barrier between copy and use)
  auto piece = [&](int slot, int u, int kv, int c) {
    return ((((slot * kDecU + u) * 2 + kv) * L::kChunks + c) * kDecThreads +
            tid) * L::kChunk;
  };
  auto issue = [&](int t) {   // tile t (kDecU keys) into slot t % stages
    if (t < ntiles) {
      const int slot = t % a.stages;
#pragma unroll
      for (int u = 0; u < kDecU; ++u) {
        const int i = t * kDecU + u;
        if (i < nk) {
          const long long key = s0 + stream + kStreams * i;
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            cp_async_n<L::kChunk>(ring + piece(slot, u, 0, c),
                                  kb + key * a.sks + c * L::kPer);
            cp_async_n<L::kChunk>(ring + piece(slot, u, 1, c),
                                  vb + key * a.svs + c * L::kPer);
          }
        }
      }
    }
    cp_async_commit();   // one group a tile, empty past the last
  };
  for (int t = 0; t < a.stages; ++t) issue(t);

  float qr[GM][E], m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < gn) {
      load_row<T, E>(a.q + b * a.sqb + (kh * G + g0 + g) * a.sqh + kl * E,
                     qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= a.scale;
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    // tile t's group is done once at most stages - 1 later ones pend
    cp_async_wait_pending(a.stages - 1);
    const int slot = t % a.stages;
    float kr[kDecU][E], vr[kDecU][E], sc[kDecU][GM];
#pragma unroll
    for (int u = 0; u < kDecU; ++u) {
      const bool live = t * kDecU + u < nk;
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        float pk[L::kPer], pv[L::kPer];
        smem_piece<T, L::kChunk>(dec_smem + piece(slot, u, 0, c), pk);
        smem_piece<T, L::kChunk>(dec_smem + piece(slot, u, 1, c), pv);
#pragma unroll
        for (int j = 0; j < L::kPer; ++j) {
          // a key past the slice was never copied: its bytes are stale
          kr[u][c * L::kPer + j] = live ? pk[j] : 0.f;
          vr[u][c * L::kPer + j] = live ? pv[j] : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kr[u][e], d);
        d = half_warp_sum(d);
        sc[u][g] = live ? d : kNeg;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kDecU; ++u) mx = fmaxf(mx, sc[u][g]);
      const float alpha = expf(m[g] - mx);
      float p[kDecU], ps = 0.f;
#pragma unroll
      for (int u = 0; u < kDecU; ++u) {
        p[u] = sc[u][g] > 0.5f * kNeg ? expf(sc[u][g] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kDecU; ++u) x = fmaf(p[u], vr[u][e], x);
        acc[g][e] = x;
      }
      m[g] = mx;
    }
    issue(t + a.stages);   // into the slot just read
  }

  // the warp's two streams (half 0's first), then the warps in order
  const bool first = lane < kKeyLanes;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], kKeyLanes);
    const float lo2 = __shfl_xor_sync(0xffffffffu, l[g], kKeyLanes);
    const float M = fmaxf(m[g], mo);
    const float cs = expf(m[g] - M), co = expf(mo - M);
    const float ca = first ? cs : co, cb = first ? co : cs;
    const float Lw = ca * (first ? l[g] : lo2) + cb * (first ? lo2 : l[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], kKeyLanes);
      const float A = ca * (first ? acc[g][e] : ao) +
                      cb * (first ? ao : acc[g][e]);
      if (first) sm_acc[(warp * GM + g) * D + kl * E + e] = A;
    }
    if (lane == 0) {
      sm_m[warp * GM + g] = M;
      sm_l[warp * GM + g] = Lw;
    }
  }
  __syncthreads();
  // the block's partial, merged over its warps in order: written out when
  // the pair has one slice, else stored into rank 0's shared memory at
  // this rank's slot (distributed shared memory; a store, no round trip)
  const size_t row0 = (size_t)b * a.Hq + kh * G + g0;   // (b, first q head)
  cg::cluster_group cluster = cg::this_cluster();
  float* gm_m = sm_m;
  float* gm_l = sm_l;
  float* gm_acc = sm_acc;
  if (a.nsplit > 1) {
    cluster_wait();   // every block of the cluster has started
    gm_m = cluster.map_shared_rank(sm_m, 0);
    gm_l = cluster.map_shared_rank(sm_l, 0);
    gm_acc = cluster.map_shared_rank(sm_acc, 0);
  }
  const int slot = (kDecWarps + split) * GM;
  for (int i = tid; i < gn * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float M = kNeg;
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sm_m[w * GM + g]);
    float Ls = 0.f, A = 0.f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = expf(sm_m[w * GM + g] - M);
      Ls += c * sm_l[w * GM + g];
      A += c * sm_acc[(w * GM + g) * D + d];
    }
    if (a.nsplit == 1) {
      a.out[(row0 + g) * D + d] = from_f<T>(A / fmaxf(Ls, 1e-30f));
      if (a.lse != nullptr && d == 0) a.lse[row0 + g] = row_lse(M, Ls);
    } else {
      gm_acc[(slot + g) * D + d] = A;
      if (d == 0) {
        gm_m[slot + g] = M;
        gm_l[slot + g] = Ls;
      }
    }
  }
  if (a.nsplit == 1) return;
  // one cluster barrier (release / acquire): rank 0 then holds every
  // slice's partial and merges them in rank (slice) order; the other ranks
  // leave (nothing reads their shared memory)
  cluster.sync();
  if (split != 0) return;
  for (int i = tid; i < gn * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float M = kNeg;
    for (int r = 0; r < a.nsplit; ++r)
      M = fmaxf(M, sm_m[(kDecWarps + r) * GM + g]);
    float Ls = 0.f, A = 0.f;
    for (int r = 0; r < a.nsplit; ++r) {
      const int p = (kDecWarps + r) * GM + g;
      const float c = expf(sm_m[p] - M);
      Ls += c * sm_l[p];
      A += c * sm_acc[p * D + d];
    }
    a.out[(row0 + g) * D + d] = from_f<T>(A / fmaxf(Ls, 1e-30f));
    if (a.lse != nullptr && d == 0) a.lse[row0 + g] = row_lse(M, Ls);
  }
}

// GM: q heads a block carries, the least power of two >= G up to the
// register budget: GM * D <= 512, at most 8 (D = 32, 64: 8; 128: 4; 192:
// 2), and one head at D = 256 (two spill under the 128-register bound
// of two blocks an SM); larger groups take several blocks (gridDim.z).
template <int D>
constexpr int decode_max_heads() {
  return D >= 256 ? 1
                  : 512 / D >= 8 ? 8 : 512 / D >= 4 ? 4 : 512 / D >= 2 ? 2 : 1;
}

// Runs body(D, GM), both as std::integral_constant, for head dim D and
// group size G.
template <typename F>
int by_decode(int D, int G, F&& body) {
  auto heads = [&](auto dv) -> int {
    constexpr int kMaxG = decode_max_heads<decltype(dv)::value>();
    const int gm = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
    // only GM <= kMaxG is instantiated
    if (gm == 1 || kMaxG == 1)
      return body(dv, std::integral_constant<int, 1>{});
    if constexpr (kMaxG >= 2)
      if (gm == 2 || kMaxG == 2)
        return body(dv, std::integral_constant<int, 2>{});
    if constexpr (kMaxG >= 4)
      if (gm == 4 || kMaxG == 4)
        return body(dv, std::integral_constant<int, 4>{});
    if constexpr (kMaxG >= 8)
      return body(dv, std::integral_constant<int, 8>{});
    return cudaErrorInvalidValue;
  };
  switch (D) {
    case 32: return heads(std::integral_constant<int, 32>{});
    case 64: return heads(std::integral_constant<int, 64>{});
    case 128: return heads(std::integral_constant<int, 128>{});
    case 192: return heads(std::integral_constant<int, 192>{});
    case 256: return heads(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

// One launch: grid (nsplit, B * Hkv, ceil(G / GM)), clusters of nsplit
// blocks along x (none when nsplit is 1).
template <typename T, int D, int GM>
int launch_decode(const DecodeArgs<T>& a, int B, int smem,
                  cudaStream_t stream) {
  auto kern = decode_cluster_kernel<T, D, GM>;
  if (a.stages < 1 || a.stages > kMaxStages || a.nsplit < 1 ||
      a.nsplit > kMaxCluster || smem < decode_smem<T, D, GM>(a.stages))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int G = a.Hq / a.Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, B * a.Hkv, (G + GM - 1) / GM);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.nsplit > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch_decode(const DecodeArgs<T>& a, int B, int D, int smem,
                    cudaStream_t stream) {
  return by_decode(D, a.Hq / a.Hkv, [&](auto dv, auto gv) {
    return launch_decode<T, decltype(dv)::value, decltype(gv)::value>(
        a, B, smem, stream);
  });
}

// out[0..4]: registers a thread, local (spill) bytes a thread, static
// shared bytes, blocks an SM with `smem` bytes of dynamic shared memory,
// and the heads a block (GM) of the (T, D, G) instantiation.
template <typename T>
int decode_info(int D, int G, int smem, int* out) {
  return by_decode(D, G, [&](auto dv, auto gv) -> int {
    auto kern = decode_cluster_kernel<T, decltype(dv)::value,
                                      decltype(gv)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncAttributes fa;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    out[4] = decltype(gv)::value;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kern,
                                                         kDecThreads, smem);
  });
}

// -------------------------------------------------------- flash attention

constexpr int kBQ = 64;    // q rows per block
constexpr int kBK = 64;    // keys per tile
constexpr int kPT = kBQ + 4;  // P^T row stride: float4-aligned, spreads banks

template <int D>
constexpr size_t flash_smem() {
  // Q and K row-major at stride D + 4, V at stride D, P^T at kPT
  return sizeof(float) * (size_t)(kBQ * (D + 4) + kBK * (D + 4) + kBK * D +
                                  kBK * kPT);
}

// rows [row0, row0 + nrows) of a (rows, D) operand at row stride ld into
// shared memory at stride sld as float32 times mul; rows past nrows are 0
template <typename T, int D, int NR>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long ld, int nrows,
                                          float* __restrict__ dst, int sld,
                                          float mul) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < NR * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float x[kVec];
    if (r < nrows) {
      load_row<T, kVec>(src + r * ld + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(dst + r * sld + c + j) =
          make_float4(x[j] * mul, x[j + 1] * mul, x[j + 2] * mul,
                      x[j + 3] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, long long sqb, long long sqh,
                       long long sqs, const T* __restrict__ k, long long skb,
                       long long skh, long long sks,
                       const T* __restrict__ v, long long svb,
                       long long svh, long long svs, T* __restrict__ o,
                       long long sob, long long soh, long long sos, int Hq,
                       int Hkv, int Sq, int Sk, int causal, int window,
                       float scale) {
  constexpr int QS = D + 4;       // Q / K shared row stride
  constexpr int DC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;      // [kBK][QS]
  float* Vs = Ks + kBK * QS;      // [kBK][D]
  float* Pt = Vs + kBK * D;       // [kBK][kPT]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = Sk - Sq;                  // q rows right-aligned
  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;

  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;
  load_tile<T, D, kBQ>(q + b * sqb + h * sqh + q0 * sqs, sqs, nq, Qs, QS,
                       scale);

  // the live key tiles (the Pallas kernel's block skip)
  int kt0 = 0, kt1 = (Sk + kBK - 1) / kBK;
  if (window > 0) kt0 = max(0, q_lo - window + 1) / kBK;
  if (causal) kt1 = q_hi < 0 ? 0 : min(kt1, q_hi / kBK + 1);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Sk - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, kBK>(kb + k0 * sks, sks, nk, Ks, QS, 1.f);
    load_tile<T, D, kBK>(vb + k0 * svs, svs, nk, Vs, D, 1.f);
    __syncthreads();

    // S = (q * scale) K^T for rows 4ty + i, keys tx + 16j
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, online softmax; a row's 64 keys live on the 16 lanes of one
    // half-warp (lane = 16 (ty % 2) + tx)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + 4 * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = kpos < Sk && 4 * ty + i < nq;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        if (!live) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] > 0.5f * kNeg ? expf(s[i][j] - mx) : 0.f;
        ps += s[i][j];
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o2);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + ps;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * j) * kPT + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V for rows 4ty + i, columns tx + 16j
    for (int c = 0; c < nk; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + c * kPT + 4 * ty);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float x = Vs[c * D + tx + 16 * j];
        acc[0][j] = fmaf(p.x, x, acc[0][j]);
        acc[1][j] = fmaf(p.y, x, acc[1][j]);
        acc[2][j] = fmaf(p.z, x, acc[2][j]);
        acc[3][j] = fmaf(p.w, x, acc[3][j]);
      }
    }
  }

  T* ob = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(q0 + r) * sos + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch_flash(const void* q, long long sqb, long long sqh, long long sqs,
                 const void* k, long long skb, long long skh, long long sks,
                 const void* v, long long svb, long long svh, long long svs,
                 void* o, long long sob, long long soh, long long sos, int B,
                 int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem<D>();
  auto kern = flash_attention_kernel<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), sqb, sqh, sqs, static_cast<const T*>(k), skb,
      skh, sks, static_cast<const T*>(v), svb, svh, svs, static_cast<T*>(o),
      sob, soh, sos, Hq, Hkv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

int dispatch_flash(int D, const void* q, long long sqb, long long sqh,
                   long long sqs, const void* k, long long skb,
                   long long skh, long long sks, const void* v,
                   long long svb, long long svh, long long svs, void* o,
                   long long sob, long long soh, long long sos, int B,
                   int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                   float scale, cudaStream_t stream) {
#define BRDS_FLASH_D(DV)                                                    \
  if (D == DV)                                                              \
  return launch_flash<float, DV>(q, sqb, sqh, sqs, k, skb, skh, sks, v,    \
                                 svb, svh, svs, o, sob, soh, sos, B, Hq, Hkv, \
                                 Sq, Sk, causal, window, scale, stream)
  BRDS_FLASH_D(32);
  BRDS_FLASH_D(64);
  BRDS_FLASH_D(128);
  BRDS_FLASH_D(192);
  BRDS_FLASH_D(256);
#undef BRDS_FLASH_D
  return cudaErrorInvalidValue;
}


// ------------------------------------------- flash attention, tensor cores

using bf16 = __nv_bfloat16;

// Tile shapes of flash_tc_kernel for head dim D (see the note at the top)
template <int D>
struct TC {
  static constexpr int DP = D < 64 ? 64 : D;   // columns in shared memory
  static constexpr int BK = D > 192 ? 32 : 64;  // keys per tile
  static constexpr int NS = 3;                  // ring stages
  static constexpr int kQ = 64 * DP * 2;        // one q head's Q tile, bytes
  static constexpr int kKV = BK * DP * 2;       // one K or V tile, bytes
  static_assert(D % 8 == 0 && DP % 64 == 0, "16-byte chunks, 64-col atoms");
};

// dynamic shared memory of a block with WG consumer warpgroups: Q tiles,
// NS K and V stages, the mbarriers, and slack to align the base to 1024
template <int D, int WG>
constexpr int tc_smem() {
  using C = TC<D>;
  return 1024 + WG * C::kQ + 2 * C::NS * C::kKV + (2 * C::NS + 1) * 8;
}

// p >= 0 as three bf16 terms that sum to it exactly: each term keeps the
// top 8 significant bits of what is left (truncation), so p - p1 has at
// most 16 significant bits, and p - p1 - p2 at most 8, a bf16 value.
// Returns the terms' float32 bit patterns, whose low 16 bits are zero.
__device__ __forceinline__ void split3(float p, uint32_t (&t)[3]) {
  const uint32_t b = __float_as_uint(p);
  t[0] = b & 0xffff0000u;
  const float r1 = p - __uint_as_float(t[0]);
  t[1] = __float_as_uint(r1) & 0xffff0000u;
  t[2] = __float_as_uint(r1 - __uint_as_float(t[1]));
}

// the bf16 pair (lo, hi) of two such terms: their high halves
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// Named barriers 1 and 2: the two consumer warpgroups take turns issuing
// their products (warpgroup w waits at 1 + w, then lets the other go), so
// one's softmax runs while the other's products hold the tensor cores.
template <int WGI>
__device__ __forceinline__ void turn_wait() {
  asm volatile("bar.sync %0, 256;\n" ::"n"(1 + WGI) : "memory");
}
template <int WGI>
__device__ __forceinline__ void turn_pass() {
  asm volatile("bar.arrive %0, 256;\n" ::"n"(2 - WGI) : "memory");
}

// Scale, mask and the online softmax of one tile of scores in place: sc
// becomes p = exp(s - m') (exactly 0 where masked), m and l move on, and
// alpha is the factor O must take before p V is added. A row's keys live
// on the 4 lanes of a quad. Masks only where the tile needs them (edge).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             bool edge, int qpos, int kpos,
                                             int Sk, int causal, int window) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float x = sc[e] * scale;
    if (edge) {
      const int qp = qpos + (e & 2 ? 8 : 0);
      const int kp = kpos + 8 * (e / 4) + (e & 1);
      bool live = kp < Sk;
      if (causal) live = live && kp <= qp;
      if (window > 0) live = live && kp > qp - window;
      if (!live) x = kNeg;
    }
    sc[e] = x;
  }
  float mx[2] = {m[0], m[1]}, ps[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = __expf(m[h] - mx[h]);
  }
  // __expf: one multiply by log2(e) and the hardware exp2, branch-free;
  // its 2^-22 relative error is far below the one-ulp gate
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int h = (e >> 1) & 1;
    const float p = __expf(sc[e] - mx[h]);
    sc[e] = sc[e] > 0.5f * kNeg ? p : 0.f;
    ps[h] += sc[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
    l[h] = l[h] * alpha[h] + ps[h];
    m[h] = mx[h];
  }
}

// One block: batch b, kv head kvh, q heads kvh * G + hg * WG + w for
// consumer warpgroup w < WG, and 64 q positions. Warpgroups 0 .. WG - 1
// are the consumers, warpgroup WG the producer; 168 registers a thread
// (three warps share each SM sub-partition's register file).
//
// A consumer's iteration i takes its turn at the tensor cores, issues
// O = alpha O + P V of tile i - 1, then S = Q K^T of tile i, passes the
// turn, releases tile i - 1's stage and runs tile i's softmax and split
// while the other warpgroup's products run.
template <int D, int WG>
__global__ void __launch_bounds__((WG + 1) * 128, 1)
flash_tc_kernel(const bf16* __restrict__ q, long long sqb, long long sqh,
                long long sqs, const bf16* __restrict__ k, long long skb,
                long long skh, long long sks, const bf16* __restrict__ v,
                long long svb, long long svh, long long svs,
                bf16* __restrict__ o, long long sob, long long soh,
                long long sos, int B, int Hq, int Hkv, int Sq, int Sk,
                int causal, int window, float scale) {
  using C = TC<D>;
  constexpr int DP = C::DP, BK = C::BK, NS = C::NS;
  constexpr int CH = DP / 8;   // 16-byte chunks a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ = smem_raw +
                ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + WG * C::kQ;
  uint8_t* sV = sK + NS * C::kKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * C::kKV);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  // heaviest first: block order runs over q tiles from the last (the most
  // live keys under a causal mask) down
  const int G = Hq / Hkv, ngrp = G / WG, nqt = (Sq + 63) / 64;
  const int per_tile = ngrp * B * Hkv;
  const int rank = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int qt = causal ? nqt - 1 - rank : rank;
  const int hg = rest % ngrp, kvh = (rest / ngrp) % Hkv,
            b = rest / ngrp / Hkv;
  const int q0 = qt * 64, nq = min(64, Sq - q0);
  const int off = Sk - Sq;                  // q rows right-aligned
  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;
  int kt0 = 0, kt1 = (Sk + BK - 1) / BK;    // the live key tiles
  if (window > 0) kt0 = max(0, q_lo - window + 1) / BK;
  if (causal) kt1 = q_hi < 0 ? 0 : min(kt1, q_hi / BK + 1);
  const int n = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 128);        // the producer's threads
      hopper::mbar_init(&empty[s], WG * 4);    // the consumer warps
    }
    hopper::mbar_init(qbar, 128);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform (a shuffle) so the compiler sees each role's
  // branch as uniform
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == WG) {
    // ---- producer: Q once, then K and V tiles into the ring
    const int pt = threadIdx.x - WG * 128;
    const bf16* qb = q + b * sqb + (long long)(kvh * G + hg * WG) * sqh;
    for (int i = pt; i < WG * 64 * CH; i += 128) {
      const int w = i / (64 * CH), r = i / CH % 64, c = i % CH;
      const bool ok = r < nq && c < D / 8;
      hopper::cp_async16(
          hopper::smem_addr(sQ + w * C::kQ) + hopper::swizzled(64, r, c),
          ok ? qb + w * sqh + (q0 + r) * sqs + c * 8 : q, ok);
    }
    hopper::cp_async_arrive(qbar);
    const bf16* kb = k + b * skb + kvh * skh;
    const bf16* vb = v + b * svb + kvh * svh;
    for (int i = 0; i < n; ++i) {
      const int s = i % NS, k0 = (kt0 + i) * BK;
      if (i >= NS) hopper::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
      const uint32_t ks = hopper::smem_addr(sK + s * C::kKV);
      const uint32_t vs = hopper::smem_addr(sV + s * C::kKV);
      for (int j = pt; j < BK * CH; j += 128) {
        const int r = j / CH, c = j % CH, pos = k0 + r;
        const bool ok = pos < Sk && c < D / 8;
        const uint32_t at = hopper::swizzled(BK, r, c);
        hopper::cp_async16(ks + at, ok ? kb + pos * sks + c * 8 : k, ok);
        hopper::cp_async16(vs + at, ok ? vb + pos * svs + c * 8 : v, ok);
      }
      hopper::cp_async_arrive(&full[s]);
    }
    hopper::cp_async_wait_all();
    return;
  }

  // ---- consumers: warpgroup wg owns q head kvh * G + hg * WG + wg; one
  // instantiation per warpgroup, so every branch on wg is resolved at
  // compile time (a runtime one made ptxas serialize the products)
  auto consume = [&](auto wgc) {
    constexpr int wg = decltype(wgc)::value;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;   // rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);             // columns cq, cq + 1 of 8
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
    float sc[BK / 2];
    uint32_t pa[3][BK / 16][4];   // the previous tile's p, three bf16 terms
    const uint32_t qa = hopper::smem_addr(sQ + wg * C::kQ);

    auto ready = [&](int i) {   // tile i's stage has landed
      hopper::mbar_wait(&full[i % NS], (i / NS) & 1);
      hopper::fence_proxy_async();
    };
    auto issue_s = [&](int i) {   // S = Q K^T of tile i
      const uint32_t ka = hopper::smem_addr(sK + (i % NS) * C::kKV);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(sc, hopper::desc_k(qa, 64, kk),
                         hopper::desc_k(ka, BK, kk), kk > 0);
      hopper::wgmma_commit();
    };
    auto issue_pv = [&](int i) {   // O += P V of tile i
      const uint32_t va = hopper::smem_addr(sV + (i % NS) * C::kKV);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int t3 = 0; t3 < 3; ++t3)
          hopper::wgmma_rs(acc, pa[t3][kk], hopper::desc_mn(va, BK, kk), 1);
      hopper::wgmma_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    };
    auto softmax = [&](int i) {
      const int k0 = (kt0 + i) * BK;
      const bool edge = (causal && k0 + BK - 1 > q_lo) ||
                        (window > 0 && k0 <= q_hi - window) || k0 + BK > Sk;
      softmax_tile<BK>(sc, m, l, alpha, scale, edge, q_lo + r0, k0 + cq, Sk,
                       causal, window);
    };
    auto release = [&](int i) {   // tile i's stage is read
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[i % NS]);
    };
    auto split = [&]() {
      // p in three bf16 terms, as the A operand of P V: 16-key slice kk is
      // the S fragments of 8-column groups 2 kk and 2 kk + 1; f runs over
      // (r0, 2kk), (r0 + 8, 2kk), (r0, 2kk + 1), (r0 + 8, 2kk + 1)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
          uint32_t x[3], y[3];
          split3(sc[e], x);
          split3(sc[e + 1], y);
#pragma unroll
          for (int t3 = 0; t3 < 3; ++t3) pa[t3][kk][f] = pack_hi(x[t3], y[t3]);
        }
    };
    // warpgroup 1 skips its last pass so every turn barrier is balanced
    auto pass = [&](int i) {
      if (WG == 2 && !(wg == 1 && i == n - 1)) turn_pass<wg>();
    };

    if (n > 0) {
      hopper::mbar_wait(qbar, 0);
      if (WG == 2 && wg == 1) turn_pass<wg>();   // warpgroup 0 goes first
      ready(0);
      if (WG == 2) turn_wait<wg>();
      hopper::wgmma_fence();
      issue_s(0);
      pass(0);
      hopper::wgmma_wait();
      hopper::fence_regs(sc);
      softmax(0);
      split();
      for (int i = 1; i < n; ++i) {
        ready(i);
        if (WG == 2) turn_wait<wg>();
        // P V of tile i - 1, then S of tile i: the S accumulators are not
        // live while P V's are in flight (both in flight at once is more
        // than ptxas keeps in 168 registers, and it serializes every wgmma)
        rescale();   // by tile i - 1's alpha, before its P V is added
        hopper::wgmma_fence();
        issue_pv(i - 1);
        hopper::wgmma_wait();
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_s(i);
        pass(i);
        hopper::wgmma_wait();
        hopper::fence_regs(sc);
        release(i - 1);
        softmax(i);
        split();
      }
      rescale();
      hopper::wgmma_fence();
      issue_pv(n - 1);
      hopper::wgmma_wait();
      hopper::fence_regs(acc);
      release(n - 1);
    }

    // out = acc / max(l, 1e-30) through o's strides
    bf16* ob = o + b * sob + (long long)(kvh * G + hg * WG + wg) * soh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= nq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      bf16* orow = ob + (q0 + r) * sos;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                    acc[4 * j + 2 * h + 1] * inv);
    }
  };
  if constexpr (WG == 2) {
    if (wgi == 0) consume(std::integral_constant<int, 0>{});
    else consume(std::integral_constant<int, 1>{});
  } else {
    consume(std::integral_constant<int, 0>{});
  }
}

template <int D, int WG>
int launch_flash_tc(const void* q, long long sqb, long long sqh,
                    long long sqs, const void* k, long long skb,
                    long long skh, long long sks, const void* v,
                    long long svb, long long svh, long long svs, void* o,
                    long long sob, long long soh, long long sos, int B,
                    int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                    float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem<D, WG>();
  auto kern = flash_tc_kernel<D, WG>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)((Sq + 63) / 64) * (Hq / Hkv / WG) * B * Hkv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, (WG + 1) * 128, smem, stream>>>(
      static_cast<const bf16*>(q), sqb, sqh, sqs, static_cast<const bf16*>(k),
      skb, skh, sks, static_cast<const bf16*>(v), svb, svh, svs,
      static_cast<bf16*>(o), sob, soh, sos, B, Hq, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

// two consumer warpgroups (two q heads) a block when the group size is
// even, else one; one at D = 256, where two keep O (128 registers a
// thread), S and the p terms in flight within 168 registers only by
// spilling: one warpgroup has 255
template <int D>
constexpr bool tc_pairs() { return D < 256; }

template <int D, typename... A>
int launch_flash_tc_d(bool pair, A... args) {
  if constexpr (tc_pairs<D>())
    if (pair) return launch_flash_tc<D, 2>(args...);
  return launch_flash_tc<D, 1>(args...);
}

int dispatch_flash_tc(int D, const void* q, long long sqb, long long sqh,
                      long long sqs, const void* k, long long skb,
                      long long skh, long long sks, const void* v,
                      long long svb, long long svh, long long svs, void* o,
                      long long sob, long long soh, long long sos, int B,
                      int Hq, int Hkv, int Sq, int Sk, int causal,
                      int window, float scale, cudaStream_t stream) {
  const bool pair = (Hq / Hkv) % 2 == 0;
#define BRDS_FLASH_TC(DV)                                                    \
  if (D == DV)                                                               \
    return launch_flash_tc_d<DV>(pair, q, sqb, sqh, sqs, k, skb, skh, sks,  \
                                 v, svb, svh, svs, o, sob, soh, sos, B, Hq, \
                                 Hkv, Sq, Sk, causal, window, scale, stream)
  BRDS_FLASH_TC(32);
  BRDS_FLASH_TC(64);
  BRDS_FLASH_TC(128);
  BRDS_FLASH_TC(192);
  BRDS_FLASH_TC(256);
#undef BRDS_FLASH_TC
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: none. scale: D^-0.5 rounded
// to float32 by the caller, as the plain versions round it. nsplit (at
// most 8, the cluster), stages (at most 8) and smem (the dynamic shared
// memory, at least the instantiation's need) come from
// kernels/plan.py::decode_plan. fixed_len >= 0 is a diagnostic
// (launch.profile_kernels): every row takes it and lengths is not read.
// lse: null, or (B, Hq) float32 that takes each row's log-sum-exp.
// start: null, or (B,) int32, each row's first live key (keys before it
// are not read; a row whose start is at or past its length reads none).
extern "C" int brds_decode_attention(
    const void* q, long long sqb, long long sqh, const void* k,
    long long skb, long long skh, long long sks, const void* v,
    long long svb, long long svh, long long svs, const void* lengths,
    const void* start, void* out, int B, int Hq, int Hkv, int S, int D, int window, float scale,
    int nsplit, int stages, int smem, int fixed_len, void* lse, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 ||
      (long long)B * Hkv > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const DecodeArgs<float> a{
        static_cast<const float*>(q), sqb, sqh, static_cast<const float*>(k),
        skb, skh, sks, static_cast<const float*>(v), svb, svh, svs,
        static_cast<const int*>(lengths), static_cast<const int*>(start),
        static_cast<float*>(out),
        static_cast<float*>(lse), S, Hq, Hkv, window, nsplit, stages,
        fixed_len, scale};
    return dispatch_decode(a, B, D, smem, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const DecodeArgs<T> a{
        static_cast<const T*>(q), sqb, sqh, static_cast<const T*>(k), skb,
        skh, sks, static_cast<const T*>(v), svb, svh, svs,
        static_cast<const int*>(lengths), static_cast<const int*>(start),
        static_cast<T*>(out),
        static_cast<float*>(lse), S, Hq, Hkv, window, nsplit, stages,
        fixed_len, scale};
    return dispatch_decode(a, B, D, smem, st);
  }
  return cudaErrorInvalidValue;
}

// For the decode instantiation of (D, G, dtype): out[0..4] = registers a
// thread, local (spill) bytes a thread, static shared bytes, blocks an SM
// with `smem` bytes of dynamic shared memory, and q heads a block.
extern "C" int brds_decode_attention_info(int D, int G, int dtype, int smem,
                                          int* out) {
  if (dtype == 0) return decode_info<float>(D, G, smem, out);
  if (dtype == 1) return decode_info<__nv_bfloat16>(D, G, smem, out);
  return cudaErrorInvalidValue;
}

// float32 operands (the SIMT body). causal: 0 / 1. window <= 0: none.
// scale as for decode.
extern "C" int brds_flash_attention(
    const void* q, long long sqb, long long sqh, long long sqs,
    const void* k, long long skb, long long skh, long long sks,
    const void* v, long long svb, long long svh, long long svs, void* o,
    long long sob, long long soh, long long sos, int B, int Hq, int Hkv,
    int Sq, int Sk, int D, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  return dispatch_flash(D, q, sqb, sqh, sqs, k, skb, skh, sks, v, svb, svh,
                        svs, o, sob, soh, sos, B, Hq, Hkv, Sq, Sk, causal,
                        window, scale, static_cast<cudaStream_t>(stream));
}

// bf16 operands (the tensor-core body); arguments as above
extern "C" int brds_flash_attention_bf16(
    const void* q, long long sqb, long long sqh, long long sqs,
    const void* k, long long skb, long long skh, long long sks,
    const void* v, long long svb, long long svh, long long svs, void* o,
    long long sob, long long soh, long long sos, int B, int Hq, int Hkv,
    int Sq, int Sk, int D, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  return dispatch_flash_tc(D, q, sqb, sqh, sqs, k, skb, skh, sks, v, svb,
                           svh, svs, o, sob, soh, sos, B, Hq, Hkv, Sq, Sk,
                           causal, window, scale,
                           static_cast<cudaStream_t>(stream));
}

// dynamic shared memory (bytes) of the tensor-core body's block at head
// dim D and group size G; 0 for an unsupported D
extern "C" int brds_flash_attention_bf16_smem(int D, int G) {
  const bool pair = G % 2 == 0;
#define BRDS_FLASH_SMEM(DV) \
  if (D == DV) return pair && tc_pairs<DV>() ? tc_smem<DV, 2>() : tc_smem<DV, 1>()
  BRDS_FLASH_SMEM(32);
  BRDS_FLASH_SMEM(64);
  BRDS_FLASH_SMEM(128);
  BRDS_FLASH_SMEM(192);
  BRDS_FLASH_SMEM(256);
#undef BRDS_FLASH_SMEM
  return 0;
}
