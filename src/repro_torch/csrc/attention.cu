// Attention for the dense-transformer serving path, fp32 math on fp32 or
// bf16 operands (the Pallas bodies cast to float32 before both products;
// so do these, and p stays float32 through P.V):
//  - decode_attention (B14): one query per sequence against its KV cache,
//    the G = Hq / Hkv q heads of a kv group sharing one K/V stream.
//    Replaces src/repro/kernels/decode_attention.py::decode_attention.
//  - flash_attention (B15): blocked causal / windowed GQA attention
//    forward, q rows right-aligned to the kv end. Replaces
//    src/repro/kernels/flash_attention.py::flash_attention.
//
// Both read q, k, v (and B15 writes o) through strides with a unit last
// dim, so the model's (B, S, H, D) cache and projections are read in place:
// no head-major copy, and no GQA expansion of the cache. Masked scores
// weigh exactly 0 (p = s > NEG/2 ? exp(s - m) : 0, so a fully dead tile
// cannot poison l), and out = acc / max(l, 1e-30): a row with no live key
// gives 0, as the Pallas kernels do.
//
// decode_attention. Bound: bytes (each live K and V row is read once and
// used for 2G flops per element). A block owns a (b, kv head) pair, up to
// GM of its q heads and one of `nsplit` slices of [lo, len): each warp
// streams its own keys, four at a time, lane l holding elements
// [l*D/32, (l+1)*D/32) of q, K, V and acc, with a running (m, l, acc) per
// head in registers; the eight warps merge in shared memory in warp order.
// Lengths are read on the card (no host read), and keys at or past
// lengths[b] (or before len - window) are never loaded. With nsplit > 1 a
// second launch merges the slices' (m, l, acc) in slice order; the
// wrapper picks nsplit so the pairs fill the SMs (64 pairs at B=8 on
// qwen3-0.6b would leave half of 132 SMs idle). Deterministic: no atomics.
//
// flash_attention. Bound: bytes at the bf16 serve shape (q, k, v read
// once and o written once), just above the tensor cores' time for the
// causal half of Q.K^T and a split-p P.V (6 B Hq Sq Sk D / 2 flops at the
// bf16 rate). This SIMT kernel is held back by its float32 FMAs, which
// alone take about 8x that bound. A block owns one
// (b, q head, 64-row q tile); q heads of a group read kv head h / G. It
// walks the 64-key tiles that the causal / window masks leave live (the
// Pallas kernel's block skip) and masks the ragged edges itself, with no
// padding to tile multiples. Q, the K and V tiles and P^T sit in shared
// memory as float32; each of 256 threads owns a 4 x 4 block of S (rows
// 4ty.., keys tx + 16j) and 4 rows x D/16 columns of the output. SIMT
// fp32 FMA throughout: a tensor-core P.V would round p to bf16 (about
// 2^-8 relative) unless p were split into two bf16 terms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// N consecutive elements at p (aligned to their size, or to 16 bytes when
// larger) into float registers, in loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else if constexpr (kBytes == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(p[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------- decode attention

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, long long sqb, long long sqh,
                        const T* __restrict__ k, long long skb,
                        long long skh, long long sks,
                        const T* __restrict__ v, long long svb,
                        long long svh, long long svs,
                        const int* __restrict__ lengths, int S, int Hq,
                        int Hkv, int window, float scale, int nsplit,
                        T* __restrict__ out, float* __restrict__ ws) {
  constexpr int E = D / 32;   // elements per lane
  constexpr int U = 4;        // keys per warp and iteration
  const int b = blockIdx.x / Hkv, kh = blockIdx.x % Hkv;
  const int split = blockIdx.y;
  const int G = Hq / Hkv;
  const int g0 = blockIdx.z * GM;
  const int gn = min(GM, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int len = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int chunk = (len - lo + nsplit - 1) / nsplit;
  const int s0 = lo + split * chunk;
  const int s1 = min(len, s0 + chunk);

  float qr[GM][E], m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < gn) {
      load_row<T, E>(q + b * sqb + (kh * G + g0 + g) * sqh + lane * E,
                     qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale;
    }
  }
  const T* kb = k + b * skb + kh * skh + lane * E;
  const T* vb = v + b * svb + kh * svh + lane * E;
  for (int base = s0 + warp * U; base < s1; base += kWarps * U) {
    float kr[U][E], vr[U][E], sc[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < s1) {
        load_row<T, E>(kb + (base + u) * sks, kr[u]);
        load_row<T, E>(vb + (base + u) * svs, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kr[u][e], d);
        d = warp_sum(d);
        sc[u][g] = base + u < s1 ? d : kNeg;
      }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      const float alpha = expf(m[g] - mx);
      float p[U], ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = sc[u][g] > 0.5f * kNeg ? expf(sc[u][g] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' (m, l, acc), in warp order
  extern __shared__ float smem[];
  float* sm_m = smem;                    // [kWarps][GM]
  float* sm_l = sm_m + kWarps * GM;      // [kWarps][GM]
  float* sm_acc = sm_l + kWarps * GM;    // [kWarps][GM][D]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      sm_m[warp * GM + g] = m[g];
      sm_l[warp * GM + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm_acc[(warp * GM + g) * D + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNeg;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * GM + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * GM + g] - M);
      L += c * sm_l[w * GM + g];
      A += c * sm_acc[(w * GM + g) * D + d];
    }
    const size_t row = (size_t)b * Hq + kh * G + g0 + g;   // (b, q head)
    if (nsplit == 1) {
      out[row * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      const size_t r = row * nsplit + split;
      float* ws_m = ws;
      float* ws_l = ws + (size_t)gridDim.x * G * nsplit;
      float* ws_acc = ws_l + (size_t)gridDim.x * G * nsplit;
      if (d == 0) {
        ws_m[r] = M;
        ws_l[r] = L;
      }
      ws_acc[r * D + d] = A;
    }
  }
}

// the slices' partial (m, l, acc) of one (b, q head) row, in slice order
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, int rows, int nsplit,
                      int D, T* __restrict__ out) {
  const size_t row = blockIdx.x;
  const float* ws_m = ws + row * nsplit;
  const float* ws_l = ws + (size_t)rows * nsplit + row * nsplit;
  const float* ws_acc = ws + 2 * (size_t)rows * nsplit + row * nsplit * D;
  float M = kNeg;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ws_m[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float c = expf(ws_m[s] - M);
      L += c * ws_l[s];
      A += c * ws_acc[s * D + d];
    }
    out[row * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int GM>
int launch_decode(const void* q, long long sqb, long long sqh, const void* k,
                  long long skb, long long skh, long long sks, const void* v,
                  long long svb, long long svh, long long svs,
                  const void* lengths, void* out, void* ws, int B, int Hq,
                  int Hkv, int S, int window, float scale, int nsplit,
                  cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv, nsplit, (G + GM - 1) / GM);
  const size_t smem = sizeof(float) * kWarps * GM * (D + 2);
  auto kern = decode_attention_kernel<T, D, GM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), sqb, sqh, static_cast<const T*>(k), skb, skh,
      sks, static_cast<const T*>(v), svb, svh, svs,
      static_cast<const int*>(lengths), S, Hq, Hkv, window, scale, nsplit,
      static_cast<T*>(out),
      static_cast<float*>(ws));
  if (nsplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_combine_kernel<T><<<B * Hq, D < kThreads ? D : kThreads, 0,
                               stream>>>(static_cast<const float*>(ws),
                                         B * Hq, nsplit, D,
                                         static_cast<T*>(out));
  }
  return cudaGetLastError();
}

// GM: q heads a block carries, the least power of two >= G up to the
// register budget (GM * D <= 1024); larger groups take several blocks.
template <typename T, int D>
int dispatch_decode_g(int G, const void* q, long long sqb, long long sqh,
                      const void* k, long long skb, long long skh,
                      long long sks, const void* v, long long svb,
                      long long svh, long long svs, const void* lengths,
                      void* out, void* ws, int B, int Hq, int Hkv, int S,
                      int window, float scale, int nsplit,
                      cudaStream_t stream) {
  constexpr int kMaxG = 1024 / D < 8 ? 1024 / D : 8;
  const int gm = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
#define BRDS_DECODE(GMV)                                                     \
  return launch_decode<T, D, GMV>(q, sqb, sqh, k, skb, skh, sks, v, svb,    \
                                  svh, svs, lengths, out, ws, B, Hq, Hkv, S, \
                                  window, scale, nsplit, stream)
  if (gm == 1 || kMaxG == 1) BRDS_DECODE(1);
  if (gm == 2 || kMaxG == 2) BRDS_DECODE(2);
  if (gm == 4 || kMaxG == 4) BRDS_DECODE(4);
  BRDS_DECODE(kMaxG);
#undef BRDS_DECODE
}

template <typename T>
int dispatch_decode(int D, int G, const void* q, long long sqb,
                    long long sqh, const void* k, long long skb,
                    long long skh, long long sks, const void* v,
                    long long svb, long long svh, long long svs,
                    const void* lengths, void* out, void* ws, int B, int Hq,
                    int Hkv, int S, int window, float scale, int nsplit,
                    cudaStream_t stream) {
#define BRDS_DECODE_D(DV)                                                   \
  if (D == DV)                                                              \
  return dispatch_decode_g<T, DV>(G, q, sqb, sqh, k, skb, skh, sks, v, svb, \
                                  svh, svs, lengths, out, ws, B, Hq, Hkv, S, \
                                  window, scale, nsplit, stream)
  BRDS_DECODE_D(32);
  BRDS_DECODE_D(64);
  BRDS_DECODE_D(128);
  BRDS_DECODE_D(256);
#undef BRDS_DECODE_D
  return cudaErrorInvalidValue;
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

template <typename T>
int dispatch_flash(int D, const void* q, long long sqb, long long sqh,
                   long long sqs, const void* k, long long skb,
                   long long skh, long long sks, const void* v,
                   long long svb, long long svh, long long svs, void* o,
                   long long sob, long long soh, long long sos, int B,
                   int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                   float scale, cudaStream_t stream) {
#define BRDS_FLASH_D(DV)                                                    \
  if (D == DV)                                                              \
  return launch_flash<T, DV>(q, sqb, sqh, sqs, k, skb, skh, sks, v, svb,   \
                             svh, svs, o, sob, soh, sos, B, Hq, Hkv, Sq, Sk, \
                             causal, window, scale, stream)
  BRDS_FLASH_D(32);
  BRDS_FLASH_D(64);
  BRDS_FLASH_D(128);
  BRDS_FLASH_D(256);
#undef BRDS_FLASH_D
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. ws: nsplit > 1 only, B*Hq*nsplit*(D + 2)
// floats. window <= 0: none. scale: D^-0.5 rounded to float32 by the
// caller, as the plain versions round it.
extern "C" int brds_decode_attention(
    const void* q, long long sqb, long long sqh, const void* k,
    long long skb, long long skh, long long sks, const void* v,
    long long svb, long long svh, long long svs, const void* lengths,
    void* out, void* ws, int B, int Hq, int Hkv, int S, int D, int window,
    float scale, int nsplit, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || nsplit <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_decode<float>(D, Hq / Hkv, q, sqb, sqh, k, skb, skh, sks,
                                  v, svb, svh, svs, lengths, out, ws, B, Hq,
                                  Hkv, S, window, scale, nsplit, st);
  if (dtype == 1)
    return dispatch_decode<__nv_bfloat16>(D, Hq / Hkv, q, sqb, sqh, k, skb,
                                          skh, sks, v, svb, svh, svs,
                                          lengths, out, ws, B, Hq, Hkv, S,
                                          window, scale, nsplit, st);
  return cudaErrorInvalidValue;
}

// causal: 0 / 1. window <= 0: none. scale as for decode.
extern "C" int brds_flash_attention(
    const void* q, long long sqb, long long sqh, long long sqs,
    const void* k, long long skb, long long skh, long long sks,
    const void* v, long long svb, long long svh, long long svs, void* o,
    long long sob, long long soh, long long sos, int B, int Hq, int Hkv,
    int Sq, int Sk, int D, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_flash<float>(D, q, sqb, sqh, sqs, k, skb, skh, sks, v,
                                 svb, svh, svs, o, sob, soh, sos, B, Hq, Hkv,
                                 Sq, Sk, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_flash<__nv_bfloat16>(D, q, sqb, sqh, sqs, k, skb, skh,
                                         sks, v, svb, svh, svs, o, sob, soh,
                                         sos, B, Hq, Hkv, Sq, Sk, causal,
                                         window, scale, st);
  return cudaErrorInvalidValue;
}
