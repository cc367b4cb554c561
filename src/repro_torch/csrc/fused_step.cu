// The fused BRDS-LSTM layer steps: the gate stage (dual-ratio SpMV and its
// epilogue), bias, gate nonlinearities and cell update in one launch.
//
//  - fused_brds_lstm_step: z = Sx@x + Sh@h + bias. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_lstm_step.
//  - fused_brds_delta_lstm_step: m' = m + Sx@(fx*dx) + Sh@(fh*dh),
//    z = m' + bias; also writes m'. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_delta_lstm_step.
//  - fused_brds_lstm_step_q8: zx, zh = dq(Sx@qx), dq(Sh@qh),
//    z = (zx + zh) + bias. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_lstm_step_q8.
//  - fused_brds_delta_lstm_step_q8: zx, zh = dq(Sx@qdx), dq(Sh@qdh) over
//    the codes of the masked deltas, m' = (m + zx) + zh, z = m' + bias;
//    also writes m'. Replaces
//    src/repro/kernels/fused_step.py::fused_brds_delta_lstm_step_q8.
//
// The TPU kernels write each row block's z (or m, zx, zh) into VMEM
// scratch and close the cell on the last step of their sequential grid
// (pl.when(i == nblk - 1)). Blocks on a GPU run in no order, so here each
// block owns kJT hidden units j and computes their four gate rows j, H+j,
// 2H+j, 3H+j (one warp per row, the same brds::row_dot and per-row
// epilogue as the chained kernel), keeps z in shared memory, and closes
// the cell in-block with the same brds::lstm_cell as lstm_gates. Each step
// is bitwise equal to its chained pair: rb_dual_spmv / delta_rb_dual_spmv /
// rb_dual_parts_q8 (then m + zx + zh for the delta q8 step), then the bias
// add in PyTorch, then lstm_gates.
//
// Bound: bytes, as the chained gate kernels: the packed weights are read
// once; z, c and h never round-trip through device memory between the two
// stages.
#include "brds_common.cuh"

namespace {

constexpr int kJT = 2;                            // hidden units per block
constexpr int kThreads = kJT * 4 * brds::kWarp;   // one warp per gate row

// Closes the cells of the block's kJT hidden units from the gate values
// the warps left in zs: thread t < kJT * B takes (unit t / B, batch t % B).
template <int NB>
__device__ __forceinline__ void close_cells(const float (&zs)[kJT][4][NB],
                                            int H, int B,
                                            const float* __restrict__ c_prev,
                                            float* __restrict__ c_out,
                                            float* __restrict__ h_out,
                                            const brds::Act& act) {
  const int t = threadIdx.x;
  if (t < kJT * B) {
    const int jl = t / B, b = t % B;
    const int j = blockIdx.x * kJT + jl;
    if (j < H) {
      const size_t o = (size_t)b * H + j;
      brds::lstm_cell(zs[jl][0][b], zs[jl][1][b], zs[jl][2][b], zs[jl][3][b],
                      c_prev[o], act, c_out + o, h_out + o);
    }
  }
}

template <typename DX, typename DH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const float* __restrict__ vx, const DX* __restrict__ dx,
                  int kx, const float* __restrict__ x, int X,
                  const float* __restrict__ vh, const DH* __restrict__ dh,
                  int kh, const float* __restrict__ h, int H,
                  const float* __restrict__ bias,
                  const float* __restrict__ c_prev, float* __restrict__ c_out,
                  float* __restrict__ h_out, int B, brds::Act act) {
  if constexpr (kTiled) {
    x = brds::tile_rows(x, X);
    h = brds::tile_rows(h, H);
    c_prev = brds::tile_rows(c_prev, H);
    c_out = brds::tile_rows(c_out, H);
    h_out = brds::tile_rows(h_out, H);
    B = brds::tile_batch(B);
  }
  __shared__ float zs[kJT][4][NB];
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int j = blockIdx.x * kJT + jl;
  if (j < H) {
    const int row = gate * H + j;
    float ax[NB] = {}, ah[NB] = {};
    brds::row_dot<DX, NB>(vx + (size_t)row * kx, dx + (size_t)row * kx, kx,
                          brds::F32Act{x, X}, B, ax);
    brds::row_dot<DH, NB>(vh + (size_t)row * kh, dh + (size_t)row * kh, kh,
                          brds::F32Act{h, H}, B, ah);
    const float bb = bias[row];
    // z would round through x's dtype here, as the chained path stores it;
    // x is float32, so that is the identity
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B && b == lane) zs[jl][gate][b] = ax[b] + ah[b] + bb;
  }
  __syncthreads();
  close_cells<NB>(zs, H, B, c_prev, c_out, h_out, act);
}

template <typename IX, typename IH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_delta_step_kernel(const float* __restrict__ vx,
                        const IX* __restrict__ ix, int kx,
                        const float* __restrict__ dx,
                        const float* __restrict__ fx, int X,
                        const float* __restrict__ vh,
                        const IH* __restrict__ ih, int kh,
                        const float* __restrict__ dh,
                        const float* __restrict__ fh, int H,
                        const float* __restrict__ m,
                        const float* __restrict__ bias,
                        const float* __restrict__ c_prev,
                        float* __restrict__ c_out, float* __restrict__ h_out,
                        float* __restrict__ m_out, int B, brds::Act act) {
  if constexpr (kTiled) {
    dx = brds::tile_rows(dx, X);
    fx = brds::tile_rows(fx, X);
    dh = brds::tile_rows(dh, H);
    fh = brds::tile_rows(fh, H);
    m = brds::tile_rows(m, 4 * H);
    m_out = brds::tile_rows(m_out, 4 * H);
    c_prev = brds::tile_rows(c_prev, H);
    c_out = brds::tile_rows(c_out, H);
    h_out = brds::tile_rows(h_out, H);
    B = brds::tile_batch(B);
  }
  __shared__ float zs[kJT][4][NB];
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int j = blockIdx.x * kJT + jl;
  if (j < H) {
    const int row = gate * H + j;
    const int R = 4 * H;
    float ax[NB] = {}, ah[NB] = {};
    brds::row_dot<IX, NB>(vx + (size_t)row * kx, ix + (size_t)row * kx, kx,
                          brds::DeltaAct{dx, fx, X}, B, ax);
    brds::row_dot<IH, NB>(vh + (size_t)row * kh, ih + (size_t)row * kh, kh,
                          brds::DeltaAct{dh, fh, H}, B, ah);
    const float bb = bias[row];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B && b == lane) {
        const size_t o = (size_t)b * R + row;
        const float mn = brds::delta_update(m[o], ax[b], ah[b]);
        m_out[o] = mn;
        zs[jl][gate][b] = __fadd_rn(mn, bb);   // the chained m + bias
      }
  }
  __syncthreads();
  close_cells<NB>(zs, H, B, c_prev, c_out, h_out, act);
}

template <typename CT, typename IX, typename IH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_step_q8_kernel(const CT* __restrict__ vx, const IX* __restrict__ ix,
                     int kx, const float* __restrict__ comb_x,
                     const CT* __restrict__ qx, int X,
                     const CT* __restrict__ vh, const IH* __restrict__ ih,
                     int kh, const float* __restrict__ comb_h,
                     const CT* __restrict__ qh, int H,
                     const float* __restrict__ bias,
                     const float* __restrict__ c_prev,
                     float* __restrict__ c_out, float* __restrict__ h_out,
                     int B, brds::Act act) {
  if constexpr (kTiled) {
    qx = brds::tile_rows(qx, X);
    qh = brds::tile_rows(qh, H);
    c_prev = brds::tile_rows(c_prev, H);
    c_out = brds::tile_rows(c_out, H);
    h_out = brds::tile_rows(h_out, H);
    B = brds::tile_batch(B);
  }
  __shared__ float zs[kJT][4][NB];
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int j = blockIdx.x * kJT + jl;
  if (j < H) {
    const int row = gate * H + j;
    uint32_t ax[NB] = {}, ah[NB] = {};
    brds::row_dot<IX, NB>(vx + (size_t)row * kx, ix + (size_t)row * kx, kx,
                          brds::CodeAct<CT>{qx, X}, B, ax);
    brds::row_dot<IH, NB>(vh + (size_t)row * kh, ih + (size_t)row * kh, kh,
                          brds::CodeAct<CT>{qh, H}, B, ah);
    const float cx = comb_x[row], ch = comb_h[row], bb = bias[row];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B && b == lane)   // the chained zx + zh + bias
        zs[jl][gate][b] = __fadd_rn(__fadd_rn(brds::dequant(ax[b], cx),
                                              brds::dequant(ah[b], ch)),
                                    bb);
  }
  __syncthreads();
  close_cells<NB>(zs, H, B, c_prev, c_out, h_out, act);
}

template <typename CT, typename IX, typename IH, int NB, bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_delta_step_q8_kernel(const CT* __restrict__ vx,
                           const IX* __restrict__ ix, int kx,
                           const float* __restrict__ comb_x,
                           const CT* __restrict__ qx, int X,
                           const CT* __restrict__ vh,
                           const IH* __restrict__ ih, int kh,
                           const float* __restrict__ comb_h,
                           const CT* __restrict__ qh, int H,
                           const float* __restrict__ m,
                           const float* __restrict__ bias,
                           const float* __restrict__ c_prev,
                           float* __restrict__ c_out,
                           float* __restrict__ h_out,
                           float* __restrict__ m_out, int B, brds::Act act) {
  if constexpr (kTiled) {
    qx = brds::tile_rows(qx, X);
    qh = brds::tile_rows(qh, H);
    m = brds::tile_rows(m, 4 * H);
    m_out = brds::tile_rows(m_out, 4 * H);
    c_prev = brds::tile_rows(c_prev, H);
    c_out = brds::tile_rows(c_out, H);
    h_out = brds::tile_rows(h_out, H);
    B = brds::tile_batch(B);
  }
  __shared__ float zs[kJT][4][NB];
  const int warp = threadIdx.x / brds::kWarp;
  const int lane = threadIdx.x % brds::kWarp;
  const int jl = warp / 4, gate = warp % 4;
  const int j = blockIdx.x * kJT + jl;
  if (j < H) {
    const int row = gate * H + j;
    const int R = 4 * H;
    uint32_t ax[NB] = {}, ah[NB] = {};
    brds::row_dot<IX, NB>(vx + (size_t)row * kx, ix + (size_t)row * kx, kx,
                          brds::CodeAct<CT>{qx, X}, B, ax);
    brds::row_dot<IH, NB>(vh + (size_t)row * kh, ih + (size_t)row * kh, kh,
                          brds::CodeAct<CT>{qh, H}, B, ah);
    const float cx = comb_x[row], ch = comb_h[row], bb = bias[row];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B && b == lane) {
        const size_t o = (size_t)b * R + row;
        // the integer sums are dequantized first; then the chained
        // m + zx + zh, in that order, and m + bias
        const float mn = brds::delta_update(m[o], brds::dequant(ax[b], cx),
                                            brds::dequant(ah[b], ch));
        m_out[o] = mn;
        zs[jl][gate][b] = __fadd_rn(mn, bb);
      }
  }
  __syncthreads();
  close_cells<NB>(zs, H, B, c_prev, c_out, h_out, act);
}

}  // namespace

extern "C" int brds_fused_lstm_step(const void* vx, const void* dx,
                                    int dx_bytes, int kx, const void* x,
                                    int X, const void* vh, const void* dh,
                                    int dh_bytes, int kh, const void* h,
                                    int H, const void* bias,
                                    const void* c_prev, void* c_out,
                                    void* h_out, int B, const void* lut,
                                    float lo, float hi, float hic,
                                    void* stream) {
  if (H <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H + kJT - 1) / kJT, brds::batch_tiles(B));
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = brds::by_delta(dx_bytes, [&](auto dxt) {
    using DX = decltype(dxt);
    return brds::by_delta(dh_bytes, [&](auto dht) {
      using DH = decltype(dht);
      return brds::by_batch(B, [&](auto nb, auto tiled) {
        constexpr int NB = decltype(nb)::value;
        fused_step_kernel<DX, DH, NB, decltype(tiled)::value>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(vx), static_cast<const DX*>(dx), kx,
                static_cast<const float*>(x), X,
                static_cast<const float*>(vh), static_cast<const DH*>(dh), kh,
                static_cast<const float*>(h), H,
                static_cast<const float*>(bias),
                static_cast<const float*>(c_prev), static_cast<float*>(c_out),
                static_cast<float*>(h_out), B, act);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_fused_delta_lstm_step(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* dx,
    const void* fx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* dh, const void* fh, int H, const void* m,
    const void* bias, const void* c_prev, void* c_out, void* h_out,
    void* m_out, int B, const void* lut, float lo, float hi, float hic,
    void* stream) {
  if (H <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H + kJT - 1) / kJT, brds::batch_tiles(B));
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = brds::by_delta(ix_bytes, [&](auto ixt) {
    using IX = decltype(ixt);
    return brds::by_delta(ih_bytes, [&](auto iht) {
      using IH = decltype(iht);
      return brds::by_batch(B, [&](auto nb, auto tiled) {
        constexpr int NB = decltype(nb)::value;
        fused_delta_step_kernel<IX, IH, NB, decltype(tiled)::value>
            <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(vx), static_cast<const IX*>(ix),
                kx, static_cast<const float*>(dx),
                static_cast<const float*>(fx), X,
                static_cast<const float*>(vh), static_cast<const IH*>(ih),
                kh, static_cast<const float*>(dh),
                static_cast<const float*>(fh), H,
                static_cast<const float*>(m),
                static_cast<const float*>(bias),
                static_cast<const float*>(c_prev), static_cast<float*>(c_out),
                static_cast<float*>(h_out), static_cast<float*>(m_out), B,
                act);
        return cudaSuccess;
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_fused_lstm_step_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    const void* bias, const void* c_prev, void* c_out, void* h_out, int B,
    const void* lut, float lo, float hi, float hic, void* stream) {
  if (H <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H + kJT - 1) / kJT, brds::batch_tiles(B));
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_delta(ix_bytes, [&](auto ixt) {
      using IX = decltype(ixt);
      return brds::by_delta(ih_bytes, [&](auto iht) {
        using IH = decltype(iht);
        return brds::by_batch(B, [&](auto nb, auto tiled) {
          constexpr int NB = decltype(nb)::value;
          fused_step_q8_kernel<CT, IX, IH, NB, decltype(tiled)::value>
              <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  static_cast<const CT*>(vx), static_cast<const IX*>(ix), kx,
                  static_cast<const float*>(comb_x),
                  static_cast<const CT*>(qx), X, static_cast<const CT*>(vh),
                  static_cast<const IH*>(ih), kh,
                  static_cast<const float*>(comb_h),
                  static_cast<const CT*>(qh), H,
                  static_cast<const float*>(bias),
                  static_cast<const float*>(c_prev),
                  static_cast<float*>(c_out), static_cast<float*>(h_out), B,
                  act);
          return cudaSuccess;
        });
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

extern "C" int brds_fused_delta_lstm_step_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    const void* m, const void* bias, const void* c_prev, void* c_out,
    void* h_out, void* m_out, int B, const void* lut, float lo, float hi,
    float hic, void* stream) {
  if (H <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H + kJT - 1) / kJT, brds::batch_tiles(B));
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_delta(ix_bytes, [&](auto ixt) {
      using IX = decltype(ixt);
      return brds::by_delta(ih_bytes, [&](auto iht) {
        using IH = decltype(iht);
        return brds::by_batch(B, [&](auto nb, auto tiled) {
          constexpr int NB = decltype(nb)::value;
          fused_delta_step_q8_kernel<CT, IX, IH, NB, decltype(tiled)::value>
              <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  static_cast<const CT*>(vx), static_cast<const IX*>(ix), kx,
                  static_cast<const float*>(comb_x),
                  static_cast<const CT*>(qx), X, static_cast<const CT*>(vh),
                  static_cast<const IH*>(ih), kh,
                  static_cast<const float*>(comb_h),
                  static_cast<const CT*>(qh), H,
                  static_cast<const float*>(m),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(c_prev),
                  static_cast<float*>(c_out), static_cast<float*>(h_out),
                  static_cast<float*>(m_out), B, act);
          return cudaSuccess;
        });
      });
    });
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}
