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
// block owns hidden units j and computes their four gate rows j, H+j,
// 2H+j, 3H+j, keeps z in shared memory, and closes the cell in-block with
// the same brds::lstm_cell as lstm_gates. Each step is bitwise equal to
// its chained pair: rb_dual_spmv / delta_rb_dual_spmv / rb_dual_parts_q8
// (then m + zx + zh for the delta q8 step), then the bias add in PyTorch
// (the float step's bias is added inside rb_dual_spmv), then lstm_gates.
//  - The float and delta steps (fused_staged_kernel, the delta step a
//    compile-time flag): one block an SM with `units` hidden units
//    (kernels/plan.py::stream_plan), x and h (the delta step: the masked
//    deltas) staged in shared memory once a block, the rows streamed with
//    loads in flight by brds::row_dot_stream, the routine of the chained
//    rb_dual_spmv and delta_rb_dual_spmv: row_dot's order, so z (m') is
//    the chained value bit for bit; z = (zx + zh) + bias (the delta step:
//    m', then z = m' + bias) is made in the epilogue, c_prev, the bias
//    and m read there only. B12 (fused_scan.cu) keeps the same order, so
//    it equals T launches of the float step.
//  - The q8 and delta-q8 steps (fused_step_q8_kernel, the delta step a
//    compile-time flag): one block an SM with `units` hidden units
//    (kernels/plan.py::q8_plan), the gate rows run by brds::q8_rows_block,
//    the routine of the chained rb_dual_parts_q8: activation codes staged
//    in shared memory, four entries a lane (brds::row_dot_q8x4's
//    arithmetic, __dp4a for int8 codes), a warp's rows streamed with
//    their loads in flight. Integer sums are exact in any order, so the
//    float epilogue sees the chained values; the q8 step makes z = (zx +
//    zh) + bias as each row ends, the delta step keeps zx and zh apart in
//    shared memory and makes m' and z in the epilogue, m read there only.
//
// Bound: bytes, as the chained gate kernels: the packed weights are read
// once; z, c and h never round-trip through device memory between the two
// stages. What the staged designs pay beyond the bytes: each block stages
// all of x and h (or d*f, or the codes) before its first product, and
// shared loads of random columns meet about two lanes on a bank slot
// (tests/test_torch_plan.py); a warp's next loads stay in flight
// (PERF.md has the card's times).
#include "brds_common.cuh"

namespace {

// The fused q8 step's arguments (one struct: the kernel takes one of
// every instantiation's parameters by value): the staged q8 routine's
// inputs, then the cell's and the delta step's.
template <typename CT>
struct Q8Args {
  brds::Q8In<CT> in;
  const float* bias;
  const float* c_prev;
  float* c_out;
  float* h_out;
  const float* m;     // (B, 4H): the delta step's partial-sum memory
  float* m_out;       // ... and m' (null for the plain q8 step)
  int units;          // hidden units a block
  brds::Act act;
};

// Row i of a block's 4 * units gate rows: unit i / 4, gate i % 4.
__device__ __forceinline__ int gate_row(int i, int H, int j0) {
  return (i & 3) * H + j0 + (i >> 2);
}

// The q8 step's emit policy: gate row i's chained z = (zx + zh) + bias in
// zs, lane b < B for batch row b; the bias is the row's constant.
struct Q8Sum {
  using Row = float;
  float* zs;
  const float* bias;
  int NB, B;
  __device__ __forceinline__ float consts(int row) const { return bias[row]; }
  __device__ __forceinline__ void operator()(int i, float zx, float zh,
                                             float bb) const {
    const int lane = threadIdx.x % brds::kWarp;
    if (lane < B) zs[i * NB + lane] = __fadd_rn(__fadd_rn(zx, zh), bb);
  }
};

// kDelta: the delta step (B9), whose codes are those of the masked deltas;
// its rows leave zx and zh apart (brds::Q8Apart) and its epilogue makes
// m' = (m + zx) + zh and z = m' + bias per gate row and batch row, as the
// chained rb_dual_parts_q8 -> m + zx + zh -> + bias.
template <typename CT, int NB, bool kTiled, bool kStaged, bool kDelta>
__global__ void __launch_bounds__(brds::kQ8Threads, 1)
fused_step_q8_kernel(Q8Args<CT> a) {
  const int H = a.in.H;
  if constexpr (kTiled) {
    brds::tile_q8_in(a.in);
    a.c_prev = brds::tile_rows(a.c_prev, H);
    a.c_out = brds::tile_rows(a.c_out, H);
    a.h_out = brds::tile_rows(a.h_out, H);
    if constexpr (kDelta) {
      a.m = brds::tile_rows(a.m, 4 * H);
      a.m_out = brds::tile_rows(a.m_out, 4 * H);
    }
  }
  extern __shared__ uint4 q8_smem[];
  uint32_t* codes = reinterpret_cast<uint32_t*>(q8_smem);
  float* zs = reinterpret_cast<float*>(
      codes + brds::q8_staged_words<NB, kStaged>(a.in));
  float* zh_s = zs + 4 * a.units * NB;   // the delta step's zh
  const int B = a.in.B;
  const int j0 = blockIdx.x * a.units;
  const int nrows = 4 * min(a.units, H - j0);
  const auto row_of = [&](int i) { return gate_row(i, H, j0); };
  if constexpr (kDelta)
    brds::q8_rows_block<NB, kStaged>(a.in, codes, nrows, row_of,
                                     brds::Q8Apart{zs, zh_s, NB, B});
  else
    brds::q8_rows_block<NB, kStaged>(a.in, codes, nrows, row_of,
                                     Q8Sum{zs, a.bias, NB, B});
  __syncthreads();
  for (int t = threadIdx.x; t < a.units * B; t += brds::kQ8Threads) {
    const int jl = t / B, b = t % B, j = j0 + jl;
    if (j < H) {
      const size_t o = (size_t)b * H + j;
      const float* z = zs + jl * 4 * NB + b;
      if constexpr (kDelta) {
        // m, the bias and m' touched only here, after every row's loads
        const float* zh = zh_s + jl * 4 * NB + b;
        float zd[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int row = g * H + j;
          const size_t mo = (size_t)b * 4 * H + row;
          const float mn = brds::delta_update(a.m[mo], z[g * NB], zh[g * NB]);
          a.m_out[mo] = mn;
          zd[g] = __fadd_rn(mn, a.bias[row]);   // the chained m' + bias
        }
        brds::lstm_cell(zd[0], zd[1], zd[2], zd[3], a.c_prev[o], a.act,
                        a.c_out + o, a.h_out + o);
      } else {
        brds::lstm_cell(z[0], z[NB], z[2 * NB], z[3 * NB], a.c_prev[o],
                        a.act, a.c_out + o, a.h_out + o);
      }
    }
  }
}

// The float step (B3) and, kDelta, the fused delta step (B5): one block
// an SM with `units` hidden units (kernels/plan.py::stream_plan), x and h
// (the masked deltas) staged in shared memory and the gate rows streamed
// in row_dot's order (brds::stream_rows_block, the routine of the chained
// rb_dual_spmv and delta_rb_dual_spmv), then per (unit, batch row) z =
// (ax + ah) + bias (the delta step: m' = delta_update(m, ax, ah), z = m' +
// bias) and the cell; c_prev, the bias and m are read only there.
template <bool kDelta>
struct StepArgs {
  brds::StreamIn<std::conditional_t<kDelta, brds::DeltaSrc, brds::F32Src>>
      in;
  const float* m;     // (B, 4H): the delta step's partial-sum memory
  const float* bias;
  const float* c_prev;
  float* c_out;
  float* h_out;
  float* m_out;       // ... and m' (null for the float step)
  int units;          // hidden units a block
  brds::Act act;
};

template <int NB, bool kTiled, bool kDelta>
__global__ void __launch_bounds__(brds::kStreamThreads, 1)
fused_staged_kernel(StepArgs<kDelta> a) {
  const int H = a.in.H;
  if constexpr (kTiled) {
    brds::tile_stream_in(a.in);
    if constexpr (kDelta) {
      a.m = brds::tile_rows(a.m, 4 * H);
      a.m_out = brds::tile_rows(a.m_out, 4 * H);
    }
    a.c_prev = brds::tile_rows(a.c_prev, H);
    a.c_out = brds::tile_rows(a.c_out, H);
    a.h_out = brds::tile_rows(a.h_out, H);
  }
  extern __shared__ float4 stream_smem[];
  float* zx = reinterpret_cast<float*>(stream_smem +
                                       brds::staged_float4s(a.in, NB));
  float* zh = zx + 4 * a.units * NB;
  const int B = a.in.B, j0 = blockIdx.x * a.units;
  brds::stream_rows_block<NB>(a.in, stream_smem, 4 * min(a.units, H - j0),
                              [&](int i) { return gate_row(i, H, j0); }, zx,
                              zh);
  for (int t = threadIdx.x; t < a.units * B; t += brds::kStreamThreads) {
    const int jl = t / B, b = t % B, j = j0 + jl;
    if (j >= H) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {   // gate_row(4 jl + g) = g H + j
      const int row = g * H + j, i = (4 * jl + g) * NB + b;
      if constexpr (kDelta) {
        const size_t mo = (size_t)b * 4 * H + row;
        const float mn = brds::delta_update(a.m[mo], zx[i], zh[i]);
        a.m_out[mo] = mn;
        z[g] = __fadd_rn(mn, a.bias[row]);   // the chained m' + bias
      } else {
        // rb_dual_spmv's z (and rb_spmv's two sums plus the bias); z
        // would round through x's dtype here, the identity for float32
        z[g] = __fadd_rn(__fadd_rn(zx[i], zh[i]), a.bias[row]);
      }
    }
    const size_t o = (size_t)b * H + j;
    brds::lstm_cell(z[0], z[1], z[2], z[3], a.c_prev[o], a.act, a.c_out + o,
                    a.h_out + o);
  }
}

// Runs `body(kern)` with the float (kDelta: delta) step's instantiation for
// batch B.
template <bool kDelta, typename F>
cudaError_t by_staged_kernel(int B, F&& body) {
  return brds::by_batch(B, [&](auto nb, auto tiled) {
    return body(fused_staged_kernel<decltype(nb)::value,
                                    decltype(tiled)::value, kDelta>);
  });
}

// One launch on kernels/plan.py::stream_plan's arguments (units a block,
// the staged layout, the dynamic shared memory).
template <bool kDelta>
cudaError_t launch_staged(const StepArgs<kDelta>& a, int smem, void* stream) {
  if (a.in.H <= 0 || a.units <= 0) return cudaErrorInvalidValue;
  const dim3 grid((a.in.H + a.units - 1) / a.units,
                  brds::batch_tiles(a.in.B));
  cudaError_t st = by_staged_kernel<kDelta>(a.in.B, [&](auto kern) {
    cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
    if (e != cudaSuccess) return e;
    kern<<<grid, brds::kStreamThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
    return cudaSuccess;
  });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// For the float (kDelta: delta) step's instantiation of batch B:
// out[0..3] as brds::kernel_info gives them, with `smem` bytes of dynamic
// shared memory.
template <bool kDelta>
cudaError_t staged_info(int B, int smem, int* out) {
  return by_staged_kernel<kDelta>(B, [&](auto kern) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kStreamThreads, smem, out);
  });
}

}  // namespace

extern "C" int brds_fused_lstm_step(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* x,
    int X, const void* vh, const void* ih, int ih_bytes, int kh,
    const void* h, int H, const void* bias, const void* c_prev, void* c_out,
    void* h_out, int B, int units, int stage_x, int stage_h, int shift_x,
    int shift_h, int slot_bits, int xpad, int hpad, int smem,
    const void* lut, float lo, float hi, float hic, void* stream) {
  const StepArgs<false> a{
      {static_cast<const float*>(vx), ix, ix_bytes, kx,
       {static_cast<const float*>(x)}, X, static_cast<const float*>(vh), ih,
       ih_bytes, kh, {static_cast<const float*>(h)}, H, B, stage_x, stage_h,
       shift_x, shift_h, slot_bits, xpad, hpad},
      nullptr, static_cast<const float*>(bias),
      static_cast<const float*>(c_prev), static_cast<float*>(c_out),
      static_cast<float*>(h_out), nullptr, units,
      brds::Act{static_cast<const float*>(lut), lo, hi, hic}};
  return launch_staged(a, smem, stream);
}

extern "C" int brds_fused_lstm_step_info(int B, int smem, int* out) {
  return staged_info<false>(B, smem, out);
}

// The same launch plan's arguments, with the deltas and masks in the place
// of x and h, plus m (B, 4H) and m_out.
extern "C" int brds_fused_delta_lstm_step(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* dx,
    const void* fx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* dh, const void* fh, int H, const void* m,
    const void* bias, const void* c_prev, void* c_out, void* h_out,
    void* m_out, int B, int units, int stage_x, int stage_h, int shift_x,
    int shift_h, int slot_bits, int xpad, int hpad, int smem,
    const void* lut, float lo, float hi, float hic, void* stream) {
  const StepArgs<true> a{
      {static_cast<const float*>(vx), ix, ix_bytes, kx,
       {static_cast<const float*>(dx), static_cast<const float*>(fx)}, X,
       static_cast<const float*>(vh), ih, ih_bytes, kh,
       {static_cast<const float*>(dh), static_cast<const float*>(fh)}, H, B,
       stage_x, stage_h, shift_x, shift_h, slot_bits, xpad, hpad},
      static_cast<const float*>(m), static_cast<const float*>(bias),
      static_cast<const float*>(c_prev), static_cast<float*>(c_out),
      static_cast<float*>(h_out), static_cast<float*>(m_out), units,
      brds::Act{static_cast<const float*>(lut), lo, hi, hic}};
  return launch_staged(a, smem, stream);
}

extern "C" int brds_fused_delta_lstm_step_info(int B, int smem, int* out) {
  return staged_info<true>(B, smem, out);
}

namespace {

// Runs `body(kern, CT{})` with the fused q8 kernel instantiation for the
// code width, batch, staging and step (delta or not; brds::by_batch's
// tiers).
template <typename F>
cudaError_t by_q8_kernel(int code_bytes, int B, int staged, int delta,
                         F&& body) {
  return brds::by_code(code_bytes, [&](auto ct) {
    using CT = decltype(ct);
    return brds::by_batch(B, [&](auto nb, auto tiled) {
      constexpr int NB = decltype(nb)::value;
      constexpr bool kT = decltype(tiled)::value;
      void (*kern)(Q8Args<CT>) =
          delta ? (staged ? fused_step_q8_kernel<CT, NB, kT, true, true>
                          : fused_step_q8_kernel<CT, NB, kT, false, true>)
                : (staged ? fused_step_q8_kernel<CT, NB, kT, true, false>
                          : fused_step_q8_kernel<CT, NB, kT, false, false>);
      return body(kern, CT{});
    });
  });
}

// One launch of the fused q8 kernel on kernels/plan.py::q8_plan's
// arguments; the delta step when m is given (m_out then too).
cudaError_t launch_q8(const void* vx, const void* ix, int ix_bytes, int kx,
                      const void* comb_x, const void* qx, int X,
                      const void* vh, const void* ih, int ih_bytes, int kh,
                      const void* comb_h, const void* qh, int H,
                      int code_bytes, const void* m, const void* bias,
                      const void* c_prev, void* c_out, void* h_out,
                      void* m_out, int B, int units, int staged, int shift_x,
                      int shift_h, int slot_bits, int xpad, int hpad,
                      int smem, const void* lut, float lo, float hi,
                      float hic, void* stream) {
  if (H <= 0 || units <= 0 || (m == nullptr) != (m_out == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((H + units - 1) / units, brds::batch_tiles(B));
  const brds::Act act{static_cast<const float*>(lut), lo, hi, hic};
  cudaError_t st = by_q8_kernel(
      code_bytes, B, staged, m != nullptr, [&](auto kern, auto ct) {
        using CT = decltype(ct);
        cudaError_t e = brds::allow_smem(reinterpret_cast<const void*>(kern));
        if (e != cudaSuccess) return e;
        const Q8Args<CT> a{
            {static_cast<const CT*>(vx), ix, ix_bytes, kx,
             static_cast<const float*>(comb_x), static_cast<const CT*>(qx), X,
             static_cast<const CT*>(vh), ih, ih_bytes, kh,
             static_cast<const float*>(comb_h), static_cast<const CT*>(qh), H,
             B, shift_x, shift_h, slot_bits, xpad, hpad},
            static_cast<const float*>(bias),
            static_cast<const float*>(c_prev), static_cast<float*>(c_out),
            static_cast<float*>(h_out), static_cast<const float*>(m),
            static_cast<float*>(m_out), units, act};
        kern<<<grid, brds::kQ8Threads, smem,
               static_cast<cudaStream_t>(stream)>>>(a);
        return cudaSuccess;
      });
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

}  // namespace

extern "C" int brds_fused_lstm_step_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    const void* bias, const void* c_prev, void* c_out, void* h_out, int B,
    int units, int staged, int shift_x, int shift_h, int slot_bits, int xpad,
    int hpad, int smem, const void* lut, float lo, float hi, float hic,
    void* stream) {
  return launch_q8(vx, ix, ix_bytes, kx, comb_x, qx, X, vh, ih, ih_bytes, kh,
                   comb_h, qh, H, code_bytes, nullptr, bias, c_prev, c_out,
                   h_out, nullptr, B, units, staged, shift_x, shift_h,
                   slot_bits, xpad, hpad, smem, lut, lo, hi, hic, stream);
}

// The same launch plan's arguments, plus m (B, 4H) and m_out.
extern "C" int brds_fused_delta_lstm_step_q8(
    const void* vx, const void* ix, int ix_bytes, int kx, const void* comb_x,
    const void* qx, int X, const void* vh, const void* ih, int ih_bytes,
    int kh, const void* comb_h, const void* qh, int H, int code_bytes,
    const void* m, const void* bias, const void* c_prev, void* c_out,
    void* h_out, void* m_out, int B, int units, int staged, int shift_x,
    int shift_h, int slot_bits, int xpad, int hpad, int smem,
    const void* lut, float lo, float hi, float hic, void* stream) {
  if (m == nullptr) return cudaErrorInvalidValue;
  return launch_q8(vx, ix, ix_bytes, kx, comb_x, qx, X, vh, ih, ih_bytes, kh,
                   comb_h, qh, H, code_bytes, m, bias, c_prev, c_out, h_out,
                   m_out, B, units, staged, shift_x, shift_h, slot_bits, xpad,
                   hpad, smem, lut, lo, hi, hic, stream);
}

// For the fused q8 instantiation of (code bytes, B, staged, delta):
// out[0..3] = registers a thread, local (spill) bytes a thread, static
// shared bytes, and the blocks an SM holds with `smem` bytes of dynamic
// shared memory.
extern "C" int brds_fused_lstm_step_q8_info(int code_bytes, int B,
                                            int staged, int delta, int smem,
                                            int* out) {
  return by_q8_kernel(code_bytes, B, staged, delta, [&](auto kern, auto) {
    return brds::kernel_info(reinterpret_cast<const void*>(kern),
                             brds::kQ8Threads, smem, out);
  });
}
