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
//    compile-time flag): one block an SM with `units` hidden units,
//    activation codes staged in shared memory, four entries a lane
//    (brds::row_dot_q8x4's arithmetic, __dp4a for int8 codes). Their
//    integer sums may take another order than rb_dual_parts_q8's and stay
//    exact, so the float epilogue sees the same values; the delta step
//    keeps zx and zh apart in shared memory and makes m' and z in the
//    epilogue, m read there only.
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
// every instantiation's parameters by value).
template <typename CT>
struct Q8Args {
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
  const float* bias;
  const float* c_prev;
  float* c_out;
  float* h_out;
  const float* m;     // (B, 4H): the delta step's partial-sum memory
  float* m_out;       // ... and m' (null for the plain q8 step)
  int B;
  int units;          // hidden units a block
  int shift_x, shift_h, slot_bits, xpad, hpad;   // the staged layout
  brds::Act act;
};

constexpr int kQ8Threads = 512;
constexpr int kQ8Warps = kQ8Threads / brds::kWarp;

// Row i of a block's 4 * units gate rows: unit i / 4, gate i % 4.
__device__ __forceinline__ int gate_row(int i, int H, int j0) {
  return (i & 3) * H + j0 + (i >> 2);
}

// The per-row constants of z: the two families' combined dequant scales
// and the bias.
struct Q8Row {
  float cx, ch, bb;
};

template <typename CT>
__device__ __forceinline__ Q8Row q8_row_consts(const Q8Args<CT>& a, int row) {
  return Q8Row{a.comb_x[row], a.comb_h[row], a.bias[row]};
}

// What gate row i's two dequantized sums leave in shared memory, lane
// b < B for batch row b: the q8 step's chained z = (zx + zh) + bias in zs;
// the delta step's zx in zs and zh in zh_s (m' and z are made in the
// epilogue, after every row's loads).
template <bool kDelta>
struct Q8Emit {
  float* zs;
  float* zh_s;
  int NB, B;
  __device__ __forceinline__ void operator()(int i, float zx, float zh,
                                             float bb) const {
    const int lane = threadIdx.x % brds::kWarp;
    if (lane >= B) return;
    if constexpr (kDelta) {
      zs[i * NB + lane] = zx;
      zh_s[i * NB + lane] = zh;
    } else {
      zs[i * NB + lane] = __fadd_rn(__fadd_rn(zx, zh), bb);
    }
  }
};

// The warp's gate rows i = warp, warp + 16, ..., each family's row in
// turn with brds::row_dot_q8x4: any delta widths.
template <int NB, typename CT, typename Fetch, typename Emit>
__device__ __forceinline__ void q8_rows(const Q8Args<CT>& a, int j0,
                                        const Fetch& fx, const Fetch& fh,
                                        const Emit& emit) {
  const int nrows = 4 * min(a.units, a.H - j0);
  for (int i = threadIdx.x / brds::kWarp; i < nrows; i += kQ8Warps) {
    const int row = gate_row(i, a.H, j0);
    const Q8Row rc = q8_row_consts(a, row);
    uint32_t ax[NB] = {}, ah[NB] = {};
    brds::row_dot_q8x4<NB, 4>(a.vx, a.ix, a.ixb, (size_t)row * a.kx, a.kx,
                              fx, ax);
    brds::row_dot_q8x4<NB, 4>(a.vh, a.ih, a.ihb, (size_t)row * a.kh, a.kh,
                              fh, ah);
    emit(i, brds::dequant(brds::lane_value(ax), rc.cx),
         brds::dequant(brds::lane_value(ah), rc.ch), rc.bb);
  }
}

// The same rows when both families' deltas are of type DT (lstm_ptb's:
// int16), as one stream of G-chunk groups: row i's Sx segment, its Sh
// segment, then row i + 16's, ...; a group's loads are issued before the
// group ahead of it is used, across segment and row boundaries, so a warp
// always has loads in flight.
template <int NB, typename DT, typename CT, typename Fetch, typename Emit>
__device__ __forceinline__ void q8_rows_stream(const Q8Args<CT>& a, int j0,
                                               const Fetch& fx,
                                               const Fetch& fh,
                                               const Emit& emit) {
  constexpr int G = sizeof(CT) == 1 ? 8 : 4;   // chunks a lane loads at once
  const int H = a.H;
  const int nrows = 4 * min(a.units, H - j0);
  int i = threadIdx.x / brds::kWarp;
  if (i >= nrows) return;
  auto off_of = [&](int i, int part) {
    return (size_t)gate_row(i, H, j0) * (part ? a.kh : a.kx);
  };
  auto load = [&](int i, int part, int c0, brds::Q8Group<CT, DT, G>& g) {
    if (part)
      brds::q8x4_load(a.vh, a.ih, a.ihb, off_of(i, 1), a.kh, c0, g);
    else
      brds::q8x4_load(a.vx, a.ix, a.ixb, off_of(i, 0), a.kx, c0, g);
  };
  brds::Q8Group<CT, DT, G> cur, nxt;
  int part = 0, c0 = 0, carry = 0;
  load(i, part, c0, cur);
  Q8Row rc = q8_row_consts(a, gate_row(i, H, j0)), rn = rc;
  uint32_t acc[NB] = {};
  float zx = 0.0f;
  for (;;) {
    const int nchunks =
        brds::q8x4_chunks(off_of(i, part), part ? a.kh : a.kx);
    // the group after this one
    int i2 = i, part2 = part, c2 = c0 + G * brds::kWarp;
    if (c2 >= nchunks) {
      c2 = 0;
      part2 = part ^ 1;
      if (part) i2 += kQ8Warps;
    }
    const bool more = i2 < nrows;
    if (more) {
      load(i2, part2, c2, nxt);
      if (i2 != i) rn = q8_row_consts(a, gate_row(i2, H, j0));
    }
    const Fetch f = part ? fh : fx;   // a copy: no address of either taken
    brds::q8x4_consume<NB>(cur, 0, c0, nchunks, carry, f, acc);
    if (c2 == 0) {   // the segment is complete
      brds::warp_sum(acc);
      const float dq =
          brds::dequant(brds::lane_value(acc), part ? rc.ch : rc.cx);
      if (part) emit(i, zx, dq, rc.bb);
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

// kDelta: the delta step (B9), whose codes are those of the masked deltas;
// its epilogue makes m' = (m + zx) + zh and z = m' + bias per gate row and
// batch row, as the chained rb_dual_parts_q8 -> m + zx + zh -> + bias.
template <typename CT, int NB, bool kTiled, bool kStaged, bool kDelta>
__global__ void __launch_bounds__(kQ8Threads, 1)
fused_step_q8_kernel(Q8Args<CT> a) {
  if constexpr (kTiled) {
    a.qx = brds::tile_rows(a.qx, a.X);
    a.qh = brds::tile_rows(a.qh, a.H);
    a.c_prev = brds::tile_rows(a.c_prev, a.H);
    a.c_out = brds::tile_rows(a.c_out, a.H);
    a.h_out = brds::tile_rows(a.h_out, a.H);
    if constexpr (kDelta) {
      a.m = brds::tile_rows(a.m, 4 * a.H);
      a.m_out = brds::tile_rows(a.m_out, 4 * a.H);
    }
    a.B = brds::tile_batch(a.B);
  }
  using Staged = brds::StagedCodes<CT, NB>;
  constexpr int kW = Staged::kWords;
  extern __shared__ uint4 q8_smem[];
  uint32_t* sx = reinterpret_cast<uint32_t*>(q8_smem);
  uint32_t* sh = sx + (kStaged ? static_cast<size_t>(a.xpad) * kW : 0);
  float* zs = reinterpret_cast<float*>(
      sh + (kStaged ? static_cast<size_t>(a.hpad) * kW : 0));
  const int H = a.H, B = a.B;
  const int j0 = blockIdx.x * a.units;
  if constexpr (kStaged) {
    // column c's NB codes (zero past B) as one vector at stage_pos(c)
    constexpr int per = 4 / sizeof(CT), bits = 8 * sizeof(CT);
    constexpr uint32_t mask = (1u << bits) - 1;
    const int n = a.X + H;
#pragma unroll 3
    for (int c = threadIdx.x; c < n; c += kQ8Threads) {
      const bool isx = c < a.X;
      const int col = isx ? c : c - a.X;
      const CT* q = isx ? a.qx : a.qh;
      const int ld = isx ? a.X : H;
      uint32_t v[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) v[i] = 0;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < B)
          v[b / per] |= (static_cast<uint32_t>(__ldg(q + b * ld + col)) & mask)
                        << (bits * (b % per));
      uint32_t* dst = (isx ? sx : sh) +
                      brds::stage_pos(col, isx ? a.shift_x : a.shift_h,
                                      a.slot_bits) * kW;
#pragma unroll
      for (int i = 0; i < kW; ++i) dst[i] = v[i];
    }
    __syncthreads();
  }
  float* zh_s = zs + 4 * a.units * NB;   // the delta step's zh
  const Q8Emit<kDelta> emit{zs, zh_s, NB, B};
  if constexpr (kStaged) {
    const Staged fx{sx, a.shift_x, a.slot_bits};
    const Staged fh{sh, a.shift_h, a.slot_bits};
    if (a.ixb == 2 && a.ihb == 2)
      q8_rows_stream<NB, int16_t>(a, j0, fx, fh, emit);
    else
      q8_rows<NB>(a, j0, fx, fh, emit);
  } else {
    using Global = brds::GlobalCodes<CT, NB>;
    q8_rows<NB>(a, j0, Global{a.qx, a.X, B}, Global{a.qh, H, B}, emit);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < a.units * B; t += kQ8Threads) {
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
        Q8Args<CT> a{static_cast<const CT*>(vx), ix, ix_bytes, kx,
                     static_cast<const float*>(comb_x),
                     static_cast<const CT*>(qx), X,
                     static_cast<const CT*>(vh), ih, ih_bytes, kh,
                     static_cast<const float*>(comb_h),
                     static_cast<const CT*>(qh), H,
                     static_cast<const float*>(bias),
                     static_cast<const float*>(c_prev),
                     static_cast<float*>(c_out), static_cast<float*>(h_out),
                     static_cast<const float*>(m), static_cast<float*>(m_out),
                     B, units, shift_x, shift_h, slot_bits, xpad, hpad, act};
        kern<<<grid, kQ8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
            a);
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
    return brds::kernel_info(reinterpret_cast<const void*>(kern), kQ8Threads,
                             smem, out);
  });
}
