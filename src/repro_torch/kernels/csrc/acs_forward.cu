// K1 — fused radix-2^rho Viterbi ACS forward pass, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `acs_forward_pallas` (body `_acs_kernel`)
// in src/repro/kernels/viterbi_acs.py, both of its semirings.  Same
// contract: for each of T radix steps, per frame f and state j,
//
//     pot[r]   = sum_k x[k] * W[k, j*R + r],   x = [L_t | Lambda] (B+S)
//     Lambda'  = max_r pot[r]     (LOGPROB: the logsumexp over r)
//     phi[t,f,j] = first argmax_r pot[r]
//
// with x rounded to the matmul dtype, products and sums in f32 (no TF32),
// an optional per-frame max subtraction, and the carry rounded to the
// carry dtype.  phi is written as int8 slots, or 16 slots per int32 word at
// SLOT_BITS[R] bits each.
//
// One kernel, acs_gather_kernel<R, NQ, WIDE, SEMI>, at both semirings:
// acs_step.cuh's gathered step.  It takes no W, only the distinct columns
// of Theta (W's LLR half) and each column's index among them; its wrapper
// has checked that W's metric half is the shift register's one-hot and
// raises on any other W (there is no dense fallback).  Per (frame, step)
// the n_u branch metrics are formed once, each potential is one add of a
// branch metric and the one predecessor metric, read from shared memory:
// the bits of the dense product (acs_step.cuh).  At TROPICAL the slot
// value is the argmax chain's max; at LOGPROB (SEMI = kLogprob, the
// reference's `_acs_kernel` with semiring="logprob", its
// `forward_fused(semiring=LOGPROB, use_kernel=True)`) reduce_slots's
// max-normalised logsumexp of the same potentials: 1 and the R - 1 other
// terms' accurate expf in the tournament's order, then log_of_sum, no fast
// math.  The potentials are bit for bit the plain version's, so the
// survivors differ only where the carried metrics' rounding moves a
// near-tie.
//
// Design:
//   * a frame's S states over S/NQ threads, kGatherWarps warps a block
//     where a frame fits in a warp (NQ = 2 from S = 64: one warp a frame
//     at S = 64, two states a lane); the threads of a frame exchange the
//     metrics through shared memory with a warp barrier a step and no
//     block barrier; where a frame spans warps (S/NQ > 32) a block is one
//     frame and the barrier the named frame barrier.  One state a lane at
//     S = 64 (a frame over two warps, half the expf a lane, the frame max
//     and barrier across warps) took 1.4-1.5x as long at LOGPROB on an
//     H100, at 64 and at 512 frames (tools/k12_variants.py builds it), so
//     NQ is gather_nq's at both semirings;
//   * the renorm max: redux.sync over order-preserving integer keys (one
//     instruction at 32 threads a frame), shuffles below, shared memory
//     across a wide frame's warps;
//   * LLRs: a stage of up to kStageSteps steps is copied with cp.async
//     while the previous stage runs; its branch metrics are formed at
//     the stage's start, off the steps' serial chain;
//   * survivors are staged in shared memory for a stage and written as
//     16-byte stores (int8 (T, F, S), or packed (T, F, S/16) words).
//
// What bounds it on this card, counted from the work the step needs
// (chip_smoke.py's `acs_bound`): per frame-step the 16 distinct branch
// metrics once (2 operations per nonzero weight: 128 at ccsds-k7,
// rho=2), then per state R adds and R-1 compares, and the renorm's 2S-1:
// 703 f32 operations.  At the decode_64k shape (512 frames x 32768 steps)
// that is 0.176 ms at the 67 TFLOP/s non-tensor f32 peak, against 0.401
// ms for the bytes (256 MiB of LLRs in, 1 GiB of int8 survivors out, at
// 3.35 TB/s): bound by bytes.  But the work has a serial floor that
// neither bound shows: step t+1's metrics need step t's, and a step of
// one frame is a chain of dependent operations (the predecessor load,
// the add, the compares, the renorm's reduction, the rounding and the
// store of the next metrics, the warp barrier) of roughly 60-100 clocks.
// With 512 frames a step holds only 512 x 64 = 32,768 (frame, state)
// updates, so the card is about 12% occupied whatever the design, and
// the floor is 32,768 steps x that chain: 1.1-1.9 ms at 1.755 GHz.  K1
// at decode_64k cannot reach half its 0.401 ms bytes bound.  The
// time-parallel recovery (8192 frames x 512 steps) has the parallelism
// instead and is bound by the shared-memory and instruction throughput
// of its steps.
// At LOGPROB each state adds R-1 expf at the special-function rate (16 a
// clock per SM, 132 SMs at 1.98 GHz: 4.18e12/s) and 2R f32 operations: at
// 64 frames x 32768 steps 0.096 ms of special functions against 0.045 ms
// of bytes, bound by operations.  The serial floor rules there even more:
// 64 frames fill 16 blocks of four warps on 132 SMs, and the chain of a
// step grows by the tournament, an expf (range reduction, ex2, scale), the
// sum of R terms and log_of_sum's dozen dependent fmas: on an H100 (700 W)
// 32,768 steps take about 10.5 ms, 320 ns a step against the tropical
// step's 245, about 1% of the 0.096 ms bound.
#include "acs_step.cuh"

namespace {

using namespace acs;

template <int R, int NQ, bool WIDE, int SEMI>
__global__ void __launch_bounds__(kGatherMaxThreads) acs_gather_kernel(
    const float* __restrict__ blocks,  // (T, F, B)
    const float* __restrict__ lam0,    // (F, S)
    const float* __restrict__ cols,    // (B, n_u): Theta's distinct columns
    const int16_t* __restrict__ cid,   // (S*R): column -> distinct column
    float* __restrict__ lam_out,       // (F, S)
    int8_t* __restrict__ phi8,         // (T, F, S), or null when packed
    int32_t* __restrict__ phi32,       // (T, F, S/16), or null when unpacked
    int T, int F, int B, int S_run, int n_u, int SS, int mm_dtype,
    int carry_dtype, int renorm, int slot_bits) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  constexpr int kS = fixed_states<NQ, WIDE>();
  const int S = kS ? kS : S_run;
  const GatherShape sh(S);
  const GroupSmem L(S, B, n_u, SS, sh.gf, false);
  const Group g(sh, F, L.bytes, gsmem);
  // a warp whose frames all lie past F (no block barrier where a frame
  // fits in a warp; a wide block is one live frame)
  if (g.live == 0) return;
  float* l_s = reinterpret_cast<float*>(g.base + L.llr);
  float* bm_s = reinterpret_cast<float*>(g.base + L.bm);
  float* x_s = reinterpret_cast<float*>(g.base + L.x);
  unsigned char* phi_s = g.base + L.phi;
  float* red = reinterpret_cast<float*>(g.base + L.red);
  const int gf = g.sh.gf, tpf = g.sh.tpf;
  const bool live = g.fl < g.live;
  const long long frame = g.first + g.fl;
  const int gR = (g.t & (S / R - 1)) * R;  // the states' predecessors gR ..
  pin(mm_dtype);
  pin(carry_dtype);
  pin(renorm);

  int cidr[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) cidr[q][r] = cid[(g.t + q * tpf) * R + r];

  float lam[NQ];
  float* xf = x_s + g.fl * S;  // buffer 0 of the frame's metrics; 1 at + gf*S
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int j = g.t + q * tpf;
    lam[q] = live ? round_to(lam0[frame * S + j], carry_dtype) : 0.f;
    xf[j] = round_to(lam[q], mm_dtype);
  }
  if (T > 0) stage_llrs(l_s, blocks, 0, min(SS, T), F, B, g);
  int cb = 0;
  for (int t0 = 0; t0 < T; t0 += SS) {
    const int steps = min(SS, T - t0);
    cp_async_wait_all();
    g.sync();  // the stage's LLRs (and at first the start metrics) visible
    stage_branch_metrics(bm_s, l_s, cols, steps, B, n_u, mm_dtype, g);
    g.sync();  // branch metrics visible; every read of l_s done
    if (t0 + SS < T) stage_llrs(l_s, blocks, t0 + SS, min(SS, T - t0 - SS), F, B, g);
    for (int s = 0; s < steps; ++s) {
      gather_step<R, NQ, false, SEMI>(bm_s + (s * gf + g.fl) * n_u, cidr,
                                      xf + cb * gf * S, xf + (cb ^ 1) * gf * S,
                                      phi_s + (size_t)(s * gf + g.fl) * S, lam, gR,
                                      S, mm_dtype, carry_dtype, renorm, g, red);
      cb ^= 1;
    }
    // the stage's survivors out (the last step's barrier made them visible)
    flush_survivors(phi_s, steps, S, phi32 != nullptr, slot_bits, g,
                    [&](int s, int f) -> void* {
                      const long long r = (long long)(t0 + s) * F + g.first + f;
                      return phi32 != nullptr ? (void*)(phi32 + r * (S / 16))
                                              : (void*)(phi8 + r * S);
                    });
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) lam_out[frame * S + g.t + q * tpf] = lam[q];
  }
}

template <int R, int NQ, bool WIDE, int SEMI>
cudaError_t launch_gather(const float* blocks, const float* lam0,
                          const float* cols, const int16_t* cid, float* lam_out,
                          void* phi, int T, int F, int B, int S, int n_u,
                          int SS, int mm_dtype, int carry_dtype, int renorm,
                          int packed, long long smem_bytes, cudaStream_t stream) {
  const GatherShape sh(S);
  const size_t smem = (size_t)sh.groups * GroupSmem(S, B, n_u, SS, sh.gf, false).bytes;
  if ((long long)smem != smem_bytes) return cudaErrorInvalidValue;
  auto kernel = acs_gather_kernel<R, NQ, WIDE, SEMI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kSlotBits = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const dim3 grid((unsigned)((F + sh.frames - 1) / sh.frames));
  kernel<<<grid, sh.threads, smem, stream>>>(
      blocks, lam0, cols, cid, lam_out,
      packed ? nullptr : static_cast<int8_t*>(phi),
      packed ? static_cast<int32_t*>(phi) : nullptr, T, F, B, S, n_u, SS,
      mm_dtype, carry_dtype, renorm, kSlotBits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 (the gathered step) on `stream` (a cudaStream_t) and returns
// the launch's cudaError_t.  Does not synchronise and allocates nothing:
// the caller owns every buffer.  cols: Theta's n_u distinct columns (B,
// n_u); cid: each of the S*R columns' index among them (the caller has
// checked that W's metric half is the shift register's one-hot); SS: the
// stage's steps and `smem_bytes` its layout (kernel_geometry.
// gather_stage_steps and k1_smem_bytes; another count is refused);
// `semiring` kTropical (0) or kLogprob (1).  S a power of two in [R,
// 1024]; S % 16 == 0 and R <= 4 when `packed`.
int acs_forward_gather_launch(const float* blocks, const float* lam0,
                              const float* cols, const int16_t* cid,
                              float* lam_out, void* phi, int T, int F, int B,
                              int S, int R, int n_u, int SS, int mm_dtype,
                              int carry_dtype, int renorm, int packed,
                              int semiring, long long smem_bytes, int device,
                              void* stream) {
  if (!gather_shape_ok(B, S, R, n_u, SS) || T < 0 || F <= 0 ||
      (packed && (S % 16 != 0 || R > 4)) ||
      (semiring != kTropical && semiring != kLogprob))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_radix_and_nq(R, S, [&](auto r, auto q, auto wide) -> cudaError_t {
    constexpr int kR = decltype(r)::value;
    constexpr int kNQ = decltype(q)::value;
    constexpr bool kWide = decltype(wide)::value;
#define K1_ARGS                                                                \
  blocks, lam0, cols, cid, lam_out, phi, T, F, B, S, n_u, SS, mm_dtype,       \
      carry_dtype, renorm, packed, smem_bytes, s
    if (semiring == kLogprob) return launch_gather<kR, kNQ, kWide, kLogprob>(K1_ARGS);
    return launch_gather<kR, kNQ, kWide, kTropical>(K1_ARGS);
#undef K1_ARGS
  });
}

const char* acs_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
