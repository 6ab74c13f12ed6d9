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
// Two kernels:
//   * acs_gather_kernel, the tropical K1: acs_step.cuh's gathered step.
//     It takes no W, only the distinct columns of Theta (W's LLR half)
//     and each column's index among them; its wrapper has checked that
//     W's metric half is the shift register's one-hot and raises on any
//     other W (there is no dense fallback).  Per (frame, step) the n_u
//     branch metrics are formed once, each potential is one add of a
//     branch metric and the one predecessor metric, read from shared
//     memory: the bits of the dense product (acs_step.cuh).
//   * acs_forward_kernel<R, kLogprob>, K1-LOGPROB, as before: the dense
//     product over all B+S rows of W, which lives in shared memory, one
//     thread per (frame, state), 256/S frames a block and two block
//     barriers a step; the max-normalised logsumexp of acs_step.cuh, as
//     the reference's `_acs_kernel` does with semiring="logprob" (its
//     `forward_fused(semiring=LOGPROB, use_kernel=True)`).  Its
//     instantiation and its bits are those of the port before the
//     gathered step; redesigning it is a later step.
//
// Design of the tropical kernel:
//   * a frame's S states over S/NQ threads (NQ = 2 from S = 64: one warp
//     a frame at S = 64, two states a lane), kGatherWarps warps a block;
//     the threads of a frame exchange the metrics through shared memory
//     with a warp barrier a step and no block barrier; from S = 128 a
//     block is one frame of S/2 threads and the barrier the block's;
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
// The LOGPROB variant adds per state R-1 expf at the special-function
// rate (16 a clock per SM, 132 SMs at 1.98 GHz: 4.18e12/s) and 2R f32
// operations: at 64 frames x 32768 steps 0.096 ms of special functions
// against 0.045 ms of bytes, bound by operations; its dense product
// streams each thread's R columns of W from shared memory every step,
// which is what that kernel runs into.
#include "acs_step.cuh"

namespace {

using namespace acs;

// K1-LOGPROB's dynamic shared memory, in floats.
size_t smem_floats(int B, int S, int R, int BF) {
  return (size_t)(B + S) * S * R             // W
         + (size_t)kStageSteps * BF * B      // staged LLR blocks
         + (size_t)BF * S                    // Lambda, rounded to the matmul dtype
         + (size_t)BF * warps_per_frame(S);  // renorm partial maxima
}

template <int R, int SEMI>
__global__ void __launch_bounds__(1024) acs_forward_kernel(
    const float* __restrict__ blocks,  // (T, F, B)
    const float* __restrict__ lam0,    // (F, S)
    const float* __restrict__ w,       // (B+S, S*R)
    float* __restrict__ lam_out,       // (F, S)
    int8_t* __restrict__ phi8,         // (T, F, S), or null when packed
    int32_t* __restrict__ phi32,       // (T, F, S/16), or null when unpacked
    int T, int F, int B, int S, int BF,
    int mm_dtype, int carry_dtype, int renorm, int slot_bits) {
  extern __shared__ __align__(16) float smem[];
  const int K = B + S;
  const int SR = S * R;
  float* w_s = smem;                              // K * SR
  float* l_s = w_s + (size_t)K * SR;              // kStageSteps * BF * B
  float* x_s = l_s + (size_t)kStageSteps * BF * B;  // BF * S
  float* red_s = x_s + (size_t)BF * S;            // BF * warps_per_frame(S)

  const int tid = threadIdx.x;
  const int fl = tid / S;  // frame within the block
  const int j = tid % S;   // state
  const long long f0 = (long long)blockIdx.x * BF;
  const long long frame = f0 + fl;
  const bool live = frame < F;
  const int nf = F - f0 < BF ? (int)(F - f0) : BF;  // live frames

  for (int i = tid; i < K * SR; i += blockDim.x) w_s[i] = round_to(w[i], mm_dtype);

  float lam = live ? round_to(lam0[frame * S + j], carry_dtype) : 0.f;
  const float* wcol = w_s + j * R;

  for (int t0 = 0; t0 < T; t0 += kStageSteps) {
    // Every read of l_s from the previous stage happened before the last
    // step's closing barrier, so the stage can be overwritten here.
    const int steps = min(kStageSteps, T - t0);
    const int per_step = nf * B;
    for (int i = tid; i < steps * per_step; i += blockDim.x) {
      const int tt = i / per_step;
      const int r = i - tt * per_step;
      l_s[tt * BF * B + r] =
          round_to(blocks[((long long)(t0 + tt) * F + f0) * B + r], mm_dtype);
    }
    for (int tt = 0; tt < steps; ++tt) {
      const long long t = t0 + tt;
      x_s[fl * S + j] = round_to(lam, mm_dtype);
      __syncthreads();  // stage and x_s complete

      int arg;
      float best = acs_best<R, SEMI>(l_s + (tt * BF + fl) * B, x_s + fl * S,
                                     wcol, B, S, arg);

      if (phi32 != nullptr) {
        const unsigned v = pack_word(arg, j, slot_bits);
        if (live && (j & 15) == 0)
          phi32[(t * F + frame) * (S / 16) + (j >> 4)] = (int32_t)v;
      } else if (live) {
        phi8[(t * F + frame) * S + j] = (int8_t)arg;
      }
      best = renorm_sync(best, renorm, tid, j, S, fl, red_s);
      lam = round_to(best, carry_dtype);
    }
  }
  if (live) lam_out[frame * S + j] = lam;
}

// -- the tropical kernel: the gathered step -------------------------------

template <int R, int NQ, bool WIDE>
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
      gather_step<R, NQ, false>(bm_s + (s * gf + g.fl) * n_u, cidr,
                                xf + cb * gf * S, xf + (cb ^ 1) * gf * S,
                                phi_s + (size_t)(s * gf + g.fl) * S, lam, gR, S,
                                mm_dtype, carry_dtype, renorm, g, red);
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

template <int R, int NQ, bool WIDE>
cudaError_t launch_gather(const float* blocks, const float* lam0,
                          const float* cols, const int16_t* cid, float* lam_out,
                          void* phi, int T, int F, int B, int S, int n_u,
                          int SS, int mm_dtype, int carry_dtype, int renorm,
                          int packed, long long smem_bytes, cudaStream_t stream) {
  const GatherShape sh(S);
  const size_t smem = (size_t)sh.groups * GroupSmem(S, B, n_u, SS, sh.gf, false).bytes;
  if ((long long)smem != smem_bytes) return cudaErrorInvalidValue;
  auto kernel = acs_gather_kernel<R, NQ, WIDE>;
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

// -- K1-LOGPROB: the dense step -------------------------------------------

template <int R, int SEMI>
cudaError_t launch(const float* blocks, const float* lam0, const float* w,
                   float* lam_out, void* phi, int T, int F, int B, int S,
                   int BF, int mm_dtype, int carry_dtype, int renorm,
                   int packed, int slot_bits, cudaStream_t stream) {
  const size_t smem = smem_floats(B, S, R, BF) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      acs_forward_kernel<R, SEMI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + BF - 1) / BF));
  const dim3 block((unsigned)(BF * S));
  acs_forward_kernel<R, SEMI><<<grid, block, smem, stream>>>(
      blocks, lam0, w, lam_out,
      packed ? nullptr : static_cast<int8_t*>(phi),
      packed ? static_cast<int32_t*>(phi) : nullptr,
      T, F, B, S, BF, mm_dtype, carry_dtype, renorm, slot_bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1-LOGPROB's dynamic shared memory a block, in bytes.
long long acs_forward_smem_bytes(int B, int S, int R, int BF) {
  return (long long)(smem_floats(B, S, R, BF) * sizeof(float));
}

// Launches K1-LOGPROB (the dense step; `semiring` must be kLogprob, 1) on
// `stream` (a cudaStream_t) and returns the launch's cudaError_t.  Does
// not synchronise and allocates nothing: the caller owns every buffer.
// BF * S threads per block; BF*S must be a multiple of 32 and at most
// 1024, and S % 16 == 0 when `packed`.  The tropical K1 is
// acs_forward_gather_launch.
int acs_forward_launch(const float* blocks, const float* lam0, const float* w,
                       float* lam_out, void* phi, int T, int F, int B, int S,
                       int R, int BF, int mm_dtype, int carry_dtype,
                       int renorm, int packed, int semiring, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_radix_and_semiring(R, semiring, [&](auto r, auto semi) -> cudaError_t {
    constexpr int kR = decltype(r)::value;
    constexpr int kSlotBits = kR == 2 ? 1 : kR == 4 ? 2 : kR == 8 ? 3 : 4;
    if constexpr (decltype(semi)::value != kLogprob) {
      return cudaErrorInvalidValue;  // the tropical K1 is the gathered kernel
    } else {
      return launch<kR, kLogprob>(blocks, lam0, w, lam_out, phi, T, F, B, S, BF,
                                  mm_dtype, carry_dtype, renorm, packed, kSlotBits, s);
    }
  });
}

// Launches the tropical K1 (the gathered step) on `stream` and returns the
// launch's cudaError_t.  Does not synchronise and allocates nothing.
// cols: Theta's n_u distinct columns (B, n_u); cid: each of the S*R
// columns' index among them (the caller has checked that W's metric half
// is the shift register's one-hot); SS: the stage's steps and
// `smem_bytes` its layout (kernel_geometry.gather_stage_steps and
// k1_smem_bytes; another count is refused).  S a power of two in [R,
// 1024]; S % 16 == 0 and R <= 4 when `packed`.
int acs_forward_gather_launch(const float* blocks, const float* lam0,
                              const float* cols, const int16_t* cid,
                              float* lam_out, void* phi, int T, int F, int B,
                              int S, int R, int n_u, int SS, int mm_dtype,
                              int carry_dtype, int renorm, int packed,
                              long long smem_bytes, int device, void* stream) {
  if (!gather_shape_ok(B, S, R, n_u, SS) || T < 0 || F <= 0 ||
      (packed && (S % 16 != 0 || R > 4)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_radix_and_nq(R, S, [&](auto r, auto nq, auto wide) -> cudaError_t {
    return launch_gather<decltype(r)::value, decltype(nq)::value, decltype(wide)::value>(
        blocks, lam0, cols, cid, lam_out, phi, T, F, B, S, n_u, SS, mm_dtype,
        carry_dtype, renorm, packed, smem_bytes, s);
  });
}

const char* acs_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
