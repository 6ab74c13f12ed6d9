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
// LOGPROB variant (the same kernel, instantiated with kLogprob): the
// slot max becomes the max-normalised logsumexp of acs_step.cuh, as the
// reference's `_acs_kernel` does with semiring="logprob" (its
// `forward_fused(semiring=LOGPROB, use_kernel=True)`, the BCJR alpha
// recursion); phi still carries the first argmax, the renorm is still
// the frame max.  expf/logf, no fast math (see acs_step.cuh).
//
// What bounds it on this card, counted from the work the step needs
// (chip_smoke.py's `acs_bound`), not from the dense matmul below: per
// frame-step the 16 distinct branch metrics once (2 operations per
// nonzero weight: 128 at ccsds-k7, rho=2), then per state R adds and R-1
// compares, and the renorm's 2S-1: 703 f32 operations.  At the decode_64k
// shape (512 frames x 32768 steps) that is 0.176 ms at the 67 TFLOP/s
// non-tensor f32 peak, against 0.401 ms for the bytes (256 MiB of LLRs
// in, 1 GiB of int8 survivors out, at 3.35 TB/s): bound by bytes.  The
// LOGPROB variant adds per state R-1 expf (exp(best - best) = 1 needs
// none), counted at the special-function rate (16 a clock per SM, 132
// SMs at 1.98 GHz: 4.18e12/s), and 2R f32 operations (the differences,
// the sum, the logf counted as one, the final add); at 64 frames x 32768
// steps that is 0.096 ms of special functions against 0.045 ms of bytes
// and 0.038 ms of f32 work: bound by operations.  The kernel does the
// dense product instead, 2*(B+S)*S*R flops per frame-step (50x the
// tropical count at ccsds-k7), and every thread streams its R columns of
// W from shared memory each step, so shared-memory bandwidth is what
// this simple design runs into.
//
// Design (simple and right first):
//   * one block per tile of BF = 256/S frames, one thread per (frame, state);
//   * W (68 x 256 f32 = 68 KiB for ccsds-k7 at rho=2) lives in dynamic
//     shared memory for the whole run (opt-in above 48 KiB);
//   * the T-loop runs inside the kernel: Lambda stays in a register of its
//     thread and in shared memory, never in HBM, between steps;
//   * LLR blocks are staged into shared memory kStageSteps steps at a time,
//     so the global-load latency is paid once per stage, not per step;
//   * W is a general input: the dot runs over all B+S rows in a fixed
//     order (k = 0 .. B+S-1, one fma each), no use of P's one-hot shape;
//   * the renorm max is a warp shuffle reduction plus one shared-memory
//     exchange between the S/32 warps of a frame.
// The step itself (dot, argmax, packing, renorm) is acs_step.cuh, shared
// with K2 (acs_decode_fused.cu).
#include "acs_step.cuh"

namespace {

using namespace acs;

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

// Dynamic shared memory one block needs, in bytes.
long long acs_forward_smem_bytes(int B, int S, int R, int BF) {
  return (long long)(smem_floats(B, S, R, BF) * sizeof(float));
}

// Launches K1 on `stream` (a cudaStream_t) and returns the launch's
// cudaError_t.  Does not synchronise and allocates nothing: the caller
// owns every buffer.  BF * S threads per block; BF*S must be a multiple
// of 32 and at most 1024, and S % 16 == 0 when `packed`.  `semiring` is
// kTropical (0) or kLogprob (1).
int acs_forward_launch(const float* blocks, const float* lam0, const float* w,
                       float* lam_out, void* phi, int T, int F, int B, int S,
                       int R, int BF, int mm_dtype, int carry_dtype,
                       int renorm, int packed, int semiring, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_radix_and_semiring(R, semiring, [&](auto r, auto semi) {
    constexpr int kR = decltype(r)::value;
    constexpr int kSlotBits = kR == 2 ? 1 : kR == 4 ? 2 : kR == 8 ? 3 : 4;
    return launch<kR, decltype(semi)::value>(
        blocks, lam0, w, lam_out, phi, T, F, B, S, BF, mm_dtype, carry_dtype,
        renorm, packed, kSlotBits, s);
  });
}

const char* acs_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
