// K3 — per-tile semiring transfer matrices of the time-parallel decode
// (tropical) and of the blocked BCJR (LOGPROB), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `transfer_matrix_pallas` (body
// `_transfer_kernel`) in src/repro/kernels/viterbi_acs.py, both of its
// semirings.  Same contract:
// for tile n of TT radix steps and frame f, start from the identity
// (0 on the diagonal, -1e9 elsewhere) and run TT fused ACS steps with the
// entry-state axis folded into the rows, so that row (f, i) carries the
// best metric from entry state i:
//
//     pot[r]     = sum_k x[k] * W[k, j*R + r],   x = [L_t(f) | M(f, i, :)]
//     M'(f,i,j)  = max_r pot[r]     (LOGPROB: the logsumexp over r)
//
// with x rounded to the matmul dtype (with split_dot the M half stays f32,
// and so do W's routing rows), products and sums in f32 (no TF32), the
// carry rounded to the carry dtype after every step and no renorm.  At the
// end each (tile, frame) matrix is shifted by its own max over S x S.
//
// LOGPROB variant (the same kernel, instantiated with kLogprob): the slot
// max becomes the max-normalised logsumexp of acs_step.cuh, as the
// reference's `_transfer_kernel` does with semiring="logprob".  Its
// callers are the BCJR paths: `soft.bcjr_llrs` (tiles of
// `pick_transfer_tile` steps) and `soft.bcjr_circular_llrs` (one step a
// tile).  The identity's -1e9 entries stay unreachable: expf(-1e9 - m)
// is exactly 0, so they add nothing to a reachable entry, and an entry
// with no reachable predecessor stays within rounding of -1e9.  expf/logf,
// no fast math (see acs_step.cuh).
//
// What bounds it on this card, counted from the work the step needs
// (chip_smoke.py's `acs_bound`), not from the dense matmul below: per
// frame-step the 16 distinct branch metrics once (128 operations at
// ccsds-k7, rho=2), then for each of the S entry rows and each state R
// adds and R-1 compares (28,672), no renorm, and each (tile, frame)'s
// final max and subtraction over S x S.  At the time-parallel latency
// shape (16 frames x 262,144 steps) that is 1.804 ms at the 67 TFLOP/s
// non-tensor f32 peak, against 0.06 ms for the bytes (64 MiB of LLRs in,
// 128 MiB of matrices out): bound by operations.  The LOGPROB variant
// adds per (entry row, state) R-1 expf (exp(best - best) = 1 needs
// none), counted at the special-function rate (16 a clock per SM, 132
// SMs at 1.98 GHz: 4.18e12/s), and 2R f32 operations (the logf counted
// as one): at the soft shape (64 frames x 32,768 steps) 6.16 ms of
// special functions against 1.9 ms of f32 work, so bound by operations.
// The kernel does the dense product instead, 2*S*(B+S)*S*R flops per
// frame-step (78x the tropical count at ccsds-k7); as in K1, every
// (row, state) pair streams its R columns of W from shared memory each
// step, so shared-memory bandwidth is what this design runs into.
//
// Design (simple and right first):
//   * one block per (tile, block of BF frames); blocks share nothing, so
//     the grid runs in any order;
//   * W (68 KiB for ccsds-k7 at rho=2) in opt-in dynamic shared memory;
//   * the BF x S x S carry in shared memory, twice (read one, write the
//     other, swap after each step's barrier): 16 KiB a frame each way at
//     S=64, so BF = 4 there (kernel_geometry.k3_block_frames);
//   * the tile's LLRs staged kStageSteps steps at a time;
//   * each of the 1024 threads loops over the block's (frame, entry,
//     state) triples, state fastest, and calls acs_best of acs_step.cuh,
//     so every entry sums the B+S rows of W in K1's order (LLR rows, then
//     metric rows, one fma each) and rounds as K1 does: the recovery pass
//     runs K1 on the same steps;
//   * the final max is a block reduction per live frame; the pad frames
//     of a ragged last block are neither computed nor read.
#include <math.h>

#include "acs_step.cuh"

namespace {

using namespace acs;

constexpr int kThreads = 1024;  // K3_THREADS in core/kernel_geometry.py
constexpr float kNeg = -1.0e9f;  // the off-trellis score

size_t smem_floats(int B, int S, int R, int BF) {
  return (size_t)(B + S) * S * R           // W
         + (size_t)kStageSteps * BF * B    // staged LLR blocks
         + 2 * (size_t)BF * S * S          // the matrix carry, twice
         + kThreads / 32                   // warp maxima
         + (size_t)BF;                     // frame maxima
}

template <int R, int SEMI>
__global__ void __launch_bounds__(kThreads) transfer_matrix_kernel(
    const float* __restrict__ blocks,  // (T, F, B)
    const float* __restrict__ w,       // (B+S, S*R)
    float* __restrict__ m_out,         // (T/TT, F, S, S)
    int F, int B, int S, int TT, int BF, int mm_dtype, int carry_dtype,
    int split_dot) {
  extern __shared__ __align__(16) float smem[];
  const int K = B + S;
  const int SR = S * R;
  const int SS = S * S;
  float* w_s = smem;                                // K * SR
  float* l_s = w_s + (size_t)K * SR;                // kStageSteps * BF * B
  float* cur = l_s + (size_t)kStageSteps * BF * B;  // BF * SS
  float* nxt = cur + (size_t)BF * SS;               // BF * SS
  float* red_s = nxt + (size_t)BF * SS;             // kThreads / 32
  float* peak_s = red_s + kThreads / 32;            // BF

  const int tid = threadIdx.x;
  const long long n = blockIdx.x;  // tile
  const long long f0 = (long long)blockIdx.y * BF;
  const int nf = F - f0 < BF ? (int)(F - f0) : BF;  // live frames
  const int items = nf * SS;

  // W's LLR rows in the matmul dtype; its routing rows too, unless split_dot
  for (int i = tid; i < K * SR; i += blockDim.x)
    w_s[i] = (split_dot && i >= B * SR) ? w[i] : round_to(w[i], mm_dtype);
  // the identity, as the first step's dot reads it
  const float off_diag = split_dot ? kNeg : round_to(kNeg, mm_dtype);
  for (int e = tid; e < items; e += blockDim.x) {
    const int i = (e / S) % S;
    cur[e] = i == e % S ? 0.f : off_diag;
  }

  for (int t0 = 0; t0 < TT; t0 += kStageSteps) {
    // Every read of l_s from the previous stage happened before the last
    // step's closing barrier, so the stage can be overwritten here.
    const int steps = min(kStageSteps, TT - t0);
    const int per_step = nf * B;
    for (int i = tid; i < steps * per_step; i += blockDim.x) {
      const int tt = i / per_step;
      const int r = i - tt * per_step;
      l_s[tt * BF * B + r] = round_to(
          blocks[((n * TT + t0 + tt) * F + f0) * B + r], mm_dtype);
    }
    __syncthreads();  // stage (and, first time round, W and the identity)
    for (int tt = 0; tt < steps; ++tt) {
      const bool last = t0 + tt == TT - 1;
      for (int e = tid; e < items; e += blockDim.x) {
        const int row = e / S;  // fl * S + entry state
        const int j = e - row * S;
        const int fl = row / S;
        int arg;
        float best = acs_best<R, SEMI>(l_s + (tt * BF + fl) * B,
                                       cur + (size_t)row * S, w_s + j * R,
                                       B, S, arg);
        best = round_to(best, carry_dtype);
        // the next step's dot reads the carry in the matmul dtype
        nxt[e] = (last || split_dot) ? best : round_to(best, mm_dtype);
      }
      __syncthreads();  // every read of cur done, nxt complete
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  // normalise each live frame's S x S matrix by its max
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int fl = 0; fl < nf; ++fl) {
    float m = -INFINITY;
    for (int e = tid; e < SS; e += blockDim.x) m = fmaxf(m, cur[fl * SS + e]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red_s[warp] = m;
    __syncthreads();
    if (tid == 0) {
      float p = red_s[0];
      for (int q = 1; q < nwarps; ++q) p = fmaxf(p, red_s[q]);
      peak_s[fl] = p;
    }
    __syncthreads();
  }
  float* out = m_out + (n * F + f0) * SS;
  for (int e = tid; e < items; e += blockDim.x) out[e] = cur[e] - peak_s[e / SS];
}

template <int R, int SEMI>
cudaError_t launch(const float* blocks, const float* w, float* m_out, int T,
                   int F, int B, int S, int TT, int BF, int mm_dtype,
                   int carry_dtype, int split_dot, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      transfer_matrix_kernel<R, SEMI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(T / TT), (unsigned)((F + BF - 1) / BF));
  transfer_matrix_kernel<R, SEMI><<<grid, kThreads, smem, stream>>>(
      blocks, w, m_out, F, B, S, TT, BF, mm_dtype, carry_dtype, split_dot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t) and returns the launch's
// cudaError_t.  Does not synchronise and allocates nothing: the caller owns
// every buffer.  T % TT == 0; `smem_bytes` is kernel_geometry.k3_smem_bytes
// and must hold the layout above; `semiring` is kTropical (0) or
// kLogprob (1).
int transfer_matrix_launch(const float* blocks, const float* w, float* m_out,
                           int T, int F, int B, int S, int R, int TT, int BF,
                           int mm_dtype, int carry_dtype, int split_dot,
                           int semiring, long long smem_bytes, int device,
                           void* stream) {
  if (TT <= 0 || T % TT != 0 || BF <= 0 ||
      smem_bytes < (long long)(smem_floats(B, S, R, BF) * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  return (int)with_radix_and_semiring(R, semiring, [&](auto r, auto semi) {
    return launch<decltype(r)::value, decltype(semi)::value>(
        blocks, w, m_out, T, F, B, S, TT, BF, mm_dtype, carry_dtype,
        split_dot, smem, s);
  });
}

const char* transfer_matrix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
