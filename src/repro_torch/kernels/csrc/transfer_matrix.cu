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
// The gather.  W = [Theta ; P] where P, W's metric half, is the 0/1
// one-hot of the shift register: column j*R + r has its one 1 in row
// pred(j, r) = ((j & mask) << rho) | r, mask = 2^(k-1-rho) - 1, S =
// 2^(k-1).  That is checked before any launch (kernel_geometry.
// gather_tables through viterbi_acs.gather_operands, once per code and
// radix where the decoder makes its tables, else by the wrapper), and
// only Theta, the B LLR rows, is passed; W itself is read nowhere here.  The dense sum of a potential is
// then the B LLR products fma'd in k order (the branch metric bm), then
// S - 1 products x * 0 = +-0 (no metric is infinite: the off-trellis
// score is -1e9) that leave the sum unchanged but for the sign of a zero,
// and the one product x * 1 of the predecessor metric, rounded once.  So
// pot[r] = bm[j*R + r] + M[pred(j, r)], one f32 add, gives the dense
// sum's value exactly, and the tropical kernel stays bit-identical to
// `transfer_matrix_ref`.  K3-LOGPROB reduces the same potentials by
// acs_step.cuh's reduce_slots, as K1-LOGPROB does, which skips exp(max -
// max) = 1 and sums the other terms in its tournament's order: within
// f32 rounding of the plain version's logsumexp (logprob_bound in
// chip_smoke.py), not its bits.
//
// Design:
//   * one block of kThreads = 128 threads per (tile, kFrames = 128 / S
//     frames), one thread per (frame, entry row i); blocks share nothing;
//   * branch metrics shared: per (frame, step) the S*R values bm[c] =
//     sum_k L[k] * Theta[k, c] (fmaf in k order, L and Theta rounded to
//     the matmul dtype: the dense kernel's first B terms) are formed once
//     by the frame's S threads, R columns each, into shared memory, a
//     stage of about kStageTarget steps at a time and double-buffered, so
//     one barrier a stage; every row of the frame reads its state's R
//     values as one broadcast vector load;
//   * the row's S metrics live in registers.  Radix-R butterfly g (g = 0
//     .. S/R - 1) reads old states g*R .. g*R + R - 1, all the
//     predecessors of new states v*(S/R) + g (v = 0 .. R - 1), and writes
//     those into the same R registers, so a step needs no second array
//     and no moves.  After p steps logical state x then lives in register
//     rotl(x, rho*p) (a rotation of its k-1 bits), which repeats after
//     kPeriod = (k-1) / gcd(k-1, rho) steps: the step loop is unrolled by
//     the period so that every register index is a compile-time constant
//     (at ccsds-k7, rho = 2: period 3, stages of 9 steps).  A stage is a
//     whole number of periods, the tile's last one ends where it ends, and
//     the row is written out un-rotated (TT mod kPeriod picks the map) as
//     float4 stores of its S floats;
//   * rounding: each step rounds all S metrics to bf16 or not at all (the
//     carry dtype, then the matmul dtype unless split_dot or it is the
//     tile's last step), a uniform branch after the step;
//   * the final shift: each thread's max over its S metrics, a warp
//     shuffle reduction over the frame's lanes, and at S = 64 one
//     shared-memory exchange between the frame's two warps.  The rows of
//     a ragged last block's pad frames read the last frame and write
//     nothing.
// The registers hold S in {16, 64} (every code of the registry) at R =
// 2, 4, 8; every other S <= 64, and R = 16, take a variant of the same
// kernel with the row in shared memory (a stride of S + 1 floats, so a
// warp's 32 rows fall in 32 banks) and the rotation at run time: the same
// gather, the same bits.  The instantiations are split over translation
// units (K3_PART) that the build compiles side by side and links into one
// library; without K3_PART one unit holds them all.  S >= 128 does not
// fit (kernel_geometry.k3_block_frames raises).
//
// What bounds it on this card, counted from the work the step needs
// (chip_smoke.py's `acs_bound`): per frame-step the 16 distinct branch
// metrics once (128 operations at ccsds-k7, rho=2), then for each of the
// S entry rows and each state R adds and R-1 compares (28,672), no
// renorm, and each (tile, frame)'s final max and subtraction over S x S.
// At the time-parallel latency shape (16 frames x 262,144 steps) that is
// 1.804 ms at the 67 TFLOP/s non-tensor f32 peak, against 0.06 ms for
// the bytes (64 MiB of LLRs in, 128 MiB of matrices out): bound by
// operations.  The LOGPROB variant adds per (entry row, state) R-1 expf,
// counted at the special-function rate (16 a clock per SM, 132 SMs at
// 1.98 GHz: 4.18e12/s), and 2R f32 operations: at the soft shape (64
// frames x 32,768 steps) 6.16 ms of special functions, bound by
// operations.  This design does those adds and compares (fmaxf issues at
// half the f32 rate) plus the table (S*R*B fmaf per frame-step, shared by
// the S rows) and one broadcast load of the table per state.  The
// LOGPROB variant's R - 1 accurate expf (exp(max - max) = 1 is not
// computed: acs_step.cuh's reduce_slots) and one log_of_sum (the accurate
// logf's steps without its cases for arguments a sum in [1, R] never is)
// are most of its instructions, and what it runs into.
//
// Registers and spills (nvcc -Xptxas=-v, printed by chip_smoke.py's
// build phase; PERF.md lists every instantiation): at S = 64, R = 4 the
// tropical kernel takes about 154 registers at three blocks an SM, the
// LOGPROB one 128 at four, neither spilling; K3-LOGPROB at S = 64, R = 8
// spills a little.  Only ints and flags stay live beside a row's
// metrics (Row), which is what keeps R = 4 from spilling.
#include <math.h>

#include "acs_step.cuh"

namespace k3 {

// The arguments of one launch, as the C entry point received them.
struct Launch {
  const float* blocks;  // (T, F, B)
  const float* theta;   // (B, S*R): W's LLR rows
  float* m_out;         // (T/TT, F, S, S)
  int T, F, B, S, TT, BF, mm_dtype, carry_dtype, split_dot;
  long long smem_bytes;
  cudaStream_t stream;
};

// The parts: each launches the instantiations it holds (K3_PART 0 to 4),
// or returns cudaErrorInvalidValue for another R.
cudaError_t regs_64_tropical(int R, const Launch& a);  // R = 2, 4, 8
cudaError_t regs_64_logprob_r2(const Launch& a);
cudaError_t regs_64_logprob(int R, const Launch& a);   // R = 4, 8
cudaError_t regs_16(int R, int semiring, const Launch& a);
cudaError_t shared(int R, int semiring, const Launch& a);

}  // namespace k3

#if !defined(K3_PART)
#define K3_IN_PART(p) 1
#else
#define K3_IN_PART(p) (K3_PART == (p))
#endif

namespace {

using namespace acs;
using k3::Launch;

constexpr int kThreads = 128;     // K3_THREADS in core/kernel_geometry.py
constexpr int kStageTarget = 8;   // K3_STAGE_TARGET: steps staged at once
constexpr int kMaxStage = 12;     // the longest stage (a period of 6, twice)
constexpr float kNeg = -1.0e9f;   // the off-trellis score

__host__ __device__ constexpr int log2_of(int x) {
  return x > 1 ? 1 + log2_of(x >> 1) : 0;
}

__host__ __device__ constexpr int gcd_of(int a, int b) {
  return b ? gcd_of(b, a % b) : a;
}

// The block geometry of S states and R slots (kernel_geometry's k3_*).
struct Geometry {
  int states, bits, rho, period, stage, frames, warps_per_frame,
      step_stride, buffer;
  __host__ __device__ constexpr Geometry(int S, int R)
      : states(S),
        bits(log2_of(S)),
        rho(log2_of(R)),
        period(log2_of(S) / gcd_of(log2_of(S), log2_of(R))),
        stage(period * ((kStageTarget + period - 1) / period)),
        frames(kThreads / S),
        warps_per_frame(S >= 32 ? S / 32 : 1),
        step_stride(kThreads / S * S * R),
        buffer(stage * step_stride) {}
  // the branch-metric table twice, the rows when they are in shared
  // memory, then the frame maxima
  __host__ __device__ constexpr size_t smem_floats(bool rows) const {
    return 2 * (size_t)buffer + (rows ? (size_t)kThreads * (states + 1) : 0) +
           (size_t)frames * warps_per_frame;
  }
};

// x rotated left by s of its n bits: the register (or shared-memory slot)
// of logical state x after steps that moved it by s bits.
__host__ __device__ constexpr int rotl(int x, int s, int n) {
  return s == 0 ? x : (((x << s) | (x >> (n - s))) & ((1 << n) - 1));
}

// This thread's share of a stage's branch metrics: columns c = q*S + i
// (q < R) of its frame, for `steps` steps.  lsrc: the frame's LLRs at the
// stage's first step (F*B floats a step), theta: (B, S*R).
template <int R>
__device__ __forceinline__ void build_table(float* dst, const float* lsrc,
                                            const float* theta, int steps,
                                            int F, int B, int mm_dtype, int S,
                                            int i, int step_stride) {
  const long long step_floats = (long long)F * B;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int c = q * S + i;
    float acc[kMaxStage];
#pragma unroll
    for (int t = 0; t < kMaxStage; ++t) acc[t] = 0.f;
    for (int k = 0; k < B; ++k) {
      const float th = round_to(__ldg(theta + (size_t)k * S * R + c), mm_dtype);
#pragma unroll
      for (int t = 0; t < kMaxStage; ++t)
        if (t < steps)
          acc[t] = fmaf(round_to(__ldg(lsrc + t * step_floats + k), mm_dtype),
                        th, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kMaxStage; ++t)
      if (t < steps) dst[t * step_stride + c] = acc[t];
  }
}

// The frame's max of the per-thread maxima m: a shuffle reduction over
// the frame's min(S, 32) lanes, then across its warps through peak_s.
// Every thread of the block calls it.
__device__ __forceinline__ float frame_peak(float m, int S, int fl, int wpf,
                                            float* peak_s) {
  for (int off = (S < 32 ? S : 32) / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (wpf > 1) {
    if ((threadIdx.x & 31) == 0) peak_s[threadIdx.x >> 5] = m;
    __syncthreads();
    m = peak_s[fl * wpf];
    for (int q = 1; q < wpf; ++q) m = fmaxf(m, peak_s[fl * wpf + q]);
  }
  return m;
}

// What every K3 thread starts from: its frame and row, and the rounding
// each step takes.  Only ints and flags, so that little stays live in
// registers beside the row's metrics.
struct Row {
  int fl, i;
  int f;   // frame; >= F for a pad row
  int fr;  // the frame whose LLRs it reads: a pad row reads the last one
  bool rnd_mid, rnd_last;

  __device__ Row(int S, int frames, int F, int mm_dtype, int carry_dtype,
                 int split_dot)
      : fl(threadIdx.x / S),
        i(threadIdx.x % S),
        f(blockIdx.y * frames + threadIdx.x / S),
        fr(f < F ? f : F - 1),
        // each step rounds to bf16 or not at all: to the carry dtype, then
        // to the matmul dtype for the next dot (not with split_dot, not
        // the tile's last step)
        rnd_mid(carry_dtype == kBF16 || (mm_dtype == kBF16 && !split_dot)),
        rnd_last(carry_dtype == kBF16) {}
  // the frame's LLRs at step t of the block's tile
  __device__ const float* llrs(const float* blocks, int F, int B, int TT,
                               int t) const {
    return blocks + (((long long)blockIdx.x * TT + t) * F + fr) * B;
  }
  __device__ float* out(float* m_out, int F, int S) const {
    return m_out + (((long long)blockIdx.x * F + f) * S + i) * S;
  }
};

// The identity's off-diagonal, as the first step reads it.
__device__ __forceinline__ float off_diagonal(int mm_dtype, int split_dot) {
  return split_dot ? kNeg : round_to(kNeg, mm_dtype);
}

// -- registers: S and R known at compile time ---------------------------

// One ACS step of a row at phase PH.  tb: this (frame, step)'s S*R
// branch metrics.  No value written here is read again in this step.
template <int S, int R, int SEMI, int PH>
__device__ __forceinline__ void acs_step_regs(float (&reg)[S],
                                              const float* tb) {
  constexpr Geometry G(S, R);
  constexpr int shift = G.rho * PH % G.bits;
#pragma unroll
  for (int g = 0; g < S / R; ++g) {
    float old[R];
#pragma unroll
    for (int r = 0; r < R; ++r) old[r] = reg[rotl(g * R + r, shift, G.bits)];
#pragma unroll
    for (int v = 0; v < R; ++v) {
      float pot[R];
      load_cols<R>(tb + (v * (S / R) + g) * R, pot);  // new state v*S/R + g
#pragma unroll
      for (int r = 0; r < R; ++r) pot[r] += old[r];
      reg[rotl(g * R + v, shift, G.bits)] = reduce_slots<R, SEMI>(pot);
    }
  }
}

// Steps t+PH, t+PH+1, ... of a stage up to the period's end or `steps`,
// each rounded to bf16 where the policy says: `rnd_last` at the tile's
// last step (index `last` of the stage, -1 if it is not in it),
// `rnd_mid` at the others.
template <int S, int R, int SEMI, int PH = 0>
__device__ __forceinline__ void run_period(float (&reg)[S], const float* tb,
                                           int t, int steps, int last,
                                           bool rnd_mid, bool rnd_last) {
  constexpr Geometry G(S, R);
  if constexpr (PH < G.period) {
    if (t + PH >= steps) return;
    acs_step_regs<S, R, SEMI, PH>(reg, tb + (t + PH) * G.step_stride);
    if (t + PH == last ? rnd_last : rnd_mid) {
#pragma unroll
      for (int x = 0; x < S; ++x) reg[x] = round_to(reg[x], kBF16);
    }
    run_period<S, R, SEMI, PH + 1>(reg, tb, t, steps, last, rnd_mid,
                                   rnd_last);
  }
}

// Writes the row un-rotated (logical state j from register rotl(j,
// rho*q)), each value shifted by the frame's max.
template <int S, int R, int PH = 0>
__device__ __forceinline__ void store_row(const float (&reg)[S], float* out,
                                          float peak, int q) {
  constexpr Geometry G(S, R);
  if constexpr (PH < G.period) {
    if (q != PH) {
      store_row<S, R, PH + 1>(reg, out, peak, q);
      return;
    }
    constexpr int shift = G.rho * PH % G.bits;
#pragma unroll
    for (int j = 0; j < S; j += 4)
      reinterpret_cast<float4*>(out)[j / 4] =
          make_float4(reg[rotl(j, shift, G.bits)] - peak,
                      reg[rotl(j + 1, shift, G.bits)] - peak,
                      reg[rotl(j + 2, shift, G.bits)] - peak,
                      reg[rotl(j + 3, shift, G.bits)] - peak);
  }
}

// The LOGPROB instantiations keep four blocks an SM (at most 128
// registers); the tropical ones need three to spill nothing.
template <int S, int R, int SEMI>
__global__ void __launch_bounds__(kThreads, SEMI == kLogprob ? 4 : 3)
    transfer_matrix_kernel(const float* __restrict__ blocks,
                           const float* __restrict__ theta,
                           float* __restrict__ m_out, int F, int B, int TT,
                           int mm_dtype, int carry_dtype, int split_dot) {
  constexpr Geometry G(S, R);
  extern __shared__ __align__(16) float smem[];
  float* peak_s = smem + 2 * G.buffer;
  const Row row(S, G.frames, F, mm_dtype, carry_dtype, split_dot);
  float reg[S];
  const float off_diag = off_diagonal(mm_dtype, split_dot);
#pragma unroll
  for (int x = 0; x < S; ++x) reg[x] = x == row.i ? 0.f : off_diag;

  float* table = smem + row.fl * S * R;  // this frame's columns
  build_table<R>(table, row.llrs(blocks, F, B, TT, 0), theta,
                 min(G.stage, TT), F, B, mm_dtype, S, row.i, G.step_stride);
  __syncthreads();
  for (int t0 = 0, s = 0; t0 < TT; t0 += G.stage, ++s) {
    const int next = t0 + G.stage;
    // Stage s+1 goes into the buffer that stage s-1 read, all of whose
    // reads happened before the last barrier.
    if (next < TT)
      build_table<R>(table + ((s + 1) & 1) * G.buffer,
                     row.llrs(blocks, F, B, TT, next), theta,
                     min(G.stage, TT - next), F, B, mm_dtype, S, row.i,
                     G.step_stride);
    // a stage starts at phase 0: it is a whole number of periods
    const float* tb = table + (s & 1) * G.buffer;
    const int steps = min(G.stage, TT - t0);
    const int last = next >= TT ? steps - 1 : -1;
    for (int t = 0; t < steps; t += G.period)
      run_period<S, R, SEMI>(reg, tb, t, steps, last, row.rnd_mid,
                             row.rnd_last);
    __syncthreads();  // stage s+1's table complete, stage s's reads done
  }

  float m = reg[0];
#pragma unroll
  for (int x = 1; x < S; ++x) m = fmaxf(m, reg[x]);
  m = frame_peak(m, S, row.fl, G.warps_per_frame, peak_s);
  if (row.f < F) store_row<S, R>(reg, row.out(m_out, F, S), m, TT % G.period);
}

template <int S, int R, int SEMI>
cudaError_t launch(const Launch& a) {
  constexpr Geometry G(S, R);
  const size_t smem = G.smem_floats(false) * sizeof(float);
  if (a.BF != G.frames || a.smem_bytes != (long long)smem)
    return cudaErrorInvalidValue;
  auto kernel = transfer_matrix_kernel<S, R, SEMI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.T / a.TT),
                  (unsigned)((a.F + G.frames - 1) / G.frames));
  kernel<<<grid, kThreads, smem, a.stream>>>(a.blocks, a.theta, a.m_out, a.F,
                                             a.B, a.TT, a.mm_dtype,
                                             a.carry_dtype, a.split_dot);
  return cudaGetLastError();
}

template <int S, int SEMI>
cudaError_t launch_slots(int R, const Launch& a) {
  switch (R) {
    case 2:
      return launch<S, 2, SEMI>(a);
    case 4:
      return launch<S, 4, SEMI>(a);
    case 8:
      return launch<S, 8, SEMI>(a);
  }
  return cudaErrorInvalidValue;
}

// -- shared memory: S known at run time ---------------------------------

// The same kernel with the row in shared memory (stride S + 1) and the
// rotation at run time, for every S <= 64 and R.
template <int R, int SEMI>
__global__ void __launch_bounds__(kThreads) transfer_matrix_shared_kernel(
    const float* __restrict__ blocks, const float* __restrict__ theta,
    float* __restrict__ m_out, int F, int B, int S, int TT, int mm_dtype,
    int carry_dtype, int split_dot) {
  const Geometry G(S, R);
  extern __shared__ __align__(16) float smem[];
  float* rows = smem + 2 * G.buffer;
  float* peak_s = rows + kThreads * (S + 1);
  const Row row(S, G.frames, F, mm_dtype, carry_dtype, split_dot);
  float* lam = rows + threadIdx.x * (S + 1);
  const float off_diag = off_diagonal(mm_dtype, split_dot);
  for (int x = 0; x < S; ++x) lam[x] = x == row.i ? 0.f : off_diag;

  float* table = smem + row.fl * S * R;
  build_table<R>(table, row.llrs(blocks, F, B, TT, 0), theta,
                 min(G.stage, TT), F, B, mm_dtype, S, row.i, G.step_stride);
  __syncthreads();
  for (int t0 = 0, s = 0; t0 < TT; t0 += G.stage, ++s) {
    const int next = t0 + G.stage;
    if (next < TT)
      build_table<R>(table + ((s + 1) & 1) * G.buffer,
                     row.llrs(blocks, F, B, TT, next), theta,
                     min(G.stage, TT - next), F, B, mm_dtype, S, row.i,
                     G.step_stride);
    const int steps = min(G.stage, TT - t0);
    for (int t = 0; t < steps; ++t) {
      const float* tb = table + (s & 1) * G.buffer + t * G.step_stride;
      const int shift = G.rho * (t % G.period) % G.bits;
      for (int g = 0; g < S / R; ++g) {
        float old[R];
#pragma unroll
        for (int r = 0; r < R; ++r) old[r] = lam[rotl(g * R + r, shift, G.bits)];
#pragma unroll
        for (int v = 0; v < R; ++v) {
          float pot[R];
          load_cols<R>(tb + (v * (S / R) + g) * R, pot);
#pragma unroll
          for (int r = 0; r < R; ++r) pot[r] += old[r];
          lam[rotl(g * R + v, shift, G.bits)] = reduce_slots<R, SEMI>(pot);
        }
      }
      if (next >= TT && t == steps - 1 ? row.rnd_last : row.rnd_mid)
        for (int x = 0; x < S; ++x) lam[x] = round_to(lam[x], kBF16);
    }
    __syncthreads();
  }

  float m = lam[0];
  for (int x = 1; x < S; ++x) m = fmaxf(m, lam[x]);
  m = frame_peak(m, S, row.fl, G.warps_per_frame, peak_s);
  if (row.f < F) {
    float* out = row.out(m_out, F, S);
    const int shift = G.rho * (TT % G.period) % G.bits;
    for (int j = 0; j < S; ++j) out[j] = lam[rotl(j, shift, G.bits)] - m;
  }
}

template <int R, int SEMI>
cudaError_t launch_shared(const Launch& a) {
  const Geometry G(a.S, R);
  const size_t smem = G.smem_floats(true) * sizeof(float);
  if (a.BF != G.frames || a.smem_bytes != (long long)smem)
    return cudaErrorInvalidValue;
  auto kernel = transfer_matrix_shared_kernel<R, SEMI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.T / a.TT),
                  (unsigned)((a.F + G.frames - 1) / G.frames));
  kernel<<<grid, kThreads, smem, a.stream>>>(a.blocks, a.theta, a.m_out, a.F,
                                             a.B, a.S, a.TT, a.mm_dtype,
                                             a.carry_dtype, a.split_dot);
  return cudaGetLastError();
}

template <int SEMI>
cudaError_t launch_shared_slots(int R, const Launch& a) {
  switch (R) {
    case 2:
      return launch_shared<2, SEMI>(a);
    case 4:
      return launch_shared<4, SEMI>(a);
    case 8:
      return launch_shared<8, SEMI>(a);
    case 16:
      return launch_shared<16, SEMI>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// -- the parts ----------------------------------------------------------

namespace k3 {

#if K3_IN_PART(0)
cudaError_t regs_64_tropical(int R, const Launch& a) {
  return launch_slots<64, kTropical>(R, a);
}
#endif

#if K3_IN_PART(1)
cudaError_t regs_64_logprob_r2(const Launch& a) {
  return launch<64, 2, kLogprob>(a);
}
#endif

#if K3_IN_PART(2)
cudaError_t regs_64_logprob(int R, const Launch& a) {
  return R == 2 ? cudaErrorInvalidValue : launch_slots<64, kLogprob>(R, a);
}
#endif

#if K3_IN_PART(3)
cudaError_t regs_16(int R, int semiring, const Launch& a) {
  return semiring == kTropical ? launch_slots<16, kTropical>(R, a)
                               : launch_slots<16, kLogprob>(R, a);
}
#endif

#if K3_IN_PART(4)
cudaError_t shared(int R, int semiring, const Launch& a) {
  return semiring == kTropical ? launch_shared_slots<kTropical>(R, a)
                               : launch_shared_slots<kLogprob>(R, a);
}
#endif

}  // namespace k3

#if K3_IN_PART(4)
extern "C" {

// Launches K3 on `stream` (a cudaStream_t) and returns the launch's
// cudaError_t.  Does not synchronise and allocates nothing: the caller owns
// every buffer.  theta is W's (B, S*R) LLR half; the caller has checked
// that W's metric half is the shift register's one-hot.  T % TT == 0;
// BF and `smem_bytes` are kernel_geometry.k3_block_frames and
// k3_smem_bytes, and must be the variant's; `semiring` is kTropical (0)
// or kLogprob (1).
int transfer_matrix_launch(const float* blocks, const float* theta,
                           float* m_out, int T, int F, int B, int S, int R,
                           int TT, int BF, int mm_dtype, int carry_dtype,
                           int split_dot, int semiring, long long smem_bytes,
                           int device, void* stream) {
  if (TT <= 0 || T % TT != 0 || F <= 0 || B <= 0 || S < 2 || S > 64 ||
      (S & (S - 1)) || R < 2 || R > S || (R & (R - 1)) ||
      (semiring != kTropical && semiring != kLogprob))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const k3::Launch a{blocks, theta,    m_out,       T,
                     F,      B,        S,           TT,
                     BF,     mm_dtype, carry_dtype, split_dot,
                     smem_bytes, static_cast<cudaStream_t>(stream)};
  // kernel_geometry.k3_in_registers: S in {16, 64}, R <= 8
  if (R > 8 || (S != 16 && S != 64)) return (int)k3::shared(R, semiring, a);
  if (S == 16) return (int)k3::regs_16(R, semiring, a);
  if (semiring == kTropical) return (int)k3::regs_64_tropical(R, a);
  return (int)(R == 2 ? k3::regs_64_logprob_r2(a) : k3::regs_64_logprob(R, a));
}

const char* transfer_matrix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif
