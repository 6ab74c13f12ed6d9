// K6 — the BCJR's within-tile alpha and beta sweeps, with the LLR combine
// fused into the beta sweep, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's alpha and beta recursions
// are `lax.scan`s (`_alpha_scan`, `_beta_scan` in src/repro/core/soft.py)
// and its combine is XLA's masked logsumexp (`_llrs_from_joints`).  It
// was added because the port's plain versions step each tile in Python:
// per step a dense [L_t | Lambda] @ W over every (tile, frame) row, a
// logsumexp and a renorm, about ten kernels, and the combine expands the
// joint into two (T', F, rho, S) temporaries.
//
// Two launches of one kernel, bcjr_sweep_kernel<R, NQ, BACK>, over rows
// row = p * F + f (tile p, frame f):
//   * K6-F (BACK = false): from the row's tile-entry alpha, tt LOGPROB
//     steps of the tables' gathered step, each followed by the renorm;
//     alpha at boundary t + 1 is stored, f32, at alphas[t][row], the
//     (tt, rows, S) layout of soft.py's `_alpha_scan`;
//   * K6-B (BACK = true): from the row's tile-end beta, t = tt-1 down to
//     0: at boundary t + 1 the joint alpha[t] + beta is formed in
//     registers and each of the rho bits' LLR taken over the frame's
//     threads,
//         LLR[t, b] = lse_{j: bit_b(j)=0} joint - lse_{j: bit_b(j)=1} joint,
//     written to out[f, (p * tt + t) * rho + b] (the (F, T' * rho) of
//     `bcjr_llrs`); then, for t >= 1, the reverse LOGPROB step on
//     `build_reverse_tables`' tables gives the beta at boundary t.  No
//     beta, joint or masked temporary leaves the SM.
//
// The step.  Each potential is one branch metric plus one routed metric:
// pot[j, r] = bm(cid[j*R + r]) + x[route[j*R + r]], where route is the
// row of the one 1 in column j*R + r of the routing one-hot (pred_onehot
// forward, succ_onehot backward; the wrapper checks that each column
// holds exactly one 1, so the dense sum is that one product), and bm one
// of Theta's n_u distinct columns' branch metrics, an fmaf chain in k
// order over L and Theta rounded to the matmul dtype (acs_step.cuh's
// stage_branch_metrics).  The slot value is reduce_slots<R, kLogprob>'s
// tournament logsumexp (accurate expf, log_of_sum, no fast math), the
// renorm subtracts the frame max, the carry is rounded to the carry
// dtype, and the routed metric to the matmul dtype (with split_dot: f32,
// unrounded): the rounding points of soft.py's `_logprob_step`.  The
// combine is the plain version's form: per bit and value, m = the max of
// the joints with that bit, NEG (-1e9) standing for each other state as
// the plain `torch.where` has it, then m + logf(sum of expf(w - m)),
// summed by a shuffle butterfly over the frame's threads, which gives
// each thread the same bits.  The per-step renorm and each combine's max
// are constants per (frame, boundary) and cancel in the LLR difference.
//
// Layout (acs_step.cuh's gathered shape, S <= 64): a row's S states over
// S/NQ threads (NQ = 2 at S = 64: one warp a row, two states a lane; one
// warp holds 32/S rows below), kGatherWarps warps a block, one warp
// barrier a step and no block barrier.  The metrics are exchanged
// through shared memory (double-buffered), LLR blocks are read where
// they lie, at the caller's strides, with cp.async a stage of
// kStageSteps steps ahead, and each stage's branch metrics formed before
// its steps.  K6-F stores each step's S metrics as coalesced rows
// (256 bytes at S = 64); K6-B loads alpha[t - 1] a step ahead into
// registers, and stages a stage's LLRs in shared memory to write each
// row's stage as one contiguous run.
//
// What bounds it on this card, at the soft cell's shape (256 frames x
// 128 tiles = 32,768 rows, tt = 256, ccsds-k7 at rho = 2: 8.4 M row-steps
// a launch).  Bytes: the alphas, 2.15 GB written by K6-F and read by
// K6-B, plus the LLR blocks read by each: about 0.68 ms a launch at 3.35
// TB/s.  Special functions: S (R - 1) = 192 expf a row-step, 0.39 ms at
// 4.18e12/s (16 a clock per SM, 132 SMs, 1.98 GHz); K6-B adds the
// combine's 2 rho S expf, 0.9 ms in all.  So K6-F is bound by bytes and
// K6-B by special functions and bytes about alike.  Unlike K1 at 64
// frames, the rows fill the card (about eight waves of 32 warps an SM),
// so the per-step serial chain (gather, tournament, expf, log_of_sum,
// the frame max, the warp barrier) is hidden by other warps, and the
// design keeps the step's instruction count low instead: no dense W, no
// survivors, the routing and column indices in registers.
#include "acs_step.cuh"

namespace {

using namespace acs;

constexpr float kNeg = -1.0e9f;  // semiring.py's NEG, the off-trellis score

template <int R>
__host__ __device__ constexpr int rho_of() {
  return R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
}

// Byte offsets in one frame group's shared-memory region (16-byte
// aligned): the staged LLRs [SS][gf][B] f32, the branch metrics
// [SS][gf][n_u] f32, the metrics rounded for routing [2][gf][S] f32, and
// K6-B's staged LLR outputs [SS][gf][rho] f32.
struct SweepSmem {
  size_t llr, bm, x, out, bytes;
  __host__ __device__ SweepSmem(int S, int B, int n_u, int SS, int gf, int rho)
      : llr(0),
        bm(align16((size_t)SS * gf * B * 4)),
        x(align16(bm + (size_t)SS * gf * n_u * 4)),
        out(align16(x + (size_t)2 * gf * S * 4)),
        bytes(align16(out + (size_t)SS * gf * rho * 4)) {}
};

// The sum of v over the frame's tpf (<= 32) threads, by a shuffle
// butterfly: every thread of the frame gets the same bits (each level
// adds the same two partial sums, in either order).
__device__ __forceinline__ float frame_sum(float v, int tpf) {
  for (int off = tpf / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copies the LLR blocks of `steps` steps of the group's live rows into
// l_s [s][row in group][B] with cp.async, as one commit group: stage
// index s is step t = t_first + dir * s of the row's tile, at blocks +
// (p * tt + t) * st + f * sf for row p * F + f.
__device__ __forceinline__ void stage_rows(float* l_s, const float* blocks, long long st,
                                           long long sf, int t_first, int dir, int steps,
                                           int F, int tt, int B, const Group& g) {
  const int per = g.live * B;
  for (int i = g.lane; i < steps * per; i += g.size) {
    const int s = i / per;
    const int rem = i - s * per;
    const int fr = rem / B;
    const int k = rem - fr * B;
    const long long row = g.first + fr;
    const long long p = row / F;
    const long long t = p * tt + t_first + dir * s;
    cp_async4(l_s + (s * g.sh.gf + fr) * B + k, blocks + t * st + (row - p * F) * sf + k);
  }
  cp_async_commit();
}

// One gathered LOGPROB step of the thread's NQ states j_q = t + q*tpf:
// potentials bm + x[route], reduce_slots' logsumexp, the renorm by the
// frame max, the carry rounded to the carry dtype and the next routed
// metrics to x_dtype; ends with the group's barrier.
template <int R, int NQ>
__device__ __forceinline__ void sweep_step(const float* bm_row, const int (&cid)[NQ][R],
                                           const int (&rt)[NQ][R], const float* xc, float* xn,
                                           float (&lam)[NQ], int x_dtype, int carry_dtype,
                                           int renorm, const Group& g) {
  const int tpf = g.sh.tpf;
  // every load of the step first, before any store to shared memory
  float px[NQ][R], bm[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      px[q][r] = xc[rt[q][r]];
      bm[q][r] = bm_row[cid[q][r]];
    }
  float val[NQ];
  float mloc = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float pot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pot[r] = bm[q][r] + px[q][r];
    val[q] = reduce_slots<R, kLogprob>(pot);
    mloc = q == 0 ? val[0] : fmaxf(mloc, val[q]);
  }
  const float m = renorm ? frame_max(mloc, g, nullptr) : 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    lam[q] = round_to(renorm ? val[q] - m : val[q], carry_dtype);
    xn[g.t + q * tpf] = round_to(lam[q], x_dtype);
  }
  g.sync();
}

// The rho LLRs of one boundary from the thread's NQ joints (states t +
// q*tpf, their decoded bits in dbits[q]), the plain combine's masked
// logsumexps over the frame's threads.
template <int NQ, int RHO>
__device__ __forceinline__ void combine(const float (&jv)[NQ], const int (&dbits)[NQ],
                                        float (&llr)[RHO], const Group& g) {
  const int tpf = g.sh.tpf;
#pragma unroll
  for (int b = 0; b < RHO; ++b) {
    float w0[NQ], w1[NQ];
    float m0 = kNeg, m1 = kNeg;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const bool one = (dbits[q] >> b) & 1;
      w0[q] = one ? kNeg : jv[q];
      w1[q] = one ? jv[q] : kNeg;
      m0 = q == 0 ? w0[0] : fmaxf(m0, w0[q]);
      m1 = q == 0 ? w1[0] : fmaxf(m1, w1[q]);
    }
    m0 = frame_max(m0, g, nullptr);
    m1 = frame_max(m1, g, nullptr);
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      e0 += expf(w0[q] - m0);
      e1 += expf(w1[q] - m1);
    }
    e0 = frame_sum(e0, tpf);
    e1 = frame_sum(e1, tpf);
    llr[b] = (m0 + logf(e0)) - (m1 + logf(e1));
  }
}

template <int R, int NQ, bool BACK>
__global__ void __launch_bounds__(32 * kGatherWarps) bcjr_sweep_kernel(
    const float* __restrict__ blocks,  // (T', F, B) at strides (st, sf, 1)
    long long st, long long sf,
    const float* __restrict__ metric0,  // (rows, S): tile-entry alphas, or tile-end betas
    const float* __restrict__ cols,     // (B, n_u): Theta's distinct columns
    const int16_t* __restrict__ cid,    // (S*R): column -> distinct column
    const int16_t* __restrict__ route,  // (S*R): column -> routed state
    const int* __restrict__ dec,        // (S): the rho decoded bits of each state (K6-B)
    float* __restrict__ alphas,         // (tt, rows, S): K6-F's output, K6-B's input
    float* __restrict__ out,            // (F, T' * rho): K6-B's LLRs
    int tt, int F, int rows, int B, int S_run, int n_u, int SS, int mm_dtype,
    int carry_dtype, int renorm, int split_dot) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  constexpr int kRho = rho_of<R>();
  constexpr int kS = NQ == 2 ? 64 : 0;
  const int S = kS ? kS : S_run;
  const GatherShape sh(S);
  const SweepSmem L(S, B, n_u, SS, sh.gf, kRho);
  const Group g(sh, rows, L.bytes, gsmem);
  // a warp whose rows all lie past the last (no block barrier)
  if (g.live == 0) return;
  float* l_s = reinterpret_cast<float*>(g.base + L.llr);
  float* bm_s = reinterpret_cast<float*>(g.base + L.bm);
  float* x_s = reinterpret_cast<float*>(g.base + L.x);
  float* o_s = reinterpret_cast<float*>(g.base + L.out);
  const int gf = sh.gf, tpf = sh.tpf;
  const bool live = g.fl < g.live;
  // a thread of a row past the last works on the group's first row and
  // stores nothing: its lanes still take part in every shuffle
  const long long row = live ? g.first + g.fl : g.first;
  const int x_dtype = split_dot ? (int)kF32 : mm_dtype;
  const int dir = BACK ? -1 : 1;
  const int t_start = BACK ? tt - 1 : 0;
  pin(mm_dtype);
  pin(carry_dtype);
  pin(renorm);

  int cidr[NQ][R], rt[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cidr[q][r] = cid[(g.t + q * tpf) * R + r];
      rt[q][r] = route[(g.t + q * tpf) * R + r];
    }
  int dbits[NQ];
  float lam[NQ], jb[NQ], a_next[NQ];
  float* xf = x_s + g.fl * S;  // buffer 0 of the row's metrics; 1 at + gf*S
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int j = g.t + q * tpf;
    const float m0 = metric0[row * S + j];
    lam[q] = round_to(m0, carry_dtype);
    jb[q] = m0;  // K6-B: the beta of the joint at boundary tt, unrounded
    xf[j] = round_to(lam[q], x_dtype);
    if constexpr (BACK) {
      dbits[q] = dec[j];
      a_next[q] = __ldg(alphas + ((long long)(tt - 1) * rows + row) * S + j);
    }
  }
  stage_rows(l_s, blocks, st, sf, t_start, dir, min(SS, tt), F, tt, B, g);
  int cb = 0;
  for (int t0 = 0; t0 < tt; t0 += SS) {  // t0: the steps done
    const int steps = min(SS, tt - t0);
    cp_async_wait_all();
    g.sync();  // the stage's LLRs (and at first the start metrics) visible
    stage_branch_metrics(bm_s, l_s, cols, steps, B, n_u, mm_dtype, g);
    g.sync();  // branch metrics visible; every read of l_s done
    if (t0 + SS < tt)
      stage_rows(l_s, blocks, st, sf, t_start + dir * (t0 + SS), dir, min(SS, tt - t0 - SS), F,
                 tt, B, g);
    for (int s = 0; s < steps; ++s) {
      const int t = t_start + dir * (t0 + s);
      if constexpr (BACK) {
        float jv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          jv[q] = a_next[q] + jb[q];  // the joint at boundary t + 1
          if (t > 0)
            a_next[q] = __ldg(alphas + ((long long)(t - 1) * rows + row) * S + g.t + q * tpf);
        }
        float llr[kRho];
        combine<NQ, kRho>(jv, dbits, llr, g);
        if (g.t == 0) {
#pragma unroll
          for (int b = 0; b < kRho; ++b) o_s[(s * gf + g.fl) * kRho + b] = llr[b];
        }
        if (t == 0) break;  // the last boundary: no step before it
      }
      sweep_step<R, NQ>(bm_s + (s * gf + g.fl) * n_u, cidr, rt, xf + cb * gf * S,
                        xf + (cb ^ 1) * gf * S, lam, x_dtype, carry_dtype, renorm, g);
      cb ^= 1;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if constexpr (BACK)
          jb[q] = lam[q];
        else if (live)
          alphas[((long long)t * rows + row) * S + g.t + q * tpf] = lam[q];
      }
    }
    if constexpr (BACK) {
      // the stage's LLRs out: steps t_hi down to t_hi - steps + 1 of each
      // live row, one contiguous run of steps * rho floats
      g.sync();
      const int t_hi = tt - 1 - t0, t_lo = t_hi - steps + 1;
      const long long n_steps = (long long)(rows / F) * tt;
      const int per = steps * kRho;
      for (int i = g.lane; i < g.live * per; i += g.size) {
        const int fr = i / per;
        const int e = i - fr * per;
        const int tl = e / kRho;
        const int b = e - tl * kRho;
        const long long r = g.first + fr;
        const long long p = r / F;
        out[(r - p * F) * n_steps * kRho + (p * tt + t_lo + tl) * kRho + b] =
            o_s[((t_hi - t_lo - tl) * gf + fr) * kRho + b];
      }
    }
  }
}

template <int R, int NQ, bool BACK>
cudaError_t launch_sweep(const float* blocks, long long st, long long sf, const float* metric0,
                         const float* cols, const int16_t* cid, const int16_t* route,
                         const int* dec, float* alphas, float* out, int tt, int F, int rows,
                         int B, int S, int n_u, int SS, int mm_dtype, int carry_dtype,
                         int renorm, int split_dot, cudaStream_t stream) {
  const GatherShape sh(S);
  const size_t smem = (size_t)sh.groups * SweepSmem(S, B, n_u, SS, sh.gf, rho_of<R>()).bytes;
  auto kernel = bcjr_sweep_kernel<R, NQ, BACK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((rows + sh.frames - 1) / sh.frames));
  kernel<<<grid, sh.threads, smem, stream>>>(blocks, st, sf, metric0, cols, cid, route, dec,
                                             alphas, out, tt, F, rows, B, S, n_u, SS, mm_dtype,
                                             carry_dtype, renorm, split_dot);
  return cudaGetLastError();
}

template <bool BACK, typename... Args>
cudaError_t by_radix(int R, int S, Args... args) {
  auto go = [&](auto r) -> cudaError_t {
    constexpr int kR = decltype(r)::value;
    if (S == 64) return launch_sweep<kR, 2, BACK>(args...);
    return launch_sweep<kR, 1, BACK>(args...);
  };
  switch (R) {
    case 2:
      return go(std::integral_constant<int, 2>{});
    case 4:
      return go(std::integral_constant<int, 4>{});
    case 8:
      return go(std::integral_constant<int, 8>{});
    case 16:
      return go(std::integral_constant<int, 16>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches K6-F (`backward` 0: writes `alphas`) or K6-B (`backward` 1:
// reads `alphas`, writes `out`) on `stream` (a cudaStream_t) and returns
// the launch's cudaError_t.  Does not synchronise and allocates nothing:
// the caller owns every buffer.  blocks: (T', F, B) f32 at element
// strides (st, sf, 1), T' = (rows / F) * tt; metric0: (rows, S); cols:
// (B, n_u); cid, route: (S*R) (the caller has checked that the routing
// one-hot has one 1 a column); dec: (S) (K6-B; null for K6-F); SS: the
// stage's steps.  S a power of two in [R, 64], R in {2, 4, 8, 16}, rows a
// multiple of F.
int bcjr_sweep_launch(int backward, const float* blocks, long long st, long long sf,
                      const float* metric0, const float* cols, const int16_t* cid,
                      const int16_t* route, const int* dec, float* alphas, float* out, int tt,
                      int F, int rows, int B, int S, int R, int n_u, int SS, int mm_dtype,
                      int carry_dtype, int renorm, int split_dot, int device, void* stream) {
  if (!gather_shape_ok(B, S, R, n_u, SS) || S > 64 || tt < 1 || F < 1 || rows < F ||
      rows % F != 0 || (backward && dec == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward)
    return (int)by_radix<true>(R, S, blocks, st, sf, metric0, cols, cid, route, dec, alphas,
                               out, tt, F, rows, B, S, n_u, SS, mm_dtype, carry_dtype, renorm,
                               split_dot, s);
  return (int)by_radix<false>(R, S, blocks, st, sf, metric0, cols, cid, route, dec, alphas, out,
                              tt, F, rows, B, S, n_u, SS, mm_dtype, carry_dtype, renorm,
                              split_dot, s);
}

const char* bcjr_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
