// K2 — one-pass time-tiled Viterbi decode: the fused ACS forward pass and
// a sliding-window traceback in one kernel, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `acs_decode_fused_pallas` (body
// `_fused_decode_kernel`, helper `_ring_select`) in
// src/repro/kernels/viterbi_acs.py.  Same contract: T radix steps of LLR
// blocks, cut into time tiles of TT steps, run through K1's ACS step with
// the metric carry kept on chip; the survivors go into a ring of D + TT
// steps (step s of the call at slot s mod (D+TT); the entry ring's steps
// -D..-1 at slots TT..D+TT-1).  After each tile, a walk from the argmax of
// the metrics back over the newest D steps, then TT more steps over the
// oldest tile, emits that tile's decisions: rho bits per step, LSB-first,
// as rows (j*TT + i)*rho + b of bits (T*rho, F).  At the end the exit ring
// (the newest D steps) is written back in time order.  The survivors never
// reach device memory except as that ring.
//
// Tropical only: the reference's K2 has no semiring argument, and its
// wrapper takes none.
//
// What bounds it on this card, counted from the work the step needs
// (chip_smoke.py's `acs_bound`), not from the dense matmul: K1's step,
// 703 f32 operations per frame-step at ccsds-k7, rho=2 (the walk's
// integer work is not counted), 0.176 ms over the decode_64k stream
// (512 frames x 32768 steps) at the 67 TFLOP/s non-tensor f32 peak,
// against 0.292 ms for the bytes (256 MiB of LLRs in, 32 MiB of bits out,
// and the entry and exit ring of each of its 16 launches, 640 MiB, at
// 3.35 TB/s): bound by bytes.  What this simple design runs into instead:
// the dense product's W reads from shared memory in the ACS (as K1), and
// the walk, a chain of D+TT dependent loads per tile that one thread per
// frame follows while the rest of the block waits.
//
// Design (simple and right first):
//   * one block owns BF frames for the whole T loop, as K1 does, so the
//     carry and the ring never cross blocks; one thread per (frame, state)
//     runs the ACS step of acs_step.cuh, bit for bit K1's;
//   * the ring lives in dynamic shared memory after W and the staged LLRs
//     when BF frames' rings fit there (the wrapper picks BF,
//     kernel_geometry.k2_block_frames); otherwise in a scratch buffer in
//     device memory that the wrapper allocates, read through the same
//     generic pointer;
//   * the walk: one thread per frame (threads 0..BF-1, one warp), after a
//     block barrier; a second barrier before the next tile's ACS
//     overwrites the window's oldest tile.
#include "acs_step.cuh"

namespace {

using namespace acs;

// Bytes before the ring in shared memory: W, staged LLRs, rounded and
// carried metrics, renorm partial maxima; 16-byte aligned.
__host__ __device__ inline size_t head_bytes(int B, int S, int R, int BF) {
  const size_t floats = (size_t)(B + S) * S * R + (size_t)kStageSteps * BF * B +
                        (size_t)2 * BF * S + (size_t)BF * warps_per_frame(S);
  return (floats * sizeof(float) + 15) / 16 * 16;
}

// Words of one ring step of one frame: S/16 packed int32, or S int8.
template <typename U>
__host__ __device__ inline int ring_row(int S) {
  return sizeof(U) == 4 ? S / 16 : S;
}

// U = int32_t: packed ring (16 slots per word); U = int8_t: one slot per byte.
template <int R, typename U>
__global__ void __launch_bounds__(1024) acs_decode_fused_kernel(
    const float* __restrict__ blocks,  // (T, F, B)
    const float* __restrict__ lam0,    // (F, S)
    const U* __restrict__ hist0,       // (D, F, Wd)
    const float* __restrict__ w,       // (B+S, S*R)
    int8_t* __restrict__ bits,         // (T*rho, F)
    float* __restrict__ lam_out,       // (F, S)
    U* __restrict__ hist_out,          // (D, F, Wd)
    U* ring_global,                    // (grid*BF, D+TT, Wd), or null: shared
    int T, int F, int B, int S, int BF, int D, int TT, int k, int rho,
    int mm_dtype, int carry_dtype, int renorm, int slot_bits) {
  extern __shared__ __align__(16) float smem[];
  const int K = B + S;
  const int SR = S * R;
  float* w_s = smem;                                 // K * SR
  float* l_s = w_s + (size_t)K * SR;                 // kStageSteps * BF * B
  float* x_s = l_s + (size_t)kStageSteps * BF * B;   // BF * S
  float* lam_s = x_s + (size_t)BF * S;               // BF * S
  float* red_s = lam_s + (size_t)BF * S;             // BF * warps_per_frame(S)
  const int RING = D + TT;
  const int Wd = ring_row<U>(S);
  const long long frame_ring = (long long)RING * Wd;  // one frame's ring
  U* ring = ring_global != nullptr
                ? ring_global + (long long)blockIdx.x * BF * frame_ring
                : reinterpret_cast<U*>(reinterpret_cast<unsigned char*>(smem) +
                                       head_bytes(B, S, R, BF));

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

  // entry ring: step -D+s of the stream at slot TT+s
  const long long ring_elems = (long long)nf * D * Wd;
  for (long long i = tid; i < ring_elems; i += blockDim.x) {
    const int e = (int)(i % Wd);
    const long long r = i / Wd;
    const int s = (int)(r / nf);
    const int q = (int)(r % nf);
    ring[q * frame_ring + (long long)(TT + s) * Wd + e] =
        hist0[((long long)s * F + f0 + q) * Wd + e];
  }
  // (the first ACS step's barrier orders these writes before any walk)

  const int n_tiles = T / TT;
  const int n_ring_tiles = RING / TT;
  const int shift = k - 1 - rho;
  const int mask = (1 << shift) - 1;
  U* my_ring = ring + fl * frame_ring;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int write_base = (jt % n_ring_tiles) * TT;  // slot of step jt*TT
    for (int t0 = 0; t0 < TT; t0 += kStageSteps) {
      // every read of l_s from the previous stage happened before the
      // last step's closing barrier, so the stage can be overwritten here
      const int steps = min(kStageSteps, TT - t0);
      const int per_step = nf * B;
      const long long g0 = (long long)jt * TT + t0;
      for (int i = tid; i < steps * per_step; i += blockDim.x) {
        const int tt = i / per_step;
        const int r = i - tt * per_step;
        l_s[tt * BF * B + r] =
            round_to(blocks[((g0 + tt) * F + f0) * B + r], mm_dtype);
      }
      for (int tt = 0; tt < steps; ++tt) {
        x_s[fl * S + j] = round_to(lam, mm_dtype);
        __syncthreads();  // stage and x_s complete

        int arg;
        float best = acs_best<R>(l_s + (tt * BF + fl) * B, x_s + fl * S,
                                 wcol, B, S, arg);
        U* row = my_ring + (long long)(write_base + t0 + tt) * Wd;
        if constexpr (sizeof(U) == 4) {
          const unsigned v = pack_word(arg, j, slot_bits);
          if (live && (j & 15) == 0) row[j >> 4] = (U)v;
        } else {
          if (live) row[j] = (U)arg;
        }
        best = renorm_sync(best, renorm, tid, j, S, fl, red_s);
        lam = round_to(best, carry_dtype);
      }
    }
    lam_s[fl * S + j] = lam;
    __syncthreads();  // metrics and this tile's survivors visible

    if (tid < nf) {
      // the walk of frame f0+tid, from the first argmax of its metrics
      const float* lr = lam_s + tid * S;
      int state = 0;
      float m = lr[0];
      for (int q = 1; q < S; ++q) {
        if (lr[q] > m) {
          m = lr[q];
          state = q;
        }
      }
      const U* rf = ring + tid * frame_ring;
      const int read_base = ((jt + 1) % n_ring_tiles) * TT;  // window[0]
      auto walk = [&](int i) {
        int slot = read_base + i;
        if (slot >= RING) slot -= RING;
        const U* rrow = rf + (long long)slot * Wd;
        int sel;
        if constexpr (sizeof(U) == 4) {
          const unsigned word = (unsigned)rrow[state >> 4];
          sel = (int)((word >> (slot_bits * (state & 15))) & (unsigned)(R - 1));
        } else {
          sel = (int)rrow[state];
        }
        state = ((state & mask) << rho) | sel;
      };
      for (int i = RING - 1; i >= TT; --i) walk(i);  // lookahead: newest D
      int8_t* out = bits + f0 + tid;
      for (int i = TT - 1; i >= 0; --i) {  // the oldest tile: emit, then walk
        const int v = state >> shift;
        const long long row0 = ((long long)jt * TT + i) * rho;
        for (int b = 0; b < rho; ++b) out[(row0 + b) * F] = (int8_t)((v >> b) & 1);
        walk(i);
      }
    }
    __syncthreads();  // the walk is done before the next tile's ACS
                      // overwrites the window's oldest tile
  }

  if (live) lam_out[frame * S + j] = lam;
  // exit ring: the newest D steps, rotated back into time order
  const int base = ((n_tiles + 1) % n_ring_tiles) * TT;
  for (long long i = tid; i < ring_elems; i += blockDim.x) {
    const int e = (int)(i % Wd);
    const long long r = i / Wd;
    const int s = (int)(r / nf);
    const int q = (int)(r % nf);
    int slot = base + s;
    if (slot >= RING) slot -= RING;
    hist_out[((long long)s * F + f0 + q) * Wd + e] =
        ring[q * frame_ring + (long long)slot * Wd + e];
  }
}

template <int R, typename U>
cudaError_t launch(const float* blocks, const float* lam0, const void* hist0,
                   const float* w, int8_t* bits, float* lam_out, void* hist_out,
                   void* ring_global, int T, int F, int B, int S, int BF, int D,
                   int TT, int k, int rho, int mm_dtype, int carry_dtype,
                   int renorm, int slot_bits, size_t smem, cudaStream_t stream) {
  // the caller sizes shared memory (kernel_geometry.k2_smem_bytes); refuse
  // a size that does not hold this layout
  const size_t ring = ring_global == nullptr
                          ? (size_t)BF * (D + TT) * ring_row<U>(S) * sizeof(U)
                          : 0;
  if (smem < head_bytes(B, S, R, BF) + ring) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      acs_decode_fused_kernel<R, U>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + BF - 1) / BF));
  const dim3 block((unsigned)(BF * S));
  acs_decode_fused_kernel<R, U><<<grid, block, smem, stream>>>(
      blocks, lam0, static_cast<const U*>(hist0), w, bits, lam_out,
      static_cast<U*>(hist_out), static_cast<U*>(ring_global), T, F, B, S,
      BF, D, TT, k, rho, mm_dtype, carry_dtype, renorm, slot_bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t) with `smem_bytes` of dynamic
// shared memory a block and returns the launch's cudaError_t.  Does not
// synchronise and allocates nothing: the caller owns every buffer,
// `ring_global` included (null keeps the rings in shared memory).  BF * S threads per block, a multiple of 32 and at most
// 1024; T % TT == 0, D % TT == 0; packed only for R <= 4 and S % 16 == 0.
int acs_decode_fused_launch(const float* blocks, const float* lam0,
                            const void* hist0, const float* w, int8_t* bits,
                            float* lam_out, void* hist_out, void* ring_global,
                            int T, int F, int B, int S, int R, int BF, int D,
                            int TT, int k, int rho, int mm_dtype,
                            int carry_dtype, int renorm, int packed,
                            int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_ARGS                                                              \
  blocks, lam0, hist0, w, bits, lam_out, hist_out, ring_global, T, F, B, S, \
      BF, D, TT, k, rho, mm_dtype, carry_dtype, renorm
  if (packed) {
    switch (R) {
      case 2: return (int)launch<2, int32_t>(K2_ARGS, 1, (size_t)smem_bytes, s);
      case 4: return (int)launch<4, int32_t>(K2_ARGS, 2, (size_t)smem_bytes, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (R) {
    case 2: return (int)launch<2, int8_t>(K2_ARGS, 1, (size_t)smem_bytes, s);
    case 4: return (int)launch<4, int8_t>(K2_ARGS, 2, (size_t)smem_bytes, s);
    case 8: return (int)launch<8, int8_t>(K2_ARGS, 3, (size_t)smem_bytes, s);
    case 16: return (int)launch<16, int8_t>(K2_ARGS, 4, (size_t)smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_ARGS
}

const char* acs_decode_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
