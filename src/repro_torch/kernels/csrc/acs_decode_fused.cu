// K2 — one-pass time-tiled Viterbi decode: the fused ACS forward pass and
// a sliding-window traceback in one kernel, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `acs_decode_fused_pallas` (body
// `_fused_decode_kernel`, helper `_ring_select`) in
// src/repro/kernels/viterbi_acs.py.  Same contract: T radix steps of LLR
// blocks, cut into time tiles of TT steps, run through the ACS step with
// the metric carry kept on chip; the survivors go into a ring (the entry
// ring `hist0` holds the stream's steps -D..-1).  After each tile, a walk
// from the first argmax of the metrics back over the newest D steps, then
// TT more steps over the oldest tile, emits that tile's decisions: rho
// bits per step, LSB-first, as rows (j*TT + i)*rho + b of bits (T*rho,
// F).  At the end the exit ring (the newest D steps) is written back in
// time order.  The survivors never reach device memory except as that
// ring.
//
// Tropical only: the reference's K2 has no semiring argument, and its
// wrapper takes none.
//
// Design:
//   * the ACS step is acs_step.cuh's gathered step, K1's, with K1's bits:
//     no W (the wrapper checks W's metric half and passes Theta's
//     distinct columns), a frame over S/NQ threads with a barrier over
//     the frame's own threads a step, LLRs staged with cp.async;
//   * one block owns its frames for the whole T loop (kGatherWarps warps
//     of one or more frames, or one frame of S/2 threads from S = 128),
//     plus one walk warp; with W out of shared memory, four frames' rings
//     of the streaming geometry (S = 64, D = 2560, TT = 32, packed: 2,624
//     steps of 16 bytes each, and their tile maps) fit beside the
//     staging, so F = 512 frames are 128 blocks: one wave on 132 SMs
//     (kernel_geometry.k2_block_frames takes the most warps whose rings
//     fit, unless the rings and maps in a scratch buffer in device memory,
//     read through the same generic pointer, at four warps a block take
//     fewer waves of the call's frames: the step is latency-bound, so
//     waves multiply the time, and a wave with its rings in device memory
//     takes about twice as long as one with them in shared memory);
//   * per-tile state maps instead of a walk of D + TT dependent loads
//     per tile: during a tile's ACS each state carries the origin of its
//     survivor path at the tile's start (the origin of the chosen
//     predecessor, from the identity at the tile's start: one u16 vector
//     load and store a step, off the metrics' chain), so after the tile's
//     last step map[s] is the state at the tile's start of the path that
//     ends in s, S bytes a tile.  The entry ring's D/TT tiles get their maps by
//     walking TT steps back from every state, at the launch's start.  The
//     walk composes the D/TT maps of the lookahead from the first argmax
//     (D/TT dependent loads, not D), then walks and emits the oldest
//     tile's TT steps through the survivors.  Map composition visits, at
//     each tile boundary, exactly the state the reference's walk reaches
//     there, so the bits are the same, ties included
//     (kernels/ref.py::acs_decode_fused_maps_ref models it);
//   * the walk runs on the walk warp, one lane a frame, while the frame
//     threads run the next tile's ACS: named barriers hand a tile over
//     (FULL: its survivors, map and start state are in shared memory) and
//     back (EMPTY: its walk is done).  The ring is one tile longer than
//     the window (D + 2 TT steps, step s at slot s mod (D + 2 TT)), and
//     the start states have two buffers by the tile's parity, so tile
//     jt+1's ACS writes nothing that the walk of tile jt reads; tile jt+2
//     waits for that walk.
//
#include "acs_step.cuh"

namespace {

using namespace acs;

// Words of one ring step of one frame: S/16 packed int32, or S int8.
template <typename U>
__host__ __device__ inline int ring_row(int S) {
  return sizeof(U) == 4 ? S / 16 : S;
}

// Ring tiles a frame keeps: the D/TT tiles of the lookahead, the oldest
// tile, which the walk emits, and one more, so that the ACS of tile jt+1
// writes a tile that the walk of tile jt, running beside it on the walk
// warp, does not read.
__host__ __device__ inline int ring_tiles(int D, int TT) { return D / TT + 2; }

// One frame's ring (ring_tiles * TT steps of ring_row words) and its tile
// maps (ring_tiles x S states, u8 where S <= 256, else u16), each 16-byte
// aligned: the stride between frames' rings (kernel_geometry.k2_frame_bytes).
__host__ __device__ inline size_t ring_bytes(int S, int D, int TT, int usize) {
  return align16((size_t)ring_tiles(D, TT) * TT * (usize == 4 ? S / 16 * 4 : S));
}

__host__ __device__ inline size_t frame_bytes(int S, int D, int TT, int usize) {
  return ring_bytes(S, D, TT, usize) +
         align16((size_t)ring_tiles(D, TT) * S * (S <= 256 ? 1 : 2));
}

// The slot of `state` in one ring step.
template <typename U>
__device__ __forceinline__ int ring_select(const U* row, int state, int R,
                                           int slot_bits) {
  if constexpr (sizeof(U) == 4) {
    const unsigned word = (unsigned)row[state >> 4];
    return (int)((word >> (slot_bits * (state & 15))) & (unsigned)(R - 1));
  } else {
    return (int)row[state] & (R - 1);
  }
}

__device__ __forceinline__ int map_load(const unsigned char* maps, int i, bool map8) {
  return map8 ? (int)maps[i] : (int)reinterpret_cast<const uint16_t*>(maps)[i];
}

__device__ __forceinline__ void map_store(unsigned char* maps, int i, int v, bool map8) {
  if (map8)
    maps[i] = (unsigned char)v;
  else
    reinterpret_cast<uint16_t*>(maps)[i] = (uint16_t)v;
}

// Named barriers between the frame threads and the walk warp: tile jt's
// survivors, map and start state are in shared memory (FULL), tile jt's
// walk is done (EMPTY).  Two of each, by the tile's parity: a barrier is
// used again only two tiles later, after a wait that orders it, so it
// never holds arrivals of two tiles.
constexpr int kFullBarrier = 1;   // and 2
constexpr int kEmptyBarrier = 3;  // and 4

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// U = int32_t: packed ring (16 slots per word); U = int8_t: one slot per byte.
template <int R, int NQ, bool WIDE, typename U>
__global__ void __launch_bounds__(WIDE ? kGatherMaxThreads + 32 : 32 * (kGatherWarps + 1),
                                  WIDE ? 1 : 3)
acs_decode_fused_kernel(
    const float* __restrict__ blocks,  // (T, F, B)
    const float* __restrict__ lam0,    // (F, S)
    const U* __restrict__ hist0,       // (D, F, Wd)
    const float* __restrict__ cols,    // (B, n_u): Theta's distinct columns
    const int16_t* __restrict__ cid,   // (S*R): column -> distinct column
    int8_t* __restrict__ bits,         // (T*rho, F)
    float* __restrict__ lam_out,       // (F, S)
    U* __restrict__ hist_out,          // (D, F, Wd)
    unsigned char* ring_global,        // grid * frames * frame_bytes, or null
    int T, int F, int B, int S_run, int n_u, int SS, int warps, int D, int TT,
    int k, int rho, int mm_dtype, int carry_dtype, int renorm, int slot_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kS = fixed_states<NQ, WIDE>();
  const int S = kS ? kS : S_run;
  const GatherShape sh(S, warps);
  const GroupSmem L(S, B, n_u, SS, sh.gf, true);
  const int n_ring = ring_tiles(D, TT);
  const int RING = n_ring * TT;
  const int K = D / TT;  // the lookahead's tiles
  const int Wd = ring_row<U>(S);
  const bool map8 = S <= 256;
  const size_t fbytes = frame_bytes(S, D, TT, sizeof(U));
  const size_t rbytes = ring_bytes(S, D, TT, sizeof(U));
  const size_t head = (size_t)sh.groups * L.bytes;
  // the frames' start states, two buffers by the tile's parity: tile jt+1
  // writes its own while the walk of tile jt still reads tile jt's
  int* start_s = reinterpret_cast<int*>(smem + head);
  unsigned char* rings =
      ring_global != nullptr ? ring_global + (size_t)blockIdx.x * sh.frames * fbytes
                             : smem + head + align16((size_t)sh.frames * 8);
  const int shift = k - 1 - rho;
  const int mask = (1 << shift) - 1;  // S/R - 1
  const int n_tiles = T / TT;
  const int sync_count = sh.threads + 32;  // the frame threads and the walk warp
  const long long f_block = (long long)blockIdx.x * sh.frames;

  if ((int)threadIdx.x >= sh.threads) {
    // The walk warp: after tile jt, for each live frame of the block (one a
    // lane), compose the lookahead's maps, newest first, from the frame's
    // first argmax, then walk and emit the oldest tile.
    const int lane = (int)threadIdx.x - sh.threads;
    const long long left = (long long)F - f_block;
    const int live_frames = left < sh.frames ? (int)left : sh.frames;
    for (int jt = 0; jt < n_tiles; ++jt) {
      bar_sync(kFullBarrier + (jt & 1), sync_count);
      for (int fb = lane; fb < live_frames; fb += 32) {
        const U* ring = reinterpret_cast<const U*>(rings + (size_t)fb * fbytes);
        const unsigned char* maps = rings + (size_t)fb * fbytes + rbytes;
        int state = start_s[(jt & 1) * sh.frames + fb];
        int rt = jt % n_ring;
        for (int q = 0; q < K; ++q) {
          state = map_load(maps, rt * S + state, map8);
          rt = rt == 0 ? n_ring - 1 : rt - 1;
        }
        const U* oldest = ring + (size_t)rt * TT * Wd;  // ring tile (jt - K) mod n_ring
        int8_t* out = bits + f_block + fb;
        for (int i = TT - 1; i >= 0; --i) {
          const int v = state >> shift;
          const long long row0 = ((long long)jt * TT + i) * rho;
          for (int b = 0; b < rho; ++b) out[(row0 + b) * F] = (int8_t)((v >> b) & 1);
          state = ((state & mask) << rho) |
                  ring_select<U>(oldest + (size_t)i * Wd, state, R, slot_bits);
        }
      }
      __syncwarp();
      bar_arrive(kEmptyBarrier + (jt & 1), sync_count);
    }
    return;
  }

  // The frame threads.  A group whose frames all lie past F still takes
  // part in the barriers (it writes nothing).
  const Group g(sh, F, L.bytes, smem);
  float* l_s = reinterpret_cast<float*>(g.base + L.llr);
  float* bm_s = reinterpret_cast<float*>(g.base + L.bm);
  float* x_s = reinterpret_cast<float*>(g.base + L.x);
  uint16_t* o_s = reinterpret_cast<uint16_t*>(g.base + L.orig);
  unsigned char* phi_s = g.base + L.phi;
  float* red = reinterpret_cast<float*>(g.base + L.red);
  const int gf = sh.gf, tpf = sh.tpf;
  // frame f of this group: its ring and its maps
  auto ring_of = [&](int f) {
    return reinterpret_cast<U*>(rings + (size_t)(g.id * gf + f) * fbytes);
  };
  auto maps_of = [&](int f) {
    return rings + (size_t)(g.id * gf + f) * fbytes + rbytes;
  };
  const bool live = g.fl < g.live;
  const long long frame = g.first + g.fl;
  const int gR = (g.t & mask) * R;
  pin(mm_dtype);
  pin(carry_dtype);
  pin(renorm);
  U* my_ring = ring_of(g.fl);
  unsigned char* my_maps = maps_of(g.fl);

  // entry ring: step -D+s of the stream at slot (-D+s) mod RING = 2TT+s
  {
    const int per = g.live * Wd;
    for (long long i = g.lane; i < (long long)D * per; i += g.size) {
      const int s = (int)(i / per);
      const int r = (int)(i - (long long)s * per);
      const int f = r / Wd;
      const int e = r - f * Wd;
      ring_of(f)[(size_t)(2 * TT + s) * Wd + e] =
          hist0[((long long)s * F + g.first) * Wd + r];
    }
  }
  g.sync();
  // the entry tiles' maps (ring tiles 2 .. n_ring-1): each state walks TT
  // steps back, two tiles at a time
  if (live) {
    for (int rt = 2; rt < n_ring; rt += 2) {
      const int nt = n_ring - rt < 2 ? n_ring - rt : 2;
      int st[2][NQ];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) st[a][q] = g.t + q * tpf;
      for (int i = TT - 1; i >= 0; --i) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a < nt) {
            const U* row = my_ring + (size_t)((rt + a) * TT + i) * Wd;
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              st[a][q] = ((st[a][q] & mask) << rho) |
                         ring_select<U>(row, st[a][q], R, slot_bits);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
        if (a < nt)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            map_store(my_maps, (rt + a) * S + g.t + q * tpf, st[a][q], map8);
    }
  }

  int cidr[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) cidr[q][r] = cid[(g.t + q * tpf) * R + r];

  float lam[NQ];
  float* xf = x_s + g.fl * S;     // buffer 0 of the frame's metrics; 1 at + gf*S
  uint16_t* of = o_s + g.fl * S;  // buffer 0 of the frame's origins; 1 at + gf*S
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int j = g.t + q * tpf;
    lam[q] = live ? round_to(lam0[frame * S + j], carry_dtype) : 0.f;
    xf[j] = round_to(lam[q], mm_dtype);
    of[j] = (uint16_t)j;  // the first tile starts from the identity
  }

  stage_llrs(l_s, blocks, 0, min(SS, TT), F, B, g);
  int cb = 0;  // the metrics' buffer
  int ob = 0;  // the origins' buffer
  for (int jt = 0; jt < n_tiles; ++jt) {
    // tile jt writes the ring tile that the walk of tile jt-2 read
    if (jt >= 2) bar_sync(kEmptyBarrier + (jt & 1), sync_count);
    const int rt_new = jt % n_ring;  // this tile's ring tile
    const int write_base = rt_new * TT;
    for (int t0 = 0; t0 < TT; t0 += SS) {
      const int steps = min(SS, TT - t0);
      cp_async_wait_all();
      g.sync();  // the stage's LLRs visible
      stage_branch_metrics(bm_s, l_s, cols, steps, B, n_u, mm_dtype, g);
      g.sync();  // branch metrics visible; every read of l_s done
      if (t0 + SS < TT)
        stage_llrs(l_s, blocks, (long long)jt * TT + t0 + SS, min(SS, TT - t0 - SS), F, B, g);
      else if (jt + 1 < n_tiles)
        stage_llrs(l_s, blocks, (long long)(jt + 1) * TT, min(SS, TT), F, B, g);
      for (int s = 0; s < steps; ++s) {
        gather_step<R, NQ, true>(bm_s + (s * gf + g.fl) * n_u, cidr,
                                 xf + cb * gf * S, xf + (cb ^ 1) * gf * S,
                                 phi_s + (size_t)(s * gf + g.fl) * S, lam, gR, S,
                                 mm_dtype, carry_dtype, renorm, g, red,
                                 of + ob * gf * S, of + (ob ^ 1) * gf * S);
        cb ^= 1;
        ob ^= 1;
      }
      // the stage's survivors into the ring
      flush_survivors(phi_s, steps, S, sizeof(U) == 4, slot_bits, g,
                      [&](int s, int f) -> void* {
                        return ring_of(f) + (size_t)(write_base + t0 + s) * Wd;
                      });
    }
    // the tile's map: each state's origin at the tile's start; the origins
    // restart from the identity for the next tile (read after its first
    // barrier)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = g.t + q * tpf;
      map_store(my_maps, rt_new * S + j, of[ob * gf * S + j], map8);
      of[ob * gf * S + j] = (uint16_t)j;
    }
    g.sync();  // the tile's survivors and map written
    const int start = frame_argmax<NQ>(lam, g, red);
    if (live && g.t == 0) start_s[(jt & 1) * sh.frames + g.id * gf + g.fl] = start;
    __threadfence_block();
    bar_arrive(kFullBarrier + (jt & 1), sync_count);
  }
  // the walks of the last two tiles, before the block's rings go
  for (int jt = n_tiles < 2 ? 0 : n_tiles - 2; jt < n_tiles; ++jt)
    bar_sync(kEmptyBarrier + (jt & 1), sync_count);

  if (live) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) lam_out[frame * S + g.t + q * tpf] = lam[q];
  }
  // exit ring: the newest D steps, at slots (T - D + s) mod RING, in time order
  const int base = ((n_tiles + 2) % n_ring) * TT;
  const int per = g.live * Wd;
  for (long long i = g.lane; i < (long long)D * per; i += g.size) {
    const int s = (int)(i / per);
    const int r = (int)(i - (long long)s * per);
    const int f = r / Wd;
    const int e = r - f * Wd;
    int slot = base + s;
    if (slot >= RING) slot -= RING;
    hist_out[((long long)s * F + g.first) * Wd + r] = ring_of(f)[(size_t)slot * Wd + e];
  }
}

template <int R, int NQ, bool WIDE, typename U>
cudaError_t launch(const float* blocks, const float* lam0, const void* hist0,
                   const float* cols, const int16_t* cid, int8_t* bits,
                   float* lam_out, void* hist_out, void* ring_global,
                   long long ring_global_bytes, int T, int F, int B, int S,
                   int n_u, int SS, int BF, int D, int TT, int k, int rho,
                   int mm_dtype, int carry_dtype, int renorm,
                   long long smem_bytes, cudaStream_t stream) {
  // BF frames a block: whole warps of frames up to kGatherWarps, or one
  // wide frame
  const GatherShape one(S, 1);
  const int warps = one.wide() ? 1 : BF / one.gf;
  if (one.wide() ? BF != 1 : (BF % one.gf != 0 || warps < 1 || warps > kGatherWarps))
    return cudaErrorInvalidValue;
  const GatherShape sh(S, warps);
  const unsigned grid = (unsigned)((F + sh.frames - 1) / sh.frames);
  const size_t fb = frame_bytes(S, D, TT, sizeof(U));
  // the caller sizes shared memory (kernel_geometry.k2_smem_bytes) and the
  // scratch rings; refuse sizes that are not this layout's
  if (ring_global != nullptr && ring_global_bytes < (long long)((size_t)grid * sh.frames * fb))
    return cudaErrorInvalidValue;
  const size_t rings = ring_global == nullptr ? (size_t)sh.frames * fb : 0;
  const size_t smem = (size_t)sh.groups * GroupSmem(S, B, n_u, SS, sh.gf, true).bytes +
                      align16((size_t)sh.frames * 8) + rings;
  if ((long long)smem != smem_bytes) return cudaErrorInvalidValue;
  auto kernel = acs_decode_fused_kernel<R, NQ, WIDE, U>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kSlotBits = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  kernel<<<grid, sh.threads + 32, smem, stream>>>(
      blocks, lam0, static_cast<const U*>(hist0), cols, cid, bits, lam_out,
      static_cast<U*>(hist_out), static_cast<unsigned char*>(ring_global), T,
      F, B, S, n_u, SS, warps, D, TT, k, rho, mm_dtype, carry_dtype, renorm,
      kSlotBits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t) with `smem_bytes` of dynamic
// shared memory a block and returns the launch's cudaError_t.  Does not
// synchronise and allocates nothing: the caller owns every buffer,
// `ring_global` included (null keeps the rings and maps in shared
// memory; else `ring_global_bytes`, at least grid * BF *
// kernel_geometry.k2_frame_bytes).  cols: Theta's n_u distinct columns
// (B, n_u); cid: each of the S*R columns' index among them (the caller
// has checked that W's metric half is the shift register's one-hot); SS,
// BF: the stage's steps and the frames a block (kernel_geometry.
// gather_stage_steps, k2_block_frames).  T % TT
// == 0, D % TT == 0; S = 2^(k-1) a power of two in [R, 1024], R = 2^rho;
// packed only for R <= 4 and S % 16 == 0.
int acs_decode_fused_launch(const float* blocks, const float* lam0,
                            const void* hist0, const float* cols,
                            const int16_t* cid, int8_t* bits, float* lam_out,
                            void* hist_out, void* ring_global,
                            long long ring_global_bytes, int T, int F, int B,
                            int S, int R, int n_u, int SS, int BF, int D,
                            int TT, int k, int rho, int mm_dtype,
                            int carry_dtype, int renorm, int packed,
                            long long smem_bytes, int device, void* stream) {
  if (!gather_shape_ok(B, S, R, n_u, SS) || F <= 0 || TT <= 0 || T <= 0 ||
      T % TT != 0 || D < 0 || D % TT != 0 || R != (1 << rho) ||
      S != (1 << (k - 1)) || (packed && (S % 16 != 0 || R > 4)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_radix_and_nq(R, S, [&](auto r, auto nq, auto wide) -> cudaError_t {
    constexpr int kR = decltype(r)::value;
    constexpr int kNQ = decltype(nq)::value;
    constexpr bool kWide = decltype(wide)::value;
#define K2_ARGS                                                             \
  blocks, lam0, hist0, cols, cid, bits, lam_out, hist_out, ring_global,    \
      ring_global_bytes, T, F, B, S, n_u, SS, BF, D, TT, k, rho, mm_dtype, \
      carry_dtype, renorm, smem_bytes, s
    if (packed) {
      if constexpr (kR <= 4) return launch<kR, kNQ, kWide, int32_t>(K2_ARGS);
      return cudaErrorInvalidValue;
    }
    return launch<kR, kNQ, kWide, int8_t>(K2_ARGS);
#undef K2_ARGS
  });
}

// Blocks of BF frames (S states, radix R, a packed or int8 ring) that one
// SM holds at `smem_bytes` of shared memory a block, by the occupancy
// calculator; -1 on a shape the launcher refuses.
int acs_decode_fused_blocks_per_sm(int S, int R, int BF, int packed,
                                   long long smem_bytes) {
  const GatherShape one(S, 1);
  const int warps = one.wide() ? 1 : BF / one.gf;
  const GatherShape sh(S, warps);
  int n = -1;
  cudaError_t err = with_radix_and_nq(R, S, [&](auto r, auto nq, auto wide) -> cudaError_t {
    constexpr int kR = decltype(r)::value;
    constexpr int kNQ = decltype(nq)::value;
    constexpr bool kWide = decltype(wide)::value;
    auto query = [&](auto kernel) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, sh.threads + 32, (size_t)smem_bytes);
    };
    if (packed) {
      if constexpr (kR <= 4) return query(acs_decode_fused_kernel<kR, kNQ, kWide, int32_t>);
      return cudaErrorInvalidValue;
    }
    return query(acs_decode_fused_kernel<kR, kNQ, kWide, int8_t>);
  });
  return err == cudaSuccess ? n : -1;
}

const char* acs_decode_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
