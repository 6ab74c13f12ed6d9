// K4 — the semiring product of S x S matrices, the compose of the
// time-parallel and soft scans, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves this compose to XLA's
// broadcast and reduce (`Semiring.matmul` in src/repro/core/semiring.py,
// called at every level of `associative_scan`).  It was added because the
// port's plain version (`Semiring.matmul_plain`) writes the (batch, S, S,
// S) sums to device memory and reads them back for the max, and at
// LOGPROB for the subtraction, the exp and the sum: about 7 MiB of
// traffic for each 64 x 64 product that needs 48 KiB, in a loop of chunks.
// It computes, for each product b of the batch,
//
//     C[b, i, j] = sum_k A[b, i, k] * B[b, k, j]
//
// in the semiring: TROPICAL max_k (A + B); LOGPROB m + logf(sum_k expf(x_k
// - m)) with x_k = A[b, i, k] + B[b, k, j] and m = max_k x_k, the plain
// version's form, with no exp-domain rescaling (a rescale by row and
// column maxima underflows where those maxima sit at different k, and is
// another result).  The operands arrive already rounded to the matmul
// dtype (the wrapper quantises them); every sum is f32.
//
// Parity.  At TROPICAL each output is one f32 add and a max over k, whose
// value does not depend on the order: bit-identical to the plain version.
// At LOGPROB the max and the x_k are the plain version's bits; the sum of
// the S accurate expf (no fast math) is taken in k order from 0 and the
// plain version's reduction picks its own order, so the two differ in
// the rounding of that sum alone: within 1e-4 at the scans' magnitudes.
//
// Design: one block of kThreads = 256 threads takes kProducts products
// (one at S = 64, four at 32, sixteen at 16, ...).  Each product's A and
// B are copied as they are into shared memory with 16-byte loads and
// stores, at a row pitch of S + 4 floats from S = 16 (rows stay 16-byte
// aligned, and the rows four apart that a warp reads fall on other
// banks).  Each thread then holds a kTile x kTile tile of C in registers
// (4 x 4 from S = 4) and walks k = 0 .. S-1 four at a time, reading its
// four rows of A and four rows of B as one vector load each (a row of A
// is a broadcast among the threads that share it).  At LOGPROB it walks
// k twice, once for the max and once for the sum, from shared memory.
// The batch is one or two levels of strides, so the wrapper passes
// `associative_scan`'s dim-0-strided views without a copy; each
// product's two matrix addresses are worked out once, by one thread.
//
// What bounds it on this card.  TROPICAL: per product S^3 adds and maxes,
// 2 S^3 f32 operations at 33.45e12/s, and 3 S^2 floats of traffic at
// 3.35e12 B/s; at the time-parallel latency cell (16 frames, 512 tiles,
// 34 launches a call, 32,416 products of 64 x 64) 0.51 ms of operations
// and 0.47 ms of bytes.  LOGPROB: S^3 accurate expf at the special-function
// rate (16 a clock per SM, 132 SMs at 1.98 GHz: 4.18e12/s) beside 4 S^3
// f32 operations; at the soft cell (256 frames, 128 tiles, 26 launches,
// 126,464 products) 7.9 ms of special functions.  The accurate expf is
// several f32 instructions around its MUFU.EX2, so the LOGPROB kernel
// runs into the f32 pipes before the special-function unit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
enum SemiringCode { kTropical = 0, kLogprob = 1 };  // semiring.py's names

// A batch operand: matrix b (of the flattened batch) starts at
// base + (b / inner) * outer_stride + (b % inner) * inner_stride floats,
// its S rows of S floats contiguous.
struct Operand {
  const float* base;
  long long inner, inner_stride, outer_stride;
};

__device__ __forceinline__ const float* matrix(const Operand& x, long long b) {
  return x.base + (b / x.inner) * x.outer_stride + (b % x.inner) * x.inner_stride;
}

// The block geometry of S x S products.
template <int S>
struct Geometry {
  static constexpr int kTile = S < 4 ? S : 4;             // C tile a thread, each way
  static constexpr int kSide = S / kTile;                 // threads along C's rows
  static constexpr int kPerProduct = kSide * kSide;       // threads a product
  static constexpr int kProducts = kThreads / kPerProduct;
  static constexpr int kPitch = S >= 16 ? S + 4 : S;      // floats a shared row
  static constexpr int kMatrix = S * kPitch;              // floats a shared matrix
};

// W consecutive floats of shared memory, as one vector load at W = 4.
template <int W>
__device__ __forceinline__ void load_run(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = p[q];
  }
}

// The block's products into shared memory as they are, at G::kPitch
// floats a row: 16-byte loads and stores where S % 4 == 0 (the wrapper
// passes 16-byte aligned matrices then), else one float at a time.
template <int S>
__device__ __forceinline__ void stage(const float* const* src, int count, float* dst) {
  using G = Geometry<S>;
  constexpr int kVec = S % 4 == 0 ? 4 : 1;
  constexpr int kPieces = S * S / kVec;  // loads a matrix
  for (int v = threadIdx.x; v < count * kPieces; v += kThreads) {
    const int p = v / kPieces, e = (v % kPieces) * kVec;
    float* to = dst + p * G::kMatrix + (e / S) * G::kPitch + e % S;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(to) = __ldg(reinterpret_cast<const float4*>(src[p] + e));
    } else {
      *to = __ldg(src[p] + e);
    }
  }
}

template <int S, int SEMI>
__global__ void __launch_bounds__(kThreads)
    semiring_compose_kernel(Operand a, Operand b, float* __restrict__ c, long long n) {
  using G = Geometry<S>;
  constexpr int T = G::kTile;
  __shared__ __align__(16) float as[G::kProducts * G::kMatrix];
  __shared__ __align__(16) float bs[G::kProducts * G::kMatrix];
  __shared__ const float* src[2][G::kProducts];
  const long long first = (long long)blockIdx.x * G::kProducts;
  const int count = (int)min((long long)G::kProducts, n - first);
  if ((int)threadIdx.x < count) {
    src[0][threadIdx.x] = matrix(a, first + threadIdx.x);
    src[1][threadIdx.x] = matrix(b, first + threadIdx.x);
  }
  __syncthreads();
  stage<S>(src[0], count, as);
  stage<S>(src[1], count, bs);
  __syncthreads();
  const int p = threadIdx.x / G::kPerProduct, t = threadIdx.x % G::kPerProduct;
  if (p >= count) return;  // a ragged last block's idle products
  const int i0 = (t / G::kSide) * T, j0 = (t % G::kSide) * T;
  const float* rows_a = as + p * G::kMatrix + i0 * G::kPitch;  // A[i0 + r, k]
  const float* rows_b = bs + p * G::kMatrix + j0;              // B[k, j0 + q]

  // A[i0 + r, k .. k+T-1] and B[k .. k+T-1, j0 .. j0+T-1]: T steps of k
  auto load = [&](int k, float (&av)[T][T], float (&bv)[T][T]) {
#pragma unroll
    for (int r = 0; r < T; ++r) load_run<T>(rows_a + r * G::kPitch + k, av[r]);
#pragma unroll
    for (int d = 0; d < T; ++d) load_run<T>(rows_b + (k + d) * G::kPitch, bv[d]);
  };

  float m[T][T];
#pragma unroll
  for (int r = 0; r < T; ++r)
#pragma unroll
    for (int q = 0; q < T; ++q) m[r][q] = -INFINITY;
#pragma unroll 2
  for (int k = 0; k < S; k += T) {
    float av[T][T], bv[T][T];
    load(k, av, bv);
#pragma unroll
    for (int d = 0; d < T; ++d)
#pragma unroll
      for (int r = 0; r < T; ++r)
#pragma unroll
        for (int q = 0; q < T; ++q) m[r][q] = fmaxf(m[r][q], av[r][d] + bv[d][q]);
  }
  if constexpr (SEMI == kLogprob) {
    float s[T][T];
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
      for (int q = 0; q < T; ++q) s[r][q] = 0.0f;
    for (int k = 0; k < S; k += T) {  // k in order from 0
      float av[T][T], bv[T][T];
      load(k, av, bv);
#pragma unroll
      for (int d = 0; d < T; ++d)
#pragma unroll
        for (int r = 0; r < T; ++r)
#pragma unroll
          for (int q = 0; q < T; ++q) s[r][q] += expf((av[r][d] + bv[d][q]) - m[r][q]);
    }
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
      for (int q = 0; q < T; ++q) m[r][q] = m[r][q] + logf(s[r][q]);
  }
  float* out = c + (first + p) * (S * S) + i0 * S + j0;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    if constexpr (T == 4) {
      *reinterpret_cast<float4*>(out + r * S) =
          make_float4(m[r][0], m[r][1], m[r][2], m[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < T; ++q) out[r * S + q] = m[r][q];
    }
  }
}

template <int S, int SEMI>
cudaError_t launch(const Operand& a, const Operand& b, float* c, long long n,
                   cudaStream_t stream) {
  constexpr int kProducts = Geometry<S>::kProducts;
  const long long blocks = (n + kProducts - 1) / kProducts;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  semiring_compose_kernel<S, SEMI><<<(unsigned)blocks, kThreads, 0, stream>>>(a, b, c, n);
  return cudaGetLastError();
}

template <int SEMI>
cudaError_t launch_states(int S, const Operand& a, const Operand& b, float* c,
                          long long n, cudaStream_t stream) {
  switch (S) {
    case 1:
      return launch<1, SEMI>(a, b, c, n, stream);
    case 2:
      return launch<2, SEMI>(a, b, c, n, stream);
    case 4:
      return launch<4, SEMI>(a, b, c, n, stream);
    case 8:
      return launch<8, SEMI>(a, b, c, n, stream);
    case 16:
      return launch<16, SEMI>(a, b, c, n, stream);
    case 32:
      return launch<32, SEMI>(a, b, c, n, stream);
    case 64:
      return launch<64, SEMI>(a, b, c, n, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K4 on `stream` (a cudaStream_t) and returns the launch's
// cudaError_t.  Does not synchronise and allocates nothing.  n products of
// S x S f32 matrices, S a power of two up to 64; operand x's matrix b
// starts at x + (b / x_inner) * x_outer + (b % x_inner) * x_stride floats
// with contiguous rows, 16-byte aligned where S % 4 == 0; c is (n, S, S)
// contiguous.  `semiring` is kTropical (0) or kLogprob (1).
int semiring_compose_launch(const float* a, long long a_inner, long long a_stride,
                            long long a_outer, const float* b, long long b_inner,
                            long long b_stride, long long b_outer, float* c,
                            long long n, int S, int semiring, int device,
                            void* stream) {
  if (n <= 0 || a_inner <= 0 || b_inner <= 0 || S < 1 || S > 64 || (S & (S - 1)) ||
      (semiring != kTropical && semiring != kLogprob))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Operand oa{a, a_inner, a_stride, a_outer};
  const Operand ob{b, b_inner, b_stride, b_outer};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(semiring == kTropical ? launch_states<kTropical>(S, oa, ob, c, n, s)
                                     : launch_states<kLogprob>(S, oa, ob, c, n, s));
}

const char* semiring_compose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
