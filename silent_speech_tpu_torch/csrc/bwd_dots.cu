// Backward-dot rate probes for Hopper (sm_90a): the weight-gradient form
// dW = sum of p_g^T dy_g over row tiles g, and the products beside it, f32
// in and f32 sums on the CUDA cores (FMAs).
//
// Replaces the four pallas_calls of the backward-dot probes:
//   bwd_dot_tt  scripts/proto_bwd_dots.py:51 (run_tt, _kernel_tt :24),
//               scripts/proto_bwd_dots2.py:60 (_make with _k_tt :36) and
//               scripts/proto_bwd_dots3.py:44 (_make with _k_tt :30):
//               out (K, N) = sum over steps s < S of p_g^T dy_g, g = s % G,
//               p_g and dy_g rows [g m, g m + m) of p (rows, K) and
//               dy (rows, N); rows past G m are not read (run_tt's
//               G = rows // m drops them);
//   bwd_dot_xp  proto_bwd_dots2.py:60 with _k_xp (:44): the same function,
//               with the p chunk written transposed into shared memory by a
//               pass of its own (the card's jnp.swapaxes) and the product
//               read from that transposed copy;
//   bwd_dot_nt  proto_bwd_dots.py:71 (run_nt, _kernel_nt :40):
//               out[g] = dy_g w^T, out (rows, K); the rows past G m, which
//               the TPU kernel leaves unwritten, are written as zeros;
//   bwd_dot_base proto_bwd_dots2.py:60 with _k_base (:30): out (1, N) =
//               sum over g of the column sums of p_g @ w, every p_g @ w
//               computed (a block a 64-row tile of p_g and 64 columns);
//   bwd_dot_nn  proto_bwd_dots3.py:44 with _k_nn (:37): out (K, N) = sum
//               over steps of pk (K, M) @ dy (M, N) (the steps kernel with
//               A row-major).
//
// The TPU grid runs its steps in order and carries the sum in the output
// block. Here a block computes one 64 x 64 output tile over one group of
// consecutive steps (whole m-row tiles), adding each step's product into
// its sum in step order, and writes the group's partial; a second kernel
// adds the partials in group order. No atomics: two launches on the same
// inputs are bitwise equal. The output tile is the fast-varying block
// index, so the blocks of one group read the same rows at about the same
// time and a row goes from device memory once, then from L2.
//
// What bounds it: the multiply-adds at the f32 FMA peak (67 TFLOP/s):
// 0.385 ms for 98,304 rows at K=512, N=256 (the bytes, 302 MB, take 0.090
// ms); dots3's constant operands are re-multiplied every step, so there
// too the multiply-adds bound it. The tile is csrc/sgemm_tile.cuh's simple
// SGEMM product (4 x 4 outputs a thread, chunks of 16 along the
// contraction in shared memory) with loads of its own (each operand's
// layout, ragged edges read as zeros): right first, fast in a later
// change.

#include <cuda_runtime.h>

#include <algorithm>

#include "sgemm_tile.cuh"

namespace {

using sgemm::BK;
using sgemm::BM;
using sgemm::BN;
using sgemm::fma_chunk;
using sgemm::Smem;  // a[c][mm]: the chunk of A', contraction-major; b[c][nn]
using sgemm::store;
using sgemm::THREADS;
enum Layout { kTT = 0, kNN = 1, kXP = 2 };

// a[c][mm] = A[c0 + c, m0 + mm]: A stored contraction-major (p of tt)
__device__ __forceinline__ void load_a_t(Smem& s, const float* __restrict__ A,
                                         int lda, int c0, int c_end, int m0,
                                         int m_end) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int c = e / BM, mm = e % BM, r = c0 + c, m = m0 + mm;
    s.a[c][mm] = (r < c_end && m < m_end) ? A[(size_t)r * lda + m] : 0.f;
  }
}

// a[c][mm] = A[m0 + mm, c0 + c]: A stored row-major (pk of nn, p of base,
// dy of nt)
__device__ __forceinline__ void load_a_n(Smem& s, const float* __restrict__ A,
                                         int lda, int c0, int c_end, int m0,
                                         int m_end) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int mm = e / BK, c = e % BK, r = c0 + c, m = m0 + mm;
    s.a[c][mm] = (r < c_end && m < m_end) ? A[(size_t)m * lda + r] : 0.f;
  }
}

// b[c][nn] = B[c0 + c, n0 + nn]: B stored contraction-major (dy, w of base)
__device__ __forceinline__ void load_b_n(Smem& s, const float* __restrict__ B,
                                         int ldb, int c0, int c_end, int n0,
                                         int n_end) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int c = e / BN, nn = e % BN, r = c0 + c, n = n0 + nn;
    s.b[c][nn] = (r < c_end && n < n_end) ? B[(size_t)r * ldb + n] : 0.f;
  }
}

// b[c][nn] = B[n0 + nn, c0 + c]: B^T of a row-major B (w of nt)
__device__ __forceinline__ void load_b_t(Smem& s, const float* __restrict__ B,
                                         int ldb, int c0, int c_end, int n0,
                                         int n_end) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int nn = e / BK, c = e % BK, r = c0 + c, n = n0 + nn;
    s.b[c][nn] = (r < c_end && n < n_end) ? B[(size_t)n * ldb + r] : 0.f;
  }
}

// the same product with A read from its transposed copy pt[mm][c] (xp)
__device__ __forceinline__ void fma_chunk_pt(float (&acc)[4][4],
                                             const float (&pt)[BM][BK + 1],
                                             const Smem& s) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < BK; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(&s.b[c][4 * tx]);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = pt[4 * ty + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
    }
  }
}

// blocks of the steps kernel an SM holds: the launch bound caps the
// registers so that they fit (77 and 100 registers unbounded); groups()
// sizes the groups to one wave of them on an H100 SXM's 132 SMs
template <int LAYOUT>
constexpr int kResident = LAYOUT == kXP ? 2 : 3;
constexpr int kSMs = 132;

// The group count for Mo x No outputs and `steps` steps: at most one wave
// of blocks (at least one group), no group empty; a function of the shapes
// only, so that the sums' order is fixed.
template <int LAYOUT>
int groups(int Mo, int No, int steps) {
  const int tiles = ((Mo + BM - 1) / BM) * ((No + BN - 1) / BN);
  const int g = std::max(
      1, std::min({steps, kSMs * kResident<LAYOUT> / tiles, 65535}));
  const int per = (steps + g - 1) / g;
  return (steps + per - 1) / per;
}

// Block (output tile blockIdx.x, group blockIdx.y): the sum over steps
// [group * per_group, ...) of A'_g B_g, contraction rows [g m, g m + m),
// g = step % G, each step's product summed apart and then added in step
// order; written to partial + group * Mo * No.
template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, kResident<LAYOUT>)
steps_kernel(const float* __restrict__ A, int lda,
             const float* __restrict__ B, int ldb, float* __restrict__ partial,
             int Mo, int No, int m, int G, int steps, int per_group) {
  __shared__ __align__(16) Smem s;
  __shared__ float pt[LAYOUT == kXP ? BM : 1][BK + 1];
  const int tiles_n = (No + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(steps, s0 + per_group);
  float acc[4][4] = {};
  for (int st = s0; st < s1; ++st) {
    const int c_begin = (st % G) * m, c_end = c_begin + m;
    float step_acc[4][4] = {};
    for (int c0 = c_begin; c0 < c_end; c0 += BK) {
      if constexpr (LAYOUT == kNN)
        load_a_n(s, A, lda, c0, c_end, m0, Mo);
      else
        load_a_t(s, A, lda, c0, c_end, m0, Mo);
      load_b_n(s, B, ldb, c0, c_end, n0, No);
      __syncthreads();
      if constexpr (LAYOUT == kXP) {
        // the transpose, a pass of its own: pt[mm][c] = a[c][mm]
        for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
          const int mm = e / BK, c = e % BK;
          pt[mm][c] = s.a[c][mm];
        }
        __syncthreads();
        fma_chunk_pt(step_acc, pt, s);
      } else {
        fma_chunk(step_acc, s);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += step_acc[i][j];
  }
  store(acc, partial + (size_t)blockIdx.y * Mo * No, No, Mo, No, m0, n0);
}

// out[i] = the groups' partials added in group order
__global__ void reduce_groups(const float* __restrict__ partial,
                              float* __restrict__ out, int n, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = partial[i];
  for (int g = 1; g < groups; ++g) v += partial[(size_t)g * n + i];
  out[i] = v;
}

// out (rows, K) = dy (rows, N) w^T for the rows below Gm, zeros past them
__global__ void __launch_bounds__(THREADS)
nt_kernel(const float* __restrict__ dy, const float* __restrict__ w,
          float* __restrict__ out, int rows, int Gm, int N, int K) {
  __shared__ __align__(16) Smem s;
  const int tiles_k = (K + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_k) * BM, n0 = (blockIdx.x % tiles_k) * BN;
  float acc[4][4] = {};
  if (m0 < Gm) {
    for (int c0 = 0; c0 < N; c0 += BK) {
      load_a_n(s, dy, N, c0, N, m0, Gm);
      load_b_t(s, w, N, c0, N, n0, K);
      __syncthreads();
      fma_chunk(acc, s);
      __syncthreads();
    }
  }
  store(acc, out, K, rows, K, m0, n0);
}

// Block (n tile, row tile rt = g tps + t): y = p[rows of tile t of step g]
// @ w[:, n tile], its column sums over those rows written to
// partial[rt, n].
__global__ void __launch_bounds__(THREADS)
base_kernel(const float* __restrict__ p, const float* __restrict__ w,
            float* __restrict__ partial, int K, int N, int m, int tps) {
  __shared__ __align__(16) Smem s;
  __shared__ float red[THREADS / 16][BN];
  const int tiles_n = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_n) * BN, rt = blockIdx.x / tiles_n;
  const int g = rt / tps, t = rt % tps;
  const int r0 = g * m + t * BM, r_end = g * m + m;
  float acc[4][4] = {};
  for (int c0 = 0; c0 < K; c0 += BK) {
    load_a_n(s, p, K, c0, K, r0, r_end);
    load_b_n(s, w, N, c0, K, n0, N);
    __syncthreads();
    fma_chunk(acc, s);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    red[ty][4 * tx + j] = ((acc[0][j] + acc[1][j]) + acc[2][j]) + acc[3][j];
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < N) {
    float v = red[0][threadIdx.x];
    for (int r = 1; r < THREADS / 16; ++r) v += red[r][threadIdx.x];
    partial[(size_t)rt * N + n0 + threadIdx.x] = v;
  }
}

// out[n] = the sum over steps g, in order, of the step's row tiles' column
// sums: one block a column; thread j takes a run of consecutive steps,
// then the runs are added in a fixed tree
__global__ void __launch_bounds__(THREADS)
base_reduce(const float* __restrict__ partial, float* __restrict__ out, int N,
            int G, int tps) {
  __shared__ float run[THREADS];
  const int n = blockIdx.x, per = (G + THREADS - 1) / THREADS;
  const int g0 = threadIdx.x * per, g1 = min(G, g0 + per);
  float v = 0.f;
  for (int g = g0; g < g1; ++g) {
    float step = 0.f;
    for (int t = 0; t < tps; ++t) step += partial[((size_t)g * tps + t) * N + n];
    v += step;
  }
  run[threadIdx.x] = v;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) run[threadIdx.x] += run[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[n] = run[0];
}

// The partial sums' floats for one launch: groups x Mo x No (none for one
// group, which writes out directly).
template <int LAYOUT>
long long scratch(int Mo, int No, int steps) {
  const int g = groups<LAYOUT>(Mo, No, steps);
  return g == 1 ? 0 : (long long)g * Mo * No;
}

template <int LAYOUT>
int launch_steps(const void* a, int lda, const void* b, int ldb, void* out,
                 void* partial, int Mo, int No, int m, int G, int steps,
                 void* stream) {
  if (Mo < 1 || No < 1 || m < 1 || G < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int n_groups = groups<LAYOUT>(Mo, No, steps);
  const int per_group = (steps + n_groups - 1) / n_groups;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((Mo + BM - 1) / BM) * ((No + BN - 1) / BN);
  float* dst = static_cast<float*>(n_groups == 1 ? out : partial);
  steps_kernel<LAYOUT><<<dim3(tiles, n_groups), THREADS, 0, st>>>(
      static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
      dst, Mo, No, m, G, steps, per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return (int)err;
  const int n = Mo * No;
  reduce_groups<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n,
      n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch floats that bwd_dot_tt (layout 0), bwd_dot_nn (1) or
// bwd_dot_xp (2) needs for `partial` at these shapes (Mo x No outputs,
// `steps` steps); -1 for an unknown layout. Launches nothing.
extern "C" long long bwd_dot_scratch(int layout, int Mo, int No, int steps) {
  if (Mo < 1 || No < 1 || steps < 1) return 0;
  switch (layout) {
    case kTT: return scratch<kTT>(Mo, No, steps);
    case kNN: return scratch<kNN>(Mo, No, steps);
    case kXP: return scratch<kXP>(Mo, No, steps);
    default: return -1;
  }
}

// p: (rows, K) f32, dy: (rows, N) f32, out: (K, N) f32, partial:
// bwd_dot_scratch(0, K, N, steps) f32 scratch, all contiguous; G m <= rows;
// steps of m-row tiles s % G, in groups of whole steps. Returns the
// cudaError_t of the launches.
extern "C" int bwd_dot_tt(const void* p, const void* dy, void* out,
                          void* partial, int K, int N, int m, int G, int steps,
                          void* stream) {
  return launch_steps<kTT>(p, K, dy, N, out, partial, K, N, m, G, steps,
                           stream);
}

// bwd_dot_tt's function through an explicit transpose of each p chunk;
// partial: bwd_dot_scratch(2, K, N, steps) floats
extern "C" int bwd_dot_xp(const void* p, const void* dy, void* out,
                          void* partial, int K, int N, int m, int G, int steps,
                          void* stream) {
  return launch_steps<kXP>(p, K, dy, N, out, partial, K, N, m, G, steps,
                           stream);
}

// dy: (rows, N) f32, w: (K, N) f32, out: (rows, K) f32, contiguous;
// Gm = G m <= rows: out rows below Gm are dy w^T, the rest zeros
extern "C" int bwd_dot_nt(const void* dy, const void* w, void* out, int rows,
                          int Gm, int N, int K, void* stream) {
  if (rows < 1 || Gm < 0 || Gm > rows || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = ((rows + BM - 1) / BM) * ((K + BN - 1) / BN);
  nt_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<float*>(out), rows, Gm, N, K);
  return (int)cudaGetLastError();
}

// pk: (K, M) f32, dy: (M, N) f32, out: (K, N) f32 = the sum over steps of
// pk @ dy, in groups as bwd_dot_tt (one tile of m = M rows); partial:
// bwd_dot_scratch(1, K, N, steps) floats
extern "C" int bwd_dot_nn(const void* pk, const void* dy, void* out,
                          void* partial, int K, int M, int N, int steps,
                          void* stream) {
  return launch_steps<kNN>(pk, M, dy, N, out, partial, K, N, M, 1, steps,
                           stream);
}

// p: (rows, K) f32, w: (K, N) f32, out: (1, N) f32 = the sum over g < G of
// the column sums of p[g m : g m + m] @ w; partial: (G ceil(m / 64), N)
// f32 scratch, the row tiles' column sums
extern "C" int bwd_dot_base(const void* p, const void* w, void* out,
                            void* partial, int K, int N, int m, int G,
                            void* stream) {
  if (K < 1 || N < 1 || m < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tps = (m + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  base_kernel<<<G * tps * tiles_n, THREADS, 0, st>>>(
      static_cast<const float*>(p), static_cast<const float*>(w),
      static_cast<float*>(partial), K, N, m, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  base_reduce<<<N, THREADS, 0, st>>>(static_cast<const float*>(partial),
                                     static_cast<float*>(out), N, G, tps);
  return (int)cudaGetLastError();
}
