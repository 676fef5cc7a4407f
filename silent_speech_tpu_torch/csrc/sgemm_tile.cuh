// One 64 x 64 f32 output tile of acc += A' B on the CUDA cores (FMAs), for
// csrc/mm_rate.cu alone (the port's other f32 products run as 3xTF32 on the
// tensor cores; this file goes when MR does). A' is A with its
// columns rolled by `shift`: A'[m, k] = A[m, (k - shift) mod K] (jnp.roll
// along the lanes, which is what pltpu.roll computes), applied as an index
// when the A chunk is loaded; shift 0 is A itself. 256 threads, 4 x 4
// outputs a thread, chunks of 16 k in shared memory (A k-major, so that a
// thread reads its 4 rows as one float4), ragged edges read as zeros.
#pragma once

#include <cuda_runtime.h>

namespace sgemm {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

struct Smem {
  float a[BK][BM + 4];
  float b[BK][BN + 4];
};

// acc[i][j] += sum over the chunk of s.a[kk][4 ty + i] s.b[kk][4 tx + j],
// tx = thread % 16, ty = thread / 16
__device__ __forceinline__ void fma_chunk(float (&acc)[4][4], const Smem& s) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[kk][4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[kk][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum over k of A'[m0 + 4 ty + i, k] B[k, n0 + 4 tx + j]
__device__ __forceinline__ void tile(float (&acc)[4][4],
                                     const float* __restrict__ A, int lda,
                                     const float* __restrict__ B, int ldb,
                                     int M, int N, int K, int m0, int n0,
                                     int shift, Smem& s) {
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK, m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        int ks = k - shift;
        if (ks < 0) ks += K;
        v = A[(size_t)m * lda + ks];
      }
      s.a[kk][mm] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN, k = k0 + kk, n = n0 + nn;
      s.b[kk][nn] = (k < K && n < N) ? B[(size_t)k * ldb + n] : 0.f;
    }
    __syncthreads();
    fma_chunk(acc, s);
    __syncthreads();
  }
}

// the thread's outputs of the tile, masked to (M, N)
__device__ __forceinline__ void store(const float (&acc)[4][4],
                                      float* __restrict__ C, int ldc, int M,
                                      int N, int m0, int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) C[(size_t)m * ldc + n] = acc[i][j];
    }
  }
}

}  // namespace sgemm
