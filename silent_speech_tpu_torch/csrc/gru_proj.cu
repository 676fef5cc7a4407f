// GRU input projection for Hopper (sm_90a): xp = x Wi + bi for every
// (batch row, step) of a layer and both its directions at once, f32 FMAs on
// the CUDA cores (not TF32, which is another function).
//
// With gru_seq (csrc/gru_seq.cu) it replaces the TPU kernel
// silent_speech_tpu/ops/pallas_gru.py::_gru_fusedproj_kernel, whose body
// computes this product itself (pallas_gru.py:95-99); here it leaves the
// serial chain: it depends on no h, so it runs as one (B T, D) x (D, 6H)
// product before the recurrence, whose steps then read their xp row.
//
// What bounds it on the H100: the multiply-adds (2.0 G at B=256, T=32,
// D=212, H=192; 0.060 ms at the f32 peak); xp (37.7 MB there) stays in the
// 50 MB L2 for the recurrence that reads it next.
//
// What the design does about it: a 128 x 128 output tile a block of 256
// threads, 8 x 8 outputs a thread (two 4-row by two 4-column sub-tiles 64
// apart, so that a k step's 16 operands arrive as four float4 loads from
// shared memory and feed 64 FMAs), 8-deep chunks of x (stored k-major) and
// Wi double-buffered in shared memory, the next chunk loaded from device
// memory into registers while the current one is multiplied. bi is added
// once at the store. Where K or N is not a multiple of 4 (or a pointer not
// 16-byte aligned) the VEC=false instantiation loads scalars instead of
// float4s: a choice made from the shapes. Each output's sum runs over k in
// order: repeated calls are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;

// the chunk [k0, k0 + BK) of this thread's share of x (one row, 4 k) and
// of Wi (one k, 4 columns), zero outside (M, K) and (K, N)
template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, float4& xa,
                                           float4& wb) {
  const int tid = threadIdx.x;
  const int m = m0 + tid / 2, kx = k0 + (tid % 2) * 4;
  const int kw = k0 + tid / 32, n = n0 + (tid % 32) * 4;
  if (VEC) {
    xa = (m < M && kx < K)
             ? __ldg(reinterpret_cast<const float4*>(x + (size_t)m * K + kx))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    wb = (kw < K && n < N)
             ? __ldg(reinterpret_cast<const float4*>(w + (size_t)kw * N + n))
             : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = (m < M && kx + i < K) ? __ldg(x + (size_t)m * K + kx + i) : 0.f;
      b[i] = (kw < K && n + i < N) ? __ldg(w + (size_t)kw * N + n + i) : 0.f;
    }
    xa = make_float4(a[0], a[1], a[2], a[3]);
    wb = make_float4(b[0], b[1], b[2], b[3]);
  }
}

// grid (ceil(M / 128), ceil(N / 128)), block 256
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gru_proj_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ xp,
                    int M, int K, int N) {
  __shared__ __align__(16) float xs[2][BK][BM];  // k-major
  __shared__ __align__(16) float ws[2][BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8] = {};

  float4 xa, wb;
  load_chunk<VEC>(x, w, M, K, N, m0, n0, 0, xa, wb);
  auto stage = [&](int buf) {
    const int mm = tid / 2, kk = (tid % 2) * 4;
    xs[buf][kk + 0][mm] = xa.x;
    xs[buf][kk + 1][mm] = xa.y;
    xs[buf][kk + 2][mm] = xa.z;
    xs[buf][kk + 3][mm] = xa.w;
    *reinterpret_cast<float4*>(&ws[buf][tid / 32][(tid % 32) * 4]) = wb;
  };
  stage(0);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_chunk<VEC>(x, w, M, K, N, m0, n0, k0 + BK, xa, wb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][4 * ty + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kk][4 * tx + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      stage(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * ty + (i % 4) + (i / 4) * 64;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 4 * tx + (j % 4) + (j / 4) * 64;
      if (n < N) xp[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace

// x: (M, K) f32, w: (K, N) f32, bias: (N,) f32, xp: (M, N) f32, all
// contiguous on the device. Returns the cudaError_t of the launch.
extern "C" int gru_proj_forward(const void* x, const void* w,
                                const void* bias, void* xp, int M, int K,
                                int N, void* stream) {
  if (M < 0 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *wf = static_cast<const float*>(w),
              *bf = static_cast<const float*>(bias);
  float* out = static_cast<float*>(xp);
  if (vec)
    gru_proj_kernel<true><<<grid, THREADS, 0, st>>>(xf, wf, bf, out, M, K, N);
  else
    gru_proj_kernel<false><<<grid, THREADS, 0, st>>>(xf, wf, bf, out, M, K, N);
  return (int)cudaGetLastError();
}
