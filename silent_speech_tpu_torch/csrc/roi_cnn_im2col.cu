// TinyROICNN forward as output-packed im2col GEMMs, for Hopper (sm_90a).
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn.py::
// _roi_cnn_kernel (roi_impl='pallas', reached through roi_cnn_pallas). It
// computes K1's function (csrc/roi_cnn.cu):
//
//   (N, 48, 96) uint8 -> /255 (f32) -> optional per-frame standardize
//   (ddof=1, std >= 1e-6) -> conv 1->8, ReLU, pool -> conv 8->16, ReLU,
//   pool -> conv 16->24, ReLU -> mean over 12x24 -> fc -> (N, emb) f32,
//
// by the TPU kernel's algorithm, not its blocks: each conv is a GEMM of
// patch rows (one per output row h) against a packed weight matrix
// Kpacked[(dy, wx, ci), (w_off, co)] = k[dy, wx - w_off, ci, co] (zero where
// the tap falls outside the 3x3 window; cuda_cnn_im2col.pack_im2col),
// tile by tile along the width: w tiles of 16 outputs for conv1
// (K = 3*18*1 = 54, N = 16*8 = 128), of 8 for conv2 (K = 3*10*8 = 240,
// N = 128) and conv3 (K = 3*10*16 = 480, N = 8*24 = 192). The patch
// matrices are built in shared memory from the zero-haloed activation
// maps, which are kept channel-last (w*C + c along a row), as the TPU
// kernel's (rows, w*C) layout. The TPU kernel's half-pooled lane groups
// (_pack_conv_halfpooled) are a Mosaic lowering workaround and are not
// carried over: the pools here are exact 2x2 maxes, taken on the GEMM's
// outputs in registers.
//
// What bounds it on the H100: arithmetic, as K1. The function is about
// 2.65 M multiply-adds a frame; the packed GEMMs do about 9.7 M (the
// packing's zeros, the price of the dense form) against 4,608 input bytes.
// This first version runs the GEMMs on the f32 CUDA cores, one frame a
// block of 256 threads: each thread computes a 2x2 output tile (two rows,
// the two w of one pool window, one channel) for conv1 and conv2 and pools
// it, and single outputs for conv3; patch rows are read as shared-memory
// broadcasts and weight rows from the L1/L2-cached device buffer. Beside
// K1 (direct convolution, weights in the constant bank) its time says
// whether a tensor-core K1 should start from this GEMM layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H0 = 48, W0 = 96;
constexpr int C1 = 8, C2 = 16, C3 = 24;
constexpr int H1 = 24, W1 = 48;
constexpr int H2 = 12, W2 = 24;
constexpr int MAX_EMB = 64;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
static_assert(H0 * W0 % THREADS == 0, "input pixels per thread");
constexpr int PIX = H0 * W0 / THREADS;  // 18

// packed GEMM shapes: K rows x N cols per w tile, and the number of tiles
constexpr int K1R = 3 * 18 * 1, N1 = 16 * C1, T1 = W0 / 16;  // 54x128, 6
constexpr int K2R = 3 * 10 * C1, N2 = 8 * C2, T2 = W1 / 8;   // 240x128, 6
constexpr int K3R = 3 * 10 * C2, N3 = 8 * C3, T3 = W2 / 8;   // 480x192, 3
// packed weight buffer (f32): k1, b1 tiled, k2, b2 tiled, k3, b3 tiled,
// fc w (24, emb), fc b (emb)
constexpr int OFF_K1 = 0;
constexpr int OFF_B1 = OFF_K1 + K1R * N1;
constexpr int OFF_K2 = OFF_B1 + N1;
constexpr int OFF_B2 = OFF_K2 + K2R * N2;
constexpr int OFF_K3 = OFF_B2 + N2;
constexpr int OFF_B3 = OFF_K3 + K3R * N3;
constexpr int OFF_FC = OFF_B3 + N3;

// shared memory (floats): c1 (haloed, channel-last), then c3; the input and
// the conv1 patch, then the conv2 and conv3 patches; c2 (haloed)
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;
constexpr int A1_SIZE = H0 * K1R;
constexpr int C1P_W = W1 + 2, C1P_SIZE = (H1 + 2) * C1P_W * C1;
constexpr int A2_SIZE = H1 * K2R;
constexpr int C2P_W = W2 + 2, C2P_SIZE = (H2 + 2) * C2P_W * C2;
constexpr int A3_SIZE = H2 * K3R;
constexpr int C3_SIZE = H2 * W2 * C3;
constexpr int P_SIZE = C1P_SIZE;
static_assert(C3_SIZE <= P_SIZE, "c3 fits where c1 was");
constexpr int Q_SIZE = XP_SIZE + A1_SIZE;
static_assert(A2_SIZE <= Q_SIZE && A3_SIZE <= Q_SIZE, "patches fit");
constexpr int RED_SIZE = 64;  // block sums, then the 24 means
constexpr size_t SMEM_BYTES =
    (size_t)(P_SIZE + Q_SIZE + C2P_SIZE + RED_SIZE) * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block in a fixed order, the same value to every thread.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w];
    red[NWARPS] = s;
  }
  __syncthreads();
  const float s = red[NWARPS];
  __syncthreads();
  return s;
}

// One pooled output of a packed conv: the 2x2 tile rows (r, r+1) x columns
// (c, c + cstep) of patch A (row stride K) times packed B (row stride N),
// max-pooled, + bias, ReLU.
template <int K, int N>
__device__ __forceinline__ float gemm_pool(const float* A, int r,
                                           const float* __restrict__ B,
                                           int c, int cstep, float bias) {
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
  const float* a0 = A + r * K;
  const float* a1 = a0 + K;
#pragma unroll 6
  for (int k = 0; k < K; ++k) {
    const float b0 = __ldg(B + k * N + c), b1 = __ldg(B + k * N + c + cstep);
    s00 = fmaf(a0[k], b0, s00);
    s01 = fmaf(a0[k], b1, s01);
    s10 = fmaf(a1[k], b0, s10);
    s11 = fmaf(a1[k], b1, s11);
  }
  return fmaxf(fmaxf(fmaxf(s00, s01), fmaxf(s10, s11)) + bias, 0.f);
}

__global__ void __launch_bounds__(THREADS)
roi_cnn_im2col_kernel(const uint8_t* __restrict__ roi,
                      const float* __restrict__ w, float* __restrict__ out,
                      int emb, int standardize) {
  extern __shared__ float smem[];
  float* c1 = smem;                  // [H1+2][W1+2][C1]
  float* c3 = smem;                  // [H2][W2][C3], once c1 is dead
  float* xp = smem + P_SIZE;         // [H0+2][W0+2]
  float* a1 = xp + XP_SIZE;          // conv1 patch [H0][K1R]
  float* a2 = xp;                    // conv2 patch [H1][K2R]
  float* a3 = xp;                    // conv3 patch [H2][K3R]
  float* c2 = xp + Q_SIZE;           // [H2+2][W2+2][C2]
  float* red = c2 + C2P_SIZE;
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;

  for (int i = tid; i < P_SIZE + XP_SIZE; i += THREADS) smem[i] = 0.f;
  for (int i = tid; i < C2P_SIZE; i += THREADS) c2[i] = 0.f;

  // ---- input, /255 in f32, optionally standardized (two passes)
  float v[PIX];
  const uint8_t* src = roi + n * (H0 * W0);
#pragma unroll
  for (int k = 0; k < PIX; ++k) v[k] = (float)src[tid + k * THREADS] / 255.0f;
  if (standardize) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < PIX; ++k) s += v[k];
    const float mu = block_sum(s, red) / (float)(H0 * W0);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < PIX; ++k) ss += (v[k] - mu) * (v[k] - mu);
    const float var = block_sum(ss, red) / (float)(H0 * W0 - 1);
    const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-6f);
#pragma unroll
    for (int k = 0; k < PIX; ++k) v[k] = (v[k] - mu) / sd;
  }
  __syncthreads();  // zero fill done before the interior is written
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int i = tid + k * THREADS;
    xp[(i / W0 + 1) * XP_W + i % W0 + 1] = v[k];
  }
  __syncthreads();

  // ---- conv1 + ReLU + pool: 6 w tiles of 16 outputs x 8 channels
  {
    const int pc = tid & 63, pw = pc >> 3, co = pc & 7;  // pooled column
    for (int j = 0; j < T1; ++j) {
      for (int e = tid; e < A1_SIZE; e += THREADS) {
        const int r = e / K1R, k = e % K1R;
        a1[e] = xp[(r + k / 18) * XP_W + 16 * j + k % 18];
      }
      __syncthreads();
#pragma unroll 1
      for (int ph = tid >> 6; ph < H1; ph += THREADS / 64)
        c1[((ph + 1) * C1P_W + 8 * j + pw + 1) * C1 + co] =
            gemm_pool<K1R, N1>(a1, 2 * ph, w + OFF_K1, 2 * pw * C1 + co, C1,
                               __ldg(w + OFF_B1 + co));
      __syncthreads();
    }
  }

  // ---- conv2 + ReLU + pool: 6 w tiles of 8 outputs x 16 channels
  {
    const int pc = tid & 63, pw = pc >> 4, co = pc & 15;
    for (int j = 0; j < T2; ++j) {
      for (int e = tid; e < A2_SIZE; e += THREADS) {
        const int r = e / K2R, k = e % K2R;
        a2[e] = c1[((r + k / 80) * C1P_W + 8 * j + (k % 80) / C1) * C1 +
                   k % C1];
      }
      __syncthreads();
#pragma unroll 1
      for (int ph = tid >> 6; ph < H2; ph += THREADS / 64)
        c2[((ph + 1) * C2P_W + 4 * j + pw + 1) * C2 + co] =
            gemm_pool<K2R, N2>(a2, 2 * ph, w + OFF_K2, 2 * pw * C2 + co, C2,
                               __ldg(w + OFF_B2 + co));
      __syncthreads();
    }
  }

  // ---- conv3 + ReLU: 3 w tiles of 8 outputs x 24 channels, into c3
  for (int j = 0; j < T3; ++j) {
    for (int e = tid; e < A3_SIZE; e += THREADS) {
      const int r = e / K3R, k = e % K3R;
      a3[e] = c2[((r + k / 160) * C2P_W + 8 * j + (k % 160) / C2) * C2 +
                 k % C2];
    }
    __syncthreads();
#pragma unroll 1
    for (int o = tid; o < H2 * N3; o += THREADS) {
      const int r = o / N3, col = o % N3;
      const float* a = a3 + r * K3R;
      const float* b = w + OFF_K3 + col;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < K3R; ++k) s = fmaf(a[k], __ldg(b + k * N3), s);
      c3[r * (W2 * C3) + 8 * C3 * j + col] =
          fmaxf(s + __ldg(w + OFF_B3 + col), 0.f);
    }
    __syncthreads();
  }

  // ---- mean over the 12x24 positions: warp w sums channels w, w+8, w+16
  float* mean = red + 32;
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int co = warp; co < C3; co += NWARPS) {
      float s = 0.f;
      for (int p = lane; p < H2 * W2; p += 32) s += c3[p * C3 + co];
      s = warp_sum(s);
      if (lane == 0) mean[co] = s / (float)(H2 * W2);
    }
  }
  __syncthreads();

  // ---- fc 24 -> emb (JAX layout: weight (24, emb))
  if (tid < emb) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C3; ++c) s = fmaf(mean[c], __ldg(w + OFF_FC + c * emb + tid), s);
    out[n * emb + tid] = s + __ldg(w + OFF_FC + C3 * emb + tid);
  }
}

}  // namespace

// roi: (n, 48, 96) uint8, contiguous; w: the packed f32 weight buffer on the
// device (cuda_cnn_im2col.pack_im2col: OFF_FC + 25 * emb entries); out:
// (n, emb) f32. Returns the first failing cudaError_t, else that of the
// launch.
extern "C" int roi_cnn_im2col_forward(const void* roi, const void* w,
                                      void* out, int n, int emb,
                                      int standardize, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      roi_cnn_im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  roi_cnn_im2col_kernel<<<n, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(roi), static_cast<const float*>(w),
      static_cast<float*>(out), emb, standardize);
  return (int)cudaGetLastError();
}
