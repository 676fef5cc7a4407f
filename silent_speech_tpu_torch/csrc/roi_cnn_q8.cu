// Int8 TinyROICNN forward for Hopper (sm_90a), the serving-only quantized
// mode.
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn2.py::
// _roi_fused_q8_kernel (variant 'tiled3_q8', reached through
// roi_cnn_fused). It computes the same function, in the Pallas kernel's
// order of f32 operations:
//
//   stage 1: the u8 input centered to s8 (x - 128; the SAME-pad halo is
//            -128, the encoding of 0) against per-output-channel s8 weights,
//            an exact s32 sum y; y * d1 + cf1 (d1 = s1 / 255, cf1 =
//            128 * colsum(w1q) * d1); 2x2 max pool; + b1; ReLU.
//   stages 2, 3: the ReLU output requantized per frame, a = max(frame max,
//            1e-12) * (1/255), rv = 1/a, q = int(v * rv + 0.5) - 128 (the
//            halo is -128); an s8 x s8 -> s32 dot with the s8 weights;
//            dequantized right after as (dot + 128 * colsum(wq)) * sw * a;
//            stage 2 pools, + b2, ReLU; stage 3 + b3, ReLU.
//   then the mean over 12x24 and the fc, in f32.
//
// Every stage's |dot| < 2^24, so the s32 sums and their corrections are
// exact in f32 too. The f32 steps use __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA: an FMA would round once where the Pallas
// kernel rounds twice, and one bit at a requantization boundary moves a
// level. Up to the stage-3 ReLU the kernel is bitwise its plain version
// (cuda_cnn_q8.roi_cnn_q8_plain); only the mean and the fc sum in another
// order.
//
// What bounds it on the H100: the int8 rate. A frame is about 2.65 M
// multiply-adds (1,979 TOPS int8 on the tensor cores), against 4,608 input
// bytes. This first version runs them on the CUDA cores: stage 1 as scalar
// integer multiply-adds (one input channel), stages 2 and 3 as dp4a (four
// s8 x s8 products a lane per instruction) over channel-last s8 maps.
//
// The design, per frame as K1 (csrc/roi_cnn.cu): one block of 288 threads
// holds one frame for the whole network in about 60 KB of shared memory:
// the centered input, the f32 stage-1 and stage-2 outputs (their frame
// maximum sets the scale before they are quantized), the s8 maps with
// halos, and the weights, copied from the device buffer once per block (no
// constant bank, so nothing orders launches against each other). The
// scales are per frame, so a frame's output does not depend on what else
// is in the batch. Only (N, emb) f32 goes back to device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H0 = 48, W0 = 96;
constexpr int C1 = 8, C2 = 16, C3 = 24;
constexpr int H1 = 24, W1 = 48;
constexpr int H2 = 12, W2 = 24;
constexpr int MAX_EMB = 64;
constexpr int THREADS = H2 * W2;  // 288: one stage-2/3 position per thread
constexpr int NWARPS = THREADS / 32;
static_assert(H0 * W0 == THREADS * 16, "one 16-byte load per thread");
static_assert((H1 * W1) % THREADS == 0, "stage-1 positions per thread");

// int32 weight buffer: stage-1 s8 taps one per word [co][9]; stage-2 and 3
// taps packed four input channels a word, [co][tap][C/4]; then the
// activation zero-point corrections 128 * colsum(wq) per output channel
constexpr int QI_W1 = 0;
constexpr int QI_W2 = QI_W1 + C1 * 9;
constexpr int QI_W3 = QI_W2 + C2 * 9 * (C1 / 4);
constexpr int QI_CQ2 = QI_W3 + C3 * 9 * (C2 / 4);
constexpr int QI_CQ3 = QI_CQ2 + C2;
constexpr int QI_SIZE = QI_CQ3 + C3;
// f32 buffer: d1, cf1, b1, sw2, b2, sw3, b3, fc w (emb, 24), fc b (emb)
constexpr int QF_D1 = 0;
constexpr int QF_CF1 = QF_D1 + C1;
constexpr int QF_B1 = QF_CF1 + C1;
constexpr int QF_SW2 = QF_B1 + C1;
constexpr int QF_B2 = QF_SW2 + C2;
constexpr int QF_SW3 = QF_B2 + C2;
constexpr int QF_B3 = QF_SW3 + C3;
constexpr int QF_FC = QF_B3 + C3;
constexpr int QF_MAX = QF_FC + MAX_EMB * C3 + MAX_EMB;

// shared memory, in bytes
constexpr int XQ_W = W0 + 2, XQ_SIZE = (H0 + 2) * XQ_W;            // s8
constexpr int P1_W = W1 + 2, P1_SIZE = (H1 + 2) * P1_W * C1;       // s8
constexpr int P2_W = W2 + 2, P2_SIZE = (H2 + 2) * P2_W * C2;       // s8
constexpr int ACT_BYTES = H1 * W1 * C1 * 4;  // f32 c1, then c2
static_assert(H2 * W2 * C2 * 4 <= ACT_BYTES, "c2 fits where c1 was");
constexpr int Q_BYTES = P1_SIZE > XQ_SIZE ? P1_SIZE : XQ_SIZE;
static_assert(P2_SIZE <= Q_BYTES, "p2q fits where p1q was");
constexpr int RED_FLOATS = NWARPS * C3 + C3;
constexpr int OFF_Q = ACT_BYTES;
constexpr int OFF_RED = OFF_Q + ((Q_BYTES + 15) / 16) * 16;
constexpr int OFF_QI = OFF_RED + RED_FLOATS * 4;
constexpr int OFF_QF = OFF_QI + QI_SIZE * 4;
constexpr size_t SMEM_BYTES = (size_t)OFF_QF + QF_MAX * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The maximum of v over the block (exact in any order); `red` holds NWARPS
// + 1 floats and may be reused once this returns.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w]);
    red[NWARPS] = m;
  }
  __syncthreads();
  const float m = red[NWARPS];
  __syncthreads();
  return m;
}

// a = max(fm, 1e-12) * (1/255) and its reciprocal, rounded as the Pallas
// kernel rounds them (one f32 multiply, one f32 division)
__device__ __forceinline__ void frame_scale(float fm, float* a, float* rv) {
  *a = __fmul_rn(fmaxf(fm, 1e-12f), 1.0f / 255.0f);
  *rv = __fdiv_rn(1.0f, *a);
}

// q = int(v * rv + 0.5) - 128 for v >= 0, as an s8 byte
__device__ __forceinline__ uint32_t quant(float v, float rv) {
  const int q = (int)__fadd_rn(__fmul_rn(v, rv), 0.5f) - 128;
  return (uint32_t)(q & 0xff);
}

__global__ void __launch_bounds__(THREADS)
roi_cnn_q8_kernel(const uint8_t* __restrict__ roi,
                  const int32_t* __restrict__ qi,
                  const float* __restrict__ qf, float* __restrict__ out,
                  int emb) {
  extern __shared__ float4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  float* act = reinterpret_cast<float*>(smem);  // c1 [H1*W1][C1], c2 [288][C2]
  int8_t* xq = reinterpret_cast<int8_t*>(smem + OFF_Q);     // [H0+2][W0+2]
  uint32_t* p1q = reinterpret_cast<uint32_t*>(smem + OFF_Q);  // [26][50][2]
  uint32_t* p2q = p1q;                                      // [14][26][4]
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  int32_t* wi = reinterpret_cast<int32_t*>(smem + OFF_QI);
  float* wf = reinterpret_cast<float*>(smem + OFF_QF);
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const int nf = QF_FC + emb * C3 + emb;

  for (int i = tid; i < QI_SIZE; i += THREADS) wi[i] = qi[i];
  for (int i = tid; i < nf; i += THREADS) wf[i] = qf[i];
  // ---- input: x - 128 as s8 (x ^ 0x80), halo -128
  for (int i = tid; i < XQ_SIZE; i += THREADS) {
    const int y = i / XQ_W, x = i % XQ_W;
    if (y == 0 || y == H0 + 1 || x == 0 || x == W0 + 1) xq[i] = -128;
  }
  {
    const uint4 q = reinterpret_cast<const uint4*>(roi + n * (H0 * W0))[tid];
    const uint32_t words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                               q.z ^ 0x80808080u, q.w ^ 0x80808080u};
    const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      xq[(y + 1) * XQ_W + x0 + 1 + k] =
          (int8_t)((words[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
  __syncthreads();

  // ---- stage 1: exact integer conv1, dequantized, pool, + b1, ReLU
  float vmax = 0.f;
  for (int i = tid; i < H1 * W1; i += THREADS) {
    const int py = i / W1, px = i % W1;
    int a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = xq[(2 * py + r) * XQ_W + 2 * px + c];
#pragma unroll
    for (int co = 0; co < C1; ++co) {
      const float d1 = wf[QF_D1 + co], cf1 = wf[QF_CF1 + co];
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          int s = 0;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              s += wi[QI_W1 + co * 9 + ky * 3 + kx] * a[dy + ky][dx + kx];
          m = fmaxf(m, __fadd_rn(__fmul_rn((float)s, d1), cf1));
        }
      const float c = fmaxf(__fadd_rn(m, wf[QF_B1 + co]), 0.f);
      act[i * C1 + co] = c;
      vmax = fmaxf(vmax, c);
    }
  }
  float a2, rv2;
  frame_scale(block_max(vmax, red), &a2, &rv2);  // syncs: xq is dead after

  // ---- quantize c1 into the haloed channel-last s8 map p1q
  for (int i = tid; i < (H1 + 2) * P1_W; i += THREADS) {
    const int y = i / P1_W - 1, x = i % P1_W - 1;
    uint32_t w[2] = {0x80808080u, 0x80808080u};
    if (y >= 0 && y < H1 && x >= 0 && x < W1) {
      const float* c = act + (y * W1 + x) * C1;
#pragma unroll
      for (int k = 0; k < C1; ++k)
        w[k >> 2] = (k & 3) ? w[k >> 2] | (quant(c[k], rv2) << (8 * (k & 3)))
                            : quant(c[k], rv2);
    }
    p1q[2 * i] = w[0];
    p1q[2 * i + 1] = w[1];
  }
  __syncthreads();

  const int py = tid / W2, px = tid % W2;  // stage 2 and 3 position

  // ---- stage 2: dp4a conv2, dequantized, pool, + b2, ReLU
  {
    float m[C2];
#pragma unroll
    for (int co = 0; co < C2; ++co) m[co] = -INFINITY;
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      const int y = 2 * py + (d >> 1), x = 2 * px + (d & 1);
      int a[9][2];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int p = (y + k / 3) * P1_W + x + k % 3;
        a[k][0] = (int)p1q[2 * p];
        a[k][1] = (int)p1q[2 * p + 1];
      }
#pragma unroll
      for (int co = 0; co < C2; ++co) {
        int s = 0;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          s = __dp4a(a[k][0], wi[QI_W2 + (co * 9 + k) * 2], s);
          s = __dp4a(a[k][1], wi[QI_W2 + (co * 9 + k) * 2 + 1], s);
        }
        const float y2 = __fmul_rn(
            __fmul_rn((float)(s + wi[QI_CQ2 + co]), wf[QF_SW2 + co]), a2);
        m[co] = fmaxf(m[co], y2);
      }
    }
    vmax = 0.f;  // c1 is dead since p1q was written: c2 takes its place
#pragma unroll
    for (int co = 0; co < C2; ++co) {
      const float c = fmaxf(__fadd_rn(m[co], wf[QF_B2 + co]), 0.f);
      act[tid * C2 + co] = c;
      vmax = fmaxf(vmax, c);
    }
  }
  float a3, rv3;
  frame_scale(block_max(vmax, red), &a3, &rv3);  // syncs: p1q is dead after

  // ---- quantize c2 into the haloed channel-last s8 map p2q
  for (int i = tid; i < (H2 + 2) * P2_W; i += THREADS) {
    const int y = i / P2_W - 1, x = i % P2_W - 1;
    uint32_t w[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
    if (y >= 0 && y < H2 && x >= 0 && x < W2) {
      const float* c = act + (y * W2 + x) * C2;
#pragma unroll
      for (int k = 0; k < C2; ++k)
        w[k >> 2] = (k & 3) ? w[k >> 2] | (quant(c[k], rv3) << (8 * (k & 3)))
                            : quant(c[k], rv3);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) p2q[4 * i + k] = w[k];
  }
  __syncthreads();

  // ---- stage 3: dp4a conv3, dequantized, + b3, ReLU, summed for the mean
  const int lane = tid & 31, warp = tid >> 5;
  {
    int a[9][4];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int p = (py + k / 3) * P2_W + px + k % 3;
#pragma unroll
      for (int w = 0; w < 4; ++w) a[k][w] = (int)p2q[4 * p + w];
    }
#pragma unroll 4
    for (int co = 0; co < C3; ++co) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          s = __dp4a(a[k][w], wi[QI_W3 + (co * 9 + k) * 4 + w], s);
      const float y3 = __fmul_rn(
          __fmul_rn((float)(s + wi[QI_CQ3 + co]), wf[QF_SW3 + co]), a3);
      const float r = warp_sum(fmaxf(__fadd_rn(y3, wf[QF_B3 + co]), 0.f));
      if (lane == 0) red[warp * C3 + co] = r;
    }
  }
  __syncthreads();
  float* mean = red + NWARPS * C3;
  if (tid < C3) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * C3 + tid];
    mean[tid] = s / (float)(H2 * W2);
  }
  __syncthreads();

  // ---- fc 24 -> emb (torch layout: weight (emb, 24))
  if (tid < emb) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C3; ++c) s = fmaf(mean[c], wf[QF_FC + tid * C3 + c], s);
    out[n * emb + tid] = s + wf[QF_FC + emb * C3 + tid];
  }
}

}  // namespace

// roi: (n, 48, 96) uint8, 16-byte aligned; qi: the int32 weight buffer and
// qf the f32 one (cuda_cnn_q8.quantize_roi_cnn: QI_SIZE and
// QF_FC + 25 * emb entries), on the device; out: (n, emb) f32. Returns the
// first failing cudaError_t, else that of the launch.
extern "C" int roi_cnn_q8_forward(const void* roi, const void* qi,
                                  const void* qf, void* out, int n, int emb,
                                  void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      roi_cnn_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  roi_cnn_q8_kernel<<<n, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(roi), static_cast<const int32_t*>(qi),
      static_cast<const float*>(qf), static_cast<float*>(out), emb);
  return (int)cudaGetLastError();
}
