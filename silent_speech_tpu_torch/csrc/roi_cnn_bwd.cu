// Fused TinyROICNN weight gradients for Hopper (sm_90a): the backward of
// roi_cnn.cu's forward (K1) in training.
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn2_grad.py::
// _roi_fused_bwd_kernel (the backward of the custom VJP roi_cnn_fused_train).
// Per frame it takes the uint8 (48, 96) input and the f32 cotangent dE of
// the (emb,) embedding, recomputes the forward, and adds the frame's weight
// and bias gradients of the three convs and the fc to a sum over all frames:
// 5,528 f32 values at emb=32, in the same flat layout as the forward's
// weight buffer (OIHW convs and biases, then fc (emb, 24) and its bias). No
// input gradient is formed: the frames are data.
//
// Semantics, as the TPU kernel and torch's autograd of the plain version:
// - a 2x2 max-pool tie sends the whole gradient to the FIRST max in
//   row-major window order (2p,2q), (2p,2q+1), (2p+1,2q), (2p+1,2q+1);
// - ReLU'(0) = 0: a pooled cell passes gradient only if its value is > 0
//   (ReLU is monotone and the bias is the same over a window, so the mask of
//   relu(max + b) equals the mask at the window's argmax).
// The recompute runs the forward's arithmetic in the forward's order (the
// same fmaf chains and block sums as roi_cnn.cu), so the activations, and
// with them the pool argmaxes, are bitwise those of K1.
//
// What bounds it on the H100: arithmetic, as K1. A frame costs about 2.65 M
// f32 multiply-adds to recompute and about 3.7 M for the gradients (conv3
// and conv2 weight gradients and their transposed convs), and brings 4,608
// input bytes and 4 * emb bytes of cotangent.
//
// The design is the simple one; making it fast is later work:
// - one block of 288 threads per SM walks frames blockIdx.x, +gridDim.x, ...
//   and holds one frame's recompute in shared memory (about 204 KB): the
//   input, the pooled maps of stages 1 and 2 with zero halos, a byte per
//   pooled cell for its window's argmax (instead of the pre-pool maps), the
//   conv3 gradient map, and the routed gradients of both pooled maps;
// - the weights are read from the device buffer into shared memory once per
//   block (not K1's constant bank: training changes them every step);
// - each weight-gradient entry belongs to one thread, which sums its
//   spatial terms in a fixed order into a per-block accumulator in shared
//   memory; the blocks' partial sums go to a scratch buffer and a second
//   kernel adds them in block order. There are no atomics, so two launches
//   on the same inputs give bitwise-equal gradients.

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

// weight (and gradient) offsets: OIHW convs and biases, then fc (emb, 24), b
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + C1 * 9;
constexpr int OFF_W2 = OFF_B1 + C1;
constexpr int OFF_B2 = OFF_W2 + C2 * C1 * 9;
constexpr int OFF_W3 = OFF_B2 + C2;
constexpr int OFF_B3 = OFF_W3 + C3 * C2 * 9;
constexpr int OFF_FC = OFF_B3 + C3;
constexpr int MAX_WEIGHTS = OFF_FC + MAX_EMB * C3 + MAX_EMB;

// shared buffers (floats); *_W / *_PLANE are the zero-haloed strides
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;          // input
constexpr int P1_W = W1 + 2, P1_PLANE = (H1 + 2) * P1_W;         // pool 1
constexpr int P1_SIZE = C1 * P1_PLANE;
constexpr int P2_W = W2 + 2, P2_PLANE = (H2 + 2) * P2_W;         // pool 2
constexpr int P2_SIZE = C2 * P2_PLANE;
constexpr int DC3_SIZE = C3 * P2_PLANE;                          // d conv3
constexpr int G1_SIZE = C1 * H1 * W1;                            // d pool 1
constexpr int G2_SIZE = C2 * H2 * W2;                            // d pool 2
constexpr int U_SIZE = (P2_SIZE + DC3_SIZE) > G1_SIZE ? (P2_SIZE + DC3_SIZE)
                                                      : G1_SIZE;
constexpr int RED_SIZE = NWARPS * C3 + C3;
// stage-1 weight gradients: each of the 80 entries is summed in 3 chunks
constexpr int DW1_CHUNKS = 3;
constexpr int DW1_ROWS = H1 / DW1_CHUNKS;
static_assert((OFF_W2 * DW1_CHUNKS) <= RED_SIZE, "chunk partials fit red");
static_assert((OFF_W2 * DW1_CHUNKS) <= THREADS, "one chunk per thread");
constexpr int SMEM_FLOATS = 2 * MAX_WEIGHTS + XP_SIZE + P1_SIZE + U_SIZE +
                            G2_SIZE + 2 * C3 + MAX_EMB + RED_SIZE;
constexpr size_t SMEM_BYTES = (size_t)SMEM_FLOATS * 4 + C1 * H1 * W1 +
                              C2 * H2 * W2;
static_assert(SMEM_BYTES <= 232448, "fits one block per SM");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// roi_cnn.cu's block_sum, the same order: `red` holds NWARPS + 1 floats.
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

__global__ void __launch_bounds__(THREADS, 1)
roi_cnn_bwd_kernel(const uint8_t* __restrict__ roi,
                   const float* __restrict__ de,
                   const float* __restrict__ weights,
                   float* __restrict__ partial, int n, int emb,
                   int standardize) {
  extern __shared__ float smem[];
  float* w = smem;                    // [MAX_WEIGHTS] this step's weights
  float* gacc = w + MAX_WEIGHTS;      // [MAX_WEIGHTS] this block's grad sum
  float* xp = gacc + MAX_WEIGHTS;     // [H0+2][W0+2]
  float* p1 = xp + XP_SIZE;           // [C1][H1+2][W1+2]
  float* p2 = p1 + P1_SIZE;           // [C2][H2+2][W2+2]
  float* dc3 = p2 + P2_SIZE;          // [C3][H2+2][W2+2]
  float* g1 = p2;                     // [C1][H1][W1], once p2, dc3 are dead
  float* g2 = p2 + U_SIZE;            // [C2][H2][W2]
  float* feat = g2 + G2_SIZE;         // [C3] the mean of conv3
  float* dfeat = feat + C3;           // [C3]
  float* dE = dfeat + C3;             // [MAX_EMB] this frame's cotangent
  float* red = dE + MAX_EMB;          // [RED_SIZE]
  uint8_t* arg1 = reinterpret_cast<uint8_t*>(red + RED_SIZE);  // [C1][H1][W1]
  uint8_t* arg2 = arg1 + C1 * H1 * W1;                         // [C2][H2][W2]

  const int tid = threadIdx.x;
  const int nw = OFF_FC + emb * C3 + emb;
  const int off_fcb = OFF_FC + emb * C3;
  const int py = tid / W2, px = tid % W2;  // stage 2 and 3 position
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < nw; i += THREADS) {
    w[i] = weights[i];
    gacc[i] = 0.f;
  }
  for (int i = tid; i < XP_SIZE + P1_SIZE; i += THREADS) xp[i] = 0.f;

  for (int f = blockIdx.x; f < n; f += gridDim.x) {
    // g1 overwrote p2 and dc3 (halos included) in the last frame
    for (int i = tid; i < U_SIZE; i += THREADS) p2[i] = 0.f;
    if (tid < emb) dE[tid] = de[(size_t)f * emb + tid];

    // ---- input, /255 and the optional standardize, as roi_cnn.cu
    float v[16];
    {
      const uint4 q =
          reinterpret_cast<const uint4*>(roi + (size_t)f * (H0 * W0))[tid];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[k] = (float)((words[k >> 2] >> (8 * (k & 3))) & 0xffu) / 255.0f;
    }
    if (standardize) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) s += v[k];
      const float mu = block_sum(s, red) / (float)(H0 * W0);
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) ss += (v[k] - mu) * (v[k] - mu);
      const float var = block_sum(ss, red) / (float)(H0 * W0 - 1);
      const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-6f);
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = (v[k] - mu) / sd;
    }
    __syncthreads();  // the last frame's readers of xp are done
    {
      const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
#pragma unroll
      for (int k = 0; k < 16; ++k) xp[(y + 1) * XP_W + x0 + 1 + k] = v[k];
    }
    __syncthreads();

    // ---- stage 1: conv1 + ReLU + pool, and each window's first argmax.
    // The channel loop is outermost, so each weight is loaded inside it
    // (hoisting all of them out of a position loop would spill); every
    // output still sums its taps in roi_cnn.cu's order.
    {
      constexpr int R = H1 * W1 / THREADS;  // pooled positions per thread
      float a[R][4][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * THREADS, qy = i / W1, qx = i % W1;
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[r][y][x] = xp[(2 * qy + y) * XP_W + 2 * qx + x];
      }
#pragma unroll 1
      for (int co = 0; co < C1; ++co) {
        float wk[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wk[k] = w[OFF_W1 + co * 9 + k];
        const float b = w[OFF_B1 + co];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = tid + r * THREADS, qy = i / W1, qx = i % W1;
          float m = -INFINITY;
          int am = 0;
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k)
              s = fmaf(wk[k], a[r][(d >> 1) + k / 3][(d & 1) + k % 3], s);
            if (s > m) {  // strict: a tie keeps the first
              m = s;
              am = d;
            }
          }
          p1[co * P1_PLANE + (qy + 1) * P1_W + qx + 1] = fmaxf(m + b, 0.f);
          arg1[(co * H1 + qy) * W1 + qx] = (uint8_t)am;
        }
      }
    }
    __syncthreads();

    // ---- stage 2: conv2 + ReLU + pool at this thread's pooled position,
    // the four window positions together (each weight loaded once a
    // channel), each output summed in roi_cnn.cu's order (ci, then tap)
    {
      float acc[4][C2];
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int co = 0; co < C2; ++co) acc[d][co] = 0.f;
#pragma unroll 1
      for (int ci = 0; ci < C1; ++ci) {
        float a[4][4];
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[y][x] = p1[ci * P1_PLANE + (2 * py + y) * P1_W + 2 * px + x];
#pragma unroll
        for (int co = 0; co < C2; ++co)
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const float wv = w[OFF_W2 + (co * C1 + ci) * 9 + k];
#pragma unroll
            for (int d = 0; d < 4; ++d)
              acc[d][co] = fmaf(wv, a[(d >> 1) + k / 3][(d & 1) + k % 3], acc[d][co]);
          }
      }
#pragma unroll
      for (int co = 0; co < C2; ++co) {
        float m = -INFINITY;
        int am = 0;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (acc[d][co] > m) {
            m = acc[d][co];
            am = d;
          }
        p2[co * P2_PLANE + (py + 1) * P2_W + px + 1] =
            fmaxf(m + w[OFF_B2 + co], 0.f);
        arg2[co * (H2 * W2) + tid] = (uint8_t)am;
      }
    }
    __syncthreads();

    // ---- stage 3: conv3 + ReLU at this thread's position, its ReLU mask,
    // and the mean over positions, as roi_cnn.cu
    uint32_t mask3 = 0;
    {
      float acc[C3];
#pragma unroll
      for (int co = 0; co < C3; ++co) acc[co] = 0.f;
#pragma unroll 1
      for (int ci = 0; ci < C2; ++ci) {
        float a[9];
#pragma unroll
        for (int k = 0; k < 9; ++k)
          a[k] = p2[ci * P2_PLANE + (py + k / 3) * P2_W + px + k % 3];
#pragma unroll
        for (int co = 0; co < C3; ++co)
#pragma unroll
          for (int k = 0; k < 9; ++k)
            acc[co] = fmaf(w[OFF_W3 + (co * C2 + ci) * 9 + k], a[k], acc[co]);
      }
#pragma unroll
      for (int co = 0; co < C3; ++co) {
        const float r = fmaxf(acc[co] + w[OFF_B3 + co], 0.f);
        if (r > 0.f) mask3 |= 1u << co;
        const float s = warp_sum(r);
        if (lane == 0) red[warp * C3 + co] = s;
      }
    }
    __syncthreads();
    if (tid < C3) {
      float s = 0.f;
      for (int wi = 0; wi < NWARPS; ++wi) s += red[wi * C3 + tid];
      feat[tid] = s / (float)(H2 * W2);
    }
    __syncthreads();

    // ---- backward 1: fc weight and bias gradients; d feat = dE W_fc
    for (int j = OFF_FC + tid; j < nw; j += THREADS) {
      if (j < off_fcb) {
        const int e = (j - OFF_FC) / C3, c = (j - OFF_FC) % C3;
        gacc[j] += dE[e] * feat[c];
      } else {
        gacc[j] += dE[j - off_fcb];
      }
    }
    if (tid < C3) {
      float s = 0.f;
      for (int e = 0; e < emb; ++e) s = fmaf(dE[e], w[OFF_FC + e * C3 + tid], s);
      dfeat[tid] = s;
    }
    __syncthreads();
    // d conv3 (post-bias, pre-ReLU) at this position: mean, then ReLU mask
#pragma unroll
    for (int co = 0; co < C3; ++co)
      dc3[co * P2_PLANE + (py + 1) * P2_W + px + 1] =
          (mask3 >> co) & 1u ? dfeat[co] / (float)(H2 * W2) : 0.f;
    __syncthreads();

    // ---- backward 2: conv3 weight and bias gradients (one entry a thread,
    // summed over the 12x24 positions in row-major order)
    for (int j = OFF_W3 + tid; j < OFF_B3; j += THREADS) {
      const int idx = j - OFF_W3;
      const int co = idx / (C2 * 9), ci = (idx / 9) % C2, k = idx % 9;
      const float* g = dc3 + co * P2_PLANE + P2_W + 1;
      const float* a = p2 + ci * P2_PLANE + (k / 3) * P2_W + k % 3;
      float s = 0.f;
      for (int y = 0; y < H2; ++y)
        for (int x = 0; x < W2; ++x)
          s = fmaf(g[y * P2_W + x], a[y * P2_W + x], s);
      gacc[j] += s;
    }
    if (tid < C3) {
      const float* g = dc3 + tid * P2_PLANE + P2_W + 1;
      float s = 0.f;
      for (int y = 0; y < H2; ++y)
        for (int x = 0; x < W2; ++x) s += g[y * P2_W + x];
      gacc[OFF_B3 + tid] += s;
    }
    // d pooled 2 at this position (the transposed conv3), masked by its ReLU
    {
      float d[C2];
#pragma unroll
      for (int ci = 0; ci < C2; ++ci) d[ci] = 0.f;
#pragma unroll 1
      for (int co = 0; co < C3; ++co) {
        float g[9];
#pragma unroll
        for (int k = 0; k < 9; ++k)  // d conv3 at (py + 1 - ky, px + 1 - kx)
          g[k] = dc3[co * P2_PLANE + (py + 2 - k / 3) * P2_W + px + 2 - k % 3];
#pragma unroll
        for (int ci = 0; ci < C2; ++ci)
#pragma unroll
          for (int k = 0; k < 9; ++k)
            d[ci] = fmaf(g[k], w[OFF_W3 + (co * C2 + ci) * 9 + k], d[ci]);
      }
#pragma unroll
      for (int ci = 0; ci < C2; ++ci)
        g2[ci * (H2 * W2) + tid] =
            p2[ci * P2_PLANE + (py + 1) * P2_W + px + 1] > 0.f ? d[ci] : 0.f;
    }
    __syncthreads();

    // ---- backward 3: conv2 weight and bias gradients; each pooled cell's
    // gradient sits at its window's argmax
    for (int j = OFF_W2 + tid; j < OFF_B2; j += THREADS) {
      const int idx = j - OFF_W2;
      const int co = idx / (C1 * 9), ci = (idx / 9) % C1, k = idx % 9;
      const float* g = g2 + co * (H2 * W2);
      const uint8_t* am = arg2 + co * (H2 * W2);
      const float* a = p1 + ci * P1_PLANE + (k / 3) * P1_W + k % 3;
      float s = 0.f;
      for (int q = 0; q < H2 * W2; ++q) {
        const int y = 2 * (q / W2) + (am[q] >> 1), x = 2 * (q % W2) + (am[q] & 1);
        s = fmaf(g[q], a[y * P1_W + x], s);
      }
      gacc[j] += s;
    }
    if (tid < C2) {
      const float* g = g2 + tid * (H2 * W2);
      float s = 0.f;
      for (int q = 0; q < H2 * W2; ++q) s += g[q];
      gacc[OFF_B2 + tid] += s;
    }
    // d pooled 1 (the transposed conv2 of the routed d conv2), masked by its
    // ReLU; written to g1, over p2 and dc3, which are dead now
    for (int i = tid; i < H1 * W1; i += THREADS) {
      const int Y = i / W1, X = i % W1;
      float d[C1];
#pragma unroll
      for (int ci = 0; ci < C1; ++ci) d[ci] = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int y = Y + 1 - k / 3, x = X + 1 - k % 3;  // the conv2 output
        if (y < 0 || y >= H1 || x < 0 || x >= W1) continue;
        const int q = (y >> 1) * W2 + (x >> 1);
        const uint8_t code = (uint8_t)(((y & 1) << 1) | (x & 1));
#pragma unroll 1
        for (int co = 0; co < C2; ++co) {
          if (arg2[co * (H2 * W2) + q] != code) continue;
          const float gv = g2[co * (H2 * W2) + q];
#pragma unroll
          for (int ci = 0; ci < C1; ++ci)
            d[ci] = fmaf(gv, w[OFF_W2 + (co * C1 + ci) * 9 + k], d[ci]);
        }
      }
#pragma unroll
      for (int ci = 0; ci < C1; ++ci)
        g1[ci * (H1 * W1) + i] =
            p1[ci * P1_PLANE + (Y + 1) * P1_W + X + 1] > 0.f ? d[ci] : 0.f;
    }
    __syncthreads();

    // ---- backward 4: conv1 weight and bias gradients, each of the 80
    // entries summed in DW1_CHUNKS row ranges, then the chunks in order
    if (tid < OFF_W2 * DW1_CHUNKS) {
      const int j = tid / DW1_CHUNKS, chunk = tid % DW1_CHUNKS;
      const int co = j < OFF_B1 ? j / 9 : j - OFF_B1, k = j % 9;
      const float* g = g1 + co * (H1 * W1);
      const uint8_t* am = arg1 + co * (H1 * W1);
      const float* a = xp + (k / 3) * XP_W + k % 3;
      float s = 0.f;
      for (int q = chunk * DW1_ROWS * W1; q < (chunk + 1) * DW1_ROWS * W1; ++q) {
        if (j < OFF_B1) {
          const int y = 2 * (q / W1) + (am[q] >> 1), x = 2 * (q % W1) + (am[q] & 1);
          s = fmaf(g[q], a[y * XP_W + x], s);
        } else {
          s += g[q];
        }
      }
      red[tid] = s;
    }
    __syncthreads();
    if (tid < OFF_W2) {
      float s = 0.f;
      for (int c = 0; c < DW1_CHUNKS; ++c) s += red[tid * DW1_CHUNKS + c];
      gacc[tid] += s;
    }
    __syncthreads();  // red, g1 and the maps are reused by the next frame
  }

  for (int i = tid; i < nw; i += THREADS)
    partial[(size_t)blockIdx.x * nw + i] = gacc[i];
}

// out[j] = the sum of the blocks' partial sums, in block order.
__global__ void roi_cnn_bwd_reduce(const float* __restrict__ partial,
                                   float* __restrict__ out, int blocks,
                                   int nw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nw) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * nw + j];
  out[j] = s;
}

}  // namespace

// roi: (n, 48, 96) uint8, 16-byte aligned; de: (n, emb) f32; weights: the
// forward's flat f32 buffer (roi_cnn_forward); partial: blocks * nw f32
// scratch, nw = the buffer's length; out: nw f32, the weight gradients in the
// buffer's layout. `blocks` (1 <= blocks <= n) blocks walk the frames; one
// fits an SM. Returns the first failing cudaError_t, else that of the last
// launch.
extern "C" int roi_cnn_backward(const void* roi, const void* de,
                                const void* weights, void* partial, void* out,
                                int n, int emb, int standardize, int blocks,
                                void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = OFF_FC + emb * C3 + emb;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, (size_t)nw * 4, s);
  if (blocks < 1 || blocks > n) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      roi_cnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  roi_cnn_bwd_kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(
      static_cast<const uint8_t*>(roi), static_cast<const float*>(de),
      static_cast<const float*>(weights), static_cast<float*>(partial), n,
      emb, standardize);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  roi_cnn_bwd_reduce<<<(nw + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      nw);
  return (int)cudaGetLastError();
}
