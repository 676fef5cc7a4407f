// The fused TinyROICNN forward's per-frame stages, shared by the forward
// (roi_cnn.cu, K1) and its weight-gradient kernel (roi_cnn_bwd.cu, K3);
// the im2col forward (roi_cnn_im2col.cu, K5) takes the input stages, conv1
// and the TF32 helpers over its own layout (the template parameter S), and
// the int8 forward (roi_cnn_q8.cu, K4) the copies, the debug moments and
// the launch plan.
//
// K3 recomputes the forward through these same functions, so its
// activations, pool argmaxes, ReLU masks and conv3 means are bitwise K1's
// (the TPU backward does the same: pallas_cnn2_grad.py:98-101). The KEEP
// instantiations also store what the backward needs, without touching the
// arithmetic: each pooled cell's first-argmax code (conv1, conv2) and each
// conv3 position's ReLU mask.
//
// Layouts (shared memory of one block, Smem<T>): the haloed image xp; the
// pooled maps p1 ((26, 50) pixels of 8 channels) and p2 ((14, 26) pixels
// of 16 channels in the order p2_chan gives), channels last, with zero
// halos; the weights packed into mma.sync fragment order (pack_weights).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "mma_tf32.cuh"

namespace {

constexpr int H0 = 48, W0 = 96;    // input frame
constexpr int C1 = 8, C2 = 16, C3 = 24;
constexpr int H1 = 24, W1 = 48;    // after pool 1
constexpr int H2 = 12, W2 = 24;    // after pool 2
constexpr int MAX_EMB = 64;
constexpr int THREADS = 288;       // 9 warps
constexpr int NWARPS = THREADS / 32;
// resident blocks an SM each build aims at (its register cap: 96 and 72)
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 2 ? 3 : 2; }
constexpr int FRAME = H0 * W0;     // bytes
static_assert(FRAME == THREADS * 16, "one 16-byte copy a thread");

// zero-haloed buffers: the image (elements), the pooled maps (pixels of
// C1 and C2 channels, channels last)
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;
constexpr int P1_W = W1 + 2, P1_PIX = (H1 + 2) * P1_W;
constexpr int P2_W = W2 + 2, P2_PIX = (H2 + 2) * P2_W;

// M tiles (2 output rows x 8 columns) and their share a warp
constexpr int M2_COLS = W1 / 8, M2_TILES = (H1 / 2) * M2_COLS;  // 6, 72
constexpr int M3_COLS = W2 / 8, M3_TILES = (H2 / 2) * M3_COLS;  // 3, 18
// conv1's pooled positions an iteration (sharing the weight loads)
constexpr int C1_PX = 2;
static_assert(W1 % C1_PX == 0, "whole iterations a row");
// conv2 tiles that share one load of B, f32 and bf16 builds
constexpr int MG2_F32 = 4, MG2_BF16 = 2;
static_assert(M2_TILES % (NWARPS * MG2_F32) == 0 &&
                  M2_TILES % (NWARPS * MG2_BF16) == 0 &&
                  M3_TILES == 2 * NWARPS,
              "whole tiles a warp");

// p2 keeps a pixel's 16 channels in the order 2t, 2t+1, 2t+8, 2t+9 for
// t = 0..3, so that one load gives a thread both K tiles of a tap: the
// channel at position pos
__host__ __device__ constexpr int p2_chan(int pos) {
  return 2 * (pos >> 2) + (pos & 1) + 8 * ((pos >> 1) & 1);
}

// the flat weight buffer: OIHW convs, then fc (emb, 24), fc b
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + C1 * 9;
constexpr int OFF_W2 = OFF_B1 + C1;
constexpr int OFF_B2 = OFF_W2 + C2 * C1 * 9;
constexpr int OFF_W3 = OFF_B2 + C2;
constexpr int OFF_B3 = OFF_W3 + C3 * C2 * 9;
constexpr int OFF_FC = OFF_B3 + C3;

constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Shared memory of one block, byte offsets. The packed B fragments: f32,
// one float a value (split as loaded); bf16, two values a 32-bit word.
template <typename T>
struct Smem {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr size_t RAW = 0;                     // the frame's bytes
  static constexpr size_t XP = RAW + FRAME;            // [50][98]
  static constexpr size_t P1 = XP + align16(XP_SIZE * sizeof(T));  // [1300][8]
  static constexpr int P1_RS = P1_W * C1;  // p1 elements a haloed row
  static constexpr size_t P2 = P1 + align16(P1_PIX * C1 * sizeof(T));
  static constexpr size_t W1S = P2 + align16(P2_PIX * C2 * sizeof(T));
  // conv1: [co][12]: 9 taps, b1, 2 zeros
  static constexpr size_t W2S = W1S + C1 * 12 * 4;
  // conv2, per tap and lane: f32 [nt][j] (4 floats), bf16 [nt] (2 words)
  static constexpr size_t W3A = W2S + 9 * 32 * (BF16 ? 2 : 4) * 4;
  // conv3, per K tile (tap, and in f32 the channel half) and lane: n tiles
  // 0 and 1 in W3A (4 values), n tile 2 in W3B (2 values)
  static constexpr int K3_TILES = BF16 ? 9 : 18;
  static constexpr size_t W3B = W3A + K3_TILES * 32 * 4 * 4;
  static constexpr size_t BIAS = W3B + K3_TILES * 32 * 2 * 4;  // b2, b3
  static constexpr size_t RED = BIAS + (C2 + C3) * 4;  // NWARPS + 1 floats
  static constexpr size_t RED3 = RED + 16 * 4;         // [NWARPS][C3]
  static constexpr size_t MEAN = RED3 + NWARPS * C3 * 4;
  static constexpr size_t BYTES = MEAN + C3 * 4;
};
static_assert(Smem<float>::BYTES + 1024 <= 233472 / min_blocks<float>() &&
                  Smem<__nv_bfloat16>::BYTES + 1024 <=
                      233472 / min_blocks<__nv_bfloat16>(),
              "the blocks an SM fit its 228 KB of shared memory");

// activation storage: f32, or bf16 rounded to nearest even
template <typename T> struct Act;
template <> struct Act<float> {
  static __device__ __forceinline__ float st(float v) { return v; }
  static __device__ __forceinline__ float ld(float v) { return v; }
};
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 st(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float ld(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// two values as one bf16x2 word, the first in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: m16n8k16 and m16n8k8 bf16, f32 accumulation
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, the same value returned to every thread.
// `red` holds NWARPS + 1 floats; the sum order is fixed (deterministic).
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
  __syncthreads();  // red may be reused right after
  return s;
}

// The weights from the flat buffer into shared memory, in the order the
// fragments read them. An m16n8k8 TF32 K tile is one tap's 8 channels
// (conv3: one of its two channel halves h), k slot t the channel 2t and
// slot t + 4 the channel 2t + 1 (offset by 8h), so that b0 = B[t][g] and
// b1 = B[t+4][g] of n tile nt are the weights of output channel 8nt + g
// from input channels 8h + 2t and 8h + 2t + 1. A bf16 m16n8k16 K tile is
// two taps of conv2 (k 0-7 the first) or one tap of conv3 (k = channel);
// b0 holds k 2t, 2t+1 and b1 k 2t+8, 2t+9.
template <typename T>
__device__ void pack_weights(const float* __restrict__ w, unsigned char* smem) {
  using S = Smem<T>;
  const int tid = threadIdx.x;
  float* w1s = reinterpret_cast<float*>(smem + S::W1S);
  for (int i = tid; i < C1 * 12; i += THREADS) {
    const int co = i / 12, k = i % 12;
    w1s[i] = k < 9 ? w[OFF_W1 + co * 9 + k] : k == 9 ? w[OFF_B1 + co] : 0.f;
  }
  float* bias = reinterpret_cast<float*>(smem + S::BIAS);
  for (int i = tid; i < C2 + C3; i += THREADS)
    bias[i] = i < C2 ? w[OFF_B2 + i] : w[OFF_B3 + i - C2];
  if constexpr (!S::BF16) {
    float* w2s = reinterpret_cast<float*>(smem + S::W2S);
    for (int i = tid; i < 9 * 32 * 4; i += THREADS) {  // [tap][lane][nt][j]
      const int e = i & 3, lane = (i >> 2) & 31, tap = i >> 7;
      const int nt = e >> 1, j = e & 1, g = lane >> 2, t = lane & 3;
      w2s[i] = w[OFF_W2 + ((8 * nt + g) * C1 + 2 * t + j) * 9 + tap];
    }
    float* w3a = reinterpret_cast<float*>(smem + S::W3A);
    float* w3b = reinterpret_cast<float*>(smem + S::W3B);
    for (int i = tid; i < 18 * 32 * 6; i += THREADS) {  // [tap][h][lane][6]
      const int e = i % 6, lane = (i / 6) & 31, kt = i / 192;
      const int tap = kt >> 1, h = kt & 1;
      const int nt = e >> 1, j = e & 1, g = lane >> 2, t = lane & 3;
      const float v =
          w[OFF_W3 + ((8 * nt + g) * C2 + 8 * h + 2 * t + j) * 9 + tap];
      const int base = kt * 32 + lane;
      if (nt < 2) w3a[base * 4 + e] = v;
      else w3b[base * 2 + j] = v;
    }
  } else {
    uint32_t* w2s = reinterpret_cast<uint32_t*>(smem + S::W2S);
    for (int i = tid; i < 9 * 32 * 2; i += THREADS) {  // [tap][lane][nt]
      const int nt = i & 1, lane = (i >> 1) & 31, tap = i >> 6;
      const int g = lane >> 2, t = lane & 3;
      const float* src = w + OFF_W2 + ((8 * nt + g) * C1 + 2 * t) * 9 + tap;
      w2s[i] = pack_bf16(src[0], src[9]);
    }
    uint32_t* w3a = reinterpret_cast<uint32_t*>(smem + S::W3A);
    uint32_t* w3b = reinterpret_cast<uint32_t*>(smem + S::W3B);
    for (int i = tid; i < 9 * 32 * 6; i += THREADS) {  // [tap][lane][nt][r]
      const int e = i % 6, lane = (i / 6) & 31, tap = i / 192;
      const int nt = e >> 1, r = e & 1, g = lane >> 2, t = lane & 3;
      const float* src =
          w + OFF_W3 + ((8 * nt + g) * C2 + 2 * t + 8 * r) * 9 + tap;
      const uint32_t v = pack_bf16(src[0], src[9]);
      const int base = tap * 32 + lane;
      if (nt < 2) w3a[base * 4 + e] = v;
      else w3b[base * 2 + r] = v;
    }
  }
}

// The f32 conv weight w[co][ci][tap] of the packed f32 fragments: conv2
// from W2S, conv3 from W3A / W3B (the backward's transposed products read
// them in place).
__device__ __forceinline__ float packed_w2(const unsigned char* smem, int co,
                                           int ci, int tap) {
  const float* w2s = reinterpret_cast<const float*>(smem + Smem<float>::W2S);
  const int lane = 4 * (co & 7) + (ci >> 1);
  return w2s[(tap * 32 + lane) * 4 + 2 * (co >> 3) + (ci & 1)];
}
__device__ __forceinline__ float packed_w3(const unsigned char* smem, int co,
                                           int ci, int tap) {
  using S = Smem<float>;
  const int kt = 2 * tap + (ci >> 3), lane = 4 * (co & 7) + ((ci & 7) >> 1);
  const int nt = co >> 3, j = ci & 1;
  if (nt < 2)
    return reinterpret_cast<const float*>(smem + S::W3A)[(kt * 32 + lane) * 4 +
                                                         2 * nt + j];
  return reinterpret_cast<const float*>(smem + S::W3B)[(kt * 32 + lane) * 2 +
                                                       j];
}

// The next frame's bytes, this thread's 16 of them (row y, columns x0..
// x0+15), scaled in f32 (the bf16 build multiplies by the rounded 1/255,
// as the Pallas kernel).
template <typename T, typename S = Smem<T>>
__device__ __forceinline__ void load_frame(const unsigned char* smem,
                                           float (&v)[16]) {
  cp_async_wait_all();
  const uint4 q = reinterpret_cast<const uint4*>(smem + S::RAW)[threadIdx.x];
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float b = (float)((words[k >> 2] >> (8 * (k & 3))) & 0xffu);
    v[k] = S::BF16 ? b * (1.0f / 255.0f) : b / 255.0f;
  }
}

// The scaled values, standardized when asked (two passes, as
// standardize_frames: mean, then var), into the haloed image.
template <typename T, typename S = Smem<T>>
__device__ __forceinline__ void normalize_store(unsigned char* smem,
                                                float (&v)[16],
                                                int standardize) {
  float* red = reinterpret_cast<float*>(smem + S::RED);
  T* xp = reinterpret_cast<T*>(smem + S::XP);
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
  const int y = (threadIdx.x * 16) / W0, x0 = (threadIdx.x * 16) % W0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    xp[(y + 1) * XP_W + x0 + 1 + k] = Act<T>::st(v[k]);
}

// conv1 + ReLU + pool on the CUDA cores, C1_PX horizontally adjacent
// pooled positions an iteration (they share each weight load);
// relu(max_i(s_i) + b) == max_i(relu(s_i + b)) exactly. KEEP (f32) also
// stores each pooled cell's first-argmax codes (2 bits a channel, the
// window's row-major position) in codes1 and its ReLU mask (bit co set if
// p1 > 0) in mask1, both [H1 * W1]. S::P1_RS is p1's row stride.
template <typename T, bool KEEP = false, typename S = Smem<T>>
__device__ __forceinline__ void conv1_stage(unsigned char* smem,
                                            uint16_t* codes1 = nullptr,
                                            uint8_t* mask1 = nullptr) {
  using A = Act<T>;
  constexpr bool BF16 = S::BF16;
  static_assert(!(KEEP && BF16), "the backward takes the f32 build");
  const T* xp = reinterpret_cast<const T*>(smem + S::XP);
  T* p1 = reinterpret_cast<T*>(smem + S::P1);
  const float4* w1s = reinterpret_cast<const float4*>(smem + S::W1S);
#pragma unroll 1
  for (int i = threadIdx.x; i < H1 * W1 / C1_PX; i += THREADS) {
    const int py = i / (W1 / C1_PX), px = C1_PX * (i % (W1 / C1_PX));
    constexpr int AW = 2 * C1_PX + 2;  // the window's columns
    float a[4][AW];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const T* row = xp + (2 * py + r) * XP_W + 2 * px;  // even: aligned
#pragma unroll
      for (int c = 0; c < AW; c += 2) {
        float2 u;
        if constexpr (BF16)
          u = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + c));
        else
          u = *reinterpret_cast<const float2*>(row + c);
        a[r][c] = u.x, a[r][c + 1] = u.y;
      }
    }
    float o[C1_PX][C1];
    [[maybe_unused]] uint32_t code[C1_PX] = {};
#pragma unroll
    for (int co = 0; co < C1; ++co) {
      const float4 k0 = w1s[3 * co], k1 = w1s[3 * co + 1],
                   k2 = w1s[3 * co + 2];
      const float k[10] = {k0.x, k0.y, k0.z, k0.w, k1.x,
                           k1.y, k1.z, k1.w, k2.x, k2.y};
#pragma unroll
      for (int q = 0; q < C1_PX; ++q) {
        float m = -INFINITY;
        [[maybe_unused]] float sd[4];  // KEEP: the window's sums
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float s = 0.f;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int kx = 0; kx < 3; ++kx)
                s = fmaf(k[ky * 3 + kx], a[dy + ky][2 * q + dx + kx], s);
            m = fmaxf(m, s);
            if constexpr (KEEP) sd[2 * dy + dx] = s;
          }
        float c;
        if constexpr (BF16)  // round the pooled sum, add bf16(b1) in bf16
          c = A::ld(A::st(A::ld(A::st(m)) + k[9]));
        else
          c = m + k[9];
        o[q][co] = fmaxf(c, 0.f);
        if constexpr (KEEP) {  // the first max in row-major window order
          const uint32_t am = sd[0] == m   ? 0u
                              : sd[1] == m ? 1u
                              : sd[2] == m ? 2u
                                           : 3u;
          code[q] |= am << (2 * co);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C1_PX; ++q) {
      T* dst = p1 + (py + 1) * S::P1_RS + (px + q + 1) * C1;
      const float* v = o[q];
      if constexpr (BF16) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
      if constexpr (KEEP) {
        uint32_t mk = 0;
#pragma unroll
        for (int co = 0; co < C1; ++co) mk |= (v[co] > 0.f ? 1u : 0u) << co;
        codes1[py * W1 + px + q] = (uint16_t)code[q];
        mask1[py * W1 + px + q] = (uint8_t)mk;
      }
    }
  }
}

// conv2 of one frame: p1 -> pooled, biased, ReLU'd p2. Warp `warp` takes
// M tiles warp + NWARPS i, MG2 at a time. KEEP (f32) also stores each
// pooled cell's first-argmax codes (2 bits a channel, natural channel
// order, the window's row-major position) in codes2 [H2 * W2].
template <typename T, bool KEEP = false>
__device__ __forceinline__ void conv2_stage(unsigned char* smem, int warp,
                                            int lane,
                                            uint32_t* codes2 = nullptr) {
  using S = Smem<T>;
  static_assert(!(KEEP && S::BF16), "the backward takes the f32 build");
  constexpr int MG2 = S::BF16 ? MG2_BF16 : MG2_F32;
  const T* p1 = reinterpret_cast<const T*>(smem + S::P1);
  T* p2 = reinterpret_cast<T*>(smem + S::P2);
  const float* b2 = reinterpret_cast<const float*>(smem + S::BIAS);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int grp = 0; grp < M2_TILES / (NWARPS * MG2); ++grp) {
    float acc[MG2][2][4];
    int base[MG2];  // p1 pixel of row g at tap (0, 0)
#pragma unroll
    for (int m = 0; m < MG2; ++m) {
      const int mt = warp + NWARPS * (grp * MG2 + m);
      base[m] = 2 * (mt / M2_COLS) * P1_W + 8 * (mt % M2_COLS) + g;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][nt][r] = 0.f;
    }
    if constexpr (!S::BF16) {
      const float4* w2s = reinterpret_cast<const float4*>(smem + S::W2S);
#pragma unroll 3  // a kernel row of taps: no spills under 96 registers
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * P1_W + tap % 3;
        const float4 wb = w2s[tap * 32 + lane];
        uint32_t bh[2][2], bl[2][2];
        split(wb.x, bh[0][0], bl[0][0]);
        split(wb.y, bh[0][1], bl[0][1]);
        split(wb.z, bh[1][0], bl[1][0]);
        split(wb.w, bh[1][1], bl[1][1]);
#pragma unroll
        for (int m = 0; m < MG2; ++m) {
          const float2 r0 = *reinterpret_cast<const float2*>(
              p1 + (base[m] + off) * C1 + 2 * t);
          const float2 r1 = *reinterpret_cast<const float2*>(
              p1 + (base[m] + off + P1_W) * C1 + 2 * t);
          uint32_t ah[4], al[4];
          split(r0.x, ah[0], al[0]);
          split(r1.x, ah[1], al[1]);
          split(r0.y, ah[2], al[2]);
          split(r1.y, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_3xtf32(acc[m][nt], ah, al, bh[nt], bl[nt]);
        }
      }
    } else {
      const uint2* w2s = reinterpret_cast<const uint2*>(smem + S::W2S);
      auto ld = [&](int m, int tap, int row) {  // channels 2t, 2t+1
        const int px = base[m] + (tap / 3) * P1_W + tap % 3 + row * P1_W;
        return *reinterpret_cast<const uint32_t*>(p1 + px * C1 + 2 * t);
      };
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {  // taps 2kt, 2kt + 1
        const uint2 wa = w2s[(2 * kt) * 32 + lane];
        const uint2 wb = w2s[(2 * kt + 1) * 32 + lane];
#pragma unroll
        for (int m = 0; m < MG2; ++m) {
          const uint32_t a0 = ld(m, 2 * kt, 0), a1 = ld(m, 2 * kt, 1);
          const uint32_t a2 = ld(m, 2 * kt + 1, 0), a3 = ld(m, 2 * kt + 1, 1);
          mma_bf16_k16(acc[m][0], a0, a1, a2, a3, wa.x, wb.x);
          mma_bf16_k16(acc[m][1], a0, a1, a2, a3, wa.y, wb.y);
        }
      }
      const uint2 w8 = w2s[8 * 32 + lane];
#pragma unroll
      for (int m = 0; m < MG2; ++m) {
        const uint32_t a0 = ld(m, 8, 0), a1 = ld(m, 8, 1);
        mma_bf16_k8(acc[m][0], a0, a1, w8.x);
        mma_bf16_k8(acc[m][1], a0, a1, w8.y);
      }
    }
    // pool: rows g and g + 8 are one column of two rows; column x0 + g's
    // neighbour is lane ^ 4. Even g stores pooled pixel (y0/2, (x0+g)/2).
#pragma unroll
    for (int m = 0; m < MG2; ++m) {
      float r[2][2];
      [[maybe_unused]] uint32_t code = 0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = fmaxf(acc[m][nt][j], acc[m][nt][j + 2]);
          r[nt][j] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          if constexpr (KEEP) {  // the first max in row-major window order
            const float tr = __shfl_xor_sync(0xffffffffu, acc[m][nt][j], 4);
            const uint32_t am = acc[m][nt][j] == r[nt][j] ? 0u
                                : tr == r[nt][j]          ? 1u
                                : acc[m][nt][j + 2] == r[nt][j] ? 2u
                                                                : 3u;
            code |= am << (2 * (8 * nt + 2 * t + j));
          }
        }
      if constexpr (KEEP) {  // the 16 channels' codes from the 4 lanes t
        code |= __shfl_xor_sync(0xffffffffu, code, 1);
        code |= __shfl_xor_sync(0xffffffffu, code, 2);
      }
      if ((g & 1) == 0) {
        const int mt = warp + NWARPS * (grp * MG2 + m);
        const int px = (mt / M2_COLS + 1) * P2_W + 4 * (mt % M2_COLS) + g / 2 + 1;
        float o[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            o[nt][j] = fmaxf(r[nt][j] + b2[8 * nt + 2 * t + j], 0.f);
        // channel 8nt + 2t + j sits at position 4t + 2nt + j
        if constexpr (S::BF16)
          *reinterpret_cast<uint2*>(p2 + px * C2 + 4 * t) =
              make_uint2(pack_bf16(o[0][0], o[0][1]),
                         pack_bf16(o[1][0], o[1][1]));
        else
          *reinterpret_cast<float4*>(p2 + px * C2 + 4 * t) =
              make_float4(o[0][0], o[0][1], o[1][0], o[1][1]);
        if constexpr (KEEP) {
          if (t == 0)
            codes2[(mt / M2_COLS) * W2 + 4 * (mt % M2_COLS) + g / 2] = code;
        }
      }
    }
  }
}

// conv3 of one frame into acc[m][nt][r]: warp `warp` takes M tiles warp and
// warp + NWARPS; row g of tile m is output (y0, x0 + g), row g + 8 is
// (y0 + 1, x0 + g), columns 2t, 2t + 1 of n tile nt output channels
// 8nt + 2t, 8nt + 2t + 1.
template <typename T>
__device__ __forceinline__ void conv3_stage(const unsigned char* smem,
                                            int warp, int lane,
                                            float (&acc)[2][3][4]) {
  using S = Smem<T>;
  const T* p2 = reinterpret_cast<const T*>(smem + S::P2);
  const int g = lane >> 2, t = lane & 3;
  int base[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = warp + NWARPS * m;
    base[m] = 2 * (mt / M3_COLS) * P2_W + 8 * (mt % M3_COLS) + g;
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][nt][r] = 0.f;
  }
  if constexpr (!S::BF16) {
    const float4* w3a = reinterpret_cast<const float4*>(smem + S::W3A);
    const float2* w3b = reinterpret_cast<const float2*>(smem + S::W3B);
#pragma unroll 3  // a kernel row of taps: no spills under 96 registers
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * P2_W + tap % 3;
      // channels 2t, 2t+1, 2t+8, 2t+9 of rows g and g + 8
      float4 a[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int row = 0; row < 2; ++row)
          a[m][row] = *reinterpret_cast<const float4*>(
              p2 + (base[m] + off + row * P2_W) * C2 + 4 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kt = 2 * tap + h;
        const float4 wa = w3a[kt * 32 + lane];
        const float2 wb = w3b[kt * 32 + lane];
        uint32_t bh[3][2], bl[3][2];
        split(wa.x, bh[0][0], bl[0][0]);
        split(wa.y, bh[0][1], bl[0][1]);
        split(wa.z, bh[1][0], bl[1][0]);
        split(wa.w, bh[1][1], bl[1][1]);
        split(wb.x, bh[2][0], bl[2][0]);
        split(wb.y, bh[2][1], bl[2][1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ah[4], al[4];
          split(h ? a[m][0].z : a[m][0].x, ah[0], al[0]);
          split(h ? a[m][1].z : a[m][1].x, ah[1], al[1]);
          split(h ? a[m][0].w : a[m][0].y, ah[2], al[2]);
          split(h ? a[m][1].w : a[m][1].y, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
            mma_3xtf32(acc[m][nt], ah, al, bh[nt], bl[nt]);
        }
      }
    }
  } else {
    const uint4* w3a = reinterpret_cast<const uint4*>(smem + S::W3A);
    const uint2* w3b = reinterpret_cast<const uint2*>(smem + S::W3B);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * P2_W + tap % 3;
      const uint4 wa = w3a[tap * 32 + lane];
      const uint2 wb = w3b[tap * 32 + lane];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // (channels 2t, 2t+1), (2t+8, 2t+9) of rows g and g + 8
        const uint2 r0 = *reinterpret_cast<const uint2*>(
            p2 + (base[m] + off) * C2 + 4 * t);
        const uint2 r1 = *reinterpret_cast<const uint2*>(
            p2 + (base[m] + off + P2_W) * C2 + 4 * t);
        mma_bf16_k16(acc[m][0], r0.x, r1.x, r0.y, r1.y, wa.x, wa.y);
        mma_bf16_k16(acc[m][1], r0.x, r1.x, r0.y, r1.y, wa.z, wa.w);
        mma_bf16_k16(acc[m][2], r0.x, r1.x, r0.y, r1.y, wb.x, wb.y);
      }
    }
  }
}

// conv3's bias and ReLU summed into the 24 channel means (S::MEAN) in a
// fixed order (a thread's rows and tiles, then lanes, then warps). KEEP
// (f32) also stores each position's ReLU mask (bit co set if conv3 + b3 >
// 0) in the zero-haloed mask3 [P2_PIX].
template <typename T, bool KEEP = false>
__device__ __forceinline__ void conv3_means(unsigned char* smem, int warp,
                                            int lane,
                                            const float (&acc)[2][3][4],
                                            uint32_t* mask3 = nullptr) {
  using S = Smem<T>;
  const float* b3 = reinterpret_cast<const float*>(smem + S::BIAS) + C2;
  float* red3 = reinterpret_cast<float*>(smem + S::RED3);
  float* mean = reinterpret_cast<float*>(smem + S::MEAN);
  const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
  if constexpr (KEEP) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        uint32_t bits = 0;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int co = 8 * nt + 2 * t + j;
            bits |= (acc[mi][nt][2 * row + j] + b3[co] > 0.f ? 1u : 0u) << co;
          }
        bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
        const int mt = warp + NWARPS * mi;
        if (t == 0)
          mask3[(2 * (mt / M3_COLS) + row + 1) * P2_W + 8 * (mt % M3_COLS) +
                g + 1] = bits;
      }
  }
  float s[3][2];
#pragma unroll
  for (int nt = 0; nt < 3; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float b = b3[8 * nt + 2 * t + j];
      float z = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        z += fmaxf(acc[mi][nt][j] + b, 0.f);
        z += fmaxf(acc[mi][nt][j + 2] + b, 0.f);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)  // over g, the same t
        z += __shfl_xor_sync(0xffffffffu, z, o);
      s[nt][j] = z;
    }
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) red3[warp * C3 + 8 * nt + 2 * t + j] = s[nt][j];
  __syncthreads();
  if (tid < C3) {
    float z = 0.f;
    for (int wi = 0; wi < NWARPS; ++wi) z += red3[wi * C3 + tid];
    mean[tid] = z / (float)(H2 * W2);
  }
  __syncthreads();
}

// The forward kernels' debug stops (K1's and K5's, each kernel's Stop)
// write, for each frame, three moments of what a stage computed.

// a debug stop's moments of its values: the sum, the sum of squares and
// the sum weighted by the value's index i in the plain version's order,
// i % 31 (31 divides none of the buffers' strides)
constexpr int POS_PERIOD = 31;
struct Moments {
  float s = 0.f, s2 = 0.f, sp = 0.f;
  __device__ __forceinline__ void add(float v, int i) {
    s += v;
    s2 = fmaf(v, v, s2);
    sp = fmaf((float)(i % POS_PERIOD), v, sp);
  }
};

// a debug stop's output: the frame's moment j % 3 in entry j of its row
__device__ void write_stop(float* out, size_t n, int emb, Moments m,
                           float* red) {
  const float t[3] = {block_sum(m.s, red), block_sum(m.s2, red),
                      block_sum(m.sp, red)};
  if ((int)threadIdx.x < emb) out[n * emb + threadIdx.x] = t[threadIdx.x % 3];
}

// A persistent kernel's launch: threads and dynamic shared memory bytes a
// block, blocks resident an SM, SMs and the wave (their product).
struct Plan {
  int threads, smem, per_sm, sms, wave;
};

// The plan of `kernel` (THREADS threads, `smem` bytes) on the current
// device, asked of the card once per device for each Tag: one wave of the
// blocks that fit at once.
template <typename Tag>
cudaError_t plan_for(const void* kernel, int smem, Plan* p) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static Plan plans[MAX_DEVICES];
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    plans[dev] = {THREADS, smem, per_sm, sms, per_sm * sms};
    ready[dev] = true;
  }
  *p = plans[dev];
  return cudaSuccess;
}

}  // namespace
