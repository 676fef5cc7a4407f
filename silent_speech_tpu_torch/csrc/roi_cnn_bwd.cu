// Fused TinyROICNN weight gradients for Hopper (sm_90a): the backward of
// roi_cnn.cu's forward (K1) in training, on the tensor cores.
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
// The recompute runs K1's own stage code (roi_cnn_stages.cuh: the input
// front, conv1 on the CUDA cores, conv2 and conv3 as 3xTF32 on mma.sync, the
// conv3 means), instantiated to also keep the pool argmaxes and ReLU masks,
// so the activations, masks and means are bitwise K1's. The check entry
// roi_cnn_backward_check, a separate instantiation (CHECK), writes each
// frame's 24 means for a test of that, and the route the gradient
// followed, and can end the frames at a stage (Stop) to time the stages;
// roi_cnn_backward compiles without them.
//
// What bounds it on the H100: arithmetic. A frame costs 2.65 M
// multiply-adds to recompute and 2.74 M for the gradients (conv3's weight
// gradient and transposed conv, conv2's over the routed cells, conv1's),
// against 4,608 input bytes and 4 * emb bytes of cotangent.
//
// The design:
// - Persistent blocks of 288 threads (9 warps), one wave of them
//   (roi_cnn_bwd_plan: cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs,
//   asked once per device; the kernel aims at 2 blocks an SM: 115,264 B of
//   shared memory a block, K1's buffers and 6 KB more). Each block packs
//   the weights once, zeroes its halos once, and walks frames blockIdx.x,
//   + gridDim.x, ...; the next frame's bytes arrive by cp.async while the
//   current one computes. Buffers are reused by liveness: d pool2 is
//   written over p2 where it is formed; once dW2 has read p1 (its ReLU
//   mask is kept apart), p1's space takes dW2's per-warp sums, then the
//   routed d conv2 band by band; dW1's per-warp sums go over the codes of
//   conv1.
// - The GEMM-shaped products on mma.sync m16n8k8 TF32 as 3xTF32 (hi*hi +
//   hi*lo + lo*hi, f32 accumulation, K1's split), as the JAX kernel does
//   them dense:
//   d conv3 is conv3's ReLU mask x dfs[co] (dfs = dfeat / 288), and the
//   mask, 0 or 1, is exact in TF32: where it is an operand, 3xTF32's
//   hi*lo term is zero and the product takes two MMAs. So dW3 (a warp a
//   tap: 16 input x 24 output channels over the 288 positions) is p2 x the
//   mask, scaled by dfs once a frame and entry, and db3 dfs x the mask's
//   count; d p2 = the transposed conv3 (288 positions x 216 x 16) is the
//   mask x the weights scaled by dfs (read transposed from K1's packed
//   fragments, then split), masked by p2 > 0;
//   dW2 over the routed d conv2 written dense (3 of 4 entries zero; a K
//   tile is two pooled cells' four window positions, so that one A
//   fragment is routed once for all 9 taps; the warps split the 1,152
//   positions);
//   d p1 = the transposed conv2 (1,152 x 144 x 8) over the routed d conv2
//   written out in bands of 6 rows, B pre-split, masked by p1 > 0.
//   conv1's dW1 and db1 (9 taps fit no MMA depth), the fc gradients and
//   the bias sums stay on the CUDA cores.
// - A fixed summation order, no atomics: each gradient entry belongs to one
//   thread of the block, which sums a frame's terms in a fixed order (an
//   MMA chain, or an FMA chain then a fixed shuffle tree and warp order)
//   and adds the frame's sum to the block's row of `partial` in device
//   memory, frame after frame. A second kernel adds the blocks' rows in
//   block order, so two launches on the same inputs give bitwise-equal
//   gradients.

#include "roi_cnn_stages.cuh"

namespace {

constexpr int W2_N = C2 * C1 * 9;  // 1,152
// the transposed conv2's bands: p1 rows a band, the routed d conv2 rows
// they read, and its floats; then its pre-split B fragments
constexpr int BAND = 6, BAND_ROWS = BAND + 2;
constexpr int BAND_FLOATS = BAND_ROWS * P1_W * C2;
constexpr int W2T_FLOATS = 9 * 2 * 32 * 4;
static_assert(H1 % BAND == 0 && (BAND / 2) * M2_COLS == 2 * NWARPS,
              "whole bands of 2 tiles a warp");
static_assert((BAND_FLOATS + W2T_FLOATS) * 4 <=
                  Smem<float>::P2 - Smem<float>::P1 &&
              NWARPS * W2_N * 4 <= Smem<float>::P2 - Smem<float>::P1,
              "the bands and dW2's per-warp sums fit p1's space");

// K3's shared memory: K1's buffers (Smem<float>), then what the backward
// keeps of the recompute
struct Bwd {
  using S = Smem<float>;
  static constexpr size_t CODES1 = S::BYTES;                      // u16 [1152]
  static constexpr size_t MASK1 = CODES1 + align16(H1 * W1 * 2);  // u8 [1152]
  static constexpr size_t CODES2 = MASK1 + align16(H1 * W1);      // u32 [288]
  static constexpr size_t MASK3 = CODES2 + align16(H2 * W2 * 4);  // u32 haloed
  static constexpr size_t DFS = MASK3 + align16(P2_PIX * 4);  // f32 [24]
  static constexpr size_t BYTES = DFS + C3 * 4;
  // K1's reduction space, free once the means are formed: the warps' live
  // counts of conv3's channels (u8 [9][24]), then their db2 sums [9][16]
  static constexpr size_t CNT3 = S::RED3;
  static constexpr size_t RED2 = CNT3 + align16(NWARPS * C3);
  // dW1's per-warp sums, over codes1 and mask1 once they are read
  static constexpr size_t RED1 = CODES1;
};
static_assert(Bwd::BYTES + 1024 <= 233472 / 2, "two blocks an SM fit");
static_assert(Bwd::RED2 + NWARPS * C2 * 4 <= Smem<float>::MEAN,
              "the counts and db2's sums fit K1's reduction space");
static_assert(NWARPS * OFF_W2 * 4 <= Bwd::CODES2 - Bwd::RED1,
              "dW1's per-warp sums fit codes1 and mask1");

// The check entry's route of a frame, the forward's decisions the gradient
// follows: codes1 (u16 [H1][W1]: 2 bits a channel, the window's first
// argmax), mask1 (u8 [H1][W1]: bit c if p1 > 0), codes2 (u32 [H2][W2]),
// mask2 (u16 [H2][W2]: bit c if p2 > 0) and mask3 (u32 [H2][W2]: bit c if
// conv3 + b3 > 0), in that order.
constexpr int ROUTE_KEPT = H1 * W1 * 3 + H2 * W2 * 4;  // codes1..codes2
constexpr int ROUTE_BYTES = ROUTE_KEPT + H2 * W2 * (2 + 4);
static_assert(Bwd::MASK1 == Bwd::CODES1 + H1 * W1 * 2 &&
                  Bwd::CODES2 == Bwd::MASK1 + H1 * W1 &&
                  ROUTE_KEPT % 4 == 0 && ROUTE_BYTES % 4 == 0,
              "codes1, mask1 and codes2 are one run of shared memory");

// The check entry's stops: the frame ends after the recompute, after fc,
// dW3 and db3, after d p2 (and db2), or after dW2; STOP_NONE: all of it.
enum Stop { STOP_NONE = 0, STOP_FORWARD = 1, STOP_DW3 = 2, STOP_DP2 = 3,
            STOP_DW2 = 4 };

// the p2 position of channel c (the inverse of p2_chan)
__device__ __forceinline__ int p2_pos(int c) {
  return 4 * ((c & 7) >> 1) + 2 * (c >> 3) + (c & 1);
}

__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }

// fc: dWfc[e][c] += dE[e] feat[c], dbfc[e] += dE[e]; d conv3 at a live
// position is dfs = dfeat / 288 with dfeat = dE Wfc
__device__ __forceinline__ void fc_grads(unsigned char* smem,
                                         const float* __restrict__ w,
                                         const float* __restrict__ de,
                                         float* part, int emb) {
  const float* mean = reinterpret_cast<const float*>(smem + Smem<float>::MEAN);
  float* dfs = reinterpret_cast<float*>(smem + Bwd::DFS);
  const int tid = threadIdx.x;
  if (tid < C3) {
    float s = 0.f;
    for (int e = 0; e < emb; ++e)
      s = fmaf(__ldg(de + e), __ldg(w + OFF_FC + e * C3 + tid), s);
    dfs[tid] = s / (float)(H2 * W2);
  }
  for (int j = tid; j < (C3 + 1) * emb; j += THREADS)
    part[OFF_FC + j] += j < C3 * emb ? __ldg(de + j / C3) * mean[j % C3]
                                     : __ldg(de + j - C3 * emb);
}

constexpr uint32_t TF32_ONE = 0x3f800000u;  // 1.0f, exact in TF32

// dW3 of tap `warp`: dW3[co][ci] = dfs[co] x the sum over positions of p2
// (shifted by the tap) x conv3's ReLU mask. The mask is exact in TF32 (its
// lo is 0), so the 3xTF32 product is two MMAs, p2's lo then its hi. M = 16
// input channels (row g the channel at p2 position 2g, row g + 8 at
// 2g + 1), N = 24 output channels, a K tile 8 positions of one row. Warp w
// also counts each channel's live positions among positions 32w..32w+31
// (into cnt, for db3 = dfs x the count).
__device__ __forceinline__ void dw3_stage(unsigned char* smem, int warp,
                                          int lane, float* part) {
  const float* p2 = reinterpret_cast<const float*>(smem + Smem<float>::P2);
  const uint32_t* mask3 = reinterpret_cast<const uint32_t*>(smem + Bwd::MASK3);
  const float* dfs = reinterpret_cast<const float*>(smem + Bwd::DFS);
  uint8_t* cnt = smem + Bwd::CNT3;
  const int g = lane >> 2, t = lane & 3, ky = warp / 3, kx = warp % 3;
  uint32_t bit[3];  // B column g of n tile nt: channel 8nt + g
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) bit[nt] = 1u << (8 * nt + g);
  float acc[3][4] = {};
#pragma unroll 2
  for (int kt = 0; kt < H2 * M3_COLS; ++kt) {
    const int y = kt / M3_COLS, x = 8 * (kt % M3_COLS) + t;  // k slot t
    const float* a = p2 + ((y + ky) * P2_W + x + kx) * C2 + 2 * g;
    const float2 r0 = *reinterpret_cast<const float2*>(a);
    const float2 r1 = *reinterpret_cast<const float2*>(a + 4 * C2);  // t + 4
    uint32_t ah[4], al[4];
    split(r0.x, ah[0], al[0]);
    split(r0.y, ah[1], al[1]);
    split(r1.x, ah[2], al[2]);
    split(r1.y, ah[3], al[3]);
    const uint32_t m0 = mask3[(y + 1) * P2_W + x + 1];
    const uint32_t m1 = mask3[(y + 1) * P2_W + x + 5];
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      const uint32_t b0 = m0 & bit[nt] ? TF32_ONE : 0u;
      const uint32_t b1 = m1 & bit[nt] ? TF32_ONE : 0u;
      mma_tf32(acc[nt], al, b0, b1);
      mma_tf32(acc[nt], ah, b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 3; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ci = p2_chan(2 * g + (r >> 1)), co = 8 * nt + 2 * t + (r & 1);
      part[OFF_W3 + (co * C2 + ci) * 9 + warp] += acc[nt][r] * dfs[co];
    }
  const int pos = 32 * warp + lane;  // 9 warps: the 288 positions
  const uint32_t m = mask3[(pos / W2 + 1) * P2_W + pos % W2 + 1];
#pragma unroll
  for (int co = 0; co < C3; ++co) {
    const int c = __popc(__ballot_sync(0xffffffffu, (m >> co) & 1u));
    if (lane == co) cnt[warp * C3 + co] = (uint8_t)c;
  }
}

// db3 = dfs x the live positions' count (an integer: any order is exact)
__device__ __forceinline__ void db3_sum(const unsigned char* smem,
                                        float* part) {
  const float* dfs = reinterpret_cast<const float*>(smem + Bwd::DFS);
  const uint8_t* cnt = smem + Bwd::CNT3;
  if (threadIdx.x < C3) {
    int c = 0;
    for (int wi = 0; wi < NWARPS; ++wi) c += cnt[wi * C3 + threadIdx.x];
    part[OFF_B3 + threadIdx.x] += dfs[threadIdx.x] * (float)c;
  }
}

// d p2 = the transposed conv3 of d conv3 = mask x dfs: M = positions
// (conv3's M tiles), N = 16 input channels, K = (tap, output channel).
// A is the mask, exact in TF32, and B the weights scaled by dfs (W3
// transposed from K1's packed fragments, x dfs[co], split), so the 3xTF32
// product is two MMAs. Masked by p2 > 0 it is d pool2, written over p2;
// db2 is its sum.
__device__ __forceinline__ void dp2_stage(unsigned char* smem, int warp,
                                          int lane, float* part) {
  using S = Smem<float>;
  float* p2 = reinterpret_cast<float*>(smem + S::P2);
  const uint32_t* mask3 = reinterpret_cast<const uint32_t*>(smem + Bwd::MASK3);
  const float* dfs = reinterpret_cast<const float*>(smem + Bwd::DFS);
  float* red = reinterpret_cast<float*>(smem + Bwd::RED2);
  const int g = lane >> 2, t = lane & 3;
  float vd[3][2];  // k slot t + 4h of K tile j: channel 8j + t + 4h
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) vd[j][h] = dfs[8 * j + t + 4 * h];
  float acc[2][2][4] = {};
  int y0[2], x[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = warp + NWARPS * m;
    y0[m] = 2 * (mt / M3_COLS);
    x[m] = 8 * (mt % M3_COLS) + g;
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    uint32_t md[2][2];  // d conv3's masks at (y + 1 - ky, x + 1 - kx)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int row = 0; row < 2; ++row)
        md[m][row] = mask3[(y0[m] + row + 2 - ky) * P2_W + x[m] + 2 - kx];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uint32_t bh[2][2], bl[2][2];  // B[k][n] = dfs[8j + k] W3[8j + k][8nt + n]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split(vd[j][h] * packed_w3(smem, 8 * j + t + 4 * h, 8 * nt + g, tap),
                bh[nt][h], bl[nt][h]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)  // row q & 1, k slot t + 4 (q >> 1)
          a[q] = (md[m][q & 1] >> (8 * j + t + 4 * (q >> 1))) & 1u ? TF32_ONE
                                                                    : 0u;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_tf32(acc[m][nt], a, bl[nt][0], bl[nt][1]);
          mma_tf32(acc[m][nt], a, bh[nt][0], bh[nt][1]);
        }
      }
    }
  }
  // channel 8nt + 2t + j sits at p2 position 4t + 2nt + j
  float s[4] = {};
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float4* px = reinterpret_cast<float4*>(
          p2 + ((y0[m] + row + 1) * P2_W + x[m] + 1) * C2 + 4 * t);
      const float4 pv = *px;
      const float4 gv =
          make_float4(pv.x > 0.f ? acc[m][0][2 * row] : 0.f,
                      pv.y > 0.f ? acc[m][0][2 * row + 1] : 0.f,
                      pv.z > 0.f ? acc[m][1][2 * row] : 0.f,
                      pv.w > 0.f ? acc[m][1][2 * row + 1] : 0.f);
      *px = gv;
      s[0] += gv.x;
      s[1] += gv.y;
      s[2] += gv.z;
      s[3] += gv.w;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    if (g == 0) red[warp * C2 + 4 * t + i] = s[i];
  }
  __syncthreads();
  if (threadIdx.x < C2) {
    float z = 0.f;
    for (int wi = 0; wi < NWARPS; ++wi) z += red[wi * C2 + threadIdx.x];
    part[OFF_B2 + p2_chan(threadIdx.x)] += z;
  }
}

// dW2 over the routed d conv2, written dense: C[m][n] for the 9 taps, M =
// 16 output channels, N = 8 input channels; a K tile is pooled cells qx
// (k slots 0-3) and qx + 1 (4-7) of one pooled row, k slot t their window
// position t, where d conv2 is d pool2 if the cell's argmax is t, else 0.
// So one routed A fragment feeds the 9 taps. Warp w takes K tiles w, w + 9,
// ...; the warps' sums meet in p1's space (read by then) and are added in
// warp order.
__device__ __forceinline__ void dw2_stage(unsigned char* smem, int warp,
                                          int lane, float* part) {
  using S = Smem<float>;
  const float* p1 = reinterpret_cast<const float*>(smem + S::P1);
  const float* g2 = reinterpret_cast<const float*>(smem + S::P2);
  const uint32_t* codes2 = reinterpret_cast<const uint32_t*>(smem + Bwd::CODES2);
  float* red = reinterpret_cast<float*>(smem + S::P1);
  const int g = lane >> 2, t = lane & 3;
  const int cg = p2_pos(g);  // channel g; g + 8 sits at cg + 2
  constexpr int PAIRS = W2 / 2;
  float acc[9][4] = {};
#pragma unroll 1
  for (int kt = warp; kt < H2 * PAIRS; kt += NWARPS) {
    const int qy = kt / PAIRS, qx = 2 * (kt % PAIRS);
    const uint32_t c0 = codes2[qy * W2 + qx], c1 = codes2[qy * W2 + qx + 1];
    const float* gp = g2 + ((qy + 1) * P2_W + qx + 1) * C2 + cg;
    const float v[4] = {
        ((c0 >> (2 * g)) & 3u) == (uint32_t)t ? gp[0] : 0.f,
        ((c0 >> (2 * g + 16)) & 3u) == (uint32_t)t ? gp[2] : 0.f,
        ((c1 >> (2 * g)) & 3u) == (uint32_t)t ? gp[C2] : 0.f,
        ((c1 >> (2 * g + 16)) & 3u) == (uint32_t)t ? gp[C2 + 2] : 0.f};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], ah[i], al[i]);
    // p1 (channel g) at conv2 output (2qy + t/2, 2qx + t%2), shifted by the tap
    const float* b =
        p1 + ((2 * qy + (t >> 1)) * P1_W + 2 * qx + (t & 1)) * C1 + g;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* bt = b + ((tap / 3) * P1_W + tap % 3) * C1;
      uint32_t bh[2], bl[2];
      split(bt[0], bh[0], bl[0]);
      split(bt[2 * C1], bh[1], bl[1]);
      mma_3xtf32(acc[tap], ah, al, bh, bl);
    }
  }
  __syncthreads();  // p1 is read: its space takes the warps' sums
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = g + 8 * (i >> 1), ci = 2 * t + (i & 1);
      red[warp * W2_N + (co * C1 + ci) * 9 + tap] = acc[tap][i];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < W2_N; e += THREADS) {
    float z = 0.f;
    for (int wi = 0; wi < NWARPS; ++wi) z += red[wi * W2_N + e];
    part[OFF_W2 + e] += z;
  }
  __syncthreads();  // p1's space takes d conv2's bands next
}

// p1's halo, which dW2's sums and the bands overwrite, back to zero for
// the next frame's conv2
__device__ __forceinline__ void zero_p1_halo(unsigned char* smem) {
  float4* p1 = reinterpret_cast<float4*>(smem + Smem<float>::P1);
  for (int i = threadIdx.x; i < 2 * P1_W + 2 * H1; i += THREADS) {
    const int k = i - 2 * P1_W;
    const int px = k < 0 ? (i < P1_W ? i : (H1 + 1) * P1_W + i - P1_W)
                         : (1 + k / 2) * P1_W + (k & 1) * (W1 + 1);
    p1[px * 2] = make_float4(0.f, 0.f, 0.f, 0.f);
    p1[px * 2 + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// d p1 = the transposed conv2 of the routed d conv2, BAND rows of p1 at a
// time: d conv2's rows for the band (one more either side, zero outside
// the map) are first written out routed, in p2's channel order, into p1's
// space; then M = positions (2 rows x 8 columns, 18 tiles a band, 2 a
// warp), N = 8 input channels, K = (tap, output channel): k slot t of K
// tile j is channel 8j + 2t, slot t + 4 channel 8j + 2t + 1, so a thread's
// A values of one position are one 8-byte load, and B comes pre-split.
// Masked by p1 > 0 it is d pool1, which each thread routes at once to its
// conv1 window's argmax for dW1 and db1 (an FMA chain a channel and tap,
// then a fixed shuffle tree and warp order).
__device__ __forceinline__ void dp1_dw1_stage(unsigned char* smem, int warp,
                                              int lane, float* part) {
  using S = Smem<float>;
  float* band = reinterpret_cast<float*>(smem + S::P1);
  float4* w2t = reinterpret_cast<float4*>(band + BAND_FLOATS);
  const float* g2 = reinterpret_cast<const float*>(smem + S::P2);
  const float* xp = reinterpret_cast<const float*>(smem + S::XP);
  const uint32_t* codes2 = reinterpret_cast<const uint32_t*>(smem + Bwd::CODES2);
  const uint16_t* codes1 = reinterpret_cast<const uint16_t*>(smem + Bwd::CODES1);
  const uint8_t* mask1 = reinterpret_cast<const uint8_t*>(smem + Bwd::MASK1);
  float* red = reinterpret_cast<float*>(smem + Bwd::RED1);
  const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
  // B of (tap, K tile j) for each lane: b0 = W2[8j + 2t][g], b1 =
  // W2[8j + 2t + 1][g], as (b0 hi, b1 hi, b0 lo, b1 lo)
  for (int i = tid; i < 9 * 2 * 32; i += THREADS) {
    const int l = i & 31, j = (i >> 5) & 1, tap = i >> 6;
    const int co = 8 * j + 2 * (l & 3), ci = l >> 2;
    uint32_t h0, l0, h1, l1;
    split(packed_w2(smem, co, ci, tap), h0, l0);
    split(packed_w2(smem, co + 1, ci, tap), h1, l1);
    w2t[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
  }
  float dw[2][10] = {};  // conv1 channel 2t + jj: its 9 taps, then its bias
#pragma unroll 1
  for (int y0 = 0; y0 < H1; y0 += BAND) {
    // d conv2 at rows y0 - 1 .. y0 + BAND, columns -1 .. W1; a quad of
    // p2's positions (channels 2q, 2q + 1, 2q + 8, 2q + 9) an item
    for (int i = tid; i < BAND_ROWS * P1_W * 4; i += THREADS) {
      const int q = i & 3, px = (i >> 2) % P1_W, r = (i >> 2) / P1_W;
      const int y = y0 - 1 + r, x = px - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y >= 0 && y < H1 && x >= 0 && x < W1) {
        const uint32_t c = codes2[(y >> 1) * W2 + (x >> 1)] >> (4 * q);
        const uint32_t d = 2 * (y & 1) + (x & 1);
        const float4 gv = *reinterpret_cast<const float4*>(
            g2 + (((y >> 1) + 1) * P2_W + (x >> 1) + 1) * C2 + 4 * q);
        v = make_float4((c & 3u) == d ? gv.x : 0.f,
                        ((c >> 2) & 3u) == d ? gv.y : 0.f,
                        ((c >> 16) & 3u) == d ? gv.z : 0.f,
                        ((c >> 18) & 3u) == d ? gv.w : 0.f);
      }
      *reinterpret_cast<float4*>(band + (r * P1_W + px) * C2 + 4 * q) = v;
    }
    __syncthreads();
    float acc[2][4] = {};
    int rr[2], x[2];  // the tile's first band row (of p1), row g's column
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = warp + NWARPS * m;
      rr[m] = 2 * (mt / M2_COLS);
      x[m] = 8 * (mt % M2_COLS) + g;
    }
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 wb = w2t[(tap * 2 + j) * 32 + lane];
        const uint32_t bh[2] = {f2u(wb.x), f2u(wb.y)};
        const uint32_t bl[2] = {f2u(wb.z), f2u(wb.w)};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // d conv2 at (y + 1 - ky, x + 1 - kx): band row rr + 2 - ky
          const float* a =
              band + ((rr[m] + 2 - ky) * P1_W + x[m] + 2 - kx) * C2 + 4 * t +
              2 * j;
          const float2 r0 = *reinterpret_cast<const float2*>(a);
          const float2 r1 = *reinterpret_cast<const float2*>(a + P1_W * C2);
          uint32_t ah[4], al[4];
          split(r0.x, ah[0], al[0]);
          split(r1.x, ah[1], al[1]);
          split(r0.y, ah[2], al[2]);
          split(r1.y, ah[3], al[3]);
          mma_3xtf32(acc[m], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int py = y0 + rr[m] + row, px = x[m];
        const uint32_t mk = mask1[py * W1 + px], c1 = codes1[py * W1 + px];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int ci = 2 * t + jj;
          const float gv = (mk >> ci) & 1u ? acc[m][2 * row + jj] : 0.f;
          const uint32_t am = (c1 >> (2 * ci)) & 3u;
          const float* xb = xp + (2 * py + (am >> 1)) * XP_W + 2 * px + (am & 1);
#pragma unroll
          for (int k = 0; k < 9; ++k)
            dw[jj][k] = fmaf(gv, xb[(k / 3) * XP_W + k % 3], dw[jj][k]);
          dw[jj][9] += gv;
        }
      }
    __syncthreads();  // the band is read
  }
  // p1's halo back to zero; codes1 and mask1 are read: their space takes
  // dW1's per-warp sums
  zero_p1_halo(smem);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      float s = dw[jj][k];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const int ci = 2 * t + jj;
      if (g == 0) red[warp * OFF_W2 + (k < 9 ? ci * 9 + k : OFF_B1 + ci)] = s;
    }
  __syncthreads();
  if (tid < OFF_W2) {
    float z = 0.f;
    for (int wi = 0; wi < NWARPS; ++wi) z += red[wi * OFF_W2 + tid];
    part[tid] += z;
  }
}

// A frame's route (ROUTE_BYTES at dst) from the forward's kept buffers.
__device__ void write_route(const unsigned char* smem, uint8_t* dst) {
  const float* p2 = reinterpret_cast<const float*>(smem + Smem<float>::P2);
  const uint32_t* mask3 = reinterpret_cast<const uint32_t*>(smem + Bwd::MASK3);
  const uint32_t* kept = reinterpret_cast<const uint32_t*>(smem + Bwd::CODES1);
  for (int i = threadIdx.x; i < ROUTE_KEPT / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(dst)[i] = kept[i];
  for (int i = threadIdx.x; i < H2 * W2; i += THREADS) {
    const int px = (i / W2 + 1) * P2_W + i % W2 + 1;
    uint32_t live = 0;
    for (int pos = 0; pos < C2; ++pos)
      live |= (p2[px * C2 + pos] > 0.f ? 1u : 0u) << p2_chan(pos);
    reinterpret_cast<uint16_t*>(dst + ROUTE_KEPT)[i] = (uint16_t)live;
    reinterpret_cast<uint32_t*>(dst + ROUTE_KEPT + H2 * W2 * 2)[i] = mask3[px];
  }
}

// partial: per block a row of nw floats. CHECK: the check instantiation,
// which takes feat: (n, 24) and route: (n, ROUTE_BYTES), each or null, and
// stop: a Stop; without it they are not read.
template <bool CHECK>
__global__ void __launch_bounds__(THREADS, min_blocks<float>())
roi_cnn_bwd_kernel(const uint8_t* __restrict__ roi,
                   const float* __restrict__ de,
                   const float* __restrict__ w, float* partial,
                   float* __restrict__ feat, uint8_t* __restrict__ route,
                   int stop, int n_frames, int emb, int standardize) {
  using S = Smem<float>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* raw = reinterpret_cast<uint4*>(smem + S::RAW);
  const float* mean = reinterpret_cast<const float*>(smem + S::MEAN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = OFF_FC + (C3 + 1) * emb;
  float* part = partial + (size_t)blockIdx.x * nw;

  // as K1: the first frame's bytes arrive while the block zeroes its
  // haloed buffers and packs the weights; the block's sums start at 0
  cp_async16(raw + tid, roi + (size_t)blockIdx.x * FRAME + 16 * tid);
  for (int i = tid; i < (int)((S::W1S - S::XP) / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem + S::XP)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < P2_PIX; i += THREADS)
    reinterpret_cast<uint32_t*>(smem + Bwd::MASK3)[i] = 0;
  pack_weights<float>(w, smem);
  for (int i = tid; i < nw; i += THREADS) part[i] = 0.f;
  __syncthreads();

#pragma unroll 1
  for (int n = blockIdx.x; n < n_frames; n += gridDim.x) {
    const int next = n + gridDim.x;
    // ---- the forward, as K1, keeping the argmaxes and ReLU masks
    float v[16];
    load_frame<float>(smem, v);
    normalize_store<float>(smem, v, standardize);
    __syncthreads();
    if (next < n_frames)
      cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);
    conv1_stage<float, true>(smem,
                             reinterpret_cast<uint16_t*>(smem + Bwd::CODES1),
                             reinterpret_cast<uint8_t*>(smem + Bwd::MASK1));
    __syncthreads();
    conv2_stage<float, true>(smem, warp, lane,
                             reinterpret_cast<uint32_t*>(smem + Bwd::CODES2));
    __syncthreads();
    {
      float acc[2][3][4];
      conv3_stage<float>(smem, warp, lane, acc);
      conv3_means<float, true>(smem, warp, lane, acc,
                               reinterpret_cast<uint32_t*>(smem + Bwd::MASK3));
    }
    if constexpr (CHECK) {
      if (feat != nullptr && tid < C3) feat[(size_t)n * C3 + tid] = mean[tid];
      if (route != nullptr)
        write_route(smem, route + (size_t)n * ROUTE_BYTES);
      if (stop == STOP_FORWARD) continue;
    }

    // ---- the backward
    fc_grads(smem, w, de + (size_t)n * emb, part, emb);
    __syncthreads();
    dw3_stage(smem, warp, lane, part);
    __syncthreads();  // p2 is read: d pool2 goes over it
    db3_sum(smem, part);
    if (CHECK && stop == STOP_DW3) continue;
    dp2_stage(smem, warp, lane, part);  // ends past a barrier
    if (CHECK && stop == STOP_DP2) continue;
    dw2_stage(smem, warp, lane, part);  // ends past a barrier
    if (CHECK && stop == STOP_DW2) {
      zero_p1_halo(smem);
      continue;
    }
    dp1_dw1_stage(smem, warp, lane, part);  // its barriers: the frame's
                                            // buffers are read
  }
  cp_async_wait_all();
}

// out[j] = the sum of the blocks' rows, in block order.
__global__ void roi_cnn_bwd_reduce(const float* __restrict__ partial,
                                   float* __restrict__ out, int blocks,
                                   int nw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nw) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * nw + j];
  out[j] = s;
}

template <bool CHECK> struct BwdTag {};

template <bool CHECK>
cudaError_t bwd_plan(Plan* p) {
  return plan_for<BwdTag<CHECK>>((const void*)roi_cnn_bwd_kernel<CHECK>,
                                 (int)Bwd::BYTES, p);
}

template <bool CHECK>
int launch(const void* roi, const void* de, const void* weights, void* partial,
           void* out, void* feat, void* route, int stop, int n, int emb,
           int standardize, int blocks, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0 || stop < STOP_NONE ||
      stop > STOP_DW2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = OFF_FC + (C3 + 1) * emb;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, (size_t)nw * 4, s);
  if (blocks < 1 || blocks > n) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = bwd_plan<CHECK>(&p);
  if (e != cudaSuccess) return (int)e;
  roi_cnn_bwd_kernel<CHECK><<<blocks, THREADS, p.smem, s>>>(
      static_cast<const uint8_t*>(roi), static_cast<const float*>(de),
      static_cast<const float*>(weights), static_cast<float*>(partial),
      static_cast<float*>(feat), static_cast<uint8_t*>(route), stop, n, emb,
      standardize);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  roi_cnn_bwd_reduce<<<(nw + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      nw);
  return (int)cudaGetLastError();
}

}  // namespace

// roi: (n, 48, 96) uint8, 16-byte aligned; de: (n, emb) f32; weights: the
// forward's flat f32 buffer (roi_cnn_forward); partial: blocks * nw f32
// scratch, nw = the buffer's length; out: nw f32, the weight gradients in
// the buffer's layout. `blocks` (1 <=
// blocks <= n; the plan's wave, or n if smaller) blocks walk the frames.
// Returns the first failing cudaError_t, else that of the last launch.
extern "C" int roi_cnn_backward(const void* roi, const void* de,
                                const void* weights, void* partial, void* out,
                                int n, int emb, int standardize, int blocks,
                                void* stream) {
  return launch<false>(roi, de, weights, partial, out, nullptr, nullptr,
                       STOP_NONE, n, emb, standardize, blocks, stream);
}

// roi_cnn_backward through the check instantiation: it also writes each
// frame's recomputed conv3 means, the fc's input, to feat: (n, 24) f32,
// and the route its gradient followed (write_route) to route: (n,
// ROUTE_BYTES) bytes, each unless null, and ends each frame at `stop` (a
// Stop; out then holds the stages done, zeros elsewhere).
extern "C" int roi_cnn_backward_check(const void* roi, const void* de,
                                      const void* weights, void* partial,
                                      void* out, void* feat, void* route,
                                      int stop, int n, int emb,
                                      int standardize, int blocks,
                                      void* stream) {
  return launch<true>(roi, de, weights, partial, out, feat, route, stop, n,
                      emb, standardize, blocks, stream);
}

// The backward kernel's launch on the current device: out[0..4] = threads
// a block, dynamic shared memory bytes a block, blocks resident an SM, SMs
// and the wave (their product). Returns the first failing cudaError_t.
extern "C" int roi_cnn_bwd_plan(int* out) {
  Plan p;
  const cudaError_t e = bwd_plan<false>(&p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.sms;
  out[4] = p.wave;
  return 0;
}
