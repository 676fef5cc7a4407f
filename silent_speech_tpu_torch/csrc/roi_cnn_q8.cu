// Int8 TinyROICNN forward for Hopper (sm_90a), the serving-only quantized
// mode: its integer dots on the tensor cores (s8 mma.sync).
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
// exact in f32 too, and the tensor cores' s32 sums are exact in any order.
// The f32 steps use __fmul_rn / __fadd_rn, which nvcc never contracts into
// an FMA: an FMA would round once where the Pallas kernel rounds twice, and
// one bit at a requantization boundary moves a level. Up to the stage-3
// ReLU the kernel is bitwise its plain version (cuda_cnn_q8.
// roi_cnn_q8_plain); only the mean and the fc sum in another order.
//
// What bounds it on the H100: the int8 rate, 2.65 M multiply-adds a frame
// (1,979 TOPS on the tensor cores) against 4,608 input bytes; in practice
// the f32 work around the dots (dequantization, pools, the frame maxima and
// requantization), which no tensor core does. The design:
// - The three dots are implicit GEMMs on m16n8k32 s8 mma.sync, an M tile 2
//   output rows x 8 columns (K1's tiling, roi_cnn.cu), so a thread's two
//   accumulator rows are vertically adjacent and the horizontal neighbour
//   sits in lane ^ 4: the pools are one fmaxf and one shuffle. A thread's
//   4 consecutive k slots are 4 channels of one pixel of the channel-last
//   s8 maps (one 32-bit load). K is (tap, ci), padded to a multiple of 32
//   with zero weights: stage 2 72 -> 96 (4 taps a k32 block), stage 3
//   144 -> 160 (2 taps a block); the pad slots' activations are 0 and add
//   nothing; the colsum corrections cover the real taps only. Stage 1 (one
//   input channel) is a pooled tiling of its own: A row g and g + 8 are
//   the two output rows of a pool window, k slot 4 ky + c the window's
//   image column c of kernel row ky (12 of 32 slots; its A words from two
//   aligned loads and a funnel shift), and N column 2 j + p channel 2 j +
//   nt at the window's column p, so a thread holds whole windows: 288 MMAs
//   a frame, no shuffle.
// - Every dequantization is monotone non-decreasing in its integer sum (its
//   scales are positive), so stages 1 and 2 take the 2x2 max on the s32
//   sums and dequantize only the pooled one: the Pallas kernel's values,
//   with a quarter of its f32 steps.
// - Persistent blocks: the grid is one wave of resident blocks
//   (roi_cnn_q8_plan, asked of the card once per device); each block of 288
//   threads packs the s8 weights into shared memory in fragment order once
//   (cuda_cnn_q8.fragment_weights is its test model), sets the halos to
//   -128 once, then walks frames n = blockIdx.x, + gridDim.x, ...,
//   prefetching the next frame with cp.async. The scales are per frame, so
//   a frame's output is bitwise the same in any batch and any block.
// - Shared memory 72 KB a block (the centered input, the f32 stage-1 and
//   stage-2 outputs, whose frame maximum sets the scale before they are
//   quantized, the s8 maps and the weights): three blocks an SM, so that
//   one block's barriers overlap another's work.
//
// The check entry (roi_cnn_q8_check_forward, the STOP template) ends each
// frame after a stage and writes three moments of its ReLU output in the
// plain version's order (cuda_cnn_q8.roi_cnn_q8_debug_plain).

#include "roi_cnn_stages.cuh"

namespace {

// the check entry's stops: after stage 1, 2 or 3 (STOP_NONE: all of it)
enum Stop { STOP_NONE = 0, STOP_STAGE1 = 1, STOP_STAGE2 = 2,
            STOP_STAGE3 = 3 };

// int32 weight buffer (quantize_roi_cnn's qi): stage-1 s8 taps one per
// word [co][9]; stage-2 and 3 taps packed four input channels a word,
// [co][tap][C/4]; then the zero-point corrections 128 * colsum(wq) of
// stage 2, then of stage 3
constexpr int QI_W1 = 0;
constexpr int QI_W2 = QI_W1 + C1 * 9;
constexpr int QI_W3 = QI_W2 + C2 * 9 * (C1 / 4);
constexpr int QI_CQ2 = QI_W3 + C3 * 9 * (C2 / 4);
// f32 buffer (qf): d1, cf1, b1, sw2, b2, sw3, b3, fc w (emb, 24), fc b
constexpr int QF_D1 = 0;
constexpr int QF_CF1 = QF_D1 + C1;
constexpr int QF_B1 = QF_CF1 + C1;
constexpr int QF_SW2 = QF_B1 + C1;
constexpr int QF_B2 = QF_SW2 + C2;
constexpr int QF_SW3 = QF_B2 + C2;
constexpr int QF_B3 = QF_SW3 + C3;
constexpr int QF_FC = QF_B3 + C3;

// k32 blocks of stages 2 and 3, and the M tiles (2 rows x 8 columns)
constexpr int KB2 = 3, KB3 = 5;
// (stages 2 and 3: roi_cnn_stages.cuh's M2_TILES, M3_TILES, as K1's);
// stage 1's tiles are 8 pooled outputs
constexpr int M1_COLS = W1 / 8, M1_TILES = H1 * M1_COLS;  // 6, 144
static_assert(M1_TILES % NWARPS == 0 && M2_TILES % NWARPS == 0 &&
                  M3_TILES == 2 * NWARPS,
              "whole tiles a warp");

// xq's rows: 144 bytes, the image's 96 from byte 16 (16-byte aligned, one
// store a thread), its halo bytes 15 and 112; 144 = 36 words, so the rows
// that the lanes t of a stage-1 fragment read lie 4 banks apart
constexpr int XQ_ROW = 144, XQ_X0 = 16;
static_assert(XQ_ROW % 16 == 0 && (XQ_ROW / 4) % 32 == 4, "xq rows");

// shared memory, byte offsets: the s8 maps are zero-haloed (-128), channel
// last: xq [50][144], p1q [26][50][8], p2q [14][26][16]
struct SmemQ {
  static constexpr size_t RAW = 0;                            // the frame
  static constexpr size_t XQ = RAW + FRAME;
  static constexpr size_t ACT = XQ + (H0 + 2) * XQ_ROW;       // f32 c1, c2
  static constexpr size_t P1Q = ACT + H1 * W1 * C1 * 4;
  static constexpr size_t P2Q = P1Q + align16(P1_PIX * C1);
  static constexpr size_t WF1 = P2Q + align16(P2_PIX * C2);   // [lane][nt]
  static constexpr size_t WF2 = WF1 + 32 * 2 * 4;             // [kb][nt][lane]
  static constexpr size_t WF3 = WF2 + KB2 * 2 * 32 * 8;
  static constexpr size_t PF = WF3 + KB3 * 3 * 32 * 8;        // qf[:QF_FC]
  static constexpr size_t CQ = PF + QF_FC * 4;                // cq2, cq3
  static constexpr size_t RED = CQ + (C2 + C3) * 4;           // [NWARPS+1]
  static constexpr size_t RED3 = RED + 16 * 4;                // [NWARPS][C3]
  static constexpr size_t MEAN = RED3 + NWARPS * C3 * 4;
  static constexpr size_t BYTES = MEAN + C3 * 4;
};
static_assert(H2 * W2 * C2 <= H1 * W1 * C1, "c2 fits where c1 was");
static_assert(SmemQ::BYTES + 1024 <= 233472 / 3, "three blocks an SM");

// d += a b: m16n8k32, s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// an s8 weight (held in an int32 word) as byte b of a word
__device__ __forceinline__ uint32_t byte_at(int32_t v, int b) {
  return ((uint32_t)v & 0xffu) << (8 * b);
}

// The weights into shared memory, once a block. B fragments of m16n8k32
// (lane g, t: b0 holds k slots 4t..4t+3, b1 slots 16+4t..16+4t+3, of N
// column g): stage 1 (column g of n tile nt: channel 2 (g / 2) + nt at
// window column p = g % 2) slot 4 ky + c is tap (ky, c - p) where
// 0 <= c - p < 3 (the rest zero, b1 zero); stages 2 and 3 column g is
// output channel 8 nt + g; stage 2 block kb: slots 4t.. are tap
// 4 kb + t/2, channels 4 (t & 1)..; slots 16+4t.. tap 4 kb + 2 + t/2;
// stage 3 block kb: b0 tap 2 kb, b1 tap 2 kb + 1, channels 4t..; taps from
// 9 on are zero. Also the f32 scales and biases and the colsum
// corrections.
__device__ void pack_weights_q8(const int32_t* __restrict__ qi,
                                const float* __restrict__ qf,
                                unsigned char* smem) {
  using S = SmemQ;
  const int tid = threadIdx.x;
  if (tid < 64) {
    const int lane = tid & 31, nt = tid >> 5, g = lane >> 2, t = lane & 3;
    const int co = 2 * (g >> 1) + nt, p = g & 1;
    uint32_t b = 0;
    if (t < 3)
      for (int kx = 0; kx < 3; ++kx)
        b |= byte_at(qi[QI_W1 + co * 9 + 3 * t + kx], kx + p);
    reinterpret_cast<uint32_t*>(smem + S::WF1)[2 * lane + nt] = b;
  }
  uint2* wf2 = reinterpret_cast<uint2*>(smem + S::WF2);
  for (int i = tid; i < KB2 * 2 * 32; i += THREADS) {
    const int lane = i & 31, nt = (i >> 5) & 1, kb = i >> 6;
    const int g = lane >> 2, t = lane & 3, co = 8 * nt + g;
    const int tap0 = 4 * kb + (t >> 1), tap1 = tap0 + 2;
    wf2[i] = make_uint2(
        tap0 < 9 ? (uint32_t)qi[QI_W2 + (co * 9 + tap0) * 2 + (t & 1)] : 0u,
        tap1 < 9 ? (uint32_t)qi[QI_W2 + (co * 9 + tap1) * 2 + (t & 1)] : 0u);
  }
  uint2* wf3 = reinterpret_cast<uint2*>(smem + S::WF3);
  for (int i = tid; i < KB3 * 3 * 32; i += THREADS) {
    const int lane = i & 31, nt = (i >> 5) % 3, kb = i / 96;
    const int g = lane >> 2, t = lane & 3, co = 8 * nt + g;
    const int tap0 = 2 * kb, tap1 = tap0 + 1;
    wf3[i] = make_uint2(
        (uint32_t)qi[QI_W3 + (co * 9 + tap0) * 4 + t],
        tap1 < 9 ? (uint32_t)qi[QI_W3 + (co * 9 + tap1) * 4 + t] : 0u);
  }
  float* pf = reinterpret_cast<float*>(smem + S::PF);
  for (int i = tid; i < QF_FC; i += THREADS) pf[i] = qf[i];
  int32_t* cq = reinterpret_cast<int32_t*>(smem + S::CQ);
  for (int i = tid; i < C2 + C3; i += THREADS) cq[i] = qi[QI_CQ2 + i];
}

// Stage 1 on the tensor cores into act (f32 [H1*W1][C1]); returns this
// thread's largest output. Tile mt is 8 pooled outputs: pooled row
// py = mt / 6, pooled columns px = 8 (mt % 6) + g. A row g is output row
// 2 py, row g + 8 output row 2 py + 1, each over the 4 image columns that
// the pool window's taps read (k slot 4 ky + c: column 2 px - 1 + c of row
// + ky). N column 2 j + p of n tile nt is channel 2 j + nt at window column
// 2 px + p, so a thread's 4 sums of an n tile are one window of channel
// 2t + nt. The dequantization y * d1 + cf1 (d1 > 0) is monotone
// non-decreasing in the integer sum y: the max is taken on the sums and
// only the pooled one is dequantized, the same value.
__device__ __forceinline__ float stage1_mma(const unsigned char* smem,
                                            float* act, int warp, int lane) {
  using S = SmemQ;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(smem + S::XQ);
  const float* pf = reinterpret_cast<const float*>(smem + S::PF);
  const uint2 b = reinterpret_cast<const uint2*>(smem + S::WF1)[lane];
  const int g = lane >> 2, t = lane & 3;
  float d1[2], cf1[2], b1[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    d1[e] = pf[QF_D1 + 2 * t + e];
    cf1[e] = pf[QF_CF1 + 2 * t + e];
    b1[e] = pf[QF_B1 + 2 * t + e];
  }
  const int ky = t < 3 ? t : 0;  // lane t holds kernel row t (t = 3: none)
  float vmax = 0.f;
#pragma unroll 2
  for (int mt = warp; mt < M1_TILES; mt += NWARPS) {
    const int py = mt / M1_COLS, px = 8 * (mt % M1_COLS) + g;
    // the 4 bytes from two aligned words and a funnel shift
    const int at = (2 * py + ky) * XQ_ROW + 2 * px + XQ_X0 - 1;
    const uint32_t sh = 8 * (at & 3);
    const uint32_t* w0 = xw + (at >> 2);
    const uint32_t* w1 = w0 + XQ_ROW / 4;
    uint32_t a0 = 0, a1 = 0;
    if (t < 3) {
      a0 = __funnelshift_r(w0[0], w0[1], sh);
      a1 = __funnelshift_r(w1[0], w1[1], sh);
    }
    float o[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      int d[4] = {0, 0, 0, 0};
      mma_s8(d, a0, a1, 0u, 0u, nt ? b.y : b.x, 0u);
      const int m = max(max(d[0], d[1]), max(d[2], d[3]));
      o[nt] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn((float)m, d1[nt]), cf1[nt]),
                              b1[nt]),
                    0.f);
    }
    *reinterpret_cast<float2*>(act + (py * W1 + px) * C1 + 2 * t) =
        make_float2(o[0], o[1]);
    vmax = fmaxf(vmax, fmaxf(o[0], o[1]));
  }
  return vmax;
}

// act (f32, [h][w][C], ReLU outputs) quantized at rv into the interior of
// the haloed s8 map q ([h+2][w+2][C], C/4 words a pixel)
template <int C>
__device__ __forceinline__ void quantize_map(const float* act, uint32_t* q,
                                             int h, int w, float rv) {
  for (int i = threadIdx.x; i < h * w; i += THREADS) {
    const int y = i / w, x = i % w;
    const float* c = act + i * C;
    uint32_t* dst = q + ((y + 1) * (w + 2) + x + 1) * (C / 4);
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(c)[k];
      dst[k] = quant(v.x, rv) | quant(v.y, rv) << 8 | quant(v.z, rv) << 16 |
               quant(v.w, rv) << 24;
    }
  }
}

// Stage 2: s8 p1q against the stage-2 weights at scale a2, pooled, + b2,
// ReLU into act (f32 [H2*W2][C2]); returns this thread's largest output.
__device__ __forceinline__ float stage2_mma(const unsigned char* smem,
                                            float* act, float a2, int warp,
                                            int lane) {
  using S = SmemQ;
  const uint32_t* p1q = reinterpret_cast<const uint32_t*>(smem + S::P1Q);
  const uint2* wf2 = reinterpret_cast<const uint2*>(smem + S::WF2);
  const float* pf = reinterpret_cast<const float*>(smem + S::PF);
  const int32_t* cq2 = reinterpret_cast<const int32_t*>(smem + S::CQ);
  const int g = lane >> 2, t = lane & 3;
  float vmax = 0.f;
#pragma unroll 1
  for (int mt = warp; mt < M2_TILES; mt += NWARPS) {
    const int y0 = 2 * (mt / M2_COLS), x = 8 * (mt % M2_COLS) + g;
    int d[2][4] = {};
#pragma unroll
    for (int kb = 0; kb < KB2; ++kb) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a0/a1: slots 4t.., a2/a3: 16 + 4t..
        const int tap = 4 * kb + 2 * r + (t >> 1);
        const int px = (y0 + tap / 3) * P1_W + x + tap % 3;
        a[2 * r] = tap < 9 ? p1q[px * 2 + (t & 1)] : 0u;
        a[2 * r + 1] = tap < 9 ? p1q[(px + P1_W) * 2 + (t & 1)] : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint2 b = wf2[(kb * 2 + nt) * 32 + lane];
        mma_s8(d[nt], a[0], a[1], a[2], a[3], b.x, b.y);
      }
    }
    // ((dot + cq2) * sw2) * a2 (sw2, a2 > 0) is monotone non-decreasing in
    // the dot: the 2x2 max on the dots, then one dequantization
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      int m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = max(d[nt][e], d[nt][e + 2]);
        m[e] = max(c, __shfl_xor_sync(0xffffffffu, c, 4));
      }
      if ((g & 1) == 0) {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * nt + 2 * t + e;
          const float y = __fmul_rn(
              __fmul_rn((float)(m[e] + cq2[co]), pf[QF_SW2 + co]), a2);
          o[e] = fmaxf(__fadd_rn(y, pf[QF_B2 + co]), 0.f);
        }
        *reinterpret_cast<float2*>(act + ((y0 / 2) * W2 + x / 2) * C2 +
                                   8 * nt + 2 * t) = make_float2(o[0], o[1]);
        vmax = fmaxf(vmax, fmaxf(o[0], o[1]));
      }
    }
  }
  return vmax;
}

// Stage 3: s8 p2q against the stage-3 weights at scale a3, + b3, ReLU,
// each output handed to emit(nt, j, value, y, x) as it is formed (tile
// warp + NWARPS mi: row (y0 + j / 2, x), x = 8 (mt % 3) + g, channel
// 8 nt + 2t + j % 2), so that no tile's outputs stay live past it.
template <typename Emit>
__device__ __forceinline__ void stage3_mma(const unsigned char* smem,
                                           float a3, int warp, int lane,
                                           Emit&& emit) {
  using S = SmemQ;
  const uint32_t* p2q = reinterpret_cast<const uint32_t*>(smem + S::P2Q);
  const uint2* wf3 = reinterpret_cast<const uint2*>(smem + S::WF3);
  const float* pf = reinterpret_cast<const float*>(smem + S::PF);
  const int32_t* cq3 = reinterpret_cast<const int32_t*>(smem + S::CQ) + C2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int mi = 0; mi < 2; ++mi) {
    const int mt = warp + NWARPS * mi;
    const int y0 = 2 * (mt / M3_COLS), x = 8 * (mt % M3_COLS) + g;
    int d[3][4] = {};
#pragma unroll
    for (int kb = 0; kb < KB3; ++kb) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a0/a1: tap 2kb, a2/a3: tap 2kb + 1
        const int tap = 2 * kb + h;
        const int px = (y0 + tap / 3) * P2_W + x + tap % 3;
        a[2 * h] = tap < 9 ? p2q[px * 4 + t] : 0u;
        a[2 * h + 1] = tap < 9 ? p2q[(px + P2_W) * 4 + t] : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const uint2 b = wf3[(kb * 3 + nt) * 32 + lane];
        mma_s8(d[nt], a[0], a[1], a[2], a[3], b.x, b.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = 8 * nt + 2 * t + (j & 1);
        const float y3 = __fmul_rn(
            __fmul_rn((float)(d[nt][j] + cq3[co]), pf[QF_SW3 + co]), a3);
        emit(nt, j, fmaxf(__fadd_rn(y3, pf[QF_B3 + co]), 0.f), y0 + (j >> 1),
             x);
      }
  }
}

template <int STOP>
__global__ void __launch_bounds__(THREADS, 3)
roi_cnn_q8_kernel(const uint8_t* __restrict__ roi,
                  const int32_t* __restrict__ qi,
                  const float* __restrict__ qf, float* __restrict__ out,
                  int n_frames, int emb) {
  using S = SmemQ;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* raw = reinterpret_cast<uint4*>(smem + S::RAW);
  uint8_t* xq = smem + S::XQ;
  float* act = reinterpret_cast<float*>(smem + S::ACT);
  float* red = reinterpret_cast<float*>(smem + S::RED);
  float* red3 = reinterpret_cast<float*>(smem + S::RED3);
  float* mean = reinterpret_cast<float*>(smem + S::MEAN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  cp_async16(raw + tid, roi + (size_t)blockIdx.x * FRAME + 16 * tid);
  // the s8 maps' halos hold -128 (0x80) from here on; only their interiors
  // are written
  for (int i = tid; i < (int)((S::WF1 - S::XQ) / 4); i += THREADS)
    reinterpret_cast<uint32_t*>(smem + S::XQ)[i] = 0x80808080u;
  pack_weights_q8(qi, qf, smem);
  __syncthreads();

#pragma unroll 1
  for (int n = blockIdx.x; n < n_frames; n += gridDim.x) {
    const int next = n + gridDim.x;
    // ---- input: x - 128 as s8 (x ^ 0x80) into the haloed xq, one
    // 16-byte store a thread
    cp_async_wait_all();
    {
      const uint4 q = raw[tid];
      const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
      *reinterpret_cast<uint4*>(xq + (y + 1) * XQ_ROW + XQ_X0 + x0) =
          make_uint4(q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                     q.z ^ 0x80808080u, q.w ^ 0x80808080u);
    }
    __syncthreads();
    if (next < n_frames)
      cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);

    // ---- stage 1: exact integer conv1, dequantized, pool, + b1, ReLU
    const float v1 = stage1_mma(smem, act, warp, lane);
    if constexpr (STOP == STOP_STAGE1) {  // i: CHW
      __syncthreads();
      Moments m;
      for (int e = tid; e < H1 * W1 * C1; e += THREADS)
        m.add(act[e], (e % C1) * (H1 * W1) + e / C1);
      write_stop(out, n, emb, m, red);
      continue;
    }
    float a2, rv2;
    frame_scale(block_max(v1, red), &a2, &rv2);  // syncs: act is complete
    quantize_map<C1>(act, reinterpret_cast<uint32_t*>(smem + S::P1Q), H1, W1,
                     rv2);
    __syncthreads();

    // ---- stage 2: s8 conv2, dequantized, pool, + b2, ReLU
    const float v2 = stage2_mma(smem, act, a2, warp, lane);
    if constexpr (STOP == STOP_STAGE2) {
      __syncthreads();
      Moments m;
      for (int e = tid; e < H2 * W2 * C2; e += THREADS)
        m.add(act[e], (e % C2) * (H2 * W2) + e / C2);
      write_stop(out, n, emb, m, red);
      continue;
    }
    float a3, rv3;
    frame_scale(block_max(v2, red), &a3, &rv3);
    quantize_map<C2>(act, reinterpret_cast<uint32_t*>(smem + S::P2Q), H2, W2,
                     rv3);
    __syncthreads();

    // ---- stage 3: s8 conv3, dequantized, + b3, ReLU, summed for the mean
    if constexpr (STOP == STOP_STAGE3) {  // i: co * 288 + y * 24 + x
      Moments m;
      stage3_mma(smem, a3, warp, lane,
                 [&](int nt, int j, float v, int y, int x) {
                   m.add(v, (8 * nt + 2 * t + (j & 1)) * (H2 * W2) + y * W2 +
                                x);
                 });
      write_stop(out, n, emb, m, red);
      continue;
    }
    // the 24 channel sums in a fixed order: a thread's tiles and rows,
    // then g, then the warps
    float zc[3][2] = {};
    stage3_mma(smem, a3, warp, lane,
               [&](int nt, int j, float v, int, int) { zc[nt][j & 1] += v; });
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = zc[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (g == 0) red3[warp * C3 + 8 * nt + 2 * t + e] = s;
      }
    __syncthreads();
    if (tid < C3) {
      float z = 0.f;
      for (int w = 0; w < NWARPS; ++w) z += red3[w * C3 + tid];
      mean[tid] = z / (float)(H2 * W2);
    }
    __syncthreads();

    // ---- fc 24 -> emb (torch layout: weight (emb, 24)), from the buffer
    if (tid < emb) {
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < C3; ++c)
        z = fmaf(mean[c], __ldg(qf + QF_FC + tid * C3 + c), z);
      out[(size_t)n * emb + tid] = z + __ldg(qf + QF_FC + emb * C3 + tid);
    }
  }
  cp_async_wait_all();
}

template <int STOP> struct TagQ {};

template <int STOP>
cudaError_t get_plan(Plan* p) {
  return plan_for<TagQ<STOP>>((const void*)roi_cnn_q8_kernel<STOP>,
                              (int)SmemQ::BYTES, p);
}

template <int STOP = STOP_NONE>
int launch(const void* roi, const void* qi, const void* qf, void* out, int n,
           int emb, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Plan p;
  cudaError_t e = get_plan<STOP>(&p);
  if (e != cudaSuccess) return (int)e;
  const int grid = n < p.wave ? n : p.wave;
  roi_cnn_q8_kernel<STOP><<<grid, THREADS, p.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(roi), static_cast<const int32_t*>(qi),
      static_cast<const float*>(qf), static_cast<float*>(out), n, emb);
  return (int)cudaGetLastError();
}

}  // namespace

// roi: (n, 48, 96) uint8, 16-byte aligned; qi: the int32 weight buffer and
// qf the f32 one (cuda_cnn_q8.quantize_roi_cnn: QI_SIZE and
// QF_FC + 25 * emb entries), on the device; out: (n, emb) f32. Returns the
// first failing cudaError_t, else that of the launch.
extern "C" int roi_cnn_q8_forward(const void* roi, const void* qi,
                                  const void* qf, void* out, int n, int emb,
                                  void* stream) {
  return launch(roi, qi, qf, out, n, emb, stream);
}

// The check entry: the arguments of roi_cnn_q8_forward and stop (0 none,
// 1-3 after that stage: out's entry j of a frame's row then holds the
// stage's ReLU output's moment j % 3, in CHW order).
extern "C" int roi_cnn_q8_check_forward(const void* roi, const void* qi,
                                        const void* qf, void* out, int n,
                                        int emb, int stop, void* stream) {
  switch (stop) {
    case STOP_NONE:
      return launch<STOP_NONE>(roi, qi, qf, out, n, emb, stream);
    case STOP_STAGE1:
      return launch<STOP_STAGE1>(roi, qi, qf, out, n, emb, stream);
    case STOP_STAGE2:
      return launch<STOP_STAGE2>(roi, qi, qf, out, n, emb, stream);
    case STOP_STAGE3:
      return launch<STOP_STAGE3>(roi, qi, qf, out, n, emb, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The serving kernel's launch on the current device: out[0..4] = threads a
// block, dynamic shared memory bytes a block, blocks resident an SM, SMs,
// and the wave. Returns the first failing cudaError_t.
extern "C" int roi_cnn_q8_plan(int* out) {
  Plan p;
  const cudaError_t e = get_plan<STOP_NONE>(&p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.sms;
  out[4] = p.wave;
  return 0;
}
