// TinyROICNN forward as output-packed im2col GEMMs, for Hopper (sm_90a):
// the packing's nonzero fragments on the tensor cores as 3xTF32.
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn.py::
// _roi_cnn_kernel (roi_impl='pallas', reached through roi_cnn_pallas). It
// computes K1's function (csrc/roi_cnn.cu):
//
//   (N, 48, 96) uint8 -> /255 (f32) -> optional per-frame standardize
//   (ddof=1, std >= 1e-6) -> conv 1->8, ReLU, pool -> conv 8->16, ReLU,
//   pool -> conv 16->24, ReLU -> mean over 12x24 -> fc -> (N, emb) f32,
//
// by the TPU kernel's algorithm: each conv is a GEMM of patch rows (one per
// output row h of a w tile) against the packed weight matrix
// Kpacked[(dy, wx, ci), (w_off, co)] = k[dy, wx - w_off, ci, co] of
// cuda_cnn_im2col.pack_im2col, whose buffer is this kernel's weight input.
// The w tiles (TILES in ops/cuda_cnn_im2col.py: 8 outputs for conv2 and
// conv3) share that matrix, so their patch rows stack into one M dimension,
// rows (j, h), as the TPU kernel stacks the rows of its F_TILE frames.
//
// What bounds it on the H100: arithmetic, as K1: 2.65 M multiply-adds a
// frame against 4,608 input bytes. The dense packed GEMMs would do 9.7 M,
// the packing's zeros included; this kernel does the function's work only:
// - The zeros of the packed matrices align with m16n8k8 fragments. A k8
//   slice is one (dy, wx) with 8 input channels, an n8 slice one w_off with
//   8 output channels, and such a fragment is nonzero only where
//   dx = wx - w_off is 0, 1 or 2. MMAs are issued for those fragments only
//   (cuda_cnn_im2col.nonzero_fragments, a test model, lists them). Every
//   nonzero fragment of one (dy, dx) holds the same 3x3 kernel slice, so
//   each block copies the (dy, dx) fragments once from the buffer (w_off 0)
//   into shared memory, in fragment order, split into TF32 hi and lo:
//   37 KB, not the 470 KB of the dense matrices.
// - conv2 (M 144 rows (j, h) x N (w_off, co) 128, 9 nonzero k8 fragments an
//   n8 one) and conv3 (M 36 x N 192, 18 a fragment) run as 3xTF32 on
//   m16n8k8 mma.sync: each operand x split as hi = rna_tf32(x), lo =
//   rna_tf32(x - hi) (roi_cnn_stages.cuh split), a product hi*hi + hi*lo +
//   lo*hi with f32 accumulation. The A fragments are read straight from the
//   zero-haloed channel-last maps in shared memory (no patch buffer) and
//   split as loaded; the B fragments are read pre-split.
// - conv2's M tile is 8 pooled rows of two output rows each: row g of the
//   fragment is output row 2 hp, row g + 8 row 2 hp + 1, so a thread holds
//   both rows of a pool window, and a warp computes the two w_off of a
//   window together: the 2x2 pool, bias and ReLU happen in registers, and
//   only the pooled map reaches shared memory. conv2's 144 rows are 9 M
//   tiles, one a warp. conv3's 36 rows fill 3 M tiles ragged (12 of 48 rows
//   idle); its tiles and 3 n8 channel tiles are one a warp, four w_off at a
//   time, each output summed into the means as it is formed.
// - p1 rows are padded to 404 floats and p2 rows to 27 pixels, so the 8
//   rows of an A fragment (output rows 2 or 1 apart) fall in distinct
//   shared-memory banks.
// - conv1 (one input channel, K = 9 taps: fragments at most 3/8 nonzero)
//   runs on the CUDA cores, K1's conv1 stage over this kernel's layout.
// - Persistent blocks: the grid is one wave of resident blocks
//   (roi_cnn_im2col_plan: cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//   SMs, asked of the card once per device); each block of 288 threads
//   copies the weights once and walks frames n = blockIdx.x, + gridDim.x,
//   ..., prefetching the next frame with cp.async. Every frame is computed
//   the same way whichever block takes it, and conv3's means are summed in
//   a fixed order, so a frame's output does not depend on N or its batch.
// - Shared memory, 109 KB a block, two blocks an SM: the image and p2
//   share one buffer (the image is dead once conv1 has run, p2 once conv3
//   has), so each frame zeroes the halo of the one it is about to use.
//
// The debug stops (roi_cnn_im2col_debug_forward, the STOP template) end
// each frame after a stage and write three moments of what it computed,
// in the plain version's order, as K1's (cuda_cnn.roi_cnn_debug_plain gives
// them): the scaled input, the haloed image, the pooled conv1 and conv2
// maps with their halos, conv3's ReLU outputs.

#include "roi_cnn_stages.cuh"

namespace {

// debug stops (cuda_cnn.DEBUG_STOPS): after the input load and scaling,
// the haloed image, each conv stage (STOP_NONE: the whole network)
enum Stop { STOP_NONE = 0, STOP_LOAD = 1, STOP_NORM = 2, STOP_CONV1 = 3,
            STOP_CONV2 = 4, STOP_CONV3 = 5 };

// packed GEMM shapes: K rows x N cols per w tile (pack_im2col)
constexpr int K1R = 3 * 18 * 1, N1 = 16 * C1;  // 54x128
constexpr int WX2 = 10, K2R = 3 * WX2 * C1, N2 = 8 * C2;   // 240x128
constexpr int WX3 = 10, K3R = 3 * WX3 * C2, N3 = 8 * C3;   // 480x192
// the packed f32 buffer: k1, b1 tiled, k2, b2 tiled, k3, b3 tiled, fc w
// (24, emb), fc b (emb)
constexpr int PK_K1 = 0;
constexpr int PK_B1 = PK_K1 + K1R * N1;
constexpr int PK_K2 = PK_B1 + N1;
constexpr int PK_B2 = PK_K2 + K2R * N2;
constexpr int PK_K3 = PK_B2 + N2;
constexpr int PK_B3 = PK_K3 + K3R * N3;
constexpr int PK_FC = PK_B3 + N3;

// conv2's M: patch rows (j, h), 6 w tiles of 24 rows, as 72 pooled pairs;
// conv3's: 3 w tiles of 12 rows
constexpr int C2_PAIRS = (W1 / 8) * (H1 / 2);  // 72
constexpr int C3_ROWS = (W2 / 8) * H2;         // 36
constexpr int C3_MTILES = (C3_ROWS + 15) / 16;  // 3
static_assert(C2_PAIRS == 8 * NWARPS, "one conv2 M tile a warp");
static_assert(C3_MTILES * (C3 / 8) == NWARPS, "one conv3 (M, n8) tile a warp");

// padded row strides (floats): p1 404 (2 rows = 8 banks apart), p2 27
// pixels of 16 (1 row = 16 banks apart)
constexpr int P1_ROW = P1_W * C1 + 4;
constexpr int P2_RS = (P2_W + 1) * C2;
static_assert((2 * P1_ROW) % 32 == 8 && P2_RS % 32 == 16, "conflict-free rows");

// Shared memory, byte offsets; the names load_frame, normalize_store and
// conv1_stage read (roi_cnn_stages.cuh) are those of Smem<float>.
struct Smem5 {
  static constexpr bool BF16 = false;
  static constexpr int P1_RS = P1_ROW;
  static constexpr size_t RAW = 0;                          // the frame
  static constexpr size_t XP = RAW + FRAME;                 // [50][98]
  static constexpr size_t P2 = XP;                          // [14][27][16]
  static constexpr size_t XP_P2 =
      align16((XP_SIZE > (H2 + 2) * P2_RS ? XP_SIZE : (H2 + 2) * P2_RS) * 4);
  static constexpr size_t P1 = XP + XP_P2;                  // [26][404]
  static constexpr size_t W1S = P1 + align16((H1 + 2) * P1_ROW * 4);
  // conv1: [co][12]: 9 taps, b1, 2 zeros (conv1_stage's layout)
  static constexpr size_t W2S = W1S + C1 * 12 * 4;
  // conv2: [tap][n8 half][lane] of (hi b0, hi b1, lo b0, lo b1)
  static constexpr size_t W3S = W2S + 9 * 2 * 32 * 16;
  // conv3: [tap][k8 half][n8 tile][lane], as conv2's
  static constexpr size_t BIAS = W3S + 9 * 2 * 3 * 32 * 16;  // b2, b3
  static constexpr size_t RED = BIAS + (C2 + C3) * 4;        // NWARPS + 1
  static constexpr size_t RED3 = RED + 16 * 4;               // [C3_MTILES][C3]
  static constexpr size_t MEAN = RED3 + C3_MTILES * C3 * 4;
  static constexpr size_t BYTES = MEAN + C3 * 4;
};
static_assert(Smem5::BYTES + 1024 <= 233472 / 2, "two blocks an SM");

// The weights from pack_im2col's buffer into shared memory, once a block:
// each (dy, dx) fragment of the packed matrices at w_off 0 (every w_off
// holds the same values; cuda_cnn_im2col.tap_blocks), conv2's and conv3's
// in m16n8k8 fragment order, split into TF32 hi and lo. A k8 slot t holds
// channel 2t (+ 8 for conv3's upper half) and slot t + 4 channel 2t + 1,
// as the A fragments read them (one float2 or float4 a pixel).
__device__ void pack_weights5(const float* __restrict__ w,
                              unsigned char* smem) {
  using S = Smem5;
  const int tid = threadIdx.x;
  float* w1s = reinterpret_cast<float*>(smem + S::W1S);
  for (int i = tid; i < C1 * 12; i += THREADS) {
    const int co = i / 12, k = i % 12;
    w1s[i] = k < 9 ? w[PK_K1 + ((k / 3) * 18 + k % 3) * N1 + co]
             : k == 9 ? w[PK_B1 + co]
                      : 0.f;
  }
  float* bias = reinterpret_cast<float*>(smem + S::BIAS);
  for (int i = tid; i < C2 + C3; i += THREADS)
    bias[i] = i < C2 ? w[PK_B2 + i] : w[PK_B3 + i - C2];
  auto frag = [](float b0, float b1) {
    uint32_t h0, h1, l0, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    return make_uint4(h0, h1, l0, l1);
  };
  uint4* w2s = reinterpret_cast<uint4*>(smem + S::W2S);
  for (int i = tid; i < 9 * 2 * 32; i += THREADS) {
    const int lane = i & 31, half = (i >> 5) & 1, tap = i >> 6;
    const int g = lane >> 2, t = lane & 3;
    const float* src =
        w + PK_K2 + ((tap / 3) * WX2 + tap % 3) * C1 * N2 + 8 * half + g;
    w2s[i] = frag(src[(2 * t) * N2], src[(2 * t + 1) * N2]);
  }
  uint4* w3s = reinterpret_cast<uint4*>(smem + S::W3S);
  for (int i = tid; i < 9 * 2 * 3 * 32; i += THREADS) {
    const int lane = i & 31, nt = (i >> 5) % 3, hk = (i / 96) & 1,
              tap = i / 192;
    const int g = lane >> 2, t = lane & 3;
    const float* src = w + PK_K3 +
                       (((tap / 3) * WX3 + tap % 3) * C2 + 8 * hk) * N3 +
                       8 * nt + g;
    w3s[i] = frag(src[(2 * t) * N3], src[(2 * t + 1) * N3]);
  }
}

__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  const uint32_t bh[2] = {b.x, b.y}, bl[2] = {b.z, b.w};
  mma_3xtf32(d, ah, al, bh, bl);
}

// conv2 + ReLU + pool: warp `warp` takes M tile `warp`, pooled pairs
// P = 8 warp + g (w tile j = P / 12, pooled row hp = P % 12): A row g is
// output row 2 hp, row g + 8 output row 2 hp + 1, of columns 8 j + w_off.
// Two w_off (one pool window's columns) at a time.
__device__ __forceinline__ void conv2_im2col(unsigned char* smem, int warp,
                                             int lane) {
  using S = Smem5;
  const float* p1 = reinterpret_cast<const float*>(smem + S::P1);
  float* p2 = reinterpret_cast<float*>(smem + S::P2);
  const uint4* w2s = reinterpret_cast<const uint4*>(smem + S::W2S);
  const float* b2 = reinterpret_cast<const float*>(smem + S::BIAS);
  const int g = lane >> 2, t = lane & 3;
  const int pr = 8 * warp + g, j = pr / 12, hp = pr % 12;
  // haloed p1: output (h, w) reads rows h + dy, columns w + dx
  const float* a_row = p1 + 2 * hp * P1_ROW + 8 * j * C1 + 2 * t;
  float bias[2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[half][e] = b2[8 * half + 2 * t + e];
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {  // w_off 2q and 2q + 1
    float acc[2][2][4] = {};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // wx = 2q + c
        const float* a = a_row + dy * P1_ROW + (2 * q + c) * C1;
        const float2 r0 = *reinterpret_cast<const float2*>(a);
        const float2 r1 = *reinterpret_cast<const float2*>(a + P1_ROW);
        uint32_t ah[4], al[4];
        split(r0.x, ah[0], al[0]);
        split(r1.x, ah[1], al[1]);
        split(r0.y, ah[2], al[2]);
        split(r1.y, ah[3], al[3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // w_off = 2q + e, dx = c - e
          const int dx = c - e;
          if (dx < 0 || dx > 2) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            mma3(acc[e][half], ah, al,
                 w2s[((dy * 3 + dx) * 2 + half) * 32 + lane]);
        }
      }
    // the window: rows g, g + 8 (d[j], d[j + 2]) of w_off 2q, 2q + 1;
    // relu(max(s) + b) == max(relu(s + b)); channel 8 half + 2t + e sits at
    // position 4t + 2 half + e (roi_cnn_stages.cuh p2_chan)
    float o[2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[half][e] = fmaxf(
            fmaxf(fmaxf(acc[0][half][e], acc[0][half][e + 2]),
                  fmaxf(acc[1][half][e], acc[1][half][e + 2])) +
                bias[half][e],
            0.f);
    *reinterpret_cast<float4*>(p2 + (hp + 1) * P2_RS +
                               (4 * j + q + 1) * C2 + 4 * t) =
        make_float4(o[0][0], o[0][1], o[1][0], o[1][1]);
  }
}

// conv3: warp `warp` takes M tile mt = warp / 3 (patch rows R = 16 mt + g
// and + 8: w tile R / 12, output row R % 12; rows from 36 on are idle and
// read row 0) and n8 tile nt = warp % 3, four w_off at a time. Each output
// of a patch row goes to emit(w_off, r, sum) as it is formed: r / 2 the
// row (g or g + 8), channel 8 nt + 2t + r % 2.
template <typename Emit>
__device__ __forceinline__ void conv3_im2col(const unsigned char* smem,
                                             int warp, int lane,
                                             Emit&& emit) {
  using S = Smem5;
  const float* p2 = reinterpret_cast<const float*>(smem + S::P2);
  const uint4* w3s = reinterpret_cast<const uint4*>(smem + S::W3S);
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp / 3, nt = warp % 3;
  const float* a_row[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mt + g + 8 * i;
    valid[i] = r < C3_ROWS;
    const int rc = valid[i] ? r : 0;
    a_row[i] = p2 + (rc % 12) * P2_RS + 8 * (rc / 12) * C2 + 4 * t;
  }
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {  // w_off 4 half + wl
    float acc[4][4] = {};
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int c = 0; c < 6; ++c) {  // wx = 4 half + c
        // channels 2t, 2t+1, 2t+8, 2t+9 of rows g and g + 8
        const int off = dy * P2_RS + (4 * half + c) * C2;
        const float4 a0 = *reinterpret_cast<const float4*>(a_row[0] + off);
        const float4 a1 = *reinterpret_cast<const float4*>(a_row[1] + off);
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          uint32_t ah[4], al[4];
          split(hk ? a0.z : a0.x, ah[0], al[0]);
          split(hk ? a1.z : a1.x, ah[1], al[1]);
          split(hk ? a0.w : a0.y, ah[2], al[2]);
          split(hk ? a1.w : a1.y, ah[3], al[3]);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {  // w_off = wx - dx
            const int wl = c - dx;
            if (wl < 0 || wl > 3) continue;
            mma3(acc[wl], ah, al,
                 w3s[(((dy * 3 + dx) * 2 + hk) * 3 + nt) * 32 + lane]);
          }
        }
      }
#pragma unroll
    for (int wl = 0; wl < 4; ++wl)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (valid[r >> 1]) emit(4 * half + wl, r, acc[wl][r]);
  }
}

// conv3's bias and ReLU summed into the 24 channel means (S::MEAN) in a
// fixed order: a thread's w_off and rows, then g, then the M tiles.
__device__ __forceinline__ void conv3_means5(unsigned char* smem, int warp,
                                             int lane) {
  using S = Smem5;
  const float* b3 = reinterpret_cast<const float*>(smem + S::BIAS) + C2;
  float* red3 = reinterpret_cast<float*>(smem + S::RED3);
  float* mean = reinterpret_cast<float*>(smem + S::MEAN);
  const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int mt = warp / 3, nt = warp % 3;
  const float b[2] = {b3[8 * nt + 2 * t], b3[8 * nt + 2 * t + 1]};
  float z[2] = {0.f, 0.f};
  conv3_im2col(smem, warp, lane, [&](int, int r, float v) {
    z[r & 1] += fmaxf(v + b[r & 1], 0.f);
  });
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)  // over g, the same t
      z[e] += __shfl_xor_sync(0xffffffffu, z[e], o);
    if (g == 0) red3[mt * C3 + 8 * nt + 2 * t + e] = z[e];
  }
  __syncthreads();
  if (tid < C3) {
    float s = 0.f;
    for (int m = 0; m < C3_MTILES; ++m) s += red3[m * C3 + tid];
    mean[tid] = s / (float)(H2 * W2);
  }
  __syncthreads();
}

// zero a haloed map's border pixels (rows 0 and h + 1, columns 0 and
// w + 1 of the rows between), `cpp` floats a pixel, `rs` floats a row
__device__ __forceinline__ void zero_halo(float* map, int h, int w, int cpp,
                                         int rs) {
  const int border = 2 * (w + 2) + 2 * h;
  for (int i = threadIdx.x; i < border * cpp; i += THREADS) {
    const int px = i / cpp, c = i % cpp;
    int y, x;
    if (px < 2 * (w + 2)) {
      y = px < w + 2 ? 0 : h + 1;
      x = px % (w + 2);
    } else {
      y = 1 + (px - 2 * (w + 2)) / 2;
      x = (px & 1) ? w + 1 : 0;
    }
    map[y * rs + x * cpp + c] = 0.f;
  }
}

template <int STOP = STOP_NONE>
__global__ void __launch_bounds__(THREADS, 2)
roi_cnn_im2col_kernel(const uint8_t* __restrict__ roi,
                      const float* __restrict__ w, float* __restrict__ out,
                      int n_frames, int emb, int standardize) {
  using S = Smem5;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* raw = reinterpret_cast<uint4*>(smem + S::RAW);
  float* xp = reinterpret_cast<float*>(smem + S::XP);
  float* p2 = reinterpret_cast<float*>(smem + S::P2);
  const float* p1 = reinterpret_cast<const float*>(smem + S::P1);
  const float* b3 = reinterpret_cast<const float*>(smem + S::BIAS) + C2;
  float* red = reinterpret_cast<float*>(smem + S::RED);
  const float* mean = reinterpret_cast<const float*>(smem + S::MEAN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cp_async16(raw + tid, roi + (size_t)blockIdx.x * FRAME + 16 * tid);
  for (int i = tid; i < (int)((S::W1S - S::XP) / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem + S::XP)[i] = make_uint4(0, 0, 0, 0);
  pack_weights5(w, smem);
  __syncthreads();

#pragma unroll 1
  for (int n = blockIdx.x; n < n_frames; n += gridDim.x) {
    const int next = n + gridDim.x;
    // ---- input: this thread's 16 pixels, scaled, standardized when asked
    float v[16];
    load_frame<float, S>(smem, v);
    if constexpr (STOP == STOP_LOAD) {
      Moments m;
#pragma unroll
      for (int k = 0; k < 16; ++k) m.add(v[k], tid * 16 + k);
      write_stop(out, n, emb, m, red);
      if (next < n_frames)
        cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);
      continue;
    }
    // p2 (the last frame's) is dead: the image's halo back to zero
    zero_halo(xp, H0, W0, 1, XP_W);
    normalize_store<float, S>(smem, v, standardize);
    __syncthreads();
    if (next < n_frames)
      cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);
    if constexpr (STOP == STOP_NORM) {
      Moments m;
      for (int i = tid; i < XP_SIZE; i += THREADS) m.add(xp[i], i);
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv1 + ReLU + pool on the CUDA cores
    conv1_stage<float, false, S>(smem);
    __syncthreads();
    if constexpr (STOP == STOP_CONV1) {  // i: CHW with halos
      Moments m;
      for (int e = tid; e < P1_PIX * C1; e += THREADS) {
        const int px = e / C1, c = e % C1;
        m.add(p1[(px / P1_W) * P1_ROW + (px % P1_W) * C1 + c],
              c * P1_PIX + px);
      }
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv2 + ReLU + pool on the tensor cores; the image is dead:
    // p2's halo back to zero
    zero_halo(p2, H2, W2, C2, P2_RS);
    conv2_im2col(smem, warp, lane);
    __syncthreads();
    if constexpr (STOP == STOP_CONV2) {  // i: CHW with halos
      Moments m;
      for (int e = tid; e < P2_PIX * C2; e += THREADS) {
        const int px = e / C2, pos = e % C2;
        m.add(p2[(px / P2_W) * P2_RS + (px % P2_W) * C2 + pos],
              p2_chan(pos) * P2_PIX + px);
      }
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv3 + ReLU on the tensor cores, summed for the mean
    if constexpr (STOP == STOP_CONV3) {  // i: co * 288 + y * 24 + x, CHW
      Moments m;
      const int g = lane >> 2, t = lane & 3, mt = warp / 3, nt = warp % 3;
      conv3_im2col(smem, warp, lane, [&](int wo, int r, float v) {
        const int row = 16 * mt + g + 8 * (r >> 1), co = 8 * nt + 2 * t + (r & 1);
        m.add(fmaxf(v + b3[co], 0.f),
              co * (H2 * W2) + (row % 12) * W2 + 8 * (row / 12) + wo);
      });
      write_stop(out, n, emb, m, red);
      continue;
    }
    conv3_means5(smem, warp, lane);

    // ---- fc 24 -> emb (JAX layout: weight (24, emb)), from the buffer
    if (tid < emb) {
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < C3; ++c)
        z = fmaf(mean[c], __ldg(w + PK_FC + c * emb + tid), z);
      out[(size_t)n * emb + tid] = z + __ldg(w + PK_FC + C3 * emb + tid);
    }
  }
  cp_async_wait_all();
}

template <int STOP> struct Tag5 {};

template <int STOP>
cudaError_t get_plan(Plan* p) {
  return plan_for<Tag5<STOP>>((const void*)roi_cnn_im2col_kernel<STOP>,
                              (int)Smem5::BYTES, p);
}

// Launch roi_cnn_im2col_kernel<STOP> on stream s over min(n, one wave)
// blocks. Returns the first failing cudaError_t.
template <int STOP = STOP_NONE>
int launch(const void* roi, const void* w, void* out, int n, int emb,
           int standardize, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Plan p;
  cudaError_t e = get_plan<STOP>(&p);
  if (e != cudaSuccess) return (int)e;
  const int grid = n < p.wave ? n : p.wave;
  roi_cnn_im2col_kernel<STOP><<<grid, THREADS, p.smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(roi), static_cast<const float*>(w),
      static_cast<float*>(out), n, emb, standardize);
  return (int)cudaGetLastError();
}

}  // namespace

// roi: (n, 48, 96) uint8, contiguous and 16-byte aligned; w: the packed f32
// weight buffer on the device (cuda_cnn_im2col.pack_im2col: PK_FC + 25 *
// emb entries); out: (n, emb) f32. Returns the first failing cudaError_t,
// else that of the launch.
extern "C" int roi_cnn_im2col_forward(const void* roi, const void* w,
                                      void* out, int n, int emb,
                                      int standardize, void* stream) {
  return launch(roi, w, out, n, emb, standardize, stream);
}

// The kernel truncated after a stage: the arguments of
// roi_cnn_im2col_forward and stop = 1 load, 2 norm, 3 conv1, 4 conv2,
// 5 conv3; out (n, emb): entry j of a frame's row holds the stage's moment
// j % 3 (sum, sum of squares, index-weighted sum), as K1's debug stops.
extern "C" int roi_cnn_im2col_debug_forward(const void* roi, const void* w,
                                            void* out, int n, int emb,
                                            int standardize, int stop,
                                            void* stream) {
  switch (stop) {
    case STOP_LOAD:
      return launch<STOP_LOAD>(roi, w, out, n, emb, standardize, stream);
    case STOP_NORM:
      return launch<STOP_NORM>(roi, w, out, n, emb, standardize, stream);
    case STOP_CONV1:
      return launch<STOP_CONV1>(roi, w, out, n, emb, standardize, stream);
    case STOP_CONV2:
      return launch<STOP_CONV2>(roi, w, out, n, emb, standardize, stream);
    case STOP_CONV3:
      return launch<STOP_CONV3>(roi, w, out, n, emb, standardize, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The serving kernel's launch on the current device: out[0..4] = threads a
// block, dynamic shared memory bytes a block, blocks resident an SM, SMs,
// and the wave (the grid of any launch of at least that many frames).
// Returns the first failing cudaError_t.
extern "C" int roi_cnn_im2col_plan(int* out) {
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
