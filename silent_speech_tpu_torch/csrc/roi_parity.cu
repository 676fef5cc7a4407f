// Parity-packed conv1 + pool1 of the ROI CNN for Hopper (sm_90a): the
// kernel of the CNN-front prototypes.
//
// Replaces three TPU kernels that share one body:
// - scripts/proto_parity_cnn.py::_kernel (conv1pool1_parity): two outputs,
//   the m-even and m-odd halves of pooled1 (LAYOUT_SPLIT);
// - scripts/proto_parity_e2e.py::_kernel (conv1pool1): one (N*12, 768)
//   output, m-even in lanes [0, 384) and m-odd in [384, 768) of row
//   n*12 + k, whose row-major reshape is (N, 24, 48, 8) (LAYOUT_ONE);
// - scripts/proto_ablate.py::make_kernel (run): the split kernel truncated
//   after a stage (the STOP template parameter; STOP_FULL is the split
//   kernel itself, the same instantiation).
//
// The function, for any (WE, WO, bias), as the TPU kernel computes it. The
// input is the frame's 48x96 uint8 image split into four row classes x_c
// (rows h = 4k + c, each (N*12, 96)); the image is widened to f32 without
// scaling (the packing folds /255 into WE, WO). For output row k of frame
// n, class c, 32-wide tile j and column col (0..127):
//   patch[dy*34 + l] = img[4k + c + dy - 1][32j + l - 1]  (zero outside;
//                      patch[102], patch[103] = 0)
//   y_e = sum_r patch[r] WE[r][col],  y_o = sum_r patch[r] WO[r][col]
//   out_half[k][128j + col] = relu(max(max(y_e, y_o)|c=ca,
//                                      max(y_e, y_o)|c=cb) + bias[128j+col])
// with (ca, cb) = (0, 1) for the m-even half and (2, 3) for the m-odd one.
// The two zero lanes of the patch add nothing for finite weights, so the
// sums run over r < 102.
//
// What bounds it on the H100: arithmetic. For any weights, through the
// packed matrices' 102 live rows, a frame is 12 x 4 x 3 x 2 x 102 x 128 =
// 3.76 M multiply-adds against 4,608 bytes in and 36,864 bytes out: 0.27 ms
// at N=8192 at the f32 FMAs and 3xTF32 together (232 TFLOP/s), against
// 0.10 ms of bytes. (Only 9 of the 102 rows of a packed column are nonzero;
// a kernel that used that would compute another function for unpacked
// weights, which proto_ablate feeds.)
//
// The design: a GEMM of each frame's 144 patch rows (k, c, j) by the 256
// columns [WE | WO] on the tensor cores, wgmma m64n128k8 TF32, with no
// patch matrix.
// - Two passes, not 3xTF32's three. The patch holds the frame's uint8
//   values widened without scaling; each is exact in TF32, so its split
//   has no lo part. W = hi + lo, each rounded as mma_tf32.cuh's split, and
//   a k8 step is patch x W_lo, then patch x W_hi (3xTF32's order, the zero
//   term left out).
// - W's planes. The hi and lo planes of all 256 columns, K = 104 padded to
//   four chunks of 32 in wgmma's 128-byte swizzle, take 256 KB: more than a
//   block has. So a block owns one column half (blockIdx.x & 1): columns
//   [64 h, 64 h + 64) of WE, then the same of WO, as B's 128 rows (128 KB
//   of planes, made once a block from WE and WO, rows 102.. zero). Each
//   frame is read by the two blocks of a pair, the second time from L2.
// - The patch is wgmma's A, in registers (implicit im2col). A warp's 16
//   rows are 8 (k, m-parity) pairs of one tile j: class ca in row g, class
//   cb in row g + 8. Its fragment values are loaded from the frame's
//   zero-haloed uint8 image in shared memory and widened there (one OR and
//   one FADD). A warpgroup's four warps are any four such slices.
// - The pool in registers. A thread's accumulators i and i + 32 are WE's
//   and WO's column c, and its rows g and g + 8 the class pair: the max,
//   the bias and the ReLU need no exchange, and each output is written
//   once, 8 bytes a thread and 32 a sector.
// - The sums. Each 32-deep chunk's wgmmas start from zero and the chunk's
//   sum is added into the tile's in f32 (the tensor cores truncate their
//   accumulation: TT's and NT's order). An output's order is fixed, so
//   repeated launches are bitwise equal. The zero k8 steps past K are left
//   out (3 of the last chunk's 4).
// - Persistent blocks, one an SM, of three warpgroups, walk groups of 8
//   frames (72 slices of 16 rows: 18 tiles of 64, 6 a warpgroup). A
//   group's bytes come by 4-byte cp.async into a double-buffered image
//   ring (rows of 104 bytes, the data at byte 4, so that the A loads are
//   conflict-free), the next group's while this one's wgmmas run.
// - A warpgroup waits for each chunk's wgmmas before it adds their sum
//   (a second set of sums does not fit its registers: 168 a thread, a few
//   spilled), so the tensor cores are kept busy by the other warpgroups:
//   each starts a group's tiles once the one before has issued its first
//   chunk (named barriers 1 and 2), and they stay a chunk apart, each
//   adding and storing while the others' wgmmas run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace {

namespace parity {

constexpr int HQ = 12, W0 = 96, H0 = 48;
constexpr int KLIVE = 102;             // live patch rows: 3 x 34
constexpr int NCOL = 128;              // columns of WE and of WO
constexpr int HALF = 384;              // output lanes of one m-parity half
constexpr int BN = 128;                // B's rows: 64 of WE, then 64 of WO
constexpr int CHUNKS = 4, ROW = 128;   // 32 k a chunk: a 128-byte row
constexpr int B_PLANE = BN * ROW;      // one chunk's hi (or lo) plane
constexpr int PLANES = CHUNKS * 2 * B_PLANE;
constexpr int IMG_S = 104;             // image row: 4 halo, 96, 4 halo bytes
constexpr int IMG_ROWS = H0 + 2;       // zero rows above and below
constexpr int IMG_BYTES = IMG_ROWS * IMG_S;
constexpr int GROUP = 8;               // frames a group
constexpr int SLICES = 9;              // 16-row slices a frame
constexpr int TILES = GROUP * SLICES / 4;  // 64-row tiles a group
constexpr int BUF = GROUP * IMG_BYTES;
constexpr int ALIGN = 1024;            // the 128-byte swizzle's period
constexpr int SMEM_BYTES = ALIGN + PLANES + HALF * 4 + 2 * BUF;
constexpr int WORDS = GROUP * H0 * (W0 / 4);  // a group's 4-byte copies
constexpr int WGS = 3, THREADS = WGS * 128;  // warpgroups a block
static_assert(TILES * 4 == GROUP * SLICES && TILES % WGS == 0,
              "whole tiles, as many for each warpgroup");
static_assert(IMG_S % 4 == 0 && BUF % 16 == 0 && PLANES % ALIGN == 0,
              "aligned copies and planes");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

enum Layout { LAYOUT_SPLIT = 0, LAYOUT_ONE = 1 };
// proto_ablate's stages, in ladder order (see ops/cuda_parity_cnn.py)
enum Stop { STOP_IO = 0, STOP_WIDEN = 1, STOP_HALO = 2, STOP_NO_DOT = 3,
            STOP_FULL = 4,
            // two controls of the products (ops/cuda_parity_cnn.CONTROLS):
            // one wgmma sum over all chunks; W_hi's pass alone
            STOP_ONE_SUM = 5, STOP_ONE_PASS = 6 };

struct Args {
  const uint8_t* x[4];  // class arrays (N*12, 96) uint8
  const float* we;      // (104, 128)
  const float* wo;      // (104, 128)
  const float* bias;    // (384,)
  float* out0;          // split: m-even (N*12, 384); one: (N*12, 768)
  float* out1;          // split: m-odd (N*12, 384); one: unused
  int n;
};

// a uint8 in the low byte of b, as the f32 of its value (exact)
__device__ __forceinline__ uint32_t widen(uint32_t b) {
  return __float_as_uint(__uint_as_float(0x4b000000u | b) - 8388608.f);
}

// the byte offset of patch lane r from (row h, column 32 j - 1) of the
// haloed image: r = dy * 34 + l lies at row h + dy, column 32 j + l - 1
__device__ __forceinline__ int lane_offset(int r) {
  const int dy = (r >= 34) + (r >= 68);
  return r + dy * (IMG_S - 34);
}

// this warp's A fragments for the k8 steps of chunk c (wgmma's A: rows g
// and g + 8, k t and t + 4), widened, from the image bytes at `row` (row g's
// origin); patch lanes 102 and 103 are zeros
__device__ __forceinline__ void load_chunk(uint32_t (&a)[4][4],
                                           const uint8_t* row, int c, int t) {
#pragma unroll
  for (int k8 = 0; k8 < 4; ++k8) {
    const int s = 4 * c + k8;
    if (s * 8 >= KLIVE) break;
    const int o0 = lane_offset(8 * s + t), o1 = lane_offset(8 * s + t + 4);
    a[k8][0] = widen(row[o0]);
    a[k8][1] = widen(row[o0 + IMG_S]);
    const bool live = 8 * s + t + 4 < KLIVE;
    a[k8][2] = live ? widen(row[o1]) : 0u;
    a[k8][3] = live ? widen(row[o1 + IMG_S]) : 0u;
  }
}

// chunk c's wgmmas into acc, from zero where `first`: for each live k8,
// patch x W_lo (LO) then patch x W_hi (planes of chunk c at shared
// address `planes`)
template <bool LO>
__device__ __forceinline__ void mma_chunk(float (&acc)[BN / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t planes, int c, bool first) {
  const uint32_t hi = planes + c * 2 * B_PLANE;
#pragma unroll
  for (int k8 = 0; k8 < 4; ++k8) {
    if ((4 * c + k8) * 8 >= KLIVE) break;
    const int scale = !first || k8 > 0;
    if constexpr (LO) {
      wgmma_tf32<BN>(acc, a[k8], wgmma_desc(hi + B_PLANE + 32 * k8), scale);
      wgmma_tf32<BN>(acc, a[k8], wgmma_desc(hi + 32 * k8), 1);
    } else {
      wgmma_tf32<BN>(acc, a[k8], wgmma_desc(hi + 32 * k8), scale);
    }
  }
}

// Write this thread's 16 pooled outputs: column pair 64 h + 8 q + 2 t (+1),
// q < 8, of tile j, output row k of frame nf, m-parity `half`; the pool
// over WE / WO (s[i], s[i + 32]) and rows g / g + 8 (s[i], s[i + 2]),
// + bias, ReLU
template <int LAYOUT>
__device__ __forceinline__ void store_pooled(const Args& a,
                                             const float (&s)[BN / 2],
                                             const float* bias_s, int nf,
                                             int k, int half, int j, int h,
                                             int t) {
  const size_t row = (size_t)nf * HQ + k;
  float* o = LAYOUT == LAYOUT_ONE ? a.out0 + row * (2 * HALF) + half * HALF
                                  : (half ? a.out1 : a.out0) + row * HALF;
  const int col = 128 * j + 64 * h + 2 * t;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 4 * q + e;
      const float m = fmaxf(fmaxf(s[i], s[i + 32]), fmaxf(s[i + 2], s[i + 34]));
      v[e] = fmaxf(m + bias_s[col + 8 * q + e], 0.f);
    }
    *reinterpret_cast<float2*>(o + col + 8 * q) = make_float2(v[0], v[1]);
  }
}

template <int LAYOUT, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
parity_kernel(const Args a) {
  // each warpgroup starts a group's tiles once the one before has issued
  // its first chunk of wgmmas; the stops without products run free
  constexpr bool STAGGER = STOP >= STOP_FULL;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                              (ALIGN - 1));
  uint8_t* planes = base;  // [chunk][hi, lo][128 rows][128 bytes]
  float* bias_s = reinterpret_cast<float*>(base + PLANES);
  uint8_t* ring = base + PLANES + HALF * 4;  // two image buffers
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wl = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x & 1, pairs = gridDim.x >> 1;
  const int groups = (a.n + GROUP - 1) / GROUP;

  // the halos are never written by a copy: zero both buffers once
  for (int i = tid; i < 2 * BUF / 16; i += THREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < HALF; i += THREADS) bias_s[i] = a.bias[i];
  if constexpr (STOP >= STOP_HALO) {  // W's planes of this column half
    for (int e = tid; e < CHUNKS * 32 * BN; e += THREADS) {
      const int k = e / BN, n = e % BN, col = 64 * h + (n & 63);
      const float w = k < KLIVE ? (n < 64 ? a.we : a.wo)[k * NCOL + col] : 0.f;
      uint32_t hi, lo;
      split(w, hi, lo);
      const int at = (k >> 5) * 2 * B_PLANE + n * ROW +
                     ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
      *reinterpret_cast<uint32_t*>(planes + at) = hi;
      *reinterpret_cast<uint32_t*>(planes + at + B_PLANE) = lo;
    }
  }

  // group gi's bytes into buffer buf: class c's row k of frame f at image
  // row 4k + c + 1, bytes 4..99
  auto fetch = [&](int gi, uint8_t* buf) {
    for (int e = tid; e < WORDS; e += THREADS) {
      const int f = e / (H0 * W0 / 4), hw = e % (H0 * W0 / 4);
      const int hh = hw / (W0 / 4), w4 = hw % (W0 / 4);
      const int nf = gi * GROUP + f, c = hh & 3;
      if (nf >= a.n) continue;
      const uint8_t* src = (c == 0 ? a.x[0] : c == 1 ? a.x[1]
                            : c == 2 ? a.x[2] : a.x[3]) +
                           ((size_t)nf * HQ + (hh >> 2)) * W0 + 4 * w4;
      cp_async4_fill(buf + f * IMG_BYTES + (hh + 1) * IMG_S + 4 + 4 * w4,
                     src, 4);
    }
  };

  const uint32_t planes_u32 = smem_u32(planes);
  int it = 0;
  __syncthreads();  // the zeros are in before any copy lands
  if ((int)(blockIdx.x >> 1) < groups) fetch(blockIdx.x >> 1, ring);
  cp_async_commit();
  for (int gi = blockIdx.x >> 1; gi < groups; gi += pairs, ++it) {
    const uint8_t* cur = ring + (it & 1) * BUF;
    __syncthreads();  // the other buffer's last reads are done (and setup)
    if (gi + pairs < groups) fetch(gi + pairs, ring + ((it + 1) & 1) * BUF);
    cp_async_commit();
    cp_async_wait<1>();  // this group's bytes have landed, for this thread
    __syncthreads();     // ... for all
    if (STAGGER && wg > 0)  // a chunk behind warpgroup wg - 1
      asm volatile("bar.sync %0, 256;\n" ::"r"(wg) : "memory");
#pragma unroll 1
    for (int tt = wg; tt < TILES; tt += WGS) {
      // this warp's slice: frame f of the group, tile j, pairs p0 .. p0 + 7
      const int sl = 4 * tt + wl, f = sl / SLICES, s = sl % SLICES;
      const int j = s / 3, p = 8 * (s % 3) + g;  // p = 2 k + m-parity
      const int nf = gi * GROUP + f;
      // row g: image row 2p (class 2 * parity of output row k = p / 2)
      const uint8_t* row = cur + f * IMG_BYTES + 2 * p * IMG_S + 32 * j + 3;
      float total[BN / 2];
      if constexpr (STOP == STOP_IO) {
        const float v = (float)row[4 * t + 1];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] = v;
      } else if constexpr (STOP == STOP_WIDEN || STOP == STOP_HALO) {
        uint32_t af[4][4];
        float v = STOP == STOP_HALO
                      ? *reinterpret_cast<const float*>(planes + 4 * tid)
                      : 0.f;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          load_chunk(af, row, c, t);
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if ((4 * c + k8) * 8 < KLIVE) v += __uint_as_float(af[k8][r]);
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] = v;
      } else {
        uint32_t a0[4][4], a1[4][4];
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] = 0.f;
        load_chunk(a0, row, 0, t);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          uint32_t (&cur_a)[4][4] = (c & 1) ? a1 : a0;
          uint32_t (&next_a)[4][4] = (c & 1) ? a0 : a1;
          if constexpr (STOP >= STOP_FULL) {  // full, one_sum, one_pass
            fence_acc(acc);
            fence_regs(cur_a);
            wgmma_fence();
            mma_chunk<STOP != STOP_ONE_PASS>(acc, cur_a, planes_u32, c,
                                             STOP != STOP_ONE_SUM || c == 0);
            wgmma_commit();
            if (STAGGER && wg + 1 < WGS && tt == wg && c == 0)
              asm volatile("bar.arrive %0, 256;\n" ::"r"(wg + 1) : "memory");
          } else {  // no_dot: the fragments in place of the products
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
              acc[i] = __uint_as_float(cur_a[(i >> 2) & 3][i & 3]);
          }
          if (c + 1 < CHUNKS) load_chunk(next_a, row, c + 1, t);
          if constexpr (STOP >= STOP_FULL) {
            wgmma_wait<0>();
            fence_acc(acc);
            fence_regs(a0);
            fence_regs(a1);
          }
          if (STOP != STOP_ONE_SUM || c == CHUNKS - 1) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) total[i] += acc[i];
          }
        }
      }
      if (nf < a.n)
        store_pooled<LAYOUT>(a, total, bias_s, nf, p >> 1, p & 1, j, h, t);
    }
  }
  cp_async_wait_all();
}

template <int LAYOUT, int STOP>
int launch(const Args& a, int grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      parity_kernel<LAYOUT, STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  parity_kernel<LAYOUT, STOP><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace parity

}  // namespace

// x0..x3: (n*12, 96) uint8 class arrays (rows h = 4k + c), 16-byte aligned;
// we, wo: (104, 128) f32; bias: (384,) f32; out0 (and out1 for layout 0):
// f32 outputs as in the note above. layout: 0 split, 1 one array; stop:
// 0 io, 1 widen, 2 halo, 3 no_dot, 4 full, 5 one_sum, 6 one_pass (all but
// full only with layout 0).
// grid: the SMs to fill; the kernel runs pairs of blocks, one a column
// half, at most one pair a group of 8 frames. Returns the cudaError_t of
// the launch.
extern "C" int roi_parity_forward(const void* x0, const void* x1,
                                  const void* x2, const void* x3,
                                  const void* we, const void* wo,
                                  const void* bias, void* out0, void* out1,
                                  int n, int layout, int stop, int grid,
                                  void* stream) {
  using namespace parity;
  if (n < 0 || grid < 1 || (layout == LAYOUT_ONE && stop != STOP_FULL))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a;
  a.x[0] = static_cast<const uint8_t*>(x0);
  a.x[1] = static_cast<const uint8_t*>(x1);
  a.x[2] = static_cast<const uint8_t*>(x2);
  a.x[3] = static_cast<const uint8_t*>(x3);
  a.we = static_cast<const float*>(we);
  a.wo = static_cast<const float*>(wo);
  a.bias = static_cast<const float*>(bias);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.n = n;
  auto s = static_cast<cudaStream_t>(stream);
  const int groups = (n + GROUP - 1) / GROUP;
  int pairs = grid / 2 < groups ? grid / 2 : groups;
  if (pairs < 1) pairs = 1;
  grid = 2 * pairs;
  if (layout == LAYOUT_ONE) return launch<LAYOUT_ONE, STOP_FULL>(a, grid, s);
  switch (stop) {
    case STOP_IO: return launch<LAYOUT_SPLIT, STOP_IO>(a, grid, s);
    case STOP_WIDEN: return launch<LAYOUT_SPLIT, STOP_WIDEN>(a, grid, s);
    case STOP_HALO: return launch<LAYOUT_SPLIT, STOP_HALO>(a, grid, s);
    case STOP_NO_DOT: return launch<LAYOUT_SPLIT, STOP_NO_DOT>(a, grid, s);
    case STOP_FULL: return launch<LAYOUT_SPLIT, STOP_FULL>(a, grid, s);
    case STOP_ONE_SUM: return launch<LAYOUT_SPLIT, STOP_ONE_SUM>(a, grid, s);
    case STOP_ONE_PASS: return launch<LAYOUT_SPLIT, STOP_ONE_PASS>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
