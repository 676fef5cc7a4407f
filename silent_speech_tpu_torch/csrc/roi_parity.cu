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
// 3.76 M multiply-adds against 4,608 bytes in and 36,864 bytes out: 0.92 ms
// of f32 FMAs at N=8192 against 0.10 ms of bytes. (Only 9 of the 102 rows
// of a packed column are nonzero; a kernel that used that would compute
// another function for unpacked weights, which proto_ablate feeds.)
//
// The design: a GEMM of the frame's 144 patch rows (k, c, j) by the 256
// columns [WE | WO] on the CUDA cores, with no patch matrix.
// - One block of 288 threads a SM walks frames (grid-stride), so WE and WO
//   (106,496 bytes) are loaded into shared memory once a block, not once a
//   frame: they do not fit the 64 KB constant bank.
// - Each frame's image is rebuilt from the four class arrays (one 16-byte
//   load a thread, prefetched one frame ahead) into shared memory as three
//   zero-haloed, transposed copies, one per dy: xT[dy][L][h'] =
//   img[h' + dy - 1][L - 1]. The 8 patch rows of a thread, classes 0..3 of
//   two consecutive k, are the 8 consecutive h' = 8 kp .. 8 kp + 7 of one
//   copy: two 16-byte loads a patch lane.
// - A thread owns 2 k x 4 classes x 4 columns, each through WE and WO: 64
//   accumulators, 64 FMAs for every 4 shared-memory loads (2 patch, 2
//   weight); its warp covers two (kp, j) row groups and 16 column groups,
//   so the patch loads broadcast and the weight loads are conflict-free. The
//   pool over the w pair (WE against WO), over the class pair and the bias
//   and ReLU are applied in registers, and each output is written once, 16
//   bytes at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HQ = 12, W0 = 96, H0 = 48;
constexpr int KP = 104;                // packed patch rows: 3 x 34 + 2 zero
constexpr int NCOL = 128;              // columns of WE and of WO
constexpr int HALF = 384;              // output lanes of one m-parity half
constexpr int THREADS = 288;           // 9 warps: 4,608 bytes = 16 a thread
constexpr int FRAME_BYTES = H0 * W0;
constexpr int CLASS_BYTES = HQ * W0;   // one class array's bytes a frame
constexpr int XT_L = W0 + 2;           // haloed lanes L = w + 1
constexpr int XT_S = H0 + 4;           // row stride: 48 h', 16-byte aligned
constexpr int XT_SIZE = XT_L * XT_S;
constexpr size_t SMEM_BYTES = (size_t)(2 * KP * NCOL + 3 * XT_SIZE) * 4;
static_assert(THREADS * 16 == FRAME_BYTES, "one 16-byte load a thread");
static_assert(CLASS_BYTES % 16 == 0, "class rows of a frame 16-byte aligned");
static_assert((XT_S * 4) % 16 == 0 && (XT_SIZE * 4) % 16 == 0, "float4 rows");

enum Layout { LAYOUT_SPLIT = 0, LAYOUT_ONE = 1 };
// proto_ablate's stages, in ladder order (see ops/cuda_parity_cnn.py)
enum Stop { STOP_IO = 0, STOP_WIDEN = 1, STOP_HALO = 2, STOP_NO_DOT = 3,
            STOP_FULL = 4 };

struct Args {
  const uint8_t* x[4];  // class arrays (N*12, 96) uint8
  const float* we;      // (104, 128)
  const float* wo;      // (104, 128)
  const float* bias;    // (384,)
  float* out0;          // split: m-even (N*12, 384); one: (N*12, 768)
  float* out1;          // split: m-odd (N*12, 384); one: unused
  int n;
};

// this thread's 16 bytes of frame n, from src = its class array + its
// offset in a frame's 12 rows
__device__ __forceinline__ uint4 load_frame(const uint8_t* src, int n) {
  return *reinterpret_cast<const uint4*>(src + (size_t)n * CLASS_BYTES);
}

__device__ __forceinline__ void widen(const uint4 q, float v[16]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (float)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

// Write 4 pooled columns of output row k, half `half`, at lane `lane`.
template <int LAYOUT>
__device__ __forceinline__ void store4(const Args& a, int n, int k, int half,
                                       int lane, float4 v) {
  const size_t row = (size_t)n * HQ + k;
  float* p = LAYOUT == LAYOUT_ONE ? a.out0 + row * (2 * HALF) + half * HALF
                                  : (half ? a.out1 : a.out0) + row * HALF;
  *reinterpret_cast<float4*>(p + lane) = v;
}

// A stop's output: s in every output this thread writes (2 column passes
// x 2 k x 2 halves, 4 columns each).
template <int LAYOUT>
__device__ __forceinline__ void store_all(const Args& a, int n, int j, int kp,
                                          int lane, float s) {
  const float4 v = make_float4(s, s, s, s);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store4<LAYOUT>(a, n, 2 * kp + kk, half,
                       128 * j + 4 * ((lane & 15) + 16 * p), v);
}

// Build the frame's three transposed, zero-haloed image copies from this
// thread's 16 widened pixels (row h_in, columns w_in .. w_in + 15).
__device__ __forceinline__ void build_image(float* xt, const float v[16],
                                            int h_in, int w_in) {
  __syncthreads();  // the last frame's reads of xt are done (and setup)
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hp = h_in - dy + 1;
    if (hp >= 0 && hp < H0) {
      float* dst = xt + dy * XT_SIZE + (w_in + 1) * XT_S + hp;
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[i * XT_S] = v[i];
    }
  }
  __syncthreads();
}

// The products of this thread's 8 patch rows (h' = 8 kp .. 8 kp + 7 of
// tile j) with its 4 columns of WE and WO, pooled, + bias, ReLU, stored;
// STOP_NO_DOT puts image values in place of the products.
template <int LAYOUT, int STOP>
__device__ __forceinline__ void pool_products(const Args& a, int n,
                                              const float* xt, const float* we,
                                              const float* wo, int j, int kp,
                                              int lane) {
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    const int cg = (lane & 15) + 16 * p;  // columns 4 cg .. 4 cg + 3
    float ae[8][4], ao[8][4];
    if constexpr (STOP == STOP_NO_DOT) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4* xr = reinterpret_cast<const float4*>(
            xt + (32 * j + c) * XT_S + 8 * kp);
        const float4 lo = xr[0], hi = xr[1];
        const float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) ae[i][c] = ao[i][c] = r[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) ae[i][c] = ao[i][c] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* xrow = xt + dy * XT_SIZE + (32 * j) * XT_S + 8 * kp;
        const float* wer = we + (dy * 34) * NCOL + 4 * cg;
        const float* wor = wo + (dy * 34) * NCOL + 4 * cg;
#pragma unroll 2
        for (int l = 0; l < 34; ++l) {
          const float4 lo = *reinterpret_cast<const float4*>(xrow + l * XT_S);
          const float4 hi = *reinterpret_cast<const float4*>(xrow + l * XT_S + 4);
          const float4 e = *reinterpret_cast<const float4*>(wer + l * NCOL);
          const float4 o = *reinterpret_cast<const float4*>(wor + l * NCOL);
          const float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          const float ev[4] = {e.x, e.y, e.z, e.w};
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ae[i][c] = fmaf(r[i], ev[c], ae[i][c]);
              ao[i][c] = fmaf(r[i], ov[c], ao[i][c]);
            }
        }
      }
    }
    // pool over the w pair, then the class pair; + bias; ReLU
    const float4 b4 =
        *reinterpret_cast<const float4*>(a.bias + 128 * j + 4 * cg);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ia = 4 * kk + 2 * half, ib = ia + 1;  // classes ca, cb
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float m = fmaxf(fmaxf(ae[ia][c], ao[ia][c]),
                                fmaxf(ae[ib][c], ao[ib][c]));
          o[c] = fmaxf(m + bv[c], 0.f);
        }
        store4<LAYOUT>(a, n, 2 * kp + kk, half, 128 * j + 4 * cg,
                       make_float4(o[0], o[1], o[2], o[3]));
      }
  }
}

template <int LAYOUT, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
parity_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* we = reinterpret_cast<float*>(smem4);   // [104][128]
  float* wo = we + KP * NCOL;                    // [104][128]
  float* xt = wo + KP * NCOL;                    // [3][98][52]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this thread's tile: row group rc = (j, kp), 4 columns a pass
  const int rc = 2 * warp + (lane >> 4);         // 0..17
  const int j = rc / 6, kp = rc % 6;
  // this thread's load: class ci, bytes [off, off + 16) of the class's
  // rows of a frame; where they land in the image
  const int ci = tid / (CLASS_BYTES / 16);
  const int off = (tid % (CLASS_BYTES / 16)) * 16;
  const int h_in = 4 * (off / W0) + ci, w_in = off % W0;
  const uint8_t* src = (ci == 0 ? a.x[0] : ci == 1 ? a.x[1]
                        : ci == 2 ? a.x[2] : a.x[3]) + off;

  if constexpr (STOP >= STOP_HALO) {
    for (int i = tid; i < KP * NCOL / 4; i += THREADS) {
      smem4[i] = reinterpret_cast<const float4*>(a.we)[i];
      smem4[KP * NCOL / 4 + i] = reinterpret_cast<const float4*>(a.wo)[i];
    }
    // the halo cells are never written by a frame: zero them once
    for (int i = tid; i < 3 * XT_SIZE; i += THREADS) xt[i] = 0.f;
  }

  const int stride = gridDim.x;
  uint4 next = make_uint4(0, 0, 0, 0);
  if ((int)blockIdx.x < a.n) next = load_frame(src, blockIdx.x);
  for (int n = blockIdx.x; n < a.n; n += stride) {
    const uint4 q = next;
    if (n + stride < a.n) next = load_frame(src, n + stride);
    if constexpr (STOP == STOP_IO) {  // the bytes in, the outputs out
      store_all<LAYOUT>(a, n, j, kp, lane,
                        (float)((q.x ^ q.y ^ q.z ^ q.w) & 0xffu));
    } else {
      float v[16];
      widen(q, v);
      if constexpr (STOP == STOP_WIDEN) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) s += v[i];
        store_all<LAYOUT>(a, n, j, kp, lane, s);
      } else {
        build_image(xt, v, h_in, w_in);
        if constexpr (STOP == STOP_HALO)
          store_all<LAYOUT>(a, n, j, kp, lane,
                            xt[XT_SIZE + (32 * j + 1) * XT_S + 8 * kp]);
        else
          pool_products<LAYOUT, STOP>(a, n, xt, we, wo, j, kp, lane);
      }
    }
  }
}

template <int LAYOUT, int STOP>
int launch(const Args& a, int grid, cudaStream_t s) {
  const size_t smem = STOP >= STOP_HALO ? SMEM_BYTES : 0;
  cudaError_t e = cudaFuncSetAttribute(
      parity_kernel<LAYOUT, STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  parity_kernel<LAYOUT, STOP><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x0..x3: (n*12, 96) uint8 class arrays (rows h = 4k + c), 16-byte aligned;
// we, wo: (104, 128) f32; bias: (384,) f32; out0 (and out1 for layout 0):
// f32 outputs as in the note above. layout: 0 split, 1 one array; stop:
// 0 io, 1 widen, 2 halo, 3 no_dot, 4 full (stops only with layout 0).
// grid: blocks (one a SM). Returns the cudaError_t of the launch.
extern "C" int roi_parity_forward(const void* x0, const void* x1,
                                  const void* x2, const void* x3,
                                  const void* we, const void* wo,
                                  const void* bias, void* out0, void* out1,
                                  int n, int layout, int stop, int grid,
                                  void* stream) {
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
  if (grid > n) grid = n;
  if (layout == LAYOUT_ONE) return launch<LAYOUT_ONE, STOP_FULL>(a, grid, s);
  switch (stop) {
    case STOP_IO: return launch<LAYOUT_SPLIT, STOP_IO>(a, grid, s);
    case STOP_WIDEN: return launch<LAYOUT_SPLIT, STOP_WIDEN>(a, grid, s);
    case STOP_HALO: return launch<LAYOUT_SPLIT, STOP_HALO>(a, grid, s);
    case STOP_NO_DOT: return launch<LAYOUT_SPLIT, STOP_NO_DOT>(a, grid, s);
    case STOP_FULL: return launch<LAYOUT_SPLIT, STOP_FULL>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
