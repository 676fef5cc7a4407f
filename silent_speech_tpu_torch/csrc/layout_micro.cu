// Layout micro-kernels for Hopper (sm_90a): the nine bodies of
// scripts/mosaic_micro.py::main (:69-113), each over `steps` (768, 768) f32
// blocks of x ((steps * 768, 768), row-major), one instantiation a body.
//
// Replaces scripts/mosaic_micro.py::_mk (:26, its pallas_call at :34):
// there one grid step holds a (768, 768) block (2.36 MB) in VMEM. Here a
// block of 2.36 MB fits no SM's shared memory, so the bodies that move
// elements (all but the transpose and the product) take 16-byte vector
// loads and stores, one float4 of an output row a thread, 8 blocks a step
// each walking every eighth row, with the row and lane arithmetic of the
// body in the index; the transpose goes through a (32 x 33) padded
// shared-memory tile; the product runs csrc/sgemm_tile.cuh's 64 x 64 f32
// tile. The bodies, with their output a block:
//   0 copy                  the block
//   1 rows_reshape_max      (384, 768): max of rows 2i and 2i + 1
//   2 lanes_roll_max        max(v, v[:, (j + 8) mod 768])
//   3 rows_roll_max         max(v, v[(i + 1) mod 768]), within the block
//   4 rows_strided_slice    (384, 768): every second row (the odd rows are
//                           never read)
//   5 transpose             the block transposed
//   6 unaligned_18lane_x6   o[:, 128j : 128j + 18] = v[:, 16j : 16j + 18],
//                           j < 6, and zeros in every other lane (the TPU
//                           kernel leaves them unwritten: undefined)
//   7 aligned_128lane_x6    six 128-lane slices: a copy
//   8 matmul_768x512x128    o[:, :128] = v[:, :512] @ v[:512, :128] (f32
//                           FMAs), o[:, 128:] = v[:, 128:]
// "Aligned" on this card means 16-byte vector accesses (4 lanes), not the
// TPU's 128-lane vregs: the 18-lane slices start on 16-lane boundaries,
// so each is four aligned float4 loads and a ragged 2-lane end (72 bytes),
// and the 128-lane slices are plain aligned copies.
//
// What bounds them: the bytes, each input read once and each output
// written once, at 3.35 TB/s; the input is 1.208 GB at 512 steps: 0.721 ms
// for a full-size output, 0.541 ms for rows_reshape_max, 0.361 ms for
// rows_strided_slice (half the input, half the output), 0.407 ms for the
// unaligned body (98 input lanes a row, 768 output lanes); the product's
// 25.8 G multiply-adds at the f32 FMA peak, 0.769 ms, over its bytes.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

namespace {

constexpr int R = 768, L = 768, L4 = L / 4;
constexpr int THREADS = 256, ROW_BLOCKS = 8;
constexpr int MM_K = 512, MM_N = 128;  // the product's contraction, width

enum Body {
  COPY = 0, ROWS_RESHAPE_MAX = 1, LANES_ROLL_MAX = 2, ROWS_ROLL_MAX = 3,
  ROWS_STRIDED = 4, TRANSPOSE = 5, UNALIGNED = 6, ALIGNED = 7, MATMUL = 8
};

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// the bodies that move elements: grid (ROW_BLOCKS, steps), one thread a
// float4 of an output row (192 threads), each block walking every
// ROW_BLOCKS-th output row of its step
template <int BODY>
__global__ void __launch_bounds__(L4)
move_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  constexpr int OUT_ROWS =
      BODY == ROWS_RESHAPE_MAX || BODY == ROWS_STRIDED ? R / 2 : R;
  const int c4 = threadIdx.x;
  const float4* xs = x + (size_t)blockIdx.y * R * L4;
  float4* os = o + (size_t)blockIdx.y * OUT_ROWS * L4;
  for (int i = blockIdx.x; i < OUT_ROWS; i += gridDim.x) {
    const int at = i * L4 + c4;
    if constexpr (BODY == COPY || BODY == ALIGNED) {
      os[at] = xs[at];
    } else if constexpr (BODY == ROWS_RESHAPE_MAX) {
      os[at] = max4(xs[2 * i * L4 + c4], xs[(2 * i + 1) * L4 + c4]);
    } else if constexpr (BODY == ROWS_STRIDED) {
      os[at] = xs[2 * i * L4 + c4];
    } else if constexpr (BODY == LANES_ROLL_MAX) {
      os[at] = max4(xs[at], xs[i * L4 + (c4 + 2) % L4]);  // lane j + 8
    } else if constexpr (BODY == ROWS_ROLL_MAX) {
      os[at] = max4(xs[at], xs[((i + 1) % R) * L4 + c4]);
    } else if constexpr (BODY == UNALIGNED) {
      const int j = c4 / 32, off = 4 * (c4 % 32);  // lane off of slice j
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off < 18) {
        v = xs[i * L4 + 4 * j + off / 4];          // lanes 16j + off ...
        if (off + 2 >= 18) v.z = v.w = 0.f;        // the ragged end: 16, 17
      }
      os[at] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
transpose_kernel(const float* __restrict__ x, float* __restrict__ o) {
  __shared__ float t[32][33];
  const size_t base = (size_t)blockIdx.z * R * L;
  const int x0 = blockIdx.x * 32, y0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 32 x 8
  for (int j = ty; j < 32; j += THREADS / 32)
    t[j][tx] = x[base + (size_t)(y0 + j) * L + x0 + tx];
  __syncthreads();
  for (int j = ty; j < 32; j += THREADS / 32)
    o[base + (size_t)(x0 + j) * L + y0 + tx] = t[tx][j];
}

// grid (2, 12, steps): block (nt, mt) computes the 64 x 64 product tile
// (mt, nt) and copies rows [64 mt, 64 mt + 64) of its half of lanes 128..767
__global__ void __launch_bounds__(sgemm::THREADS)
matmul_kernel(const float* __restrict__ x, float* __restrict__ o) {
  __shared__ __align__(16) sgemm::Smem s;
  const size_t base = (size_t)blockIdx.z * R * L;
  const int n0 = blockIdx.x * sgemm::BN, m0 = blockIdx.y * sgemm::BM;
  float acc[4][4] = {};
  sgemm::tile(acc, x + base, L, x + base, L, R, MM_N, MM_K, m0, n0, 0, s);
  sgemm::store(acc, o + base, L, R, MM_N, m0, n0);
  constexpr int HALF4 = (L - MM_N) / 4 / 2;  // 80 float4 a row a block
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  float4* o4 = reinterpret_cast<float4*>(o + base);
  for (int e = threadIdx.x; e < sgemm::BM * HALF4; e += sgemm::THREADS) {
    const int r = m0 + e / HALF4;
    const int c4 = MM_N / 4 + blockIdx.x * HALF4 + e % HALF4;
    o4[(size_t)r * L4 + c4] = x4[(size_t)r * L4 + c4];
  }
}

template <int BODY>
int launch_move(const void* x, void* o, int steps, cudaStream_t s) {
  move_kernel<BODY><<<dim3(ROW_BLOCKS, steps), L4, 0, s>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (steps * 768, 768) f32, 16-byte aligned; o: (steps * 384, 768) for
// bodies 1 and 4, else (steps * 768, 768) f32. body: 0-8 as listed above.
// Returns the cudaError_t of the launch.
extern "C" int layout_micro(const void* x, void* o, int steps, int body,
                            void* stream) {
  if (steps < 0 || steps > 65535 || body < COPY || body > MATMUL)
    return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case COPY: return launch_move<COPY>(x, o, steps, s);
    case ROWS_RESHAPE_MAX:
      return launch_move<ROWS_RESHAPE_MAX>(x, o, steps, s);
    case LANES_ROLL_MAX: return launch_move<LANES_ROLL_MAX>(x, o, steps, s);
    case ROWS_ROLL_MAX: return launch_move<ROWS_ROLL_MAX>(x, o, steps, s);
    case ROWS_STRIDED: return launch_move<ROWS_STRIDED>(x, o, steps, s);
    case UNALIGNED: return launch_move<UNALIGNED>(x, o, steps, s);
    case ALIGNED: return launch_move<ALIGNED>(x, o, steps, s);
    case TRANSPOSE:
      transpose_kernel<<<dim3(L / 32, R / 32, steps), THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(o));
      return (int)cudaGetLastError();
    default:
      matmul_kernel<<<dim3(MM_N / sgemm::BN, R / sgemm::BM, steps),
                      sgemm::THREADS, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<float*>(o));
      return (int)cudaGetLastError();
  }
}
