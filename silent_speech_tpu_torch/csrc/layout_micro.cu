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
// shared-memory tile; the product runs as 3xTF32 on the tensor cores
// (below). The bodies, with their output a block:
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
//   8 matmul_768x512x128    o[:, :128] = v[:, :512] @ v[:512, :128],
//                           o[:, 128:] = v[:, 128:]
// "Aligned" on this card means 16-byte vector accesses (4 lanes), not the
// TPU's 128-lane vregs: the 18-lane slices start on 16-lane boundaries,
// so each is four aligned float4 loads and a ragged 2-lane end (72 bytes),
// and the 128-lane slices are plain aligned copies.
//
// What bounds them: the bytes, each input read once and each output
// written once, at 3.35 TB/s; the input is 1.208 GB at 512 steps: 0.721 ms
// for a full-size output (the product body's too: its 25.8 G multiply-adds
// take 0.222 ms at the f32 FMAs and 3xTF32 together, 232 TFLOP/s), 0.541
// ms for rows_reshape_max, 0.361 ms for rows_strided_slice (half the
// input, half the output), 0.407 ms for the unaligned body (98 input lanes
// a row, 768 output lanes).
//
// The product body: A = v[:, :512] holds the contraction on its fast axis
// and B = v[:512, :128] on its slow one, bwd_dots.cu's nn layout, so it
// runs that mainloop (tc_mainloop.cuh: 3xTF32 on m16n8k8 mma.sync, each
// fragment split hi / lo in registers as it is loaded, a ring of 4
// cp.async stages of 32 contraction rows; B changes every step, so no
// split planes could be packed once for wgmma). Persistent blocks, one an
// SM, walk the items (step, 128-row tile of the 768 rows): 6 a step, 3,072
// at 512 steps, each one 128 x 128 output tile over K = 512 in 16 chunks,
// a chunk's MMAs from zero and the chunks' sums added in f32, written to
// o[:, :128] at its end (no sum across items). The copy rides in the same
// item, so that each input byte is read once: the A chunks of lanes
// 128..511 are in shared memory for the MMAs and are stored to o from
// there, and lanes 512..767 of the item's rows are copied beside the
// mainloop, 2 float4 a thread a chunk, loaded before the chunk's MMAs and
// stored after them.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc_mainloop.cuh"

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

// the product body's kernel (the file's note): block b walks the items
// i = b, b + gridDim.x, ... (step i / 6, rows (i % 6) 128 of the step), as
// one stream of 16 chunks an item through the ring
constexpr int MM_TILES = R / tc::BM, MM_CHUNKS = MM_K / tc::BK;
constexpr int MM_SMEM = tc::Ring<kNN>::TOTAL * 4;
constexpr int HIGH4 = (L - MM_K) / 4;  // lanes 512..767: 64 float4 a row
constexpr int COPY4 = tc::BM * HIGH4 / MM_CHUNKS / tc::THREADS;
static_assert(R % tc::BM == 0 && MM_K % tc::BK == 0 && MM_N == tc::BN &&
                  MM_N % tc::BK == 0 &&
                  COPY4 * tc::THREADS * MM_CHUNKS == tc::BM * HIGH4,
              "whole tiles, chunks and copies");

// item j of this block: the offset of its step's block in x (and o) and
// its first row there
__device__ __forceinline__ void item_rows(int j, size_t& base, int& r0) {
  const int i = blockIdx.x + j * gridDim.x;
  base = (size_t)(i / MM_TILES) * R * L;
  r0 = (i % MM_TILES) * tc::BM;
}

__global__ void __launch_bounds__(tc::THREADS, 1)
matmul_kernel(const float* __restrict__ x, float* __restrict__ o,
              int items) {
  using Rg = tc::Ring<kNN>;
  using tc::BK;
  using tc::BM;
  extern __shared__ __align__(16) float ring[];
  const int mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int count = mine * MM_CHUNKS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % tc::WARPS_M, wn = warp / tc::WARPS_M;
  auto fetch = [&](int t) {  // chunk t % 16 of item t / 16
    size_t base;
    int r0;
    item_rows(t / MM_CHUNKS, base, r0);
    tc::load_chunk<kNN, 4>(ring + (t % Rg::DEPTH) * Rg::STAGE, x + base, L,
                           x + base, L, (t % MM_CHUNKS) * BK, MM_K, r0, R, 0,
                           MM_N);
  };
#pragma unroll
  for (int t = 0; t < Rg::DEPTH - 1; ++t) {
    if (t < count) fetch(t);
    cp_async_commit();
  }
  float chunk_acc[tc::MT][tc::NT][4] = {}, tile_acc[tc::MT][tc::NT][4] = {};
  for (int t = 0; t < count; ++t) {
    const int k = t % MM_CHUNKS;
    size_t base;
    int r0;
    item_rows(t / MM_CHUNKS, base, r0);
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4* o4 = reinterpret_cast<float4*>(o + base);
    float4 high[COPY4];  // this chunk's share of lanes 512..767
    size_t at[COPY4];
#pragma unroll
    for (int c = 0; c < COPY4; ++c) {
      const int e = (k * COPY4 + c) * tc::THREADS + threadIdx.x;
      at[c] = (size_t)(r0 + e / HIGH4) * L4 + MM_K / 4 + e % HIGH4;
      high[c] = __ldcs(x4 + at[c]);
    }
    cp_async_wait<Rg::DEPTH - 2>();  // chunk t has landed, for this thread
    __syncthreads();  // ... for all; chunk t - 1's stage is read
    if (t + Rg::DEPTH - 1 < count) fetch(t + Rg::DEPTH - 1);
    cp_async_commit();
    const float* stage = ring + (t % Rg::DEPTH) * Rg::STAGE;
    tc::mma_chunk<kNN, tc::kAll>(chunk_acc, stage, stage + Rg::A_FLOATS, wm,
                                 wn, tc::MT);
    tc::add_chunk(tile_acc, chunk_acc);
#pragma unroll
    for (int c = 0; c < COPY4; ++c) __stcs(o4 + at[c], high[c]);
    if (k * BK >= MM_N) {  // lanes 128..511: the A chunk, from the stage
#pragma unroll
      for (int c = 0; c < BM * BK / 4 / tc::THREADS; ++c) {
        const int e = c * tc::THREADS + threadIdx.x;
        const int r = e / (BK / 4), c4 = e % (BK / 4);
        __stcs(o4 + (size_t)(r0 + r) * L4 + k * (BK / 4) + c4,
               *reinterpret_cast<const float4*>(stage + r * Rg::A_LD +
                                                4 * c4));
      }
    }
    if (k < MM_CHUNKS - 1) continue;
#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)  // the item's tile, to o[:, :128]
#pragma unroll
      for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + wm * tc::WM + mt * 16 + (lane >> 2) + 8 * hf;
          const int c = wn * tc::WN + nt * 8 + 2 * (lane & 3);
          __stcs(reinterpret_cast<float2*>(o + base + (size_t)r * L + c),
                 make_float2(tile_acc[mt][nt][2 * hf],
                             tile_acc[mt][nt][2 * hf + 1]));
          tile_acc[mt][nt][2 * hf] = tile_acc[mt][nt][2 * hf + 1] = 0.f;
        }
  }
  cp_async_wait_all();
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
    default: {
      const cudaError_t err = cudaFuncSetAttribute(
          matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MM_SMEM);
      if (err != cudaSuccess) return (int)err;
      // persistent blocks, one an SM (the ring takes 140 KB), at most one an
      // item; each item's output is its own, so the count moves no result
      int dev = 0, sms = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      const int items = steps * MM_TILES;
      matmul_kernel<<<std::min(items, sms), tc::THREADS, MM_SMEM, s>>>(
          static_cast<const float*>(x), static_cast<float*>(o), items);
      return (int)cudaGetLastError();
    }
  }
}
