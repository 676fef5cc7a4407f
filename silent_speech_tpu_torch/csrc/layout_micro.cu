// Layout micro-kernels for Hopper (sm_90a): the nine bodies of
// scripts/mosaic_micro.py::main (:69-113), each over `steps` (768, 768) f32
// blocks of x ((steps * 768, 768), row-major), one instantiation a body.
//
// Replaces scripts/mosaic_micro.py::_mk (:26, its pallas_call at :34):
// there one grid step holds a (768, 768) block (2.36 MB) in VMEM. Here a
// block of 2.36 MB fits no SM's shared memory, so the bodies that move
// elements (all but the transpose and the product) stream 16-byte vectors
// through registers (below), with the row and lane arithmetic of the body
// in the index; the transpose goes through a (32 x 33) padded
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
// The element-moving bodies keep the memory system busy, each through
// one route (layout_micro_plan names it):
// - the TMA route (bulk_kernel: copy, aligned_128lane_x6,
//   rows_strided_slice and rows_reshape_max): persistent blocks, as many as
//   the card holds at once (the SM count times the kernel's occupancy,
//   layout_micro_plan), each keep a ring of four shared-memory stages
//   filled by bulk copies (cp.async.bulk) two units ahead, one thread
//   issuing them; a unit is 8 output rows (rows_strided_slice: 8 row
//   copies; rows_reshape_max: its 16 input rows, their row-pair max
//   written back in place by the block's threads), stored by one bulk copy
//   from the stage;
// - the register route (move_kernel: lanes_roll_max and
//   unaligned_18lane_x6): persistent blocks, as many as the card holds at
//   once, walk units of 8 x 256 output float4s (a unit lies inside one
//   step; consecutive threads on consecutive float4s of a row). A thread
//   issues all its loads of a unit (twice as many for lanes_roll_max)
//   before its first store, and the next unit's loads before this unit's
//   stores;
// - rows_roll_max walks down columns (walk_kernel): a thread holds one
//   float4 column of 8 rows and the next, so each input row is loaded
//   once, not twice.
// Each route's blocks take units in turn (block b: b, b + gridDim.x, ...),
// so no partial last wave of blocks is left: the blocks' last sweep
// differs by at most one unit.
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

#include <stdint.h>

#include <algorithm>

#include "tc_mainloop.cuh"

namespace {

constexpr int R = 768, L = 768, L4 = L / 4;
constexpr int THREADS = 256;
constexpr int MM_K = 512, MM_N = 128;  // the product's contraction, width

enum Body {
  COPY = 0, ROWS_RESHAPE_MAX = 1, LANES_ROLL_MAX = 2, ROWS_ROLL_MAX = 3,
  ROWS_STRIDED = 4, TRANSPOSE = 5, UNALIGNED = 6, ALIGNED = 7, MATMUL = 8
};

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// the bodies that move elements (the file's note): a unit of the register
// route is UNROLL x MOVE_THREADS output float4s of one step
constexpr int MOVE_THREADS = 256, UNROLL = 8;

template <int BODY>
__host__ __device__ constexpr int out_rows() {
  return BODY == ROWS_RESHAPE_MAX || BODY == ROWS_STRIDED ? R / 2 : R;
}
template <int BODY>
__host__ __device__ constexpr int units_per_step() {
  return out_rows<BODY>() * L4 / (UNROLL * MOVE_THREADS);
}

// unit u's operands into v (and w, lanes_roll_max's second operands)
template <int BODY>
__device__ __forceinline__ void load_unit(const float4* __restrict__ x, int u,
                                          float4 (&v)[UNROLL],
                                          float4 (&w)[UNROLL]) {
  constexpr int UNITS = units_per_step<BODY>();
  const int step = u / UNITS;
  const int first = (u % UNITS) * UNROLL * MOVE_THREADS + threadIdx.x;
  const float4* xs = x + (size_t)step * R * L4;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int e = first + k * MOVE_THREADS, i = e / L4, c4 = e % L4;
    if constexpr (BODY == LANES_ROLL_MAX) {
      v[k] = xs[e];
      w[k] = xs[i * L4 + (c4 + 2) % L4];  // lane j + 8
    } else {  // UNALIGNED
      const int j = c4 / 32, off = 4 * (c4 % 32);  // lane off of slice j
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off < 18) {
        v[k] = xs[i * L4 + 4 * j + off / 4];  // 16j + off
        if (off + 2 >= 18) v[k].z = v[k].w = 0.f;  // the ragged end
      }
    }
  }
}

template <int BODY>
__device__ __forceinline__ void store_unit(float4* __restrict__ o, int u,
                                           const float4 (&v)[UNROLL],
                                           const float4 (&w)[UNROLL]) {
  constexpr int UNITS = units_per_step<BODY>();
  float4* os = o + (size_t)(u / UNITS) * out_rows<BODY>() * L4 +
               (u % UNITS) * UNROLL * MOVE_THREADS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    os[k * MOVE_THREADS] = BODY == LANES_ROLL_MAX ? max4(v[k], w[k]) : v[k];
}

// the register route: block b walks units b, b + gridDim.x, ...; the next
// unit's loads are issued before this unit's stores
template <int BODY>
__global__ void __launch_bounds__(MOVE_THREADS)
move_kernel(const float4* __restrict__ x, float4* __restrict__ o,
            int units) {
  static_assert(BODY == LANES_ROLL_MAX || BODY == UNALIGNED,
                "the register route's bodies");
  static_assert(units_per_step<BODY>() * UNROLL * MOVE_THREADS ==
                    out_rows<BODY>() * L4,
                "whole units in a step");
  int u = blockIdx.x;
  if (u >= units) return;
  float4 v[UNROLL], w[UNROLL];
  load_unit<BODY>(x, u, v, w);
  for (;;) {
    const int next = u + gridDim.x;
    float4 nv[UNROLL], nw[UNROLL];
    if (next < units) load_unit<BODY>(x, next, nv, nw);
    store_unit<BODY>(o, u, v, w);
    if (next >= units) break;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      v[k] = nv[k];
      w[k] = nw[k];
    }
    u = next;
  }
}

// the TMA route (the file's note): units of ROWS output rows; a stage
// holds a unit's input rows (twice ROWS rows of 3,072 bytes for
// rows_reshape_max), a ring of RING bytes of stages, loads issued
// STAGES - 2 units ahead
constexpr int ROW_BYTES = L * 4, BULK_ROWS = 8;
template <int BODY>
__host__ __device__ constexpr int bulk_ring() {  // four stages
  return (BODY == ROWS_RESHAPE_MAX ? 192 : 96) * 1024;
}
template <int BODY, int ROWS>
__host__ __device__ constexpr int bulk_stage() {
  return (BODY == ROWS_RESHAPE_MAX ? 2 : 1) * ROWS * ROW_BYTES;
}
template <int BODY>
__host__ __device__ constexpr int bulk_threads() {
  return BODY == ROWS_RESHAPE_MAX ? 128 : 32;
}
template <int BODY, int ROWS, int RING>
__host__ __device__ constexpr int bulk_smem() {
  return RING + 8 * (RING / bulk_stage<BODY, ROWS>());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// `bytes` from global to shared memory, completing on the barrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` from shared to global memory, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(src), "r"(bytes)
      : "memory");
}
// at most N of this thread's bulk stores still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int BODY, int ROWS, int RING>
__global__ void __launch_bounds__(128)
bulk_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ o,
            int units) {
  constexpr int STAGE = bulk_stage<BODY, ROWS>(), STAGES = RING / STAGE;
  constexpr int UNITS = out_rows<BODY>() / ROWS;  // a step's
  constexpr int OUT = ROWS * ROW_BYTES;            // a unit's output
  static_assert(UNITS * ROWS == out_rows<BODY>() && STAGES >= 3,
                "whole units, a ring of 3");
  extern __shared__ __align__(128) uint8_t bulk_ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(bulk_ring + RING);
  const int tid = threadIdx.x;
  const int count = (units - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (count <= 0) return;
  if constexpr (BODY != ROWS_RESHAPE_MAX) {  // one thread moves the bytes
    if (tid) return;
  }
  auto unit = [&](int k, int& step, int& r0) {
    const int u = blockIdx.x + k * gridDim.x;
    step = u / UNITS;
    r0 = (u % UNITS) * ROWS;
  };
  auto issue = [&](int k) {  // unit k's input rows into stage k % STAGES
    int step, r0;
    unit(k, step, r0);
    const uint8_t* xs = x + (size_t)step * R * ROW_BYTES;
    const uint32_t st = smem_addr(bulk_ring + (k % STAGES) * STAGE);
    const uint32_t bar = smem_addr(full + k % STAGES);
    mbar_expect(bar, STAGE);
    if constexpr (BODY == ROWS_STRIDED) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        bulk_load(st + r * ROW_BYTES, xs + (size_t)2 * (r0 + r) * ROW_BYTES,
                  ROW_BYTES, bar);
    } else {
      const int in0 = BODY == ROWS_RESHAPE_MAX ? 2 * r0 : r0;
      bulk_load(st, xs + (size_t)in0 * ROW_BYTES, STAGE, bar);
    }
  };
  if (tid == 0)
    for (int k = 0; k < STAGES - 2 && k < count; ++k) issue(k);
  for (int k = 0; k < count; ++k) {
    const int s = k % STAGES;
    if (tid == 0) {
      bulk_wait_read<1>();  // unit k - 2's store has read its stage
      if (k + STAGES - 2 < count) issue(k + STAGES - 2);
    }
    mbar_wait(smem_addr(full + s), (k / STAGES) & 1);
    uint8_t* st = bulk_ring + s * STAGE;
    if constexpr (BODY == ROWS_RESHAPE_MAX) {  // rows 2r, 2r + 1 -> row r
      constexpr int PER = ROWS * L4 / 128;
      float4* st4 = reinterpret_cast<float4*>(st);
      float4 a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = tid + i * 128, r = e / L4, c4 = e % L4;
        a[i] = st4[2 * r * L4 + c4];
        b[i] = st4[(2 * r + 1) * L4 + c4];
      }
      __syncthreads();  // every read is done before a row is overwritten
#pragma unroll
      for (int i = 0; i < PER; ++i) st4[tid + i * 128] = max4(a[i], b[i]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (tid == 0) {
      int step, r0;
      unit(k, step, r0);
      bulk_store(o + ((size_t)step * out_rows<BODY>() + r0) * ROW_BYTES,
                 smem_addr(st), OUT);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// rows_roll_max walking down a column: a unit is RB rows of a step, a
// thread one float4 column c4; rows i0 .. i0 + RB (the last mod 768) loaded
// once each, RB outputs, the max of each row and the next
constexpr int RB = 8;
__global__ void __launch_bounds__(L4)
walk_kernel(const float4* __restrict__ x, float4* __restrict__ o, int units) {
  const int c4 = threadIdx.x;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int step = u / (R / RB), i0 = (u % (R / RB)) * RB;
    const float4* xs = x + (size_t)step * R * L4 + c4;
    float4* os = o + (size_t)step * R * L4 + (size_t)i0 * L4 + c4;
    float4 v[RB + 1];
#pragma unroll
    for (int r = 0; r <= RB; ++r) v[r] = xs[((i0 + r) % R) * L4];
#pragma unroll
    for (int r = 0; r < RB; ++r) os[r * L4] = max4(v[r], v[r + 1]);
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

// a moving body's route (the file's note; Python's
// cuda_layout_micro.MOVE_ROUTES, in this order)
enum Route { kBulk = 0, kRegisters = 1, kWalk = 2 };
inline int route_of(int body) {
  return body == LANES_ROLL_MAX || body == UNALIGNED ? kRegisters
         : body == ROWS_ROLL_MAX                    ? kWalk
                                                    : kBulk;
}

// the card's SMs
inline int sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// launch (out == nullptr) or plan (out: blocks, units, threads) a kernel
// of `threads` and `smem` bytes over `units`: as many blocks as the card
// holds at once, at most one a unit
template <typename Kernel, typename... A>
int run(Kernel kernel, int threads, int smem, int units, int* out,
        cudaStream_t s, A... args) {
  int sms = 0, occ = 0;
  int e = sm_count(sms);
  if (e) return e;
  if (smem > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e) return e;
  }
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                         threads, smem);
  if (e) return e;
  const int blocks = std::min(units, std::max(1, sms * occ));
  if (out) {
    out[0] = blocks;
    out[1] = units;
    out[2] = threads;
    return 0;
  }
  kernel<<<blocks, threads, smem, s>>>(args..., units);
  return (int)cudaGetLastError();
}

template <int BODY>
int run_bulk(const void* x, void* o, int steps, int* out, cudaStream_t s) {
  constexpr int RING = bulk_ring<BODY>();
  return run(bulk_kernel<BODY, BULK_ROWS, RING>, bulk_threads<BODY>(),
             bulk_smem<BODY, BULK_ROWS, RING>(),
             steps * (out_rows<BODY>() / BULK_ROWS), out, s,
             static_cast<const uint8_t*>(x), static_cast<uint8_t*>(o));
}
template <int BODY>
int run_reg(const void* x, void* o, int steps, int* out, cudaStream_t s) {
  return run(move_kernel<BODY>, MOVE_THREADS, 0,
             steps * units_per_step<BODY>(), out, s,
             static_cast<const float4*>(x), static_cast<float4*>(o));
}

// launch (out == nullptr) or plan a moving body on its route
int move_body(const void* x, void* o, int steps, int body, int* out,
              cudaStream_t s) {
  switch (body) {
    case COPY: return run_bulk<COPY>(x, o, steps, out, s);
    case ROWS_RESHAPE_MAX:
      return run_bulk<ROWS_RESHAPE_MAX>(x, o, steps, out, s);
    case ROWS_STRIDED: return run_bulk<ROWS_STRIDED>(x, o, steps, out, s);
    case ALIGNED: return run_bulk<ALIGNED>(x, o, steps, out, s);
    case LANES_ROLL_MAX: return run_reg<LANES_ROLL_MAX>(x, o, steps, out, s);
    case UNALIGNED: return run_reg<UNALIGNED>(x, o, steps, out, s);
    case ROWS_ROLL_MAX:
      return run(walk_kernel, L4, 0, steps * (R / RB), out, s,
                 static_cast<const float4*>(x), static_cast<float4*>(o));
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (body != TRANSPOSE && body != MATMUL)
    return move_body(x, o, steps, body, nullptr, s);
  if (body == TRANSPOSE) {
    transpose_kernel<<<dim3(L / 32, R / 32, steps), THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(o));
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks, one an SM (the ring takes 140 KB), at most one an
  // item; each item's output is its own, so the count moves no result
  int sms = 0;
  const int e = sm_count(sms);
  if (e) return e;
  const int items = steps * MM_TILES;
  matmul_kernel<<<std::min(items, sms), tc::THREADS, MM_SMEM, s>>>(
      static_cast<const float*>(x), static_cast<float*>(o), items);
  return (int)cudaGetLastError();
}

// A moving body's launch at `steps`: out[0..3] = blocks, units, threads,
// its route (Route). Returns a cudaError_t.
extern "C" int layout_micro_plan(int steps, int body, int* out) {
  if (steps < 1 || steps > 65535 || body == TRANSPOSE || body < COPY ||
      body >= MATMUL)
    return (int)cudaErrorInvalidValue;
  out[3] = route_of(body);
  return move_body(nullptr, nullptr, steps, body, out, nullptr);
}
