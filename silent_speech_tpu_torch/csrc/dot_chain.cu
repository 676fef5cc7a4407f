// Chained-dot rate probe for Hopper (sm_90a): for each of `steps` grid
// steps, a seed from the sum of the step's (8, 128) uint8 block, then a
// serial chain of DEPTH = 14 products y <- y W, y (384, K), W (K, K),
// K in {384, 512}, and one f32 value, the sum of y[0, 0:128], written over
// the step's (8, 128) output block.
//
// Replaces scripts/probe_int8.py::_kernel (:57, built by ::build, the
// pallas_call at :97). Modes, as there:
//   f32    y0 = f32(seed) * 1e-6; y <- y W in f32 (FMAs on the CUDA cores)
//   bf16   y0 = bf16(f32(seed) * 1e-6); y <- bf16(y W), each product's f32
//          sum rounded to bf16 (wgmma m64nNk16 bf16 -> f32)
//   int8   y0 = s8(seed & 63); y <- s8(acc >> 7), acc = y W in s32 (mma.sync
//          m16n8k32 s8 -> s32), the arithmetic shift then a wrap modulo 256
//          as XLA's convert does (not a saturation)
//   int8i  acc = sum over d < 14 of (base + d) W in s32, base = s8(seed & 63):
//          14 independent s8 products, no re-narrowing
// The int modes' output sum is taken exactly (int64) and rounded once to
// f32. The TPU kernel's W is a VMEM scratch that is never written, so its
// output is undefined; this kernel takes W as an input.
//
// The TPU kernel keeps the whole (384, K) chain state in VMEM (576-768 KB
// in f32), more than a block's 227 KB of shared memory. y <- y W acts row
// by row, so here a block owns a tile of TM = 64 rows of one step through
// all 14 products, in shared memory, and streams W from L2 in chunks:
// every row of every step is still computed, 6 blocks a step.
//
// What bounds it: the multiply-adds, steps * 14 * 384 * K^2 (203 G at
// K=384, 361 G at K=512 for 256 steps): 6.06 / 10.77 ms at the f32 FMA
// peak, 0.41 / 0.73 ms bf16, 0.205 / 0.365 ms int8. A block re-reads the
// whole of W for every product (64 rows a pass): at the bf16 peak one SM
// would draw 117 GB/s of W from L2, 15.5 TB/s for 132 SMs.
//
// f32, int8, int8i: all 256 threads stage each W chunk (rows of W, or of
// W^T for the s8 MMAs, so that a B fragment's k-quads are one 32-bit
// word) synchronously, then multiply it (FMAs; mma.sync m16n8k32 s8).
//
// bf16 (namespace chain16): the blocks of a step form clusters of C (1,
// 2, 3 or 6, dividing the 6 tiles; dot_chain_plan takes the largest whose
// clusters the card runs on 15/16 of its SMs) that share each W chunk: a
// chunk is 64 k-columns of W^T for one half of the n (24 KB at K=384, 32
// KB at K=512), packed contiguous in wgmma's 128-byte swizzle
// (ops/cuda_dot_chain.pack_weights), and each block's copy warp brings its
// 1/C of the chunk's rows from L2 into the same stage of every block of
// the cluster by one TMA bulk copy (cp.async.bulk ... multicast::cluster),
// so L2 serves W once a cluster: a ring of 7 (K=384) or 5 (K=512) stages
// beside y, each with a full mbarrier (the chunk's bytes) and an empty one
// (the 4 warps of that half's warpgroup in each of the C blocks arrive,
// across the cluster), so that the copies run up to a ring ahead of the
// MMAs, across products. Two warpgroups each take all 64 rows by one half
// of the n: one wgmma m64n(K/2)k16 bf16 a k16 step, A (y) and B (the
// chunk) read from shared memory in the 128-byte swizzle (y: 64 rows x 128
// bytes an atom of 64 k), f32 sums in k order, a stage freed once the next
// chunk's wgmmas are in flight. After a product the warpgroups round their
// sums to bf16 into y between two barriers of their own, then fence y's
// writes for the wgmmas' reads. Repeated calls, and every cluster size,
// give the same bits. What it does not hide is each product's tail: the
// rounding of y between two barriers, which no wgmma overlaps (not timed
// apart; PERF.md gives its times). Its CPU tests are the geometry
// and the chunk layout (tests/test_torch_dot_chain_bf16.py) and the
// chain's arithmetic against the Pallas kernel
// (tests/test_torch_rate_probes.py).

// A check instantiation (moments != nullptr) also writes the three moments
// of each block's final y values (the sum, the sum of squares and the sum
// weighted by i % 31, i = row * K + col in the step's (384, K) y): doubles
// for f32 / bf16, int64 sums modulo 2^64 for the int modes (exact, so any
// order gives the same bits), one triple a (step, tile). In bf16 it also
// writes the trace: row 13 * tile % 64 of the block's tile after each of
// the 14 products, the bf16 values the next product reads, so that each
// product's rounding can be held against the product of the block's own
// previous row. The moments cannot tell that: a chain that keeps y in f32
// ends about as far from the plain version as two sound chains whose f32
// sums once round a value to its other bf16 neighbour.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int M = 384, DEPTH = 14, XBLOCK = 8 * 128;
constexpr int TM = 64, TILES = M / TM;
constexpr int THREADS = 256, NWARPS = THREADS / 32;
constexpr int POS_PERIOD = 31, ROW0 = 128;
constexpr int TRACE_STRIDE = 13;  // the traced row of tile t: 13 t % TM

enum Mode { F32 = 0, BF16 = 1, INT8 = 2, INT8I = 3 };

// shared-memory geometry of a mode: the y tile (TM rows, stride YS
// elements) and one chunk of W (f32: BK k-rows of K, k-major; MMA modes: K
// n-rows of BK, stride WSS, n-major)
template <int MODE, int K> struct Geo {
  static constexpr bool MMA = MODE != F32;
  static constexpr int ESIZE = MODE == F32 ? 4 : MODE == BF16 ? 2 : 1;
  static constexpr int YS = K + 16 / ESIZE;             // 16 bytes of pad
  static constexpr int BK = MODE == F32 ? 16 : MODE == BF16 ? 32 : 64;
  static constexpr int WSS = MMA ? BK + 16 / ESIZE : K;  // 16 bytes of pad
  static constexpr int Y_BYTES = TM * YS * ESIZE;
  static constexpr int W_BYTES = (MMA ? K * WSS : BK * K) * ESIZE;
  static constexpr int SMEM = Y_BYTES + W_BYTES;
  static_assert(K % 128 == 0 && K % BK == 0, "K a multiple of 128");
  static_assert(Y_BYTES % 16 == 0, "W chunk 16-byte aligned");
};

__device__ __forceinline__ void mma_s8(int& d0, int& d1, int& d2, int& d3,
                                       const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sum over the block, returned to every thread; red holds NWARPS + 1
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int w = 0; w < NWARPS; ++w) s += red[w];
    red[NWARPS] = s;
  }
  __syncthreads();
  const T s = red[NWARPS];
  __syncthreads();
  return s;
}

// copy rows [k0, k0 + BK) of W (f32, k-major) or columns [k0, k0 + BK) of
// W^T (MMA modes, n-major) into the chunk buffer, 16 bytes a thread a step
template <int MODE, int K>
__device__ void stage_w(const uint8_t* __restrict__ w, uint8_t* ws, int k0) {
  using G = Geo<MODE, K>;
  if constexpr (!G::MMA) {
    const uint4* src = reinterpret_cast<const uint4*>(w + (size_t)k0 * K * 4);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = threadIdx.x; i < G::BK * K / 4; i += THREADS) dst[i] = src[i];
  } else {
    constexpr int VEC = G::BK * G::ESIZE / 16;  // 16-byte pieces an n-row
    for (int i = threadIdx.x; i < K * VEC; i += THREADS) {
      const int n = i / VEC, v = i % VEC;
      const uint4 q = *reinterpret_cast<const uint4*>(
          w + ((size_t)n * K + k0) * G::ESIZE + v * 16);
      *reinterpret_cast<uint4*>(ws + (n * G::WSS) * G::ESIZE + v * 16) = q;
    }
  }
}

template <int MODE, int K, bool CHECK>
__global__ void __launch_bounds__(THREADS, 1)
dot_chain_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 float* __restrict__ out, void* __restrict__ moments,
                 __nv_bfloat16* __restrict__ trace, float* __restrict__ sink,
                 int sink_at) {
  using G = Geo<MODE, K>;
  constexpr bool INTS = MODE == INT8 || MODE == INT8I;
  using Acc = typename std::conditional<INTS, int, float>::type;
  using Mom = typename std::conditional<INTS, unsigned long long,
                                        double>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ys = smem;                  // the y tile
  uint8_t* ws = smem + G::Y_BYTES;     // one chunk of W
  __shared__ Acc row0[ROW0];           // y[0, 0:128] (tile 0)
  __shared__ int redi[NWARPS + 1];
  __shared__ Mom redm[NWARPS + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, step = blockIdx.y;

  // ---- the seed: the sum of the step's 1,024 bytes, in s32
  const uint32_t word =
      reinterpret_cast<const uint32_t*>(x + (size_t)step * XBLOCK)[tid];
  const int seed = block_sum<int>(
      (int)((word & 0xffu) + ((word >> 8) & 0xffu) + ((word >> 16) & 0xffu) +
            (word >> 24)), redi);

  // ---- y0, all TM x K elements of the tile equal
  if constexpr (MODE == F32) {
    const float y0 = (float)seed * 1e-6f;
    for (int i = tid; i < TM * G::YS; i += THREADS)
      reinterpret_cast<float*>(ys)[i] = y0;
  } else if constexpr (MODE == INT8) {
    for (int i = tid; i < TM * G::YS; i += THREADS)
      ys[i] = (uint8_t)(seed & 63);
  }

  // per-thread outputs: f32, 8 rows x (K / 128) float4 columns; MMA modes,
  // 4 m16 tiles x NT n8 tiles x 4 values
  constexpr int NJ = K / 128;                   // f32 layout
  constexpr int KW = K / NWARPS, NT = KW / 8;   // MMA layout: a warp's cols
  constexpr int NACC = G::MMA ? 4 * NT * 4 : 8 * NJ * 4;
  Acc acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  const int g = lane >> 2, t = lane & 3;

  // (row, col) of accumulator i in the tile
  auto row_of = [&](int i) -> int {
    if constexpr (G::MMA)
      return (i / (NT * 4)) * 16 + g + ((i & 3) >= 2 ? 8 : 0);
    else
      return warp * 8 + i / (NJ * 4);
  };
  auto col_of = [&](int i) -> int {
    if constexpr (G::MMA)
      return warp * KW + ((i / 4) % NT) * 8 + 2 * t + (i & 1);
    else
      return ((i / 4) % NJ) * 128 + 4 * lane + (i & 3);
  };

  for (int d = 0; d < DEPTH; ++d) {
    if constexpr (MODE == INT8I) {  // this product's A: base + d, in s8
      __syncthreads();  // the previous product's reads of ys are done
      const uint8_t v = (uint8_t)((seed & 63) + d);
      for (int i = tid; i < TM * G::YS; i += THREADS) ys[i] = v;
    } else {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += G::BK) {
      __syncthreads();  // the previous chunk is consumed (and y written)
      stage_w<MODE, K>(w, ws, k0);
      __syncthreads();
      if constexpr (MODE == F32) {
        const float* yf = reinterpret_cast<const float*>(ys);
        const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll 1
        for (int kk = 0; kk < G::BK; kk += 4) {
          float4 a[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)  // one address a warp: a broadcast
            a[r] = *reinterpret_cast<const float4*>(
                yf + (warp * 8 + r) * G::YS + k0 + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const float4 b = *reinterpret_cast<const float4*>(
                  wf + (kk + q) * K + j * 128 + 4 * lane);
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                const float av = q == 0 ? a[r].x : q == 1 ? a[r].y
                               : q == 2 ? a[r].z : a[r].w;
                const int c = (r * NJ + j) * 4;
                acc[c] = fmaf(av, b.x, acc[c]);
                acc[c + 1] = fmaf(av, b.y, acc[c + 1]);
                acc[c + 2] = fmaf(av, b.z, acc[c + 2]);
                acc[c + 3] = fmaf(av, b.w, acc[c + 3]);
              }
            }
          }
        }
      } else {
        constexpr int KSTEP = 32;  // k a fragment
        constexpr int E = G::ESIZE;
#pragma unroll 1
        for (int kk = 0; kk < G::BK; kk += KSTEP) {
          uint32_t b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t* p =
                ws + ((warp * KW + nt * 8 + g) * G::WSS + kk) * E;
            const int off = 4 * t * E;
            b[nt][0] = *reinterpret_cast<const uint32_t*>(p + off);
            b[nt][1] =
                *reinterpret_cast<const uint32_t*>(p + off + KSTEP / 2 * E);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const uint8_t* p0 = ys + ((mt * 16 + g) * G::YS + k0 + kk) * E;
            const uint8_t* p1 = p0 + 8 * G::YS * E;
            const int off = 4 * t * E;
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(p0 + off),
                *reinterpret_cast<const uint32_t*>(p1 + off),
                *reinterpret_cast<const uint32_t*>(p0 + off + KSTEP / 2 * E),
                *reinterpret_cast<const uint32_t*>(p1 + off + KSTEP / 2 * E)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = (mt * NT + nt) * 4;
              mma_s8(acc[c], acc[c + 1], acc[c + 2], acc[c + 3], a, b[nt][0],
                     b[nt][1]);
            }
          }
        }
      }
    }
    // ---- the product's epilogue: y for the next product (not for int8i,
    // whose sum stays in acc, nor after the last product)
    if constexpr (MODE != INT8I) {
      if (d + 1 < DEPTH) {
        __syncthreads();  // every warp is done reading ys
#pragma unroll
        for (int i = 0; i < NACC; i += 2) {
          const int off = row_of(i) * G::YS + col_of(i);
          if constexpr (MODE == F32) {
            reinterpret_cast<float2*>(ys)[off / 2] =
                make_float2(acc[i], acc[i + 1]);
          } else {
            const uint32_t lo = (uint32_t)(acc[i] >> 7) & 0xffu;
            const uint32_t hi = (uint32_t)(acc[i + 1] >> 7) & 0xffu;
            reinterpret_cast<uint16_t*>(ys)[off / 2] =
                (uint16_t)(lo | (hi << 8));
          }
        }
      }
    }
  }

  // ---- the final y values, as the TPU kernel holds them
  auto final_value = [&](int i) -> Acc {
    if constexpr (MODE == INT8)
      return (int)(int8_t)(uint8_t)((uint32_t)(acc[i] >> 7) & 0xffu);
    else
      return acc[i];
  };

  if (tile == 0) {  // the output: sum(y[0, 0:128]) over the (8, 128) block
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      if (row_of(i) == 0 && col_of(i) < ROW0) row0[col_of(i)] = final_value(i);
    __syncthreads();
    if (warp == 0) {
      float s;
      if constexpr (INTS) {
        long long v = 0;
        for (int q = 0; q < 4; ++q) v += row0[4 * lane + q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        s = (float)v;
      } else {
        float v = 0.f;
        for (int q = 0; q < 4; ++q) v += row0[4 * lane + q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        s = v;
      }
      float4* o4 = reinterpret_cast<float4*>(out + (size_t)step * XBLOCK);
      for (int i = lane; i < XBLOCK / 4; i += 32)
        o4[i] = make_float4(s, s, s, s);
    }
  }

  if constexpr (!CHECK) {
    // every final value stays live: one block (a runtime index, -1 for
    // none) stores their sum, so the compiler cannot drop the rows and
    // columns of the last product that the output does not read
    if (step * TILES + tile == sink_at) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) v += (float)final_value(i);
      atomicAdd(sink, v);
    }
  } else {
    Mom m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = (tile * TM + row_of(i)) * K + col_of(i);
      const Acc v = final_value(i);
      if constexpr (INTS) {
        const unsigned long long u = (unsigned long long)(long long)v;
        m0 += u;
        m1 += u * u;
        m2 += (unsigned long long)(idx % POS_PERIOD) * u;
      } else {
        const double dv = (double)v;
        m0 += dv;
        m1 += dv * dv;
        m2 += (double)(idx % POS_PERIOD) * dv;
      }
    }
    m0 = block_sum<Mom>(m0, redm);
    m1 = block_sum<Mom>(m1, redm);
    m2 = block_sum<Mom>(m2, redm);
    if (tid == 0) {
      Mom* mo = static_cast<Mom*>(moments) + ((size_t)step * TILES + tile) * 3;
      mo[0] = m0;
      mo[1] = m1;
      mo[2] = m2;
    }
  }
}

template <int MODE, int K, bool CHECK>
int launch(const void* x, const void* w, void* out, void* moments,
           void* trace, int steps, void* sink, int sink_at, cudaStream_t s) {
  auto kern = dot_chain_kernel<MODE, K, CHECK>;
  const int smem = Geo<MODE, K>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(TILES, steps), THREADS, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), moments, static_cast<__nv_bfloat16*>(trace),
      static_cast<float*>(sink), sink_at);
  return (int)cudaGetLastError();
}

template <int MODE, bool CHECK>
int launch_k(const void* x, const void* w, void* out, void* moments,
             void* trace, int steps, int K, void* sink, int sink_at,
             cudaStream_t s) {
  return K == 384 ? launch<MODE, 384, CHECK>(x, w, out, moments, trace, steps,
                                             sink, sink_at, s)
                  : launch<MODE, 512, CHECK>(x, w, out, moments, trace, steps,
                                             sink, sink_at, s);
}

template <int MODE>
int launch_mode(const void* x, const void* w, void* out, void* moments,
                void* trace, int steps, int K, void* sink, int sink_at,
                cudaStream_t s) {
  return moments ? launch_k<MODE, true>(x, w, out, moments, trace, steps, K,
                                        sink, sink_at, s)
                 : launch_k<MODE, false>(x, w, out, moments, trace, steps, K,
                                         sink, sink_at, s);
}

// ---------------------------------------------------------------- bf16
// The bf16 chain on a cluster ring (mode 1; see the notes at the top).
namespace chain16 {

constexpr int CONSUMERS = 256, CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // 8 MMA warps and 1 copy warp
constexpr int KA = 64, ROW = 2 * KA;     // k a chunk; its bytes an n-row
constexpr int Y_ATOM = TM * ROW;         // y's bytes of 64 k-columns
constexpr int MAX_STAGES = 8;
constexpr int ALIGN = 1024;  // the swizzle's period: planes start on it
// a block's dynamic shared memory, beside its static 1 KB or less
constexpr int SMEM_BUDGET = 232448 - 1024;
constexpr int CLUSTERS[] = {1, 2, 3, 6};  // divisors of TILES

// K's geometry: a chunk is 64 k-columns of W^T (one 128-byte row an n)
// for one half of the n (columns of y W), HALF rows; a product's chunks
// go atom by atom, half 0 then half 1; y is TM rows x K in bf16, both in
// the swizzled layout (16-byte unit u of a 128-byte row r stored at
// u ^ (r % 8): wgmma's 128-byte swizzle); the ring takes what y leaves,
// at most MAX_STAGES; then the full and empty mbarrier of each stage;
// ALIGN bytes to start y on 1024
template <int K>
struct Geo {
  static constexpr int HALF = K / 2, CHUNK = HALF * ROW;
  static constexpr int ATOMS = K / KA, CHUNKS = 2 * ATOMS;
  static constexpr int Y_BYTES = TM * K * 2;
  static constexpr int FIT =
      (SMEM_BUDGET - ALIGN - Y_BYTES - 16 * MAX_STAGES) / CHUNK;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = ALIGN + Y_BYTES + STAGES * CHUNK + 16 * STAGES;
  static constexpr int NACC = K / 4;  // a thread's sums (64 x K/2 a group)
  static_assert(K % 128 == 0 && HALF % 8 == 0 && STAGES >= 2 &&
                    SMEM <= SMEM_BUDGET && Y_BYTES % ALIGN == 0 &&
                    CHUNK % ALIGN == 0,
                "whole atoms, swizzle rows, a ring, aligned planes");
};

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the 8 MMA warps alone (the copy warp never waits on them)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// one arrival on the barrier at `bar` in block `cta` of the cluster (the
// stage's reads are done: their values are in the MMAs' registers)
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta) : "memory");
}
// `bytes` from global to shared memory by the TMA unit, completing on the
// barrier at the same offset; multicast: into every block of `mask`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}
// byte offset of the 16-byte unit u of row r in a swizzled 128-byte-row
// plane
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * ROW + ((u ^ (r & 7)) << 4));
}
// this warp's share of d (64 x 256 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n256k16 bf16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
      "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// this warp's share of d (64 x 192 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n192k16 bf16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_half(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (K == 512)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n192(d, da, db, scale_d);
}

template <typename T>
__device__ T consumer_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  consumer_sync();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int i = 0; i < CWARPS; ++i) s += red[i];
    red[CWARPS] = s;
  }
  consumer_sync();
  const T s = red[CWARPS];
  consumer_sync();
  return s;
}

// grid (TILES, steps), clusters of C along the tiles: block (tile, step)
// runs the step's rows [tile TM, tile TM + TM) through the 14 products.
// Warp 8 (one thread) streams W's chunks, DEPTH times over, into the ring:
// in a cluster each block copies its share of a chunk's rows into every
// block's stage (multicast) once every block's MMA warps have freed that
// stage (its empty barrier counts 4 warps of each of the C blocks), and
// the stage's full barrier waits for all of the chunk's bytes. Warps 4 h
// to 4 h + 3, a warpgroup, take the columns of half h, the chunks (a, h):
// one wgmma m64n(K/2)k16 a k16 step reading y and the chunk from shared
// memory, a chunk's stage freed once the next chunk's wgmmas are in
// flight. f32 sums in k order; after a product the MMA warps round
// their sums to bf16 into y, between two barriers of their own.
template <int K, int C, bool CHECK>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
             float* __restrict__ out, double* __restrict__ moments,
             __nv_bfloat16* __restrict__ trace, float* __restrict__ sink,
             int sink_at) {
  using G = Geo<K>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ys = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                            (ALIGN - 1));
  uint8_t* ring = ys + G::Y_BYTES;
  const uint32_t full0 = smem_u32(ring + G::STAGES * G::CHUNK);
  const uint32_t empty0 = full0 + 8 * G::STAGES;
  __shared__ float row0[ROW0];
  __shared__ int redi[CWARPS + 1];
  __shared__ double redm[CWARPS + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, step = blockIdx.y;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (C > 1) cluster_sync();  // every block's barriers are set

  if (warp == CWARPS) {  // ---- the copy warp
    if (lane == 0) {
      const uint32_t rank = C > 1 ? cta_rank() : 0;
      const int lo = rank * G::HALF / C, hi = (rank + 1) * G::HALF / C;
      const uint32_t bytes = (hi - lo) * ROW;
      for (int t = 0; t < DEPTH * G::CHUNKS; ++t) {
        const int s = t % G::STAGES, round = t / G::STAGES;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        mbar_expect(full0 + 8 * s, G::CHUNK);
        const int c = t % G::CHUNKS;  // atom c / 2, half c % 2
        const uint8_t* src =
            w + ((size_t)(c / 2) * K + (c % 2) * G::HALF + lo) * ROW;
        const uint32_t dst = smem_u32(ring + s * G::CHUNK + lo * ROW);
        if constexpr (C == 1)
          bulk_copy(dst, src, bytes, full0 + 8 * s);
        else
          bulk_copy_multicast(dst, src, bytes, full0 + 8 * s,
                              (uint16_t)((1u << C) - 1));
      }
    }
    __syncwarp();
  } else {  // ---- the MMA warps
    const uint32_t word =
        reinterpret_cast<const uint32_t*>(x + (size_t)step * XBLOCK)[tid];
    const int seed = consumer_sum<int>(
        (int)((word & 0xffu) + ((word >> 8) & 0xffu) + ((word >> 16) & 0xffu) +
              (word >> 24)), redi);
    {  // y0: every element equal, so the layout does not matter here
      const __nv_bfloat162 y0 =
          __bfloat162bfloat162(__float2bfloat16_rn((float)seed * 1e-6f));
      for (int i = tid; i < G::Y_BYTES / 4; i += CONSUMERS)
        reinterpret_cast<__nv_bfloat162*>(ys)[i] = y0;
    }
    // y's generic writes, before wgmma reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    const int g = lane >> 2, t4 = lane & 3;
    const int half = warp / 4, wl = warp % 4;
    const uint32_t y_u32 = smem_u32(ys), ring_u32 = smem_u32(ring);
    float acc[G::NACC];
    // (row, column) in the tile of acc[e], e = j 4 + i (j the
    // warpgroup's n8 block)
    auto row_of = [&](int e) { return wl * 16 + g + 8 * ((e & 3) >> 1); };
    auto col_of = [&](int e) {
      return half * G::HALF + e / 4 * 8 + 2 * t4 + (e & 1);
    };
    auto release = [&](int s) {  // this warp is done with stage s
      __syncwarp();
      if (lane < C) mbar_arrive_at(empty0 + 8 * s, lane);
    };
    for (int d = 0; d < DEPTH; ++d) {
      int held = -1;  // the stage whose wgmmas may still run
#pragma unroll 1
      for (int a = 0; a < G::ATOMS; ++a) {
        const int t = d * G::CHUNKS + 2 * a + half;
        const int s = t % G::STAGES;
        mbar_wait(full0 + 8 * s, (t / G::STAGES) & 1);
        const uint32_t stage = ring_u32 + s * G::CHUNK;
        const uint32_t yatom = y_u32 + a * Y_ATOM;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KA / 16; ++kk)
          wgmma_half<K>(acc, wgmma_desc(yatom + 32 * kk),
                        wgmma_desc(stage + 32 * kk), a > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the chunk before this one is read
        if (held >= 0) release(held);
        held = s;
      }
      wgmma_wait<0>();
      release(held);
      if constexpr (CHECK) {  // the traced row after product d
        const int trow = TRACE_STRIDE * tile % TM;
        __nv_bfloat16* tr =
            trace + (((size_t)step * TILES + tile) * DEPTH + d) * K;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e)
          if (row_of(e) == trow) tr[col_of(e)] = __float2bfloat16_rn(acc[e]);
      }
      if (d + 1 < DEPTH) {  // y for the next product, rounded to bf16
        consumer_sync();    // every MMA warp is done reading y
#pragma unroll
        for (int e = 0; e < G::NACC; e += 2) {
          const int r = row_of(e), c = col_of(e);
          *reinterpret_cast<__nv_bfloat162*>(
              ys + (c / KA) * Y_ATOM + swz(r, (c % KA) / 8) + (c % 8) * 2) =
              __floats2bfloat162_rn(acc[e], acc[e + 1]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync();
      }
    }

    auto final_value = [&](int e) {
      return __bfloat162float(__float2bfloat16_rn(acc[e]));
    };
    if (tile == 0) {  // the output: sum(y[0, 0:128]) over the (8, 128) block
#pragma unroll
      for (int e = 0; e < G::NACC; ++e)
        if (row_of(e) == 0 && col_of(e) < ROW0)
          row0[col_of(e)] = final_value(e);
      consumer_sync();
      if (warp == 0) {
        float v = 0.f;
        for (int q = 0; q < 4; ++q) v += row0[4 * lane + q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        float4* o4 = reinterpret_cast<float4*>(out + (size_t)step * XBLOCK);
        for (int i = lane; i < XBLOCK / 4; i += 32)
          o4[i] = make_float4(v, v, v, v);
      }
    }
    if constexpr (!CHECK) {
      // every final value stays live (see the int modes' kernel)
      if (step * TILES + tile == sink_at) {
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e) v += final_value(e);
        atomicAdd(sink, v);
      }
    } else {
      double m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int e = 0; e < G::NACC; ++e) {
        const int idx = (tile * TM + row_of(e)) * K + col_of(e);
        const double dv = (double)final_value(e);
        m0 += dv;
        m1 += dv * dv;
        m2 += (double)(idx % POS_PERIOD) * dv;
      }
      m0 = consumer_sum<double>(m0, redm);
      m1 = consumer_sum<double>(m1, redm);
      m2 = consumer_sum<double>(m2, redm);
      if (tid == 0) {
        double* mo = moments + ((size_t)step * TILES + tile) * 3;
        mo[0] = m0;
        mo[1] = m1;
        mo[2] = m2;
      }
    }
  }
  // no block leaves while another may still copy into it or arrive on it
  if constexpr (C > 1) cluster_sync();
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, float*, double*,
                        __nv_bfloat16*, float*, int);

template <int K, bool CHECK>
Kernel entry_c(int C) {
  switch (C) {
    case 1: return chain_kernel<K, 1, CHECK>;
    case 2: return chain_kernel<K, 2, CHECK>;
    case 3: return chain_kernel<K, 3, CHECK>;
    default: return chain_kernel<K, 6, CHECK>;
  }
}

Kernel entry(int K, int C, bool check) {
  if (K == 384) return check ? entry_c<384, true>(C) : entry_c<384, false>(C);
  return check ? entry_c<512, true>(C) : entry_c<512, false>(C);
}

int smem_of(int K) {
  return K == 384 ? Geo<384>::SMEM : Geo<512>::SMEM;
}

cudaLaunchConfig_t config(int K, int C, int steps, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(TILES, steps, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_of(K);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of C blocks the card runs at once, for the (K, C) timed
// kernel, asked once a device (the attributes of both instantiations set
// with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_active[kMaxDevices][2][7];  // [dev][K][C]

cudaError_t active_clusters(int K, int C, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_active[dev][K == 512][C];
  if (!slot.load()) {
    for (bool check : {false, true}) {
      e = cudaFuncSetAttribute(entry(K, C, check),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_of(K));
      if (e != cudaSuccess) return e;
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(K, C, 1, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, entry(K, C, false), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    slot.store(n);
  }
  *active = slot.load();
  return cudaSuccess;
}

// the cluster size of variant 0: of the sizes whose clusters cover at
// least 15/16 of the SMs at once, the largest (the larger the cluster, the
// fewer L2 reads of W)
cudaError_t choose_cluster(int K, int* C) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *C = 1;
  for (int c : CLUSTERS) {
    int active = 0;
    if (e == cudaSuccess) e = active_clusters(K, c, &active);
    if (e == cudaSuccess && 16 * active * c >= 15 * sms) *C = c;
  }
  return e;
}

// variant: the cluster size (0: choose_cluster's)
cudaError_t resolve(int K, int variant, int* C) {
  *C = variant;
  return *C ? cudaSuccess : choose_cluster(K, C);
}

bool variant_ok(int variant) {
  return variant == 0 || variant == 1 || variant == 2 || variant == 3 ||
         variant == 6;
}

int launch(const void* x, const void* w, void* out, void* moments,
           void* trace, int steps, int K, int variant, void* sink,
           int sink_at, cudaStream_t s) {
  int C = 0, active = 0;
  cudaError_t e = resolve(K, variant, &C);
  if (e == cudaSuccess) e = active_clusters(K, C, &active);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(K, C, steps, s, attr);
  e = cudaLaunchKernelEx(
      &cfg, entry(K, C, moments != nullptr),
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), static_cast<double*>(moments),
      static_cast<__nv_bfloat16*>(trace), static_cast<float*>(sink), sink_at);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace chain16

}  // namespace

// x: (steps * 8, 128) uint8; w: (K, K) f32 k-major for mode 0, W^T
// (n-major) in s8 for modes 2, 3, and for mode 1 W^T in bf16 in chain16's
// chunk layout (ops/cuda_dot_chain.pack_weights: atom a, row n, 16-byte
// unit u of W^T[n, 64 a + 8 u ...] at unit u ^ (n % 8)), 16-byte aligned;
// out: (steps, 8, 128) f32; moments: nullptr, or (steps, 6, 3) doubles
// (modes 0, 1) or int64 (modes 2, 3), the check instantiation's; trace:
// the check instantiation's (steps, 6, 14, K) bf16 in mode 1, else unused;
// sink: one f32 that the timed instantiation's block sink_at (step * 6 +
// tile; -1: none) adds the sum of its final values to. mode: 0 f32, 1
// bf16, 2 int8, 3 int8i; K: 384 or 512; variant: mode 1's blocks a
// cluster (1, 2, 3 or 6), 0 for dot_chain_plan's choice; 0 in the other
// modes. Every variant computes the same bits. Returns the cudaError_t of
// the launch.
extern "C" int dot_chain(const void* x, const void* w, void* out,
                         void* moments, void* trace, void* sink, int sink_at,
                         int steps, int K, int mode, int variant,
                         void* stream) {
  if (steps < 0 || (K != 384 && K != 512) || mode < F32 || mode > INT8I ||
      !(mode == BF16 ? chain16::variant_ok(variant) : variant == 0) ||
      (moments && mode == BF16 && !trace))
    return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case F32:
      return launch_mode<F32>(x, w, out, moments, trace, steps, K, sink,
                              sink_at, s);
    case BF16:
      return chain16::launch(x, w, out, moments, trace, steps, K, variant,
                             sink, sink_at, s);
    case INT8:
      return launch_mode<INT8>(x, w, out, moments, trace, steps, K, sink,
                               sink_at, s);
    default:
      return launch_mode<INT8I>(x, w, out, moments, trace, steps, K, sink,
                                sink_at, s);
  }
}

// mode 1's launch at K on the current card, variant as dot_chain takes
// it; out[0..7]: the cluster size, ring stages, dynamic shared memory bytes a block, bytes a chunk, threads
// a block, the clusters of that size the card runs at once, the SMs they
// cover and the card's SMs. Returns the cudaError_t of the occupancy
// query.
extern "C" int dot_chain_plan(int K, int variant, int* out) {
  if ((K != 384 && K != 512) || !chain16::variant_ok(variant))
    return (int)cudaErrorInvalidValue;
  int C = 0, active = 0, dev = 0, sms = 0;
  cudaError_t e = chain16::resolve(K, variant, &C);
  if (e == cudaSuccess) e = chain16::active_clusters(K, C, &active);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool k384 = K == 384;
  const int fields[] = {
      C,
      k384 ? chain16::Geo<384>::STAGES : chain16::Geo<512>::STAGES,
      chain16::smem_of(K),
      k384 ? chain16::Geo<384>::CHUNK : chain16::Geo<512>::CHUNK,
      chain16::THREADS,
      active,
      active * C,
      sms};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}
