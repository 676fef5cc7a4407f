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
//          sum rounded to bf16 (mma.sync m16n8k16 bf16 -> f32)
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
// all 14 products, in shared memory, and streams W from L2 in chunks of
// rows (1 MB f32 at K=512, 512 KB bf16, 256 KB s8): every row of every
// step is still computed, 6 blocks a step. The MMA modes read W
// transposed (n-major, (K, K)), so that a B fragment's k-pairs (bf16) or
// k-quads (s8) are one 32-bit word.
//
// What bounds it: the multiply-adds, steps * 14 * 384 * K^2 (203 G at
// K=384, 361 G at K=512 for 256 steps): 6.06 / 10.77 ms at the f32 FMA
// peak, 0.41 / 0.73 ms bf16, 0.205 / 0.365 ms int8. The design re-reads W
// once a block a product (6 blocks a step, so 14 * 6 * |W| a step from
// L2), which at TM = 64 costs the MMA modes more L2 traffic than their
// tensor-core time: a simple kernel that is right first; wgmma with a
// larger row tile is a later change.
//
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

#include <type_traits>

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

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  } else if constexpr (MODE == BF16) {
    const __nv_bfloat16 y0 = __float2bfloat16_rn((float)seed * 1e-6f);
    for (int i = tid; i < TM * G::YS; i += THREADS)
      reinterpret_cast<__nv_bfloat16*>(ys)[i] = y0;
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
        constexpr int KSTEP = MODE == BF16 ? 16 : 32;  // k a fragment
        constexpr int E = G::ESIZE;
#pragma unroll 1
        for (int kk = 0; kk < G::BK; kk += KSTEP) {
          uint32_t b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t* p =
                ws + ((warp * KW + nt * 8 + g) * G::WSS + kk) * E;
            const int off = MODE == BF16 ? 2 * t * E : 4 * t * E;
            b[nt][0] = *reinterpret_cast<const uint32_t*>(p + off);
            b[nt][1] =
                *reinterpret_cast<const uint32_t*>(p + off + KSTEP / 2 * E);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const uint8_t* p0 = ys + ((mt * 16 + g) * G::YS + k0 + kk) * E;
            const uint8_t* p1 = p0 + 8 * G::YS * E;
            const int off = MODE == BF16 ? 2 * t * E : 4 * t * E;
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(p0 + off),
                *reinterpret_cast<const uint32_t*>(p1 + off),
                *reinterpret_cast<const uint32_t*>(p0 + off + KSTEP / 2 * E),
                *reinterpret_cast<const uint32_t*>(p1 + off + KSTEP / 2 * E)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = (mt * NT + nt) * 4;
              if constexpr (MODE == BF16)
                mma_bf16(acc[c], acc[c + 1], acc[c + 2], acc[c + 3], a,
                         b[nt][0], b[nt][1]);
              else
                mma_s8(acc[c], acc[c + 1], acc[c + 2], acc[c + 3], a,
                       b[nt][0], b[nt][1]);
            }
          }
        }
      }
    }
    if constexpr (CHECK && MODE == BF16) {  // the traced row after product d
      const int trow = TRACE_STRIDE * tile % TM;
      __nv_bfloat16* tr =
          trace + (((size_t)step * TILES + tile) * DEPTH + d) * K;
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        if (row_of(i) == trow) tr[col_of(i)] = __float2bfloat16_rn(acc[i]);
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
          } else if constexpr (MODE == BF16) {
            reinterpret_cast<__nv_bfloat162*>(ys)[off / 2] =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
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
    if constexpr (MODE == BF16)
      return __bfloat162float(__float2bfloat16_rn(acc[i]));
    else if constexpr (MODE == INT8)
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

}  // namespace

// x: (steps * 8, 128) uint8; w: (K, K) f32 k-major for mode 0, else W^T
// (n-major) in bf16 (mode 1) or s8 (modes 2, 3), 16-byte aligned; out:
// (steps, 8, 128) f32; moments: nullptr, or (steps, 6, 3) doubles (modes
// 0, 1) or int64 (modes 2, 3), the check instantiation's; trace: the check
// instantiation's (steps, 6, 14, K) bf16 in mode 1, else unused; sink: one
// f32 that the timed instantiation's block sink_at (step * 6 + tile; -1:
// none) adds the sum of its final values to. mode: 0 f32, 1 bf16, 2 int8,
// 3 int8i; K: 384 or 512. Returns the cudaError_t of the launch.
extern "C" int dot_chain(const void* x, const void* w, void* out,
                         void* moments, void* trace, void* sink, int sink_at,
                         int steps, int K, int mode, void* stream) {
  if (steps < 0 || (K != 384 && K != 512) || mode < F32 || mode > INT8I ||
      (moments && mode == BF16 && !trace))
    return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case F32:
      return launch_mode<F32>(x, w, out, moments, trace, steps, K, sink,
                              sink_at, s);
    case BF16:
      return launch_mode<BF16>(x, w, out, moments, trace, steps, K, sink,
                               sink_at, s);
    case INT8:
      return launch_mode<INT8>(x, w, out, moments, trace, steps, K, sink,
                               sink_at, s);
    default:
      return launch_mode<INT8I>(x, w, out, moments, trace, steps, K, sink,
                                sink_at, s);
  }
}
