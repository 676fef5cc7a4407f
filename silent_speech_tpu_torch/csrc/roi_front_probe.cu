// Micro-kernels of the ROI CNN's input front for Hopper (sm_90a), at the
// block geometry of K1's first design (csrc/roi_cnn.cu): one 288-thread
// block a frame, one 16-byte load a thread, a (50 x 98) zero-haloed f32
// image in shared memory, per-frame standardization in two passes.
//
// Replaces scripts/probe_front.py::_probe_kernel (built by ::build), the
// TPU's probe of the shipped K1 front at its own block geometry ((M, 384)
// u8 blocks, M = 12 F_TILE, and a (4, M, 128) f32 halo: 786 KB at F=32,
// which fits no block's shared memory). Each stage is a cumulative rung:
//   dma        the load, touching the bytes minimally: a wrapping sum of
//              the four 32-bit words a thread loaded; F frames a block
//              (1, 2, 4: the counterpart of F_TILE 16 / 32 / 64) with the
//              288 threads fixed, so the block count halves as F doubles
//   widen      + u8 -> f32 and /255 as K1 does it (an IEEE division), and
//              the moments of the 16 values
//   front      + K1's zero fill and haloed shared-memory store, its moments
//              read back from shared memory
//   front_std  + K1's standardization (mean, then the variance about it,
//              ddof=1, std >= 1e-6) before the store
//   overlap_a  front, then a chain of FMAs as long as K1's arithmetic a
//              frame (288 threads x 8 accumulators x 1152 = 2,654,208 =
//              K1's multiply-adds), seeded from the widened values
//   overlap_b  the same chain seeded from one 4-byte word a block (byte
//              i % 4 + i for accumulator i, so that no two chains are equal
//              and the compiler merges none): no input stream; A - B is what
//              the front costs beside K1-sized arithmetic
// Every stage writes checkable values a block. dma: the uint32 sum of its
// words; overlap_b: the f32 sum of its chains. The others: three f32
// moments of the values the stage built (the sum, the sum of squares and
// the sum weighted by i % 31, i the value's index: the pixel's in the frame
// for widen, the haloed image's for the rest), so that a wrong scale or a
// misplaced store shows; overlap_a adds its chains' sum to the first. The
// chain multiplies by a runtime 1 and adds a runtime 0, so its result is
// its seed while the card still issues every FMA.
//
// What bounds them: the bytes (37.75 MB of u8 at N=8192, 0.0113 ms at
// 3.35 TB/s), except the overlap pair, bound by K1's FMAs (0.65 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H0 = 48, W0 = 96;
constexpr int THREADS = 288, NWARPS = THREADS / 32;
constexpr int FRAME_BYTES = H0 * W0;
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;  // K1's image
constexpr int CHAIN_ACC = 8, CHAIN_LEN = 1152;
constexpr int MOMENTS = 3, POS_PERIOD = 31;
static_assert(THREADS * 16 == FRAME_BYTES, "one 16-byte load a thread");

enum Stage { DMA = 0, WIDEN = 1, FRONT = 2, FRONT_STD = 3, OVERLAP_A = 4,
             OVERLAP_B = 5 };

// sum of v over the block, returned to every thread; red holds NWARPS + 1
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w];
    red[NWARPS] = s;
  }
  __syncthreads();
  const float s = red[NWARPS];
  __syncthreads();
  return s;
}

template <int STAGE, int F>
__global__ void __launch_bounds__(THREADS)
front_probe_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                   float chain_a, float chain_c) {
  constexpr bool IMAGE =
      STAGE == FRONT || STAGE == FRONT_STD || STAGE == OVERLAP_A;
  __shared__ float xp[IMAGE ? XP_SIZE : 1];
  __shared__ float red[NWARPS + 1];
  __shared__ uint32_t redu[NWARPS];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;

  if constexpr (STAGE == DMA) {
    uint4 q[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      q[f] = reinterpret_cast<const uint4*>(x + (b * F + f) * FRAME_BYTES)[tid];
    uint32_t s = 0;
#pragma unroll
    for (int f = 0; f < F; ++f) s += q[f].x + q[f].y + q[f].z + q[f].w;
    s = __reduce_add_sync(0xffffffffu, s);
    if ((tid & 31) == 0) redu[tid >> 5] = s;
    __syncthreads();
    if (tid == 0) {
      uint32_t t = 0;
      for (int w = 0; w < NWARPS; ++w) t += redu[w];
      reinterpret_cast<uint32_t*>(out)[b] = t;
    }
  } else {
    float s = 0.f, s2 = 0.f, sp = 0.f;  // the moments
    auto add = [&](float u, int i) {
      s += u;
      s2 = fmaf(u, u, s2);
      sp = fmaf((float)(i % POS_PERIOD), u, sp);
    };
    float acc[CHAIN_ACC];
    if constexpr (STAGE == OVERLAP_B) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(x)[b];
#pragma unroll
      for (int i = 0; i < CHAIN_ACC; ++i)  // distinct seeds: no chain is
        acc[i] = (float)((w >> (8 * (i & 3))) & 0xffu) + (float)i;  // shared
    } else {
      // ---- K1's input: 16 consecutive pixels of one row, scaled in f32
      float v[16];
      const uint4 q = reinterpret_cast<const uint4*>(x + b * FRAME_BYTES)[tid];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[k] = (float)((words[k >> 2] >> (8 * (k & 3))) & 0xffu) / 255.0f;
      if constexpr (!IMAGE) {  // widen: i the pixel's index in the frame
#pragma unroll
        for (int k = 0; k < 16; ++k) add(v[k], tid * 16 + k);
      } else {
        for (int i = tid; i < XP_SIZE; i += THREADS) xp[i] = 0.f;
        if constexpr (STAGE == FRONT_STD) {  // two passes, as K1
          float m = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) m += v[k];
          const float mu = block_sum(m, red) / (float)FRAME_BYTES;
          float ss = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) ss += (v[k] - mu) * (v[k] - mu);
          const float var = block_sum(ss, red) / (float)(FRAME_BYTES - 1);
          const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-6f);
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = (v[k] - mu) / sd;
        }
        __syncthreads();  // zero fill done before the interior is written
        const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
#pragma unroll
        for (int k = 0; k < 16; ++k) xp[(y + 1) * XP_W + x0 + 1 + k] = v[k];
        __syncthreads();
        for (int i = tid; i < XP_SIZE; i += THREADS) add(xp[i], i);
        if constexpr (STAGE == OVERLAP_A) {
#pragma unroll
          for (int i = 0; i < CHAIN_ACC; ++i) acc[i] = v[2 * i] + v[2 * i + 1];
        }
      }
    }
    if constexpr (STAGE == OVERLAP_A || STAGE == OVERLAP_B) {
#pragma unroll 8
      for (int it = 0; it < CHAIN_LEN; ++it)
#pragma unroll
        for (int i = 0; i < CHAIN_ACC; ++i)
          acc[i] = fmaf(acc[i], chain_a, chain_c);
#pragma unroll
      for (int i = 0; i < CHAIN_ACC; ++i) s += acc[i];
    }
    s = block_sum(s, red);
    if constexpr (STAGE == OVERLAP_B) {
      if (tid == 0) out[b] = s;
    } else {
      s2 = block_sum(s2, red);
      sp = block_sum(sp, red);
      if (tid == 0) {
        out[b * MOMENTS] = s;
        out[b * MOMENTS + 1] = s2;
        out[b * MOMENTS + 2] = sp;
      }
    }
  }
}

template <int STAGE, int F>
int launch(const void* x, void* out, int blocks, float a, float c,
           cudaStream_t s) {
  front_probe_kernel<STAGE, F><<<blocks, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out), a, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, 48, 96) uint8, 16-byte aligned (overlap_b: n 4-byte words, one a
// block); out: n / frames_per_block blocks of one 4-byte value (uint32 bits
// for dma, f32 for overlap_b) or of three f32 moments (the other stages). stage: 0 dma, 1 widen, 2 front, 3 front_std,
// 4 overlap_a, 5 overlap_b; frames_per_block 1, 2 or 4 for dma, else 1;
// chain_a, chain_c: the chain's runtime 1 and 0. Returns the cudaError_t
// of the launch.
extern "C" int roi_front_probe(const void* x, void* out, int n, int stage,
                               int frames_per_block, float chain_a,
                               float chain_c, void* stream) {
  const int F = frames_per_block;
  if (n < 0 || stage < DMA || stage > OVERLAP_B ||
      (stage == DMA ? (F != 1 && F != 2 && F != 4) : F != 1) || n % F)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = n / F;
  switch (stage) {
    case DMA:
      return F == 1 ? launch<DMA, 1>(x, out, blocks, chain_a, chain_c, s)
           : F == 2 ? launch<DMA, 2>(x, out, blocks, chain_a, chain_c, s)
                    : launch<DMA, 4>(x, out, blocks, chain_a, chain_c, s);
    case WIDEN: return launch<WIDEN, 1>(x, out, blocks, chain_a, chain_c, s);
    case FRONT: return launch<FRONT, 1>(x, out, blocks, chain_a, chain_c, s);
    case FRONT_STD:
      return launch<FRONT_STD, 1>(x, out, blocks, chain_a, chain_c, s);
    case OVERLAP_A:
      return launch<OVERLAP_A, 1>(x, out, blocks, chain_a, chain_c, s);
    default:
      return launch<OVERLAP_B, 1>(x, out, blocks, chain_a, chain_c, s);
  }
}
