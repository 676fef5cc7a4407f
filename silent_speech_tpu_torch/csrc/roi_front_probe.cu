// Micro-kernels of the ROI CNN's input front for Hopper (sm_90a): the
// front's ladder on K1's persistent geometry (csrc/roi_cnn.cu since its
// redesign), beside the first design's block-a-frame geometry, which the
// dma sweep and the overlap pair keep.
//
// Replaces scripts/probe_front.py::_probe_kernel (built by ::build), the
// TPU's probe of the shipped K1 front at its own block geometry ((M, 384)
// u8 blocks, M = 12 F_TILE, and a (4, M, 128) f32 halo: 786 KB at F=32,
// which fits no block's shared memory). Each stage is a cumulative rung:
//   dma_ring   the load alone at the ladder's geometry: frames streamed
//              into a ring, a wrapping sum of the frame's 32-bit words
//   widen      + u8 -> f32 and /255, bitwise K1's IEEE division, and the
//              moments of the frame's 4,608 values
//   front      + K1's haloed shared-memory image (50 x 98 f32, the halo
//              zero), its moments read back from shared memory
//   front_std  + K1's standardization (mean, then the variance about it,
//              ddof=1, std >= 1e-6) before the store
//   dma        the first geometry's load, touching the bytes minimally: a
//              wrapping sum of the four 32-bit words a thread loaded; F
//              frames a block (1, 2, 4: the counterpart of F_TILE 16 / 32 /
//              64) with the 288 threads fixed, so the block count halves as
//              F doubles
//   overlap_a  front at the first geometry (one 288-thread block a frame,
//              its image zeroed every frame), then a chain of FMAs as long
//              as K1's arithmetic a frame (288 threads x 8 accumulators x
//              1152 = 2,654,208 = K1's multiply-adds), seeded from the
//              widened values
//   overlap_b  the same chain seeded from one 4-byte word a block (byte
//              i % 4 + i for accumulator i, so that no two chains are equal
//              and the compiler merges none): no input stream; A - B is what
//              the front costs beside K1-sized arithmetic
// Every stage writes checkable values a frame (a block of F frames for
// dma). dma, dma_ring: the uint32 sum of its words; overlap_b: the f32 sum
// of its chains. The others: three f32 moments of the values the stage
// built (the sum, the sum of squares and the sum weighted by i % 31, i the
// value's index: the pixel's in the frame for widen, the haloed image's for
// the rest), so that a wrong scale or a misplaced store shows; overlap_a
// adds its chains' sum to the first. The chain multiplies by a runtime 1
// and adds a runtime 0, so its result is its seed while the card still
// issues every FMA.
//
// What bounds them: the bytes (37.75 MB of u8 at N=8192, 0.0113 ms at
// 3.35 TB/s), except the overlap pair, bound by K1's FMAs (0.65 ms).
//
// The ladder's design (ring_kernel): one geometry for its four rungs, so
// that each rung's delta is its work alone. Persistent blocks of 288
// threads, one wave (roi_front_probe_plan: the fewest blocks an SM that
// any rung fits on the card), block b walking frames b, b + gridDim.x,
// ...; thread 0 keeps SLOTS = 7 frames in flight by TMA bulk copies of
// 4,608 bytes into a ring of shared-memory slots, each with an mbarrier, a
// slot refilled once every thread has read it (the frame's barrier); every
// rung reserves the ring and two images (71,456 bytes: three blocks an
// SM). A warp takes 512 pixels of a frame, lane l the pixels 32 k + l (k <
// 16): one byte load each, and 32 consecutive floats of one image row a
// store, in 32 banks; a thread's image indices and i % 31 weights are the
// same for every frame and are computed once. The /255 (and front_std's
// division by the frame's std) is the product by the rounded reciprocal
// and one FMA of its exact residual (Markstein's correction), bitwise the
// IEEE division for every byte, without the division's reciprocal on the
// multi-function units a pixel. The image is double-buffered, its halo
// zeroed once a block; a frame's three moments go through the warps'
// shuffles and one barrier (front_std: two more, its mean and variance),
// the read-back's written out a frame later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int H0 = 48, W0 = 96;
constexpr int THREADS = 288, NWARPS = THREADS / 32;
constexpr int FRAME_BYTES = H0 * W0;
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;  // K1's image
constexpr int CHAIN_ACC = 8, CHAIN_LEN = 1152;
constexpr int MOMENTS = 3, POS_PERIOD = 31;
static_assert(THREADS * 16 == FRAME_BYTES, "one 16-byte load a thread");

enum Stage { DMA = 0, WIDEN = 1, FRONT = 2, FRONT_STD = 3, OVERLAP_A = 4,
             OVERLAP_B = 5, DMA_RING = 6 };

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

// the first geometry: one block of F frames
template <int STAGE, int F>
__global__ void __launch_bounds__(THREADS)
front_probe_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                   float chain_a, float chain_c) {
  static_assert(STAGE == DMA || STAGE == OVERLAP_A || STAGE == OVERLAP_B,
                "the first geometry's stages");
  constexpr bool IMAGE = STAGE == OVERLAP_A;
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
      for (int i = tid; i < XP_SIZE; i += THREADS) xp[i] = 0.f;
      __syncthreads();  // zero fill done before the interior is written
      const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
#pragma unroll
      for (int k = 0; k < 16; ++k) xp[(y + 1) * XP_W + x0 + 1 + k] = v[k];
      __syncthreads();
      for (int i = tid; i < XP_SIZE; i += THREADS) add(xp[i], i);
#pragma unroll
      for (int i = 0; i < CHAIN_ACC; ++i) acc[i] = v[2 * i] + v[2 * i + 1];
    }
#pragma unroll 8
    for (int it = 0; it < CHAIN_LEN; ++it)
#pragma unroll
      for (int i = 0; i < CHAIN_ACC; ++i)
        acc[i] = fmaf(acc[i], chain_a, chain_c);
#pragma unroll
    for (int i = 0; i < CHAIN_ACC; ++i) s += acc[i];
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

// ------------------------------------------------ the ladder (ring_kernel)
namespace ring {

constexpr int PIX = FRAME_BYTES / THREADS;  // a thread's pixels (16)
constexpr int IMG4 = (XP_SIZE + 3) / 4;     // the image's float4s (1,225)
constexpr int READS = (IMG4 + THREADS - 1) / THREADS;  // a thread's (5)
constexpr int IMG_BYTES = 16 * IMG4;        // an image, 16-byte aligned
constexpr float R255 = 1.0f / 255.0f;       // rounded to nearest

// frames in flight a block, every rung; with two images beside them three
// blocks an SM fit the card's 228 KB
constexpr int SLOTS = 7;
// dynamic shared memory, every rung: the ring, then two images
constexpr int SMEM = SLOTS * FRAME_BYTES + 2 * IMG_BYTES;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// frame `src` into the slot at `dst` by the TMA unit, completing on `bar`
__device__ __forceinline__ void fetch(uint32_t dst, const uint8_t* src,
                                      uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(FRAME_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(FRAME_BYTES),
      "r"(bar) : "memory");
}

// a / b from r = RN(1 / b): the product a r is within an ulp of the
// quotient, and one FMA of its exact residual a - b q (Markstein's
// correction) rounds it to RN(a / b): bitwise b / 255.0f for every byte
// (tests/test_torch_front_probe_tc.py), without the division's reciprocal
// on the multi-function units
__device__ __forceinline__ float quotient(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}
__device__ __forceinline__ float scaled(uint32_t b) {  // b / 255.0f
  return quotient(__fsub_rn(__uint_as_float(0x4b000000u | b), 8388608.0f),
                  255.0f, R255);
}

// the warp's three sums to lane 0
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
}
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// block b's frames b, b + gridDim.x, ... (n in all), each one item of the
// ring; out: a uint32 a frame (dma_ring) or three f32 moments
template <int STAGE>
__global__ void __launch_bounds__(THREADS, 3)
ring_kernel(const uint8_t* __restrict__ x, float* __restrict__ out, int n) {
  constexpr bool IMAGE = STAGE == FRONT || STAGE == FRONT_STD;
  extern __shared__ __align__(128) uint8_t smem[];
  float* img = reinterpret_cast<float*>(smem + SLOTS * FRAME_BYTES);
  __shared__ __align__(8) uint64_t full[SLOTS];
  __shared__ float red[2][NWARPS][MOMENTS];  // a frame's warp partials
  __shared__ float stat[2][2][NWARPS];       // front_std: mean, variance
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, first = blockIdx.x;
  const int count = first < n ? (n - first + G - 1) / G : 0;
  const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = (uint32_t)__cvta_generic_to_shared(full);

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < SLOTS && i < count; ++i)
      fetch(ring0 + i * FRAME_BYTES,
            x + (size_t)(first + i * G) * FRAME_BYTES, full0 + 8 * i);
  }
  // this thread's pixels p = 512 warp + 32 k + lane (32 of a warp's step
  // in one row: 96 = 3 x 32): their image indices at(k) (warp-uniform but
  // for the lane) and weights (p % 31); the image's float4s tid + 288 j it
  // reads back, their weights
  auto at = [&](int k) {
    const int p0 = 512 * warp + 32 * k;
    return (p0 / W0 + 1) * XP_W + p0 % W0 + 1 + lane;
  };
  float wp[PIX], wr[READS][4];
#pragma unroll
  for (int k = 0; k < PIX; ++k)
    wp[k] = (float)((512 * warp + 32 * k + lane) % POS_PERIOD);
#pragma unroll
  for (int j = 0; j < READS; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wr[j][c] = (float)((4 * (tid + THREADS * j) + c) % POS_PERIOD);
  if constexpr (IMAGE) {  // both images' halos (and tails) zeroed once
    for (int i = tid; i < 2 * IMG4; i += THREADS)
      reinterpret_cast<float4*>(img)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the read-back of frame i's image: its moments' warp partials
  auto read_back = [&](int i) {
    const float4* im = reinterpret_cast<const float4*>(img + (i & 1) *
                                                       (IMG_BYTES / 4));
    float s = 0.f, s2 = 0.f, sp = 0.f;
#pragma unroll
    for (int j = 0; j < READS; ++j) {
      const int e = tid + THREADS * j;
      if (j + 1 < READS || e < IMG4) {
        const float4 v = im[e];
        const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s += u[c];
          s2 = fmaf(u[c], u[c], s2);
          sp = fmaf(wr[j][c], u[c], sp);
        }
      }
    }
    warp_sum3(s, s2, sp);
    if (lane == 0) {
      red[i & 1][warp][0] = s;
      red[i & 1][warp][1] = s2;
      red[i & 1][warp][2] = sp;
    }
  };
  // frame i's three moments, from its warp partials, by threads 0-2
  auto write_out = [&](int i) {
    if (tid < MOMENTS) {
      float t = 0.f;
      for (int w = 0; w < NWARPS; ++w) t += red[i & 1][w][tid];
      out[(size_t)(first + i * G) * MOMENTS + tid] = t;
    }
  };

#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const int s = i % SLOTS;
    mbar_wait(full0 + 8 * s, (i / SLOTS) & 1);
    const uint8_t* frame = smem + s * FRAME_BYTES;
    if constexpr (STAGE == DMA_RING) {
      const uint4 q = reinterpret_cast<const uint4*>(frame)[tid];
      const uint32_t u =
          __reduce_add_sync(0xffffffffu, q.x + q.y + q.z + q.w);
      if (lane == 0) reinterpret_cast<uint32_t*>(red[i & 1][warp])[0] = u;
    } else {
      float v[PIX];
#pragma unroll
      for (int k = 0; k < PIX; ++k)
        v[k] = scaled(frame[512 * warp + 32 * k + lane]);
      if constexpr (STAGE == WIDEN) {
        float a = 0.f, a2 = 0.f, ap = 0.f;
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          a += v[k];
          a2 = fmaf(v[k], v[k], a2);
          ap = fmaf(wp[k], v[k], ap);
        }
        warp_sum3(a, a2, ap);
        if (lane == 0) {
          red[i & 1][warp][0] = a;
          red[i & 1][warp][1] = a2;
          red[i & 1][warp][2] = ap;
        }
      } else {
        if constexpr (STAGE == FRONT_STD) {  // two passes, as K1
          float m = 0.f;
#pragma unroll
          for (int k = 0; k < PIX; ++k) m += v[k];
          m = warp_sum(m);
          if (lane == 0) stat[i & 1][0][warp] = m;
          __syncthreads();
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) t += stat[i & 1][0][w];
          const float mu = t / (float)FRAME_BYTES;
          float ss = 0.f;
#pragma unroll
          for (int k = 0; k < PIX; ++k) ss += (v[k] - mu) * (v[k] - mu);
          ss = warp_sum(ss);
          if (lane == 0) stat[i & 1][1][warp] = ss;
          __syncthreads();
          t = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) t += stat[i & 1][1][w];
          const float var = t / (float)(FRAME_BYTES - 1);
          const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-6f);
          const float r = __frcp_rn(sd);
#pragma unroll
          for (int k = 0; k < PIX; ++k)
            v[k] = quotient(v[k] - mu, sd, r);
        }
        float* im = img + (i & 1) * (IMG_BYTES / 4);
#pragma unroll
        for (int k = 0; k < PIX; ++k) im[at(k)] = v[k];
      }
    }
    __syncthreads();  // slot s is read; frame i's partials or image are whole
    if (tid == 0 && i + SLOTS < count)
      fetch(ring0 + s * FRAME_BYTES,
            x + (size_t)(first + (i + SLOTS) * G) * FRAME_BYTES,
            full0 + 8 * s);
    if constexpr (STAGE == DMA_RING) {
      if (tid == 0) {
        uint32_t t = 0;
        for (int w = 0; w < NWARPS; ++w)
          t += reinterpret_cast<const uint32_t*>(red[i & 1][w])[0];
        reinterpret_cast<uint32_t*>(out)[first + i * G] = t;
      }
    } else if constexpr (STAGE == WIDEN) {
      write_out(i);
    } else {  // the previous frame's read-back is summed; this one's read
      if (i > 0) write_out(i - 1);
      read_back(i);
    }
  }
  if constexpr (IMAGE) {
    __syncthreads();
    if (count > 0) write_out(count - 1);
  }
}

using Kernel = void (*)(const uint8_t*, float*, int);

Kernel entry(int stage) {
  switch (stage) {
    case DMA_RING: return ring_kernel<DMA_RING>;
    case WIDEN: return ring_kernel<WIDEN>;
    case FRONT: return ring_kernel<FRONT>;
    default: return ring_kernel<FRONT_STD>;
  }
}

// the ladder's wave, every rung's: the fewest blocks an SM that any rung
// fits times the SMs, asked once a device (the attribute set with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_wave[kMaxDevices];

cudaError_t wave(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_wave[dev];
  if (!slot.load()) {
    int fewest = 0;
    for (int stage : {DMA_RING, WIDEN, FRONT, FRONT_STD}) {
      const Kernel k = entry(stage);
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      int occ = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, THREADS,
                                                          SMEM);
      if (e != cudaSuccess) return e;
      fewest = stage == DMA_RING || occ < fewest ? occ : fewest;
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (fewest < 1) return cudaErrorInvalidConfiguration;
    slot.store(fewest * sms);
  }
  *blocks = slot.load();
  return cudaSuccess;
}

int launch(const void* x, void* out, int n, int stage, cudaStream_t s) {
  int blocks = 0;
  cudaError_t e = wave(&blocks);
  if (e != cudaSuccess) return (int)e;
  entry(stage)<<<blocks < n ? blocks : n, THREADS, SMEM, s>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace ring

bool ring_stage(int stage) {
  return stage == DMA_RING || stage == WIDEN || stage == FRONT ||
         stage == FRONT_STD;
}

}  // namespace

// x: (n, 48, 96) uint8, 16-byte aligned (overlap_b: n 4-byte words, one a
// block); out: n / frames_per_block values of 4 bytes (uint32 bits for dma
// and dma_ring, f32 for overlap_b) or of three f32 moments (the other
// stages), one a block of frames_per_block frames (the ladder's stages:
// one a frame). stage: 0 dma, 1 widen, 2 front, 3 front_std, 4 overlap_a,
// 5 overlap_b, 6 dma_ring; frames_per_block 1, 2 or 4 for dma, else 1;
// chain_a, chain_c: the chain's runtime 1 and 0.
// Returns the cudaError_t of the launch.
extern "C" int roi_front_probe(const void* x, void* out, int n, int stage,
                               int frames_per_block, float chain_a,
                               float chain_c, void* stream) {
  const int F = frames_per_block;
  if (n < 0 || stage < DMA || stage > DMA_RING ||
      (stage == DMA ? (F != 1 && F != 2 && F != 4) : F != 1) || n % F)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (ring_stage(stage)) return ring::launch(x, out, n, stage, s);
  const int blocks = n / F;
  switch (stage) {
    case DMA:
      return F == 1 ? launch<DMA, 1>(x, out, blocks, chain_a, chain_c, s)
           : F == 2 ? launch<DMA, 2>(x, out, blocks, chain_a, chain_c, s)
                    : launch<DMA, 4>(x, out, blocks, chain_a, chain_c, s);
    case OVERLAP_A:
      return launch<OVERLAP_A, 1>(x, out, blocks, chain_a, chain_c, s);
    default:
      return launch<OVERLAP_B, 1>(x, out, blocks, chain_a, chain_c, s);
  }
}

// the ladder's launch, every rung's, on the current card; out[0..4]: the
// blocks of one wave, ring slots, dynamic shared memory bytes a block,
// threads a block, the card's SMs. Returns the cudaError_t of the
// occupancy query.
extern "C" int roi_front_probe_plan(int* out) {
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t e = ring::wave(&blocks);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int fields[] = {blocks, ring::SLOTS, ring::SMEM, THREADS, sms};
  for (int i = 0; i < 5; ++i) out[i] = fields[i];
  return 0;
}
