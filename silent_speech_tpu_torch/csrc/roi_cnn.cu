// Fused TinyROICNN forward for Hopper (sm_90a).
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn2.py::
// _roi_fused_kernel (served as variant 'tiled3', reached through
// roi_cnn_fused). It computes the same function:
//
//   (N, 48, 96) uint8 -> /255 (f32) -> optional per-frame standardize
//   (ddof=1, std >= 1e-6) -> conv3x3 SAME 1->8 + b, ReLU, maxpool 2
//   -> conv 8->16, ReLU, pool 2 -> conv 16->24, ReLU -> mean over 12x24
//   -> fc 24->emb -> (N, emb) f32.
//
// What bounds it on the H100: arithmetic. A frame costs about 2.65 M f32
// multiply-adds and brings only 4,608 input bytes, so the kernel is bound
// by the f32 FMA rate of the CUDA cores, not by device memory.
//
// What the design does about it:
// - One block of 288 threads holds one frame for the whole network. The
//   input is read once with one 16-byte load per thread; every activation
//   stays in shared memory (about 64 KB with halos, dynamic shared memory
//   above the 48 KB default); only (N, emb) f32 goes back to device memory.
// - conv1 is fused with its ReLU and pool, and conv2 likewise, so only the
//   pooled maps are stored; conv3 + ReLU is summed straight into the
//   24-channel mean.
// - The weights (plain OIHW f32, ~22 KB) sit in the constant bank. The
//   loops over output and input channels and taps are unrolled, so every
//   weight is a compile-time constant-bank operand of its FMA: the inner
//   loops issue no load for weights, only shared-memory loads of inputs.
//   (Passing them instead as a 25 KB __grid_constant__ launch parameter,
//   with the same registers and no spills, ran 13% slower at 8192 frames.)
// - The TPU kernel's h-mod-4 parity packing and packed weight matrices
//   exist for the TPU's 128-lane layout and are not carried over.
//
// The bf16 build (roi_cnn_bf16_forward) replaces the same TPU kernel with
// compute_dtype=bfloat16. It is the same code instantiated with bf16
// activations in shared memory (33 KB instead of 64 KB) and bf16-valued
// conv weights in the bank, rounded on the host. A bf16 x bf16 product is
// exact in f32, so f32 FMAs over bf16 values compute what the TPU's bf16
// dot with f32 accumulation computes; the kernel rounds where the Pallas
// kernel does (pallas_cnn2.py:436, :492-501, :557, :573): the scaled input
// (x * (1/255), standardized when asked); the pooled conv1 sum, then that
// plus bf16(b1) (pre-rounded in the bank) in bf16 before the ReLU; conv2's
// pooled sum + b2 after the ReLU. conv3, its bias, ReLU, the mean and the
// fc stay f32. Its bound is the bf16 tensor-core rate: these CUDA-core FMAs
// are the simple first version.
//
// The debug stops (roi_cnn_debug_forward) replace the TPU kernel's
// perf-debug knob _DEBUG_STOP_AFTER (pallas_cnn2.py:78, used at :427 load,
// :437 norm, :503 conv1, :575 conv2, :632 conv3), a module global there and
// the template parameter STOP here: the f32 kernel truncated after a stage,
// each row of the output holding three moments of what that stage computed
// (load: the scaled input; norm: the haloed image, standardized when
// asked; conv1, conv2: the pooled maps with their halos; conv3: the ReLU
// outputs), entry j the moment j % 3: the sum, the sum of squares and the
// sum weighted by (i % 31), i the value's index in the stage's buffer, so
// that a wrong scale or a misplaced store shows. STOP_NONE is the serving
// kernel, unchanged.
//
// The constant bank is one per device, so both builds order their
// launches: under a host mutex the launch copies the weights into the bank
// on the caller's stream, launches, and records an event; a launch on
// another stream first waits for that event. Launches with different
// weights on any streams or host threads therefore never read each other's
// weights; K1 launches on different streams run one after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int H0 = 48, W0 = 96;    // input frame
constexpr int C1 = 8, C2 = 16, C3 = 24;
constexpr int H1 = 24, W1 = 48;    // after pool 1
constexpr int H2 = 12, W2 = 24;    // after pool 2
constexpr int MAX_EMB = 64;
constexpr int THREADS = H2 * W2;   // 288: one stage-2/3 position per thread
constexpr int NWARPS = THREADS / 32;
static_assert(H0 * W0 == THREADS * 16, "one 16-byte load per thread");
static_assert((H1 * W1) % THREADS == 0, "stage-1 positions per thread");

// zero-haloed shared buffers (activation elements, f32 or bf16)
constexpr int XP_W = W0 + 2, XP_SIZE = (H0 + 2) * XP_W;          // input
constexpr int P1_W = W1 + 2, P1_PLANE = (H1 + 2) * P1_W;         // pool 1
constexpr int P1_SIZE = C1 * P1_PLANE;
constexpr int P2_W = W2 + 2, P2_PLANE = (H2 + 2) * P2_W;         // pool 2
constexpr int P2_SIZE = C2 * P2_PLANE;
constexpr int U_SIZE = XP_SIZE > P2_SIZE ? XP_SIZE : P2_SIZE;    // xp / p2
constexpr int RED_SIZE = NWARPS * C3 + C3;  // floats
static_assert((P1_SIZE + U_SIZE) % 2 == 0, "red stays 4-byte aligned");
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(P1_SIZE + U_SIZE) * sizeof(T) + (size_t)RED_SIZE * 4;
}

// activation storage: f32, or bf16 rounded to nearest even
template <typename T> struct Act;
template <> struct Act<float> {
  static __device__ __forceinline__ float st(float v) { return v; }
  static __device__ __forceinline__ float ld(float v) { return v; }
};
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 st(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float ld(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// weight offsets in the constant bank: OIHW convs, then fc (emb, 24), fc b
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + C1 * 9;
constexpr int OFF_W2 = OFF_B1 + C1;
constexpr int OFF_B2 = OFF_W2 + C2 * C1 * 9;
constexpr int OFF_W3 = OFF_B2 + C2;
constexpr int OFF_B3 = OFF_W3 + C3 * C2 * 9;
constexpr int OFF_FC = OFF_B3 + C3;
constexpr int MAX_WEIGHTS = OFF_FC + MAX_EMB * C3 + MAX_EMB;

__constant__ float c_w[MAX_WEIGHTS];

// the last launch on each device: its stream and an event recorded after it
constexpr int MAX_DEVICES = 64;
struct LastLaunch {
  cudaStream_t stream = nullptr;
  cudaEvent_t done = nullptr;
  bool any = false;
};
std::mutex g_mu;
LastLaunch g_last[MAX_DEVICES];

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, the same value returned to every thread.
// `red` holds NWARPS + 1 floats; the sum order is fixed (deterministic).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w];
    red[NWARPS] = s;
  }
  __syncthreads();
  const float s = red[NWARPS];
  __syncthreads();  // red may be reused right after
  return s;
}

// debug stops: after the input load and scaling, the haloed image, each
// conv stage (STOP_NONE: the whole network)
enum Stop { STOP_NONE = 0, STOP_LOAD = 1, STOP_NORM = 2, STOP_CONV1 = 3,
            STOP_CONV2 = 4, STOP_CONV3 = 5 };

// a debug stop's moments of its values: the sum, the sum of squares and
// the sum weighted by the value's index i in the stage's buffer, i % 31
// (31 divides none of the buffers' strides)
constexpr int POS_PERIOD = 31;
struct Moments {
  float s = 0.f, s2 = 0.f, sp = 0.f;
  __device__ __forceinline__ void add(float v, int i) {
    s += v;
    s2 = fmaf(v, v, s2);
    sp = fmaf((float)(i % POS_PERIOD), v, sp);
  }
};

// a debug stop's output: the frame's moment j % 3 in entry j of its row
__device__ void write_stop(float* out, size_t n, int emb, Moments m,
                           float* red) {
  const float t[3] = {block_sum(m.s, red), block_sum(m.s2, red),
                      block_sum(m.sp, red)};
  if ((int)threadIdx.x < emb) out[n * emb + threadIdx.x] = t[threadIdx.x % 3];
}

template <typename T, int STOP = STOP_NONE>
__global__ void __launch_bounds__(THREADS)
roi_cnn_kernel(const uint8_t* __restrict__ roi, float* __restrict__ out,
               int emb, int standardize) {
  constexpr bool BF16 = sizeof(T) == 2;
  using A = Act<T>;
  extern __shared__ float4 smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* p1 = smem;                     // [C1][H1+2][W1+2]
  T* xp = smem + P1_SIZE;           // [H0+2][W0+2], stage 1 only
  T* p2 = xp;                       // [C2][H2+2][W2+2], reuses xp
  float* red = reinterpret_cast<float*>(xp + U_SIZE);  // [NWARPS][C3], [C3]
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;

  if constexpr (STOP != STOP_LOAD)  // the load stop writes no image
    for (int i = tid; i < P1_SIZE + XP_SIZE; i += THREADS) smem[i] = A::st(0.f);

  // ---- input: 16 consecutive pixels of one row per thread, scaled in f32
  // (the bf16 build multiplies by the rounded 1/255, as the Pallas kernel)
  float v[16];
  {
    const uint4 q = reinterpret_cast<const uint4*>(roi + n * (H0 * W0))[tid];
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float b = (float)((words[k >> 2] >> (8 * (k & 3))) & 0xffu);
      v[k] = BF16 ? b * (1.0f / 255.0f) : b / 255.0f;
    }
  }
  if constexpr (STOP == STOP_LOAD) {  // i: the pixel's index in the frame
    Moments m;
#pragma unroll
    for (int k = 0; k < 16; ++k) m.add(v[k], tid * 16 + k);
    write_stop(out, n, emb, m, red);
    return;
  }
  if (standardize) {  // two passes, as standardize_frames: mean, then var
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) s += v[k];
    const float mu = block_sum(s, red) / (float)(H0 * W0);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) ss += (v[k] - mu) * (v[k] - mu);
    const float var = block_sum(ss, red) / (float)(H0 * W0 - 1);
    const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-6f);
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = (v[k] - mu) / sd;
  }
  __syncthreads();  // zero fill done before the interior is written
  {
    const int y = (tid * 16) / W0, x0 = (tid * 16) % W0;
#pragma unroll
    for (int k = 0; k < 16; ++k) xp[(y + 1) * XP_W + x0 + 1 + k] = A::st(v[k]);
  }
  __syncthreads();
  if constexpr (STOP == STOP_NORM) {
    Moments m;
    for (int i = tid; i < XP_SIZE; i += THREADS) m.add(A::ld(xp[i]), i);
    write_stop(out, n, emb, m, red);
    return;
  }

  // ---- stage 1: conv1 + ReLU + pool, one pooled position per iteration.
  // relu(max_i(s_i) + b) == max_i(relu(s_i + b)) exactly (monotone rounding)
  for (int i = tid; i < H1 * W1; i += THREADS) {
    const int py = i / W1, px = i % W1;
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        a[r][c] = A::ld(xp[(2 * py + r) * XP_W + 2 * px + c]);
#pragma unroll
    for (int co = 0; co < C1; ++co) {
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          float s = 0.f;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              s = fmaf(c_w[OFF_W1 + co * 9 + ky * 3 + kx], a[dy + ky][dx + kx], s);
          m = fmaxf(m, s);
        }
      float c;
      if constexpr (BF16)  // round the pooled sum, add bf16(b1) in bf16
        c = A::ld(A::st(A::ld(A::st(m)) + c_w[OFF_B1 + co]));
      else
        c = m + c_w[OFF_B1 + co];
      p1[co * P1_PLANE + (py + 1) * P1_W + px + 1] = A::st(fmaxf(c, 0.f));
    }
  }
  __syncthreads();
  if constexpr (STOP == STOP_CONV1) {
    Moments m;
    for (int i = tid; i < P1_SIZE; i += THREADS) m.add(A::ld(p1[i]), i);
    write_stop(out, n, emb, m, red);
    return;
  }
  for (int i = tid; i < P2_SIZE; i += THREADS) p2[i] = A::st(0.f);  // xp dead
  __syncthreads();

  const int py = tid / W2, px = tid % W2;  // stage 2 and 3 position

  // ---- stage 2: conv2 + ReLU + pool; this thread's pooled position
  {
    float m[C2];
#pragma unroll
    for (int co = 0; co < C2; ++co) m[co] = -INFINITY;
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      const int y = 2 * py + (d >> 1), x = 2 * px + (d & 1);
      float acc[C2];
#pragma unroll
      for (int co = 0; co < C2; ++co) acc[co] = 0.f;
#pragma unroll
      for (int ci = 0; ci < C1; ++ci) {
        float a[9];
#pragma unroll
        for (int k = 0; k < 9; ++k)
          a[k] = A::ld(p1[ci * P1_PLANE + (y + k / 3) * P1_W + x + k % 3]);
#pragma unroll
        for (int co = 0; co < C2; ++co)
#pragma unroll
          for (int k = 0; k < 9; ++k)
            acc[co] = fmaf(c_w[OFF_W2 + (co * C1 + ci) * 9 + k], a[k], acc[co]);
      }
#pragma unroll
      for (int co = 0; co < C2; ++co) m[co] = fmaxf(m[co], acc[co]);
    }
#pragma unroll
    for (int co = 0; co < C2; ++co)
      p2[co * P2_PLANE + (py + 1) * P2_W + px + 1] =
          A::st(fmaxf(m[co] + c_w[OFF_B2 + co], 0.f));
  }
  __syncthreads();
  if constexpr (STOP == STOP_CONV2) {
    Moments m;
    for (int i = tid; i < P2_SIZE; i += THREADS) m.add(A::ld(p2[i]), i);
    write_stop(out, n, emb, m, red);
    return;
  }

  // ---- stage 3: conv3 + ReLU at this thread's position, summed for the mean
  float acc[C3];
#pragma unroll
  for (int co = 0; co < C3; ++co) acc[co] = 0.f;
#pragma unroll
  for (int ci = 0; ci < C2; ++ci) {
    float a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      a[k] = A::ld(p2[ci * P2_PLANE + (py + k / 3) * P2_W + px + k % 3]);
#pragma unroll
    for (int co = 0; co < C3; ++co)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        acc[co] = fmaf(c_w[OFF_W3 + (co * C2 + ci) * 9 + k], a[k], acc[co]);
  }
  if constexpr (STOP == STOP_CONV3) {  // i: co * 288 + tid, CHW order
    Moments m;
#pragma unroll
    for (int co = 0; co < C3; ++co)
      m.add(fmaxf(acc[co] + c_w[OFF_B3 + co], 0.f), co * THREADS + tid);
    write_stop(out, n, emb, m, red);
    return;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int co = 0; co < C3; ++co) {
    const float s = warp_sum(fmaxf(acc[co] + c_w[OFF_B3 + co], 0.f));
    if (lane == 0) red[warp * C3 + co] = s;
  }
  __syncthreads();
  float* mean = red + NWARPS * C3;
  if (tid < C3) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * C3 + tid];
    mean[tid] = s / (float)(H2 * W2);
  }
  __syncthreads();

  // ---- fc 24 -> emb (torch layout: weight (emb, 24))
  if (tid < emb) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C3; ++c) s = fmaf(mean[c], c_w[OFF_FC + tid * C3 + c], s);
    out[n * emb + tid] = s + c_w[OFF_FC + emb * C3 + tid];
  }
}

// Launch roi_cnn_kernel<T> on stream s after copying the weights into the
// constant bank, ordered against the last launch of either build (see the
// note at the top). Returns the first failing cudaError_t.
template <typename T, int STOP = STOP_NONE>
int launch(const void* roi, const void* weights, void* out, int n, int emb,
           int standardize, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  LastLaunch& last = g_last[dev];
  if (last.done == nullptr) {
    e = cudaEventCreateWithFlags(&last.done, cudaEventDisableTiming);
    if (e != cudaSuccess) return (int)e;
  }
  if (last.any && last.stream != s) {  // that launch may still read c_w
    e = cudaStreamWaitEvent(s, last.done, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t nw = (size_t)OFF_FC + (size_t)emb * C3 + emb;
  e = cudaMemcpyToSymbolAsync(c_w, weights, nw * sizeof(float), 0,
                              cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  constexpr size_t smem = smem_bytes<T>();
  e = cudaFuncSetAttribute(roi_cnn_kernel<T, STOP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  roi_cnn_kernel<T, STOP><<<n, THREADS, smem, s>>>(
      static_cast<const uint8_t*>(roi), static_cast<float*>(out), emb,
      standardize);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaEventRecord(last.done, s);
  if (e != cudaSuccess) return (int)e;
  last.stream = s;
  last.any = true;
  return 0;
}

}  // namespace

// roi: (n, 48, 96) uint8, 16-byte aligned; weights: one f32 buffer on the
// device holding conv1 w (8,1,3,3), b (8), conv2 w (16,8,3,3), b (16),
// conv3 w (24,16,3,3), b (24), fc w (emb,24), fc b (emb), in that order;
// out: (n, emb) f32. Returns the first failing cudaError_t, else that of
// the launch.
extern "C" int roi_cnn_forward(const void* roi, const void* weights, void* out,
                               int n, int emb, int standardize, void* stream) {
  return launch<float>(roi, weights, out, n, emb, standardize, stream);
}

// The bf16 build: the same arguments, with the three convs' weights and b1
// already rounded to bf16 in the f32 buffer (cuda_cnn.flat_weights_bf16).
extern "C" int roi_cnn_bf16_forward(const void* roi, const void* weights,
                                    void* out, int n, int emb,
                                    int standardize, void* stream) {
  return launch<__nv_bfloat16>(roi, weights, out, n, emb, standardize,
                               stream);
}

// The f32 kernel truncated after a stage (the TPU kernel's
// _DEBUG_STOP_AFTER): the arguments of roi_cnn_forward and stop = 1 load,
// 2 norm, 3 conv1, 4 conv2, 5 conv3; out (n, emb): entry j of a frame's row
// holds the stage's moment j % 3 (sum, sum of squares, index-weighted sum).
extern "C" int roi_cnn_debug_forward(const void* roi, const void* weights,
                                     void* out, int n, int emb,
                                     int standardize, int stop, void* stream) {
  switch (stop) {
    case STOP_LOAD:
      return launch<float, STOP_LOAD>(roi, weights, out, n, emb, standardize,
                                      stream);
    case STOP_NORM:
      return launch<float, STOP_NORM>(roi, weights, out, n, emb, standardize,
                                      stream);
    case STOP_CONV1:
      return launch<float, STOP_CONV1>(roi, weights, out, n, emb, standardize,
                                       stream);
    case STOP_CONV2:
      return launch<float, STOP_CONV2>(roi, weights, out, n, emb, standardize,
                                       stream);
    case STOP_CONV3:
      return launch<float, STOP_CONV3>(roi, weights, out, n, emb, standardize,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
