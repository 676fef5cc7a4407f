// Fused TinyROICNN forward for Hopper (sm_90a): conv2 and conv3 on the
// tensor cores.
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_cnn2.py::
// _roi_fused_kernel (served as variant 'tiled3', reached through
// roi_cnn_fused, :1018). It computes the same function:
//
//   (N, 48, 96) uint8 -> /255 (f32) -> optional per-frame standardize
//   (ddof=1, std >= 1e-6) -> conv3x3 SAME 1->8 + b, ReLU, maxpool 2
//   -> conv 8->16, ReLU, pool 2 -> conv 16->24, ReLU -> mean over 12x24
//   -> fc 24->emb -> (N, emb) f32.
//
// What bounds it on the H100: arithmetic. A frame costs 2.65 M
// multiply-adds (conv1 0.33 M, conv2 1.33 M, conv3 1.00 M) and brings only
// 4,608 input bytes. 88% of the work, conv2 and conv3, is GEMM-shaped and
// runs on the tensor cores; conv1 (K = 9 taps, fits no MMA depth) runs on
// the CUDA cores.
//
// The design (the per-frame stages are in roi_cnn_stages.cuh, which the
// weight-gradient kernel roi_cnn_bwd.cu runs too):
// - Persistent blocks. The grid is one wave of resident blocks
//   (roi_cnn_plan: cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs,
//   asked of the card once per device and build; the builds aim at 2 (f32)
//   and 3 (bf16) blocks an SM, so that one block's CUDA-core stage
//   overlaps another's tensor-core stage). Each block of 288 threads (9
//   warps) packs the weights from the flat f32 buffer into shared memory
//   once, zeroes its haloed buffers once, then walks frames n = blockIdx.x,
//   + gridDim.x, ... Every frame is computed the same way whichever block
//   takes it, so a frame's output is bitwise the same for any N and batch
//   position.
// - Input: each thread copies its 16 bytes of the next frame into shared
//   memory with cp.async while the current frame computes; /255 and the
//   two-pass standardization as before, into a haloed image.
// - conv1 (1->8) on the CUDA cores: 2 adjacent pooled positions an
//   iteration, ReLU and the 2x2 pool fused, the 80 weights read from
//   shared memory as broadcasts, each load serving both positions. The
//   pooled map is stored channels-last, (26, 50) haloed pixels of 8
//   channels, so that an MMA fragment's row is 8 or 16 contiguous bytes of
//   one pixel.
// - conv2 (M 1,152 x K 72 x N 16) and conv3 (M 288 x K 144 x N 24) are
//   implicit GEMMs on mma.sync. An M tile is 2 image rows x 8 columns, so a
//   thread's two accumulator rows (g, g+8) are vertically adjacent and the
//   horizontal neighbour sits in lane ^ 4: conv2's 2x2 pool is one fmaxf
//   and one shuffle, and only pooled maps reach shared memory
//   (relu(max(s) + b) == max(relu(s + b))). A K tile is one tap's channels;
//   its k slots map to channels so that a thread's A values of one pixel
//   are adjacent (one 8- or 16-byte load, no bank conflicts: the 8 rows of
//   a fragment are 8 consecutive pixels). conv2's 72 M tiles are 8 a warp,
//   4 (bf16: 2) at a time sharing each B load; conv3's 18 are 2 a warp.
// - f32 build: m16n8k8 TF32 as 3xTF32. Each operand x is split as hi =
//   rna_tf32(x), lo = rna_tf32(x - hi) (rounded as cvt.rna.tf32.f32
//   rounds; see tf32() below), and a product is hi*hi + hi*lo + lo*hi
//   with f32 accumulation (x - hi - lo is below 2^-22 |x|, the lo*lo term
//   below 2^-22 of the product): f32 accuracy on the TF32 units. The split
//   is made as a fragment is loaded, not stored as hi and lo planes: the
//   planes would double p1, p2 and the packed weights (to about 146 KB a
//   block) and allow one block an SM, where the f32 planes (107 KB) allow
//   two.
// - conv3, its bias and ReLU are summed straight into the 24 channel sums
//   in a fixed order (a thread's rows and tiles, then lanes, then warps);
//   the mean and the fc follow.
//
// The bf16 build (roi_cnn_bf16_forward) replaces the same TPU kernel with
// compute_dtype=bfloat16: bf16 activations in shared memory, conv2 on
// m16n8k16 (taps in pairs) plus one m16n8k8 (tap 8) and conv3 on m16n8k16
// (one tap a K tile), bf16 x bf16 products (exact in f32) with f32
// accumulation: the TPU's bf16 dot up to the order of the sum. It rounds
// where the Pallas kernel does (pallas_cnn2.py:436, :492-501, :557, :573):
// the scaled input (x * (1/255), standardized when asked); the pooled conv1
// sum, then that plus bf16(b1) (pre-rounded in the buffer) in bf16 before
// the ReLU; conv2's pooled sum + b2 after the ReLU. conv3, its bias, ReLU,
// the mean and the fc stay f32. The buffer's conv weights are bf16 values
// already (cuda_cnn.flat_weights_bf16), so packing them is exact.
//
// The debug stops (roi_cnn_debug_forward) replace the TPU kernel's
// perf-debug knob _DEBUG_STOP_AFTER (pallas_cnn2.py:78, used at :427 load,
// :437 norm, :503 conv1, :575 conv2, :632 conv3), a module global there and
// the template parameter STOP here: the f32 kernel truncated after a stage,
// each row of the output holding three moments of what that stage computed
// (load: the scaled input; norm: the haloed image, standardized when
// asked; conv1, conv2: the pooled maps with their halos; conv3: the ReLU
// outputs), entry j the moment j % 3: the sum, the sum of squares and the
// sum weighted by (i % 31), i the value's index in the plain version's
// order (CHW with halos, whatever this kernel's layout), so that a wrong
// scale or a misplaced store shows. STOP_NONE is the serving kernel.
//
// The weights travel as a kernel argument and each block reads them once:
// launches with different weights on any streams run concurrently.

#include "roi_cnn_stages.cuh"

namespace {

// debug stops: after the input load and scaling, the haloed image, each
// conv stage (STOP_NONE: the whole network)
enum Stop { STOP_NONE = 0, STOP_LOAD = 1, STOP_NORM = 2, STOP_CONV1 = 3,
            STOP_CONV2 = 4, STOP_CONV3 = 5 };

template <typename T, int STOP = STOP_NONE>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
roi_cnn_kernel(const uint8_t* __restrict__ roi, const float* __restrict__ w,
               float* __restrict__ out, int n_frames, int emb,
               int standardize) {
  using S = Smem<T>;
  using A = Act<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* raw = reinterpret_cast<uint4*>(smem + S::RAW);
  const T* xp = reinterpret_cast<const T*>(smem + S::XP);
  const T* p1 = reinterpret_cast<const T*>(smem + S::P1);
  const T* p2 = reinterpret_cast<const T*>(smem + S::P2);
  const float* b3 = reinterpret_cast<const float*>(smem + S::BIAS) + C2;
  float* red = reinterpret_cast<float*>(smem + S::RED);
  const float* mean = reinterpret_cast<const float*>(smem + S::MEAN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the first frame's bytes arrive while the block zeroes its haloed
  // buffers (from here on only their interiors are written) and packs the
  // weights
  cp_async16(raw + tid, roi + (size_t)blockIdx.x * FRAME + 16 * tid);
  for (int i = tid; i < (int)((S::W1S - S::XP) / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem + S::XP)[i] = make_uint4(0, 0, 0, 0);
  pack_weights<T>(w, smem);
  __syncthreads();

#pragma unroll 1
  for (int n = blockIdx.x; n < n_frames; n += gridDim.x) {
    const int next = n + gridDim.x;
    // ---- input: this thread's 16 pixels, scaled, standardized when asked
    float v[16];
    load_frame<T>(smem, v);
    if constexpr (STOP == STOP_LOAD) {  // i: the pixel's index in the frame
      Moments m;
#pragma unroll
      for (int k = 0; k < 16; ++k) m.add(v[k], tid * 16 + k);
      write_stop(out, n, emb, m, red);  // its barriers: raw[tid] was read
      if (next < n_frames)
        cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);
      continue;
    }
    normalize_store<T>(smem, v, standardize);
    __syncthreads();
    // every thread has read its bytes of frame n: fetch the next frame's
    if (next < n_frames)
      cp_async16(raw + tid, roi + (size_t)next * FRAME + 16 * tid);
    if constexpr (STOP == STOP_NORM) {
      Moments m;
      for (int i = tid; i < XP_SIZE; i += THREADS) m.add(A::ld(xp[i]), i);
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv1 + ReLU + pool on the CUDA cores
    conv1_stage<T>(smem);
    __syncthreads();
    if constexpr (STOP == STOP_CONV1) {  // i: CHW with halos
      Moments m;
      for (int e = tid; e < P1_PIX * C1; e += THREADS)
        m.add(A::ld(p1[e]), (e % C1) * P1_PIX + e / C1);
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv2 + ReLU + pool on the tensor cores
    conv2_stage<T>(smem, warp, lane);
    __syncthreads();
    if constexpr (STOP == STOP_CONV2) {  // i: CHW with halos
      Moments m;
      for (int e = tid; e < P2_PIX * C2; e += THREADS)
        m.add(A::ld(p2[e]), p2_chan(e % C2) * P2_PIX + e / C2);
      write_stop(out, n, emb, m, red);
      continue;
    }

    // ---- conv3 + ReLU on the tensor cores, summed for the mean
    float acc[2][3][4];
    conv3_stage<T>(smem, warp, lane, acc);
    if constexpr (STOP == STOP_CONV3) {  // i: co * 288 + y * 24 + x, CHW
      Moments m;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mt = warp + NWARPS * mi;
        const int y0 = 2 * (mt / M3_COLS), x = 8 * (mt % M3_COLS) + g;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int co = 8 * nt + 2 * t + (r & 1), y = y0 + (r >> 1);
            m.add(fmaxf(acc[mi][nt][r] + b3[co], 0.f),
                  co * (H2 * W2) + y * W2 + x);
          }
      }
      write_stop(out, n, emb, m, red);
      continue;
    }
    conv3_means<T>(smem, warp, lane, acc);

    // ---- fc 24 -> emb (torch layout: weight (emb, 24)), from the buffer
    if (tid < emb) {
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < C3; ++c)
        z = fmaf(mean[c], __ldg(w + OFF_FC + tid * C3 + c), z);
      out[(size_t)n * emb + tid] = z + __ldg(w + OFF_FC + emb * C3 + tid);
    }
  }
  cp_async_wait_all();
}

template <typename T, int STOP> struct Tag {};

// The plan of roi_cnn_kernel<T, STOP> on the current device.
template <typename T, int STOP>
cudaError_t get_plan(Plan* p) {
  return plan_for<Tag<T, STOP>>((const void*)roi_cnn_kernel<T, STOP>,
                                (int)Smem<T>::BYTES, p);
}

// Launch roi_cnn_kernel<T, STOP> on stream s over min(n, one wave) blocks.
// Returns the first failing cudaError_t.
template <typename T, int STOP = STOP_NONE>
int launch(const void* roi, const void* weights, void* out, int n, int emb,
           int standardize, void* stream) {
  if (emb < 1 || emb > MAX_EMB || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Plan p;
  cudaError_t e = get_plan<T, STOP>(&p);
  if (e != cudaSuccess) return (int)e;
  const int grid = n < p.wave ? n : p.wave;
  roi_cnn_kernel<T, STOP><<<grid, THREADS, p.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(roi), static_cast<const float*>(weights),
      static_cast<float*>(out), n, emb, standardize);
  return (int)cudaGetLastError();
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

// The launch of the serving kernel (bf16 = 0: f32 build, 1: bf16 build) on
// the current device: out[0..4] = threads a block, dynamic shared memory
// bytes a block, blocks resident an SM, SMs, and the wave (the grid of any
// launch of at least that many frames; smaller launches take one block a
// frame). Returns the first failing cudaError_t.
extern "C" int roi_cnn_plan(int bf16, int* out) {
  Plan p;
  const cudaError_t e = bf16 ? get_plan<__nv_bfloat16, STOP_NONE>(&p)
                             : get_plan<float, STOP_NONE>(&p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.sms;
  out[4] = p.wave;
  return 0;
}
