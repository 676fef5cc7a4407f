// GRU sequence kernel for Hopper (sm_90a): one direction (or both) of one
// GRU layer over a padded batch, the whole time loop inside the block.
//
// Replaces the TPU kernel silent_speech_tpu/ops/pallas_gru.py::
// _gru_fusedproj_kernel (reached through gru_sequence_pallas /
// bigru_pallas). Same function, gate order r, z, n:
//
//   xp = x_t Wi + bi, hp = h Wh + bh          (Wi (D, 3H), Wh (H, 3H))
//   r = sig(xr + hr), z = sig(xz + hz), n = tanh(xn + r * hn)
//   h' = (1 - z) n + z h
//
// with h frozen for t >= len and y zero there. The reverse direction reads
// x at L-1-t and writes y there (for t < L), which equals flip_padded
// around a forward pass, without the two gathers.
//
// What bounds it on the H100: the weights. Wi and Wh are (D + H) x 3H f32,
// 0.93 MB for layer 0 (D=212, H=192) and 1.33 MB for layer 1 (D=384): far
// more than the 227 KB of shared memory a block can hold, so every step
// streams them again from L2 (50 MB, where they stay resident). The
// traffic per step is (blocks) x (weight bytes), which makes L2 bandwidth
// the bound at large batch; at batch 1 the bound is the latency of one
// block's dependent step chain.
//
// What the design does about it:
// - One block runs BT = 8 batch rows through all T steps; blocks run in no
//   order and carry nothing between them. The carry h lives in registers
//   and in shared memory (for the other threads' dot products).
// - Thread j owns hidden unit j of all three gates for all BT rows, so a
//   weight value fetched once (coalesced across j) feeds BT multiply-adds,
//   and the gate arithmetic needs no exchange between threads.
// - The input projection x_t Wi + bi is computed in the block each step:
//   no (B, T, 3H) tensor reaches device memory.
// - Both directions share one launch through blockIdx.y and write the two
//   halves of the (B, T, 2H) layer output directly.
// A thread-block cluster sharing h over distributed shared memory, or bf16
// weights, would cut the L2 traffic; both are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 8;  // batch rows per block

struct GruDir {
  const float* wi;  // (D, 3H)
  const float* bi;  // (3H,)
  const float* wh;  // (H, 3H)
  const float* bh;  // (3H,)
  int reverse;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// grid (ceil(B / BT), ndir), block H threads; dynamic shared memory
// BT * (D + H) floats. y is (B, T, ldy); direction k writes columns
// [k*H, k*H + H).
__global__ void gru_seq_kernel(const float* __restrict__ x,
                               const int* __restrict__ lengths, GruDir d0,
                               GruDir d1, float* __restrict__ y, int B, int T,
                               int D, int H, int ldy) {
  extern __shared__ float smem[];
  float* xs = smem;           // [BT][D]: this step's inputs
  float* hs = smem + BT * D;  // [BT][H]: the carry, read by every thread
  __shared__ int ls[BT];
  const GruDir d = blockIdx.y ? d1 : d0;
  const int j = threadIdx.x;
  const int H3 = 3 * H;
  const int b0 = blockIdx.x * BT;
  const int col = blockIdx.y * H + j;

  for (int b = j; b < BT; b += H)
    ls[b] = (b0 + b < B) ? min(max(lengths[b0 + b], 0), T) : 0;
  float h[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    h[b] = 0.f;
    hs[b * H + j] = 0.f;
  }
  const float bir = __ldg(d.bi + j), biz = __ldg(d.bi + H + j),
              bin = __ldg(d.bi + 2 * H + j);
  const float bhr = __ldg(d.bh + j), bhz = __ldg(d.bh + H + j),
              bhn = __ldg(d.bh + 2 * H + j);
  __syncthreads();
  int len[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) len[b] = ls[b];

  for (int t = 0; t < T; ++t) {
    for (int i = j; i < BT * D; i += H) {
      const int b = i / D, k = i - b * D;
      const int L = ls[b];
      float v = 0.f;
      if (t < L) {
        const int tt = d.reverse ? L - 1 - t : t;
        v = x[((size_t)(b0 + b) * T + tt) * D + k];
      }
      xs[i] = v;
    }
    __syncthreads();

    float xr[BT], xz[BT], xn[BT], hr[BT], hz[BT], hn[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b)
      xr[b] = xz[b] = xn[b] = hr[b] = hz[b] = hn[b] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float* w = d.wi + (size_t)k * H3 + j;
      const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float v = xs[b * D + k];
        xr[b] = fmaf(v, wr, xr[b]);
        xz[b] = fmaf(v, wz, xz[b]);
        xn[b] = fmaf(v, wn, xn[b]);
      }
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float* w = d.wh + (size_t)k * H3 + j;
      const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float v = hs[b * H + k];
        hr[b] = fmaf(v, wr, hr[b]);
        hz[b] = fmaf(v, wz, hz[b]);
        hn[b] = fmaf(v, wn, hn[b]);
      }
    }
    __syncthreads();  // every read of xs / hs for this step is done

#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float r = sigmoid((xr[b] + bir) + (hr[b] + bhr));
      const float z = sigmoid((xz[b] + biz) + (hz[b] + bhz));
      const float n = tanhf((xn[b] + bin) + r * (hn[b] + bhn));
      const float h_new = (1.f - z) * n + z * h[b];
      const bool valid = t < len[b];
      if (valid) h[b] = h_new;  // frozen past the end
      hs[b * H + j] = h[b];
      if (b0 + b < B) {
        const int tt = (valid && d.reverse) ? len[b] - 1 - t : t;
        y[((size_t)(b0 + b) * T + tt) * ldy + col] = valid ? h[b] : 0.f;
      }
    }
  }
}

}  // namespace

// x: (B, T, D) f32; lengths: (B,) int32; per direction k < ndir: wi (D, 3H),
// bi (3H,), wh (H, 3H), bh (3H,) f32 and a reverse flag; y: (B, T, ldy) f32
// with ldy >= ndir * H. All contiguous on the device. Returns the
// cudaError_t of the launch.
extern "C" int gru_seq_forward(const void* x, const void* lengths,
                               const void* wi0, const void* bi0,
                               const void* wh0, const void* bh0, int rev0,
                               const void* wi1, const void* bi1,
                               const void* wh1, const void* bh1, int rev1,
                               int ndir, void* y, int B, int T, int D, int H,
                               int ldy, void* stream) {
  if (ndir < 1 || ndir > 2 || H < 1 || H > 1024 || D < 1 || B < 0 || T < 0 ||
      ldy < ndir * H)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const size_t smem = (size_t)BT * (D + H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const GruDir d0 = {static_cast<const float*>(wi0),
                     static_cast<const float*>(bi0),
                     static_cast<const float*>(wh0),
                     static_cast<const float*>(bh0), rev0};
  const GruDir d1 = ndir > 1 ? GruDir{static_cast<const float*>(wi1),
                                      static_cast<const float*>(bi1),
                                      static_cast<const float*>(wh1),
                                      static_cast<const float*>(bh1), rev1}
                             : d0;
  const dim3 grid((B + BT - 1) / BT, ndir);
  gru_seq_kernel<<<grid, H, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(lengths), d0, d1,
      static_cast<float*>(y), B, T, D, H, ldy);
  return (int)cudaGetLastError();
}
