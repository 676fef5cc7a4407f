// The GRU design probes' kernels for Hopper (sm_90a): the alternatives the
// TPU design weighed for the GRU sequence kernel (csrc/gru_seq.cu, K2),
// each a kernel of its own so that the card can measure it.
//
// 1. gru_rec_kernel: one GRU direction's recurrence over a projection
//    xp = x Wi + bi computed outside the kernel. Replaces
//    scripts/proto_gru2.py::_gru_kstep_kernel (gru_sequence_kstep) and, with
//    two weight sets, ::_gru_kstep2w_kernel (gru_sequence_kstep_2w: the two
//    directions of a layer stacked along the batch). Rows [s*R, (s+1)*R)
//    take weight set s (R = rows_per_set); blockIdx.y is the set, so a block
//    never straddles two sets.
// 2. gru_dual_kernel: both directions of one layer in one block, as two
//    independent chains, the projections fused. Replaces
//    scripts/proto_gru4.py::_gru_dual_kernel (gru_layer_dual). It takes x
//    and x_flip (flip_padded(x)) and writes y_f and y_b, y_b in the flipped
//    order, as the TPU kernel does.
//
// The math is K2's, gate order r, z, n:
//   hp = h Wh + bh;  r = sig(xr + hr), z = sig(xz + hz), n = tanh(xn + r hn)
//   h' = (1 - z) n + z h, frozen at t >= len, y zero there.
// With BF16 the instantiations round with __float2bfloat16_rn exactly where
// the TPU kernels apply their `cast`: h and Wh in both (proto_gru2.py:54-57,
// proto_gru4.py:45-47), x and Wi in the dual kernel (proto_gru4.py:76-84).
// Products of bf16 values are exact in f32 and every sum is f32. The f32
// instantiations do not round anywhere.
//
// What bounds them on the H100. At B=512 the operations (about 2.7 GFLOP
// a direction for the recurrence at T=32, H=192) over 67 TFLOP/s of f32
// FMAs; at B=1 the latency of T dependent steps, each a 3H x H product whose
// weights stream from L2 in f32. The designs:
// - One block runs BT rows (template: rows per block, the port's
//   `batch_tile`) through the whole time loop; thread j owns hidden unit j
//   of all three gates for the block's rows (and, in the dual kernel, of
//   both chains), so a weight value fetched once feeds BT (or 2 BT)
//   multiply-adds and the gates need no exchange between threads. The carry
//   h is in registers and, for the other threads' products, in shared
//   memory.
// - K steps of input (the port's `k_steps`) are staged in shared memory at
//   a time: the loads of K steps are in flight together.
// - The bf16 recurrence kernel keeps Wh, rounded, in shared memory for the
//   whole sequence: at H=192 it is 221,184 bytes, which fits in one block's
//   227 KB beside a small stage (batch_tile * H * 4 + k_steps * batch_tile *
//   3H * 4 bytes); in f32 (442 KB) it does not, and the weights stream from
//   L2 every step as in K2. The dual kernel's two chains hold 2 (D + H) x 3H
//   weights, which fit in neither type: it reads them from L2 and, in bf16,
//   rounds each on the fly.
// - The dual kernel's thread interleaves the products and gate arithmetic
//   of two independent dependency chains (the forward and the backward
//   direction), the H100 counterpart of the TPU kernel's aim: one chain's
//   loads overlap the other's arithmetic.
// - A block stops at the longest length of its rows and writes zeros after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// one block's shared memory (232,448 bytes) less room for the static arrays
constexpr size_t kMaxSmem = 232448 - 128;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// The TPU kernels' cast: round to bf16 and back (identity in f32).
template <bool BF16>
__device__ __forceinline__ float cast(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// One hidden unit's GRU update from its input projection (xr, xz, xn) and
// recurrent projection (hr, hz, hn) = h Wh + bh. Every operation rounds on
// its own (nvcc would otherwise contract some into FMAs, differently in
// each instantiation), so the f32 result does not depend on the template.
__device__ __forceinline__ float gru_update(float xr, float xz, float xn,
                                           float hr, float hz, float hn,
                                           float h) {
  const float r = sigmoid(__fadd_rn(xr, hr));
  const float z = sigmoid(__fadd_rn(xz, hz));
  const float n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), n), __fmul_rn(z, h));
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// grid (ceil(R / BT), nsets), block H threads. Dynamic shared memory:
// [Wh rounded to bf16, H x 3H, BF16 only][hs: BT x H f32][xs: K x BT x 3H f32].
template <int BT, bool BF16>
__global__ void gru_rec_kernel(const float* __restrict__ xp,
                               const int* __restrict__ lengths,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               float* __restrict__ y, int R, int T, int H,
                               int K) {
  extern __shared__ __align__(16) unsigned char gp_smem[];
  __shared__ int ls[BT];
  const int H3 = 3 * H;
  const int j = threadIdx.x;
  const int r0 = blockIdx.x * BT;
  const int nrows = min(BT, R - r0);
  const size_t row0 = (size_t)blockIdx.y * R + r0;
  const float* w = wh + (size_t)blockIdx.y * H * H3;
  const float* bset = bh + (size_t)blockIdx.y * H3;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(gp_smem);
  float* hs = reinterpret_cast<float*>(
      gp_smem + (BF16 ? align16((size_t)H * H3 * sizeof(__nv_bfloat16)) : 0));
  float* xs = hs + BT * H;

  if constexpr (BF16) {
    for (int i = j; i < H * H3; i += H) ws[i] = __float2bfloat16_rn(__ldg(w + i));
  }
  for (int b = j; b < BT; b += H)
    ls[b] = b < nrows ? min(max(lengths[row0 + b], 0), T) : 0;
  float h[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    h[b] = 0.f;
    hs[b * H + j] = 0.f;
  }
  const float bhr = __ldg(bset + j), bhz = __ldg(bset + H + j),
              bhn = __ldg(bset + 2 * H + j);
  __syncthreads();
  int len[BT];
  int tmax = 0;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    len[b] = ls[b];
    tmax = max(tmax, len[b]);
  }

  for (int t0 = 0; t0 < tmax; t0 += K) {
    const int kn = min(K, tmax - t0);
    // Stage this thread's own columns (j, H + j, 2H + j) of kn steps: only
    // this thread reads them back, so no barrier is needed.
    for (int k = 0; k < kn; ++k) {
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (t0 + k < len[b]) {
          const float* s = xp + ((row0 + b) * T + t0 + k) * H3 + j;
          float* d = xs + (k * BT + b) * H3 + j;
          d[0] = __ldg(s);
          d[H] = __ldg(s + H);
          d[2 * H] = __ldg(s + 2 * H);
        }
      }
    }
    for (int k = 0; k < kn; ++k) {
      const int t = t0 + k;
      float hr[BT], hz[BT], hn[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) hr[b] = hz[b] = hn[b] = 0.f;
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        float wr, wz, wn;
        if constexpr (BF16) {
          const __nv_bfloat16* p = ws + i * H3 + j;
          wr = __bfloat162float(p[0]);
          wz = __bfloat162float(p[H]);
          wn = __bfloat162float(p[2 * H]);
        } else {
          const float* p = w + (size_t)i * H3 + j;
          wr = __ldg(p);
          wz = __ldg(p + H);
          wn = __ldg(p + 2 * H);
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float v = hs[b * H + i];
          hr[b] = fmaf(v, wr, hr[b]);
          hz[b] = fmaf(v, wz, hz[b]);
          hn[b] = fmaf(v, wn, hn[b]);
        }
      }
      __syncthreads();  // every read of hs for this step is done
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const bool valid = t < len[b];
        if (valid) {
          const float* xv = xs + (k * BT + b) * H3 + j;
          h[b] = gru_update(xv[0], xv[H], xv[2 * H], __fadd_rn(hr[b], bhr),
                            __fadd_rn(hz[b], bhz), __fadd_rn(hn[b], bhn),
                            h[b]);
        }
        hs[b * H + j] = cast<BF16>(h[b]);
        if (b < nrows) y[((row0 + b) * T + t) * H + j] = valid ? h[b] : 0.f;
      }
      __syncthreads();  // hs holds this step's carry
    }
  }
  for (int t = tmax; t < T; ++t)
    for (int b = 0; b < nrows; ++b) y[((row0 + b) * T + t) * H + j] = 0.f;
}

struct GruDir {
  const float* wi;  // (D, 3H)
  const float* bi;  // (3H,)
  const float* wh;  // (H, 3H)
  const float* bh;  // (3H,)
};

// grid ceil(B / BT), block H threads. Dynamic shared memory:
// [xs: 2 chains x K x BT x D f32][hs: 2 chains x BT x H f32].
template <int BT, bool BF16>
__global__ void gru_dual_kernel(const float* __restrict__ x,
                                const float* __restrict__ x_flip,
                                const int* __restrict__ lengths, GruDir df,
                                GruDir db, float* __restrict__ yf,
                                float* __restrict__ yb, int B, int T, int D,
                                int H, int K) {
  extern __shared__ __align__(16) unsigned char gp_smem[];
  __shared__ int ls[BT];
  float* xs = reinterpret_cast<float*>(gp_smem);
  float* hs = xs + 2 * K * BT * D;
  const int H3 = 3 * H;
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);

  for (int b = j; b < BT; b += H)
    ls[b] = b < nrows ? min(max(lengths[b0 + b], 0), T) : 0;
  float h[2][BT];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      h[c][b] = 0.f;
      hs[(c * BT + b) * H + j] = 0.f;
    }
  float bir[2], biz[2], bin[2], bhr[2], bhz[2], bhn[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const GruDir& d = c ? db : df;
    bir[c] = __ldg(d.bi + j);
    biz[c] = __ldg(d.bi + H + j);
    bin[c] = __ldg(d.bi + 2 * H + j);
    bhr[c] = __ldg(d.bh + j);
    bhz[c] = __ldg(d.bh + H + j);
    bhn[c] = __ldg(d.bh + 2 * H + j);
  }
  __syncthreads();
  int len[BT];
  int tmax = 0;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    len[b] = ls[b];
    tmax = max(tmax, len[b]);
  }

  for (int t0 = 0; t0 < tmax; t0 += K) {
    const int kn = min(K, tmax - t0);
    // Stage kn steps of both chains' inputs; every thread reads all of them.
    const int per_chain = kn * BT * D;
    for (int i = j; i < 2 * per_chain; i += H) {
      const int c = i / per_chain;
      const int rem = i - c * per_chain;
      const int kb = rem / D, e = rem - kb * D;
      const int k = kb / BT, b = kb - k * BT;
      float v = 0.f;
      if (t0 + k < ls[b])
        v = cast<BF16>(__ldg((c ? x_flip : x) +
                             ((size_t)(b0 + b) * T + t0 + k) * D + e));
      xs[((c * K + k) * BT + b) * D + e] = v;
    }
    __syncthreads();

    for (int k = 0; k < kn; ++k) {
      const int t = t0 + k;
      float axr[2][BT], axz[2][BT], axn[2][BT];
      float ahr[2][BT], ahz[2][BT], ahn[2][BT];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          axr[c][b] = axz[c][b] = axn[c][b] = ahr[c][b] = ahz[c][b] =
              ahn[c][b] = 0.f;
#pragma unroll 2
      for (int e = 0; e < D; ++e) {
        float wr[2], wz[2], wn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* p = (c ? db.wi : df.wi) + (size_t)e * H3 + j;
          wr[c] = cast<BF16>(__ldg(p));
          wz[c] = cast<BF16>(__ldg(p + H));
          wn[c] = cast<BF16>(__ldg(p + 2 * H));
        }
#pragma unroll
        for (int b = 0; b < BT; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = xs[((c * K + k) * BT + b) * D + e];
            axr[c][b] = fmaf(v, wr[c], axr[c][b]);
            axz[c][b] = fmaf(v, wz[c], axz[c][b]);
            axn[c][b] = fmaf(v, wn[c], axn[c][b]);
          }
      }
#pragma unroll 2
      for (int i = 0; i < H; ++i) {
        float wr[2], wz[2], wn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* p = (c ? db.wh : df.wh) + (size_t)i * H3 + j;
          wr[c] = cast<BF16>(__ldg(p));
          wz[c] = cast<BF16>(__ldg(p + H));
          wn[c] = cast<BF16>(__ldg(p + 2 * H));
        }
#pragma unroll
        for (int b = 0; b < BT; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = hs[(c * BT + b) * H + i];
            ahr[c][b] = fmaf(v, wr[c], ahr[c][b]);
            ahz[c][b] = fmaf(v, wz[c], ahz[c][b]);
            ahn[c][b] = fmaf(v, wn[c], ahn[c][b]);
          }
      }
      __syncthreads();  // every read of xs and hs for this step is done
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const bool valid = t < len[b];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (valid)
            h[c][b] = gru_update(
                __fadd_rn(axr[c][b], bir[c]), __fadd_rn(axz[c][b], biz[c]),
                __fadd_rn(axn[c][b], bin[c]), __fadd_rn(ahr[c][b], bhr[c]),
                __fadd_rn(ahz[c][b], bhz[c]), __fadd_rn(ahn[c][b], bhn[c]),
                h[c][b]);
          hs[(c * BT + b) * H + j] = cast<BF16>(h[c][b]);
          if (b < nrows)
            (c ? yb : yf)[((size_t)(b0 + b) * T + t) * H + j] =
                valid ? h[c][b] : 0.f;
        }
      }
      __syncthreads();  // hs holds this step's carries
    }
  }
  for (int t = tmax; t < T; ++t)
    for (int b = 0; b < nrows; ++b) {
      const size_t o = ((size_t)(b0 + b) * T + t) * H + j;
      yf[o] = 0.f;
      yb[o] = 0.f;
    }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t rec_smem(int bt, int H, int K, bool bf16) {
  return (bf16 ? align16((size_t)H * 3 * H * 2) : 0) +
         (size_t)bt * H * 4 + (size_t)K * bt * 3 * H * 4;
}

size_t dual_smem(int bt, int D, int H, int K) {
  return 2 * ((size_t)K * bt * D + (size_t)bt * H) * 4;
}

template <int BT, bool BF16>
int launch_rec(const float* xp, const int* lengths, const float* wh,
               const float* bh, float* y, int R, int S, int T, int H, int K,
               cudaStream_t stream) {
  const size_t smem = rec_smem(BT, H, K, BF16);
  cudaError_t e = allow_smem(gru_rec_kernel<BT, BF16>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + BT - 1) / BT, S);
  gru_rec_kernel<BT, BF16><<<grid, H, smem, stream>>>(xp, lengths, wh, bh, y,
                                                      R, T, H, K);
  return (int)cudaGetLastError();
}

template <bool BF16>
int rec_tile(int bt, const float* xp, const int* lengths, const float* wh,
             const float* bh, float* y, int R, int S, int T, int H, int K,
             cudaStream_t s) {
  switch (bt) {
    case 1: return launch_rec<1, BF16>(xp, lengths, wh, bh, y, R, S, T, H, K, s);
    case 2: return launch_rec<2, BF16>(xp, lengths, wh, bh, y, R, S, T, H, K, s);
    case 4: return launch_rec<4, BF16>(xp, lengths, wh, bh, y, R, S, T, H, K, s);
    case 8: return launch_rec<8, BF16>(xp, lengths, wh, bh, y, R, S, T, H, K, s);
    case 16: return launch_rec<16, BF16>(xp, lengths, wh, bh, y, R, S, T, H, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BT, bool BF16>
int launch_dual(const float* x, const float* xf, const int* lengths,
                const GruDir& df, const GruDir& db, float* yf, float* yb,
                int B, int T, int D, int H, int K, cudaStream_t stream) {
  const size_t smem = dual_smem(BT, D, H, K);
  cudaError_t e = allow_smem(gru_dual_kernel<BT, BF16>, smem);
  if (e != cudaSuccess) return (int)e;
  gru_dual_kernel<BT, BF16><<<(B + BT - 1) / BT, H, smem, stream>>>(
      x, xf, lengths, df, db, yf, yb, B, T, D, H, K);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dual_tile(int bt, const float* x, const float* xf, const int* lengths,
              const GruDir& df, const GruDir& db, float* yf, float* yb, int B,
              int T, int D, int H, int K, cudaStream_t s) {
  switch (bt) {
    case 1: return launch_dual<1, BF16>(x, xf, lengths, df, db, yf, yb, B, T, D, H, K, s);
    case 2: return launch_dual<2, BF16>(x, xf, lengths, df, db, yf, yb, B, T, D, H, K, s);
    case 4: return launch_dual<4, BF16>(x, xf, lengths, df, db, yf, yb, B, T, D, H, K, s);
    case 8: return launch_dual<8, BF16>(x, xf, lengths, df, db, yf, yb, B, T, D, H, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

GruDir make_dir(const void* wi, const void* bi, const void* wh,
                const void* bh) {
  return {static_cast<const float*>(wi), static_cast<const float*>(bi),
          static_cast<const float*>(wh), static_cast<const float*>(bh)};
}

}  // namespace

// xp: (nsets * R, T, 3H) f32; lengths: (nsets * R,) int32; wh: (nsets, H,
// 3H), bh: (nsets, 3H) f32; y: (nsets * R, T, H) f32. Row r takes weight
// set r / R. bt (rows per block) in {1, 2, 4, 8, 16}; k_steps >= 1 steps
// staged at a time. All contiguous on the device. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int gru_rec_forward(const void* xp, const void* lengths,
                               const void* wh, const void* bh, void* y,
                               int rows_per_set, int nsets, int T, int H,
                               int bt, int k_steps, int bf16, void* stream) {
  if (rows_per_set < 0 || nsets < 1 || T < 0 || H < 1 || H > 1024 ||
      k_steps < 1 || rec_smem(bt, H, k_steps, bf16) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (rows_per_set == 0 || T == 0) return 0;
  const auto* a = static_cast<const float*>(xp);
  const auto* l = static_cast<const int*>(lengths);
  const auto* w = static_cast<const float*>(wh);
  const auto* c = static_cast<const float*>(bh);
  auto* o = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? rec_tile<true>(bt, a, l, w, c, o, rows_per_set, nsets, T, H,
                               k_steps, s)
              : rec_tile<false>(bt, a, l, w, c, o, rows_per_set, nsets, T, H,
                                k_steps, s);
}

// x, x_flip: (B, T, D) f32; lengths: (B,) int32; per direction wi (D, 3H),
// bi (3H,), wh (H, 3H), bh (3H,) f32, forward then backward; y_f, y_b:
// (B, T, H) f32. bt in {1, 2, 4, 8}; k_steps >= 1. All contiguous on the
// device. Returns the cudaError_t of the launch.
extern "C" int gru_dual_forward(const void* x, const void* x_flip,
                                const void* lengths, const void* wif,
                                const void* bif, const void* whf,
                                const void* bhf, const void* wib,
                                const void* bib, const void* whb,
                                const void* bhb, void* y_f, void* y_b, int B,
                                int T, int D, int H, int bt, int k_steps,
                                int bf16, void* stream) {
  if (B < 0 || T < 0 || D < 1 || H < 1 || H > 1024 || k_steps < 1 ||
      dual_smem(bt, D, H, k_steps) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const GruDir df = make_dir(wif, bif, whf, bhf);
  const GruDir db = make_dir(wib, bib, whb, bhb);
  const auto* a = static_cast<const float*>(x);
  const auto* af = static_cast<const float*>(x_flip);
  const auto* l = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(y_f);
  auto* ob = static_cast<float*>(y_b);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dual_tile<true>(bt, a, af, l, df, db, of, ob, B, T, D, H,
                                k_steps, s)
              : dual_tile<false>(bt, a, af, l, df, db, of, ob, B, T, D, H,
                                 k_steps, s);
}
