// Backward-dot rate probes for Hopper (sm_90a): the weight-gradient form
// dW = sum of p_g^T dy_g over row tiles g, and the products beside it, f32
// in and f32 sums.
//
// Replaces the four pallas_calls of the backward-dot probes:
//   bwd_dot_tt  scripts/proto_bwd_dots.py:51 (run_tt, _kernel_tt :24),
//               scripts/proto_bwd_dots2.py:60 (_make with _k_tt :36) and
//               scripts/proto_bwd_dots3.py:44 (_make with _k_tt :30):
//               out (K, N) = sum over steps s < S of p_g^T dy_g, g = s % G,
//               p_g and dy_g rows [g m, g m + m) of p (rows, K) and
//               dy (rows, N); rows past G m are not read (run_tt's
//               G = rows // m drops them);
//   bwd_dot_xp  proto_bwd_dots2.py:60 with _k_xp (:44): the same function,
//               with the p chunk written transposed into shared memory by a
//               pass of its own (the card's jnp.swapaxes) and the product
//               read from that transposed copy;
//   bwd_dot_nt  proto_bwd_dots.py:71 (run_nt, _kernel_nt :40):
//               out[g] = dy_g w^T, out (rows, K); the rows past G m, which
//               the TPU kernel leaves unwritten, are written as zeros;
//   bwd_dot_base proto_bwd_dots2.py:60 with _k_base (:30): out (1, N) =
//               sum over g of the column sums of p_g @ w, every p_g @ w
//               computed (a block a 64-row tile of p_g and 64 columns);
//   bwd_dot_nn  proto_bwd_dots3.py:44 with _k_nn (:37): out (K, N) = sum
//               over steps of pk (K, M) @ dy (M, N) (the steps kernel with
//               A row-major).
//
// The TPU grid runs its steps in order and carries the sum in the output
// block. Here a block computes one output tile over one group of
// consecutive steps (whole m-row tiles), summing each step's product on its
// own and adding it into its sum in step order, and writes the group's
// partial; a second kernel adds the partials in group order. No atomics:
// two launches on the same inputs are bitwise equal. The output tile is the
// fast-varying block index, so the blocks of one group read the same rows
// at about the same time and a row goes from device memory once, then from
// L2. The groups are sized from the shapes alone (groups()): one wave of
// the blocks the launch bounds keep resident on 132 SMs.
//
// tt and nn (tc::steps_kernel): the products on the tensor cores as 3xTF32
// (m16n8k8 TF32 mma.sync, x = hi + lo, three MMAs a product, f32 sums;
// split and mma_tf32 from mma_tf32.cuh, as K1, K3 and K5), so the
// multiply-adds bound them at the f32 FMAs and 3xTF32 together (67 +
// 495/3 = 232 TFLOP/s): 0.111 ms for 98,304 rows at K=512, N=256 (the
// bytes, 302 MB, take 0.090 ms). A block of 8 warps computes a 128 x 128
// output tile (a warp 64 x 32: 4 x 4 m16n8 tiles) from chunks of 32
// contraction rows that a ring of 4 cp.async stages in dynamic shared
// memory brings in 3 chunks ahead, across step boundaries; ragged edges
// arrive as zeros (src-size below 16; 4-byte copies where a row does not
// start on 16 bytes). Both tt operands hold the contraction on their slow
// axis (p[r, k], dy[r, n]) and nn's pk (K, M) on its fast one; ldmatrix
// cannot transpose 32-bit values and wgmma takes TF32 only K-major from
// shared memory, so the fragments come through 32-bit shared loads, split
// hi/lo in registers as they are loaded, with padded rows that keep a
// warp's 32 loads on 32 banks: a [contraction][row] stage's stride is 8
// mod 32 floats (lane % 4 picks the contraction row, lane / 4 the column),
// nn's [row][contraction] A stage's 4 mod 32. The MMAs go in three passes
// over the warp's 16 tiles (lo*hi, hi*lo, hi*hi), so that none waits on
// the one before it. The tensor cores' f32 accumulation truncates (on an
// H100 one chain of MMAs over a 3,072-row step lay past the float64 bar of
// ops/cuda_bwd_dots.compare): a chunk's MMAs start from zero and the
// chunk's sum joins the step's by an f32 add; the block's
// sum over its steps lives in shared memory, so that the registers hold
// two accumulators (chunk, step) and not three. dots3's constant operands
// (1.2 MB) stay in L2, re-read every step; every output tile re-reads its
// rows from L2 (8 tiles at K=512, N=256: 805 MB a call). bwd_dot_tt_stop
// runs tt's kernel stopped after a part of the mainloop, to time the
// parts.
//
// xp, nt and base: csrc/sgemm_tile.cuh's simple SGEMM product on the CUDA
// cores (4 x 4 outputs a thread, chunks of 16 along the contraction in
// shared memory) with loads of their own (each operand's layout, ragged
// edges read as zeros), bound by the multiply-adds at the f32 FMA peak (67
// TFLOP/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <iterator>

#include "mma_tf32.cuh"
#include "sgemm_tile.cuh"

namespace {

using sgemm::BK;
using sgemm::BM;
using sgemm::BN;
using sgemm::fma_chunk;
using sgemm::Smem;  // a[c][mm]: the chunk of A', contraction-major; b[c][nn]
using sgemm::store;
using sgemm::THREADS;
enum Layout { kTT = 0, kNN = 1, kXP = 2 };

// a[c][mm] = A[c0 + c, m0 + mm]: A stored contraction-major (p of xp)
__device__ __forceinline__ void load_a_t(Smem& s, const float* __restrict__ A,
                                         int lda, int c0, int c_end, int m0,
                                         int m_end) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int c = e / BM, mm = e % BM, r = c0 + c, m = m0 + mm;
    s.a[c][mm] = (r < c_end && m < m_end) ? A[(size_t)r * lda + m] : 0.f;
  }
}

// a[c][mm] = A[m0 + mm, c0 + c]: A stored row-major (pk of nn, p of base,
// dy of nt)
__device__ __forceinline__ void load_a_n(Smem& s, const float* __restrict__ A,
                                         int lda, int c0, int c_end, int m0,
                                         int m_end) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int mm = e / BK, c = e % BK, r = c0 + c, m = m0 + mm;
    s.a[c][mm] = (r < c_end && m < m_end) ? A[(size_t)m * lda + r] : 0.f;
  }
}

// b[c][nn] = B[c0 + c, n0 + nn]: B stored contraction-major (dy, w of base)
__device__ __forceinline__ void load_b_n(Smem& s, const float* __restrict__ B,
                                         int ldb, int c0, int c_end, int n0,
                                         int n_end) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int c = e / BN, nn = e % BN, r = c0 + c, n = n0 + nn;
    s.b[c][nn] = (r < c_end && n < n_end) ? B[(size_t)r * ldb + n] : 0.f;
  }
}

// b[c][nn] = B[n0 + nn, c0 + c]: B^T of a row-major B (w of nt)
__device__ __forceinline__ void load_b_t(Smem& s, const float* __restrict__ B,
                                         int ldb, int c0, int c_end, int n0,
                                         int n_end) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int nn = e / BK, c = e % BK, r = c0 + c, n = n0 + nn;
    s.b[c][nn] = (r < c_end && n < n_end) ? B[(size_t)n * ldb + r] : 0.f;
  }
}

// the same product with A read from its transposed copy pt[mm][c] (xp)
__device__ __forceinline__ void fma_chunk_pt(float (&acc)[4][4],
                                             const float (&pt)[BM][BK + 1],
                                             const Smem& s) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < BK; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(&s.b[c][4 * tx]);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = pt[4 * ty + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
    }
  }
}

// The tensor-core steps kernel's (tt, nn) block: a BM x BN output tile in
// 8 warps (2 along M, 4 along N; a warp 64 x 32, MT x NT m16n8 tiles),
// chunks of BK contraction rows, a ring of STAGES of them
namespace tc {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int WARPS_M = 2, WARPS_N = THREADS / 32 / WARPS_M;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;

constexpr int OUTS = MT * NT * 4;  // a thread's outputs

// How much of the mainloop runs (bwd_dot_tt_stop, to time its parts): all
// of it; hi*hi alone (one TF32 pass, another function); the fragment loads
// and splits without MMAs (each split value folded into the sums by one
// XOR, so that none is dropped); the cp.async ring and its barriers alone
enum Stop { kAll = 0, kOnePass = 1, kFeed = 2, kRing = 3 };

// Dynamic shared memory, floats: the ring's STAGES stages, each A's chunk
// then B's [BK][B_LD] (tt's A [BK][A_LD], contraction-major as p is
// stored; nn's [BM][A_LD], as pk is stored; the strides keep a warp's
// fragment loads on 32 banks), then the block's sum over its steps,
// [OUTS][THREADS] (a thread's own column: no barrier)
template <int LAYOUT>
struct Ring {
  static constexpr int A_LD = LAYOUT == kTT ? BM + 8 : BK + 4;
  static constexpr int A_FLOATS = LAYOUT == kTT ? BK * A_LD : BM * A_LD;
  static constexpr int B_LD = BN + 8;
  static constexpr int STAGE = A_FLOATS + BK * B_LD;
  static constexpr int TOTAL = STAGES * STAGE;
  static constexpr int BYTES = (TOTAL + OUTS * THREADS) * 4;
  static_assert((LAYOUT == kTT ? A_LD % 32 == 8 : A_LD % 32 == 4) &&
                    B_LD % 32 == 8 && A_FLOATS % 4 == 0 && STAGE % 4 == 0,
                "conflict-free fragment loads, 16-byte aligned copies");
  static_assert(BYTES <= 232448, "a block's shared memory holds it");
};

// dst[r][c] (row stride ld) = src[(r0 + r) lds + c0 + c] for r < ROWS,
// c < COLS, by cp.async of VEC floats a copy (4: 16 bytes, src 16-byte
// aligned), zeros where r0 + r >= r_end or c0 + c >= c_end
template <int ROWS, int COLS, int VEC>
__device__ __forceinline__ void copy_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int lds, int r0, int r_end, int c0,
                                          int c_end) {
  constexpr int PER_ROW = COLS / VEC, N = ROWS * PER_ROW;
  static_assert(COLS % VEC == 0 && N % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < N / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const int row = r0 + r, col = c0 + c;
    const int n = row < r_end ? max(0, min(VEC, c_end - col)) : 0;
    const float* g = n > 0 ? src + (size_t)row * lds + col : src;
    if constexpr (VEC == 4)
      cp_async16_fill(dst + r * ld + c, g, 4 * n);
    else
      cp_async4_fill(dst + r * ld + c, g, 4 * n);
  }
}

// A's and B's chunk of contraction rows [c0, c0 + BK), zeros from c_end,
// into the stage at sa
template <int LAYOUT, int VEC>
__device__ __forceinline__ void load_chunk(float* sa,
                                           const float* __restrict__ A,
                                           int lda,
                                           const float* __restrict__ B,
                                           int ldb, int c0, int c_end, int m0,
                                           int Mo, int n0, int No) {
  using R = Ring<LAYOUT>;
  if constexpr (LAYOUT == kTT)
    copy_tile<BK, BM, VEC>(sa, R::A_LD, A, lda, c0, c_end, m0, Mo);
  else
    copy_tile<BM, BK, VEC>(sa, R::A_LD, A, lda, m0, Mo, c0, c_end);
  copy_tile<BK, BN, VEC>(sa + R::A_FLOATS, R::B_LD, B, ldb, c0, c_end, n0,
                         No);
}

// acc += the stage's chunk product for warp (wm, wn): each fragment value
// split hi/lo as it is loaded, then three passes over the warp's m16n8
// tiles, lo*hi, hi*lo and hi*hi (mma_3xtf32's order), so that an MMA waits
// on the one 16 before it; m16 tiles at or past Mo (rows mt_live on) are
// skipped
template <int LAYOUT, int STOP>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const float* sa, int wm, int wn,
                                          int mt_live) {
  using R = Ring<LAYOUT>;
  if constexpr (STOP == kRing) return;
  const float* sb = sa + R::A_FLOATS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * WM + mt * 16 + g;
      float v[4];
      if constexpr (LAYOUT == kTT) {  // a[c][mm]
        const float* s = sa + (k8 + t) * R::A_LD + r;
        v[0] = s[0];
        v[1] = s[8];
        v[2] = s[4 * R::A_LD];
        v[3] = s[4 * R::A_LD + 8];
      } else {  // a[mm][c]
        const float* s = sa + r * R::A_LD + k8 + t;
        v[0] = s[0];
        v[1] = s[8 * R::A_LD];
        v[2] = s[4];
        v[3] = s[8 * R::A_LD + 4];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[mt][i], al[mt][i]);
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* s = sb + (k8 + t) * R::B_LD + wn * WN + nt * 8 + g;
      split(s[0], bh[nt][0], bl[nt][0]);
      split(s[4 * R::B_LD], bh[nt][1], bl[nt][1]);
    }
    if constexpr (STOP == kFeed) {
      uint32_t x = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) x ^= ah[mt][i] ^ al[mt][i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        x ^= bh[nt][0] ^ bh[nt][1] ^ bl[nt][0] ^ bl[nt][1];
      acc[0][0][0] += __uint_as_float(x & 0x007fffffu);
      continue;
    }
#pragma unroll
    for (int pass = STOP == kOnePass ? 2 : 0; pass < 3; ++pass)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt >= mt_live) continue;
          if (pass == 0)
            mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
          else if (pass == 1)
            mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
          else
            mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
  }
}

// tt and nn: block (output tile blockIdx.x, group blockIdx.y): the sum
// over steps [group * per_group, ...) of A'_g B_g, contraction rows
// [g m, g m + m), g = step % G, each step's product summed apart and then
// added in step order; written to partial + group * Mo * No. Chunk t of
// the group's (steps x chunks) is computed while chunks t + 1 .. t +
// STAGES - 1 are in flight; one barrier a chunk frees the stage read
// before it. The tensor cores' f32 accumulation truncates, so a chunk's
// MMAs start from zero and its sum joins the step's by an f32 add, and
// the step sums join the block's sum in shared memory: the registers hold
// two accumulators, not three.
template <int LAYOUT, int VEC, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
steps_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B,
             int ldb, float* __restrict__ partial, int Mo, int No, int m,
             int G, int steps, int per_group) {
  using R = Ring<LAYOUT>;
  extern __shared__ __align__(16) float ring[];
  float* total = ring + R::TOTAL + threadIdx.x;  // [e * THREADS]
  const int tiles_n = (No + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(steps, s0 + per_group);
  const int chunks = (m + BK - 1) / BK, count = (s1 - s0) * chunks;
  const int warp = threadIdx.x >> 5, wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int mt_live = (Mo - m0 - wm * WM + 15) / 16;
  auto fetch = [&](int t) {
    const int c_begin = ((s0 + t / chunks) % G) * m;
    load_chunk<LAYOUT, VEC>(ring + (t % STAGES) * R::STAGE, A, lda, B, ldb,
                            c_begin + (t % chunks) * BK, c_begin + m, m0, Mo,
                            n0, No);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < count) fetch(t);
    cp_async_commit();
  }
  float chunk_acc[MT][NT][4] = {}, step_acc[MT][NT][4] = {};
  for (int t = 0; t < count; ++t) {
    cp_async_wait<STAGES - 2>();  // chunk t has landed, for this thread
    __syncthreads();              // ... for all; and chunk t - 1 is read
    if (t + STAGES - 1 < count) fetch(t + STAGES - 1);
    cp_async_commit();
    mma_chunk<LAYOUT, STOP>(chunk_acc, ring + (t % STAGES) * R::STAGE, wm,
                            wn, mt_live);
    const bool step_end = (t + 1) % chunks == 0, first = t < chunks;
#pragma unroll
    for (int e = 0; e < OUTS; ++e) {
      float& c = (&chunk_acc[0][0][0])[e];
      float& st = (&step_acc[0][0][0])[e];
      st += c;
      c = 0.f;
      if (step_end) {  // the step's product, added in step order
        total[e * THREADS] = first ? st : total[e * THREADS] + st;
        st = 0.f;
      }
    }
  }
  cp_async_wait_all();
  float* out = partial + (size_t)blockIdx.y * Mo * No;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + wm * WM + mt * 16 + (lane >> 2) + 8 * (i >> 1);
        const int c = n0 + wn * WN + nt * 8 + 2 * (lane & 3) + (i & 1);
        if (r < Mo && c < No)
          out[(size_t)r * No + c] = total[((mt * NT + nt) * 4 + i) * THREADS];
      }
}

}  // namespace tc

// blocks of a steps kernel an SM holds: tt and nn one (their launch bound
// lets a thread have the registers of two 64-float accumulators; the ring
// and the block's sum take 200-204 KB of shared memory); xp two (its
// launch bound caps the registers so that they fit, 100 unbounded);
// groups() sizes the groups to one wave of them on an H100 SXM's 132 SMs
template <int LAYOUT>
struct Tile {
  static constexpr int M = tc::BM, N = tc::BN, RESIDENT = 1;
};
template <>
struct Tile<kXP> {
  static constexpr int M = BM, N = BN, RESIDENT = 2;
};
constexpr int kSMs = 132;

template <int LAYOUT>
int tiles(int Mo, int No) {
  using T = Tile<LAYOUT>;
  return ((Mo + T::M - 1) / T::M) * ((No + T::N - 1) / T::N);
}

// The group count for Mo x No outputs and `steps` steps: at most one wave
// of blocks (at least one group), no group empty; a function of the shapes
// only, so that the sums' order is fixed.
template <int LAYOUT>
int groups(int Mo, int No, int steps) {
  const int wave = kSMs * Tile<LAYOUT>::RESIDENT / tiles<LAYOUT>(Mo, No);
  const int g = std::max(1, std::min({steps, wave, 65535}));
  const int per = (steps + g - 1) / g;
  return (steps + per - 1) / per;
}

// xp: block (output tile blockIdx.x, group blockIdx.y) as tc::steps_kernel,
// with the p chunk transposed into shared memory by a pass of its own and
// the product on the FMAs
__global__ void __launch_bounds__(THREADS, Tile<kXP>::RESIDENT)
xp_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B,
          int ldb, float* __restrict__ partial, int Mo, int No, int m, int G,
          int steps, int per_group) {
  __shared__ __align__(16) Smem s;
  __shared__ float pt[BM][BK + 1];
  const int tiles_n = (No + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(steps, s0 + per_group);
  float acc[4][4] = {};
  for (int st = s0; st < s1; ++st) {
    const int c_begin = (st % G) * m, c_end = c_begin + m;
    float step_acc[4][4] = {};
    for (int c0 = c_begin; c0 < c_end; c0 += BK) {
      load_a_t(s, A, lda, c0, c_end, m0, Mo);
      load_b_n(s, B, ldb, c0, c_end, n0, No);
      __syncthreads();
      // the transpose, a pass of its own: pt[mm][c] = a[c][mm]
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int mm = e / BK, c = e % BK;
        pt[mm][c] = s.a[c][mm];
      }
      __syncthreads();
      fma_chunk_pt(step_acc, pt, s);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += step_acc[i][j];
  }
  store(acc, partial + (size_t)blockIdx.y * Mo * No, No, Mo, No, m0, n0);
}

// out[i] = the groups' partials added in group order
__global__ void reduce_groups(const float* __restrict__ partial,
                              float* __restrict__ out, int n, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = partial[i];
  for (int g = 1; g < groups; ++g) v += partial[(size_t)g * n + i];
  out[i] = v;
}

// out (rows, K) = dy (rows, N) w^T for the rows below Gm, zeros past them
__global__ void __launch_bounds__(THREADS)
nt_kernel(const float* __restrict__ dy, const float* __restrict__ w,
          float* __restrict__ out, int rows, int Gm, int N, int K) {
  __shared__ __align__(16) Smem s;
  const int tiles_k = (K + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_k) * BM, n0 = (blockIdx.x % tiles_k) * BN;
  float acc[4][4] = {};
  if (m0 < Gm) {
    for (int c0 = 0; c0 < N; c0 += BK) {
      load_a_n(s, dy, N, c0, N, m0, Gm);
      load_b_t(s, w, N, c0, N, n0, K);
      __syncthreads();
      fma_chunk(acc, s);
      __syncthreads();
    }
  }
  store(acc, out, K, rows, K, m0, n0);
}

// Block (n tile, row tile rt = g tps + t): y = p[rows of tile t of step g]
// @ w[:, n tile], its column sums over those rows written to
// partial[rt, n].
__global__ void __launch_bounds__(THREADS)
base_kernel(const float* __restrict__ p, const float* __restrict__ w,
            float* __restrict__ partial, int K, int N, int m, int tps) {
  __shared__ __align__(16) Smem s;
  __shared__ float red[THREADS / 16][BN];
  const int tiles_n = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_n) * BN, rt = blockIdx.x / tiles_n;
  const int g = rt / tps, t = rt % tps;
  const int r0 = g * m + t * BM, r_end = g * m + m;
  float acc[4][4] = {};
  for (int c0 = 0; c0 < K; c0 += BK) {
    load_a_n(s, p, K, c0, K, r0, r_end);
    load_b_n(s, w, N, c0, K, n0, N);
    __syncthreads();
    fma_chunk(acc, s);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    red[ty][4 * tx + j] = ((acc[0][j] + acc[1][j]) + acc[2][j]) + acc[3][j];
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < N) {
    float v = red[0][threadIdx.x];
    for (int r = 1; r < THREADS / 16; ++r) v += red[r][threadIdx.x];
    partial[(size_t)rt * N + n0 + threadIdx.x] = v;
  }
}

// out[n] = the sum over steps g, in order, of the step's row tiles' column
// sums: one block a column; thread j takes a run of consecutive steps,
// then the runs are added in a fixed tree
__global__ void __launch_bounds__(THREADS)
base_reduce(const float* __restrict__ partial, float* __restrict__ out, int N,
            int G, int tps) {
  __shared__ float run[THREADS];
  const int n = blockIdx.x, per = (G + THREADS - 1) / THREADS;
  const int g0 = threadIdx.x * per, g1 = min(G, g0 + per);
  float v = 0.f;
  for (int g = g0; g < g1; ++g) {
    float step = 0.f;
    for (int t = 0; t < tps; ++t) step += partial[((size_t)g * tps + t) * N + n];
    v += step;
  }
  run[threadIdx.x] = v;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) run[threadIdx.x] += run[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[n] = run[0];
}

// The partial sums' floats for one launch: groups x Mo x No (none for one
// group, which writes out directly).
template <int LAYOUT>
long long scratch(int Mo, int No, int steps) {
  const int g = groups<LAYOUT>(Mo, No, steps);
  return g == 1 ? 0 : (long long)g * Mo * No;
}

using StepsKernel = void (*)(const float*, int, const float*, int, float*,
                             int, int, int, int, int, int);

// tt and nn copy 16 bytes at a time when every row of both operands starts
// on 16 bytes, else 4
bool vec4(const void* a, int lda, const void* b, int ldb) {
  return lda % 4 == 0 && ldb % 4 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

template <int LAYOUT>
struct Steps {
  static constexpr int THREADS = tc::THREADS, BK = tc::BK;
  static constexpr int STAGES = tc::STAGES, SMEM = tc::Ring<LAYOUT>::BYTES;
  static StepsKernel kernel(bool vec) {
    return vec ? tc::steps_kernel<LAYOUT, 4, tc::kAll>
               : tc::steps_kernel<LAYOUT, 1, tc::kAll>;
  }
};
template <>
struct Steps<kXP> {
  static constexpr int THREADS = sgemm::THREADS, BK = sgemm::BK;
  static constexpr int STAGES = 1, SMEM = 0;
  static StepsKernel kernel(bool) { return xp_kernel; }
};

// a kernel's dynamic shared memory above the default 48 KB, allowed
cudaError_t allow_smem(StepsKernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// a steps kernel and its reduction over the groups; `kernel`: a stop of
// tt's (bwd_dot_tt_stop), else the layout's own
template <int LAYOUT>
int launch_steps(const void* a, int lda, const void* b, int ldb, void* out,
                 void* partial, int Mo, int No, int m, int G, int steps,
                 void* stream, StepsKernel kernel = nullptr) {
  using S = Steps<LAYOUT>;
  if (Mo < 1 || No < 1 || m < 1 || G < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int n_groups = groups<LAYOUT>(Mo, No, steps);
  const int per_group = (steps + n_groups - 1) / n_groups;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kernel) kernel = S::kernel(vec4(a, lda, b, ldb));
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(n_groups == 1 ? out : partial);
  kernel<<<dim3(tiles<LAYOUT>(Mo, No), n_groups), S::THREADS, S::SMEM, st>>>(
      static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
      dst, Mo, No, m, G, steps, per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return (int)err;
  const int n = Mo * No;
  reduce_groups<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n,
      n_groups);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int plan(int Mo, int No, int steps, int* out) {
  using S = Steps<LAYOUT>;
  const int g = groups<LAYOUT>(Mo, No, steps);
  const int fields[] = {Tile<LAYOUT>::M, Tile<LAYOUT>::N, S::BK, S::THREADS,
                        S::STAGES, S::SMEM, tiles<LAYOUT>(Mo, No), g,
                        (steps + g - 1) / g};
  std::copy(std::begin(fields), std::end(fields), out);
  const StepsKernel kernel = S::kernel(true);
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[9], kernel,
                                                        S::THREADS, S::SMEM);
  return (int)err;
}

}  // namespace

// The scratch floats that bwd_dot_tt (layout 0), bwd_dot_nn (1) or
// bwd_dot_xp (2) needs for `partial` at these shapes (Mo x No outputs,
// `steps` steps); -1 for an unknown layout. Launches nothing.
extern "C" long long bwd_dot_scratch(int layout, int Mo, int No, int steps) {
  if (Mo < 1 || No < 1 || steps < 1) return 0;
  switch (layout) {
    case kTT: return scratch<kTT>(Mo, No, steps);
    case kNN: return scratch<kNN>(Mo, No, steps);
    case kXP: return scratch<kXP>(Mo, No, steps);
    default: return -1;
  }
}

// The launch plan of the steps kernel of `layout` (as bwd_dot_scratch) at
// these shapes, out[0..9]: the output tile's rows and columns, the
// contraction rows a chunk, threads a block, ring stages (xp: 1, its one
// buffer), dynamic shared memory bytes, output tiles, groups, steps a group,
// and the blocks an SM holds by the occupancy query (groups() assumes 1 for
// tt and nn, 2 for xp). Returns the cudaError_t of the query.
extern "C" int bwd_dot_plan(int layout, int Mo, int No, int steps, int* out) {
  if (Mo < 1 || No < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case kTT: return plan<kTT>(Mo, No, steps, out);
    case kNN: return plan<kNN>(Mo, No, steps, out);
    case kXP: return plan<kXP>(Mo, No, steps, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// p: (rows, K) f32, dy: (rows, N) f32, out: (K, N) f32, partial:
// bwd_dot_scratch(0, K, N, steps) f32 scratch, all contiguous; G m <= rows;
// steps of m-row tiles s % G, in groups of whole steps. Returns the
// cudaError_t of the launches.
extern "C" int bwd_dot_tt(const void* p, const void* dy, void* out,
                          void* partial, int K, int N, int m, int G, int steps,
                          void* stream) {
  return launch_steps<kTT>(p, K, dy, N, out, partial, K, N, m, G, steps,
                           stream);
}

// bwd_dot_tt's launch with its mainloop stopped at `stop` (tc::Stop: 0 all
// of it, 1 hi*hi alone, 2 the fragment loads and splits without MMAs, 3
// the cp.async ring alone), to time the parts; rows of 16 bytes only (K
// and N multiples of 4). Only stop 0 computes bwd_dot_tt's function.
extern "C" int bwd_dot_tt_stop(const void* p, const void* dy, void* out,
                               void* partial, int K, int N, int m, int G,
                               int steps, int stop, void* stream) {
  static const StepsKernel stops[] = {
      tc::steps_kernel<kTT, 4, tc::kAll>,
      tc::steps_kernel<kTT, 4, tc::kOnePass>,
      tc::steps_kernel<kTT, 4, tc::kFeed>,
      tc::steps_kernel<kTT, 4, tc::kRing>};
  if (stop < 0 || stop > 3 || !vec4(p, K, dy, N))
    return (int)cudaErrorInvalidValue;
  return launch_steps<kTT>(p, K, dy, N, out, partial, K, N, m, G, steps,
                           stream, stops[stop]);
}

// bwd_dot_tt's function through an explicit transpose of each p chunk;
// partial: bwd_dot_scratch(2, K, N, steps) floats
extern "C" int bwd_dot_xp(const void* p, const void* dy, void* out,
                          void* partial, int K, int N, int m, int G, int steps,
                          void* stream) {
  return launch_steps<kXP>(p, K, dy, N, out, partial, K, N, m, G, steps,
                           stream);
}

// dy: (rows, N) f32, w: (K, N) f32, out: (rows, K) f32, contiguous;
// Gm = G m <= rows: out rows below Gm are dy w^T, the rest zeros
extern "C" int bwd_dot_nt(const void* dy, const void* w, void* out, int rows,
                          int Gm, int N, int K, void* stream) {
  if (rows < 1 || Gm < 0 || Gm > rows || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = ((rows + BM - 1) / BM) * ((K + BN - 1) / BN);
  nt_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<float*>(out), rows, Gm, N, K);
  return (int)cudaGetLastError();
}

// pk: (K, M) f32, dy: (M, N) f32, out: (K, N) f32 = the sum over steps of
// pk @ dy, in groups as bwd_dot_tt (one tile of m = M rows); partial:
// bwd_dot_scratch(1, K, N, steps) floats
extern "C" int bwd_dot_nn(const void* pk, const void* dy, void* out,
                          void* partial, int K, int M, int N, int steps,
                          void* stream) {
  return launch_steps<kNN>(pk, M, dy, N, out, partial, K, N, M, 1, steps,
                           stream);
}

// p: (rows, K) f32, w: (K, N) f32, out: (1, N) f32 = the sum over g < G of
// the column sums of p[g m : g m + m] @ w; partial: (G ceil(m / 64), N)
// f32 scratch, the row tiles' column sums
extern "C" int bwd_dot_base(const void* p, const void* w, void* out,
                            void* partial, int K, int N, int m, int G,
                            void* stream) {
  if (K < 1 || N < 1 || m < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tps = (m + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  base_kernel<<<G * tps * tiles_n, THREADS, 0, st>>>(
      static_cast<const float*>(p), static_cast<const float*>(w),
      static_cast<float*>(partial), K, N, m, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  base_reduce<<<N, THREADS, 0, st>>>(static_cast<const float*>(partial),
                                     static_cast<float*>(out), N, G, tps);
  return (int)cudaGetLastError();
}
