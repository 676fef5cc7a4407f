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
//               computed (never colsum(p) @ w, 1/N of the work);
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
// one block an SM on 132 SMs.
//
// tt, xp, nn and base (namespace tc): the products on the tensor cores as
// 3xTF32 (m16n8k8 TF32 mma.sync, x = hi + lo, three MMAs a product, f32
// sums; split and mma_tf32 from mma_tf32.cuh, as K1, K3 and K5), so the
// multiply-adds bound them at the f32 FMAs and 3xTF32 together (67 +
// 495/3 = 232 TFLOP/s): 0.111 ms for 98,304 rows at K=512, N=256 (the
// bytes, 302 MB, take 0.090 ms). A block of 8 warps computes a 128 x 128
// output tile (a warp 64 x 32: 4 x 4 m16n8 tiles) from chunks of 32
// contraction rows that a ring of 4 cp.async stages in dynamic shared
// memory brings in 3 chunks ahead (xp: 3, 2 ahead), across step
// boundaries; ragged edges
// arrive as zeros (src-size below 16; 4-byte copies where a row does not
// start on 16 bytes). Both tt operands hold the contraction on their slow
// axis (p[r, k], dy[r, n]) and nn's pk (K, M) and base's p on their fast
// one; ldmatrix cannot transpose 32-bit values and wgmma takes TF32 only
// K-major from shared memory, so the fragments come through 32-bit shared
// loads, split hi/lo in registers as they are loaded, with padded rows that
// keep a warp's 32 loads on 32 banks: a [contraction][row] stage's stride
// is 8 mod 32 floats (lane % 4 picks the contraction row, lane / 4 the
// column), a [row][contraction] plane's 4 mod 32. xp stages p as tt does
// and then, a pass of its own, writes each chunk transposed into a plane
// [row][contraction] that it reads as nn reads its A stage: the same
// values in the same fragments, so xp is bitwise tt, and the difference in
// time is the transposing stage's. Its two planes (chunk t + 1 written
// while the MMAs read chunk t, under tt's one barrier a chunk) fit beside
// a ring of 3 stages, not 4; a single plane and a second barrier a chunk
// took 5% longer (H100). The MMAs go in three passes over the
// warp's 16 tiles (lo*hi, hi*lo, hi*hi), so that none waits on the one
// before it. The tensor cores' f32 accumulation truncates (on an H100 one
// chain of MMAs over a 3,072-row step lay past the float64 bar of
// ops/cuda_bwd_dots.compare): a chunk's MMAs start from zero and the
// chunk's sum joins the step's by an f32 add; the block's
// sum over its steps lives in shared memory, so that the registers hold
// two accumulators (chunk, step) and not three. dots3's constant operands
// (1.2 MB) stay in L2, re-read every step; every output tile re-reads its
// rows from L2 (8 tiles at K=512, N=256: 805 MB a call). bwd_dot_tt_stop
// runs tt's kernel stopped after a part of the mainloop, to time the
// parts. base: persistent blocks walk the (128-row tile of a step, 128
// columns of w) items through the same ring and MMAs, K in chunks of 32,
// and end each item with its column sums in a fixed order (a thread's
// rows, warp shuffles, the two warps along M through shared memory); a
// second kernel adds them in step order. Its item indices are divided out
// once an item, not every chunk (14% of its time on an H100).
//
// nt: csrc/sgemm_tile.cuh's simple SGEMM product on the CUDA cores (4 x 4
// outputs a thread, chunks of 16 along the contraction in shared memory)
// with loads of its own (ragged edges read as zeros), bound by the
// multiply-adds at the f32 FMA peak (67 TFLOP/s).

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
enum Layout { kTT = 0, kNN = 1, kXP = 2, kBASE = 3 };

// a[c][mm] = A[m0 + mm, c0 + c]: A stored row-major (dy of nt)
__device__ __forceinline__ void load_a_n(Smem& s, const float* __restrict__ A,
                                         int lda, int c0, int c_end, int m0,
                                         int m_end) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int mm = e / BK, c = e % BK, r = c0 + c, m = m0 + mm;
    s.a[c][mm] = (r < c_end && m < m_end) ? A[(size_t)m * lda + r] : 0.f;
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

// The tensor-core kernels' (tt, xp, nn, base) block: a BM x BN output tile
// in 8 warps (2 along M, 4 along N; a warp 64 x 32, MT x NT m16n8 tiles),
// chunks of BK contraction rows, a ring of STAGES of them (xp: one fewer,
// Ring::DEPTH)
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

// Dynamic shared memory, floats: the ring's DEPTH stages, each A's chunk
// then B's [BK][B_LD] (A as it is stored: tt's and xp's p [BK][A_LD],
// contraction-major; nn's pk and base's p [BM][A_LD]); then xp's two
// transposed planes pt [BM][PT_LD] (the chunk the MMAs read, the next one
// being written; the second plane fits beside a ring of 3 stages, not 4);
// then the block's sum over its steps, [OUTS][THREADS] (a thread's own
// column: no barrier), or base's column sums of its two warps along M,
// [WARPS_M][BN]. The A fragments are read from a [contraction][row] stage
// (tt) or a [row][contraction] plane (nn's and base's stage, xp's pt); the
// strides keep a warp's loads, and xp's transpose, on 32 banks.
template <int LAYOUT>
struct Ring {
  static constexpr bool A_ROWS = LAYOUT == kNN || LAYOUT == kBASE;
  static constexpr int A_LD = A_ROWS ? BK + 4 : BM + 8;
  static constexpr int A_FLOATS = A_ROWS ? BM * A_LD : BK * A_LD;
  static constexpr int B_LD = BN + 8;
  static constexpr int STAGE = A_FLOATS + BK * B_LD;
  static constexpr int DEPTH = LAYOUT == kXP ? STAGES - 1 : STAGES;
  static constexpr int TOTAL = DEPTH * STAGE;
  static constexpr int PT_LD = BK + 4, PLANE = BM * PT_LD;
  static constexpr int PT = LAYOUT == kXP ? 2 * PLANE : 0;
  static constexpr int SUM = LAYOUT == kBASE ? WARPS_M * BN : OUTS * THREADS;
  static constexpr int BYTES = (TOTAL + PT + SUM) * 4;
  // the A fragments' plane: [row][contraction] but for tt, and its stride
  static constexpr bool FRAG_ROWS = LAYOUT != kTT;
  static constexpr int FRAG_LD = LAYOUT == kXP ? PT_LD : A_LD;
  static_assert(A_LD % 32 == (A_ROWS ? 4 : 8) && PT_LD % 32 == 4 &&
                    B_LD % 32 == 8 && A_FLOATS % 4 == 0 && STAGE % 4 == 0 &&
                    DEPTH >= 3,
                "conflict-free fragment loads, 16-byte aligned copies, a "
                "chunk landing while the one before it is read");
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
// into the stage at sa; A's rows (or columns) [m0, m0 + BM), zeros from Mo
template <int LAYOUT, int VEC>
__device__ __forceinline__ void load_chunk(float* sa,
                                           const float* __restrict__ A,
                                           int lda,
                                           const float* __restrict__ B,
                                           int ldb, int c0, int c_end, int m0,
                                           int Mo, int n0, int No) {
  using R = Ring<LAYOUT>;
  if constexpr (R::A_ROWS)
    copy_tile<BM, BK, VEC>(sa, R::A_LD, A, lda, m0, Mo, c0, c_end);
  else
    copy_tile<BK, BM, VEC>(sa, R::A_LD, A, lda, c0, c_end, m0, Mo);
  copy_tile<BK, BN, VEC>(sa + R::A_FLOATS, R::B_LD, B, ldb, c0, c_end, n0,
                         No);
}

// xp's transpose, a pass of its own: pt[mm][c] = a[c][mm] for a stage's
// chunk (the card's jnp.swapaxes). A warp moves 32 rows mm by 4
// contraction rows c at a time, lane = mm', by 4 loads a[c..c + 3][mm]
// (consecutive in mm: a bank a lane) and one 16-byte store pt[mm][c..c +
// 3] (8 lanes a phase on 8 rows of stride BK + 4, 4 mod 32: 32 banks)
__device__ __forceinline__ void transpose_chunk(float* pt, const float* sa) {
  using R = Ring<kXP>;
  constexpr int BLOCKS_M = BM / 32, WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < BLOCKS_M * (BK / 4) / WARPS; ++i) {
    const int blk = warp + i * WARPS;
    const int mm = (blk % BLOCKS_M) * 32 + lane, c = (blk / BLOCKS_M) * 4;
    const float* a = sa + c * R::A_LD + mm;
    *reinterpret_cast<float4*>(pt + mm * R::PT_LD + c) =
        make_float4(a[0], a[R::A_LD], a[2 * R::A_LD], a[3 * R::A_LD]);
  }
}

// acc += the chunk product for warp (wm, wn), A's fragments from sa (as
// Ring::FRAG_ROWS says), B's from the stage's sb: each fragment value
// split hi/lo as it is loaded, then three passes over the warp's m16n8
// tiles, lo*hi, hi*lo and hi*hi (mma_3xtf32's order), so that an MMA waits
// on the one 16 before it; m16 tiles at or past the live rows (mt_live on)
// are skipped
template <int LAYOUT, int STOP>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const float* sa, const float* sb,
                                          int wm, int wn, int mt_live) {
  using R = Ring<LAYOUT>;
  if constexpr (STOP == kRing) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * WM + mt * 16 + g;
      float v[4];
      if constexpr (!R::FRAG_ROWS) {  // a[c][mm]
        const float* s = sa + (k8 + t) * R::A_LD + r;
        v[0] = s[0];
        v[1] = s[8];
        v[2] = s[4 * R::A_LD];
        v[3] = s[4 * R::A_LD + 8];
      } else {  // a[mm][c]
        const float* s = sa + r * R::FRAG_LD + k8 + t;
        v[0] = s[0];
        v[1] = s[8 * R::FRAG_LD];
        v[2] = s[4];
        v[3] = s[8 * R::FRAG_LD + 4];
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

// sum += chunk, chunk = 0, element by element
__device__ __forceinline__ void add_chunk(float (&sum)[MT][NT][4],
                                          float (&chunk)[MT][NT][4]) {
#pragma unroll
  for (int e = 0; e < OUTS; ++e) {
    (&sum[0][0][0])[e] += (&chunk[0][0][0])[e];
    (&chunk[0][0][0])[e] = 0.f;
  }
}

// tt, nn and xp: block (output tile blockIdx.x, group blockIdx.y): the sum
// over steps [group * per_group, ...) of A'_g B_g, contraction rows
// [g m, g m + m), g = step % G, each step's product summed apart and then
// added in step order; written to partial + group * Mo * No. Chunk t of
// the group's (steps x chunks) is computed while chunks t + 1 .. t +
// DEPTH - 1 are in flight; one barrier a chunk frees the stage read
// before it. xp transposes chunk t + 1 (landed: its ring is one stage
// shorter) into one plane while its MMAs read chunk t from the other, so
// that the transpose runs beside the MMAs under the same barrier. The
// tensor cores' f32 accumulation truncates, so a chunk's MMAs start from
// zero and its sum joins the step's by an f32 add, and the step sums join
// the block's sum in shared memory: the registers hold two accumulators,
// not three.
template <int LAYOUT, int VEC, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
steps_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B,
             int ldb, float* __restrict__ partial, int Mo, int No, int m,
             int G, int steps, int per_group) {
  using R = Ring<LAYOUT>;
  constexpr int DEPTH = R::DEPTH;
  constexpr bool XP = LAYOUT == kXP;
  extern __shared__ __align__(16) float ring[];
  float* pt = ring + R::TOTAL;  // xp: chunk t's plane pt + (t & 1) PLANE
  float* total = pt + R::PT + threadIdx.x;  // [e * THREADS]
  const int tiles_n = (No + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(steps, s0 + per_group);
  const int chunks = (m + BK - 1) / BK, count = (s1 - s0) * chunks;
  const int warp = threadIdx.x >> 5, wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int mt_live = (Mo - m0 - wm * WM + 15) / 16;
  auto fetch = [&](int t) {
    const int c_begin = ((s0 + t / chunks) % G) * m;
    load_chunk<LAYOUT, VEC>(ring + (t % DEPTH) * R::STAGE, A, lda, B, ldb,
                            c_begin + (t % chunks) * BK, c_begin + m, m0, Mo,
                            n0, No);
  };
#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < count) fetch(t);
    cp_async_commit();
  }
  if constexpr (XP) {  // chunk 0 into its plane
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    transpose_chunk(pt, ring);
  }
  float chunk_acc[MT][NT][4] = {}, step_acc[MT][NT][4] = {};
  for (int t = 0; t < count; ++t) {
    // chunk t (xp: t + 1) has landed, for this thread; after the barrier
    // for all, and chunk t - 1's stage (xp: and plane) is read
    cp_async_wait<XP ? DEPTH - 3 : DEPTH - 2>();
    __syncthreads();
    if (t + DEPTH - 1 < count) fetch(t + DEPTH - 1);
    cp_async_commit();
    const float* stage = ring + (t % DEPTH) * R::STAGE;
    if constexpr (XP) {
      if (t + 1 < count)
        transpose_chunk(pt + ((t + 1) & 1) * R::PLANE,
                        ring + ((t + 1) % DEPTH) * R::STAGE);
    }
    mma_chunk<LAYOUT, STOP>(chunk_acc, XP ? pt + (t & 1) * R::PLANE : stage,
                            stage + R::A_FLOATS, wm, wn, mt_live);
    add_chunk(step_acc, chunk_acc);
    if ((t + 1) % chunks == 0) {  // the step's product, added in step order
      const bool first = t < chunks;
#pragma unroll
      for (int e = 0; e < OUTS; ++e) {
        float& st = (&step_acc[0][0][0])[e];
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

// base's item: row tile rt = g tps + t (rows [g m + t BM, ...) of p, the
// step's rows ending at g m + m) by the column tile from n0
struct Item {
  int rt, r0, r_end, n0;
};
__device__ __forceinline__ Item item(int i, int tiles_n, int m, int tps) {
  const int rt = i / tiles_n, g = rt / tps;
  return {rt, g * m + (rt % tps) * BM, g * m + m, (i % tiles_n) * BN};
}

// The tile's column sums in a fixed order, into red[wm][column]: a
// thread's 8 rows of a column (mt, then the tile's two row halves), then
// the warp's 8 row groups by shuffles (lane ^ 4, ^ 8, ^ 16: each pair adds
// the same two values), lanes 0-3 writing the warp's 32 columns; tile is
// zeroed
__device__ __forceinline__ void column_sums(float (&tile)[MT][NT][4],
                                            float* red, int wm, int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = tile[0][nt][j];
      s += tile[0][nt][2 + j];
#pragma unroll
      for (int mt = 1; mt < MT; ++mt) {
        s += tile[mt][nt][j];
        s += tile[mt][nt][2 + j];
      }
#pragma unroll
      for (int d = 4; d < 32; d *= 2) s += __shfl_xor_sync(0xffffffffu, s, d);
      if (lane < 4) red[wm * BN + wn * WN + nt * 8 + 2 * lane + j] = s;
    }
#pragma unroll
  for (int e = 0; e < OUTS; ++e) (&tile[0][0][0])[e] = 0.f;
}

// base: persistent blocks, block b walking the items i = b, b + gridDim.x,
// ... (the column tile the fast index, so that the blocks at work at one
// time read the same rows of p) as one stream of chunks through the ring,
// so that an item's epilogue runs while the next item's chunks land: an
// item is its rows of p (zeros from the step's end) times w's column tile
// over K, in chunks of BK, each chunk's MMAs from zero and added into the
// tile's sum in f32; then the tile's column sums (column_sums, then the
// two warps along M added through shared memory) to partial[rt, n]. The
// loads and the MMAs each keep a cursor (item, chunk) that moves on by a
// chunk, so that an item's indices are divided out once, not every chunk.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
base_kernel(const float* __restrict__ p, const float* __restrict__ w,
            float* __restrict__ partial, int K, int N, int m, int tps,
            int items) {
  using R = Ring<kBASE>;
  extern __shared__ __align__(16) float ring[];
  float* red = ring + R::TOTAL;  // [WARPS_M][BN]
  const int tiles_n = (N + BN - 1) / BN, chunks = (K + BK - 1) / BK;
  const int mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int count = mine * chunks;
  const int warp = threadIdx.x >> 5, wm = warp % WARPS_M, wn = warp / WARPS_M;
  auto at = [&](int j) {  // this block's item j
    return item(blockIdx.x + j * gridDim.x, tiles_n, m, tps);
  };
  Item load_it = at(0);
  int load_j = 0, load_k = 0;
  auto fetch = [&](int t) {  // chunk t, the one after the last fetched
    load_chunk<kBASE, VEC>(ring + (t % R::DEPTH) * R::STAGE, p, K, w, N,
                           load_k * BK, K, load_it.r0, load_it.r_end,
                           load_it.n0, N);
    if (++load_k == chunks) {
      load_k = 0;
      if (++load_j < mine) load_it = at(load_j);
    }
  };
#pragma unroll
  for (int t = 0; t < R::DEPTH - 1; ++t) {
    if (t < count) fetch(t);
    cp_async_commit();
  }
  Item it = at(0);
  int j = 0, k = 0, mt_live = (it.r_end - it.r0 - wm * WM + 15) / 16;
  float chunk_acc[MT][NT][4] = {}, tile_acc[MT][NT][4] = {};
  for (int t = 0; t < count; ++t) {
    cp_async_wait<R::DEPTH - 2>();  // chunk t has landed, for this thread
    __syncthreads();  // ... for all; chunk t - 1 and red read
    if (t + R::DEPTH - 1 < count) fetch(t + R::DEPTH - 1);
    cp_async_commit();
    const float* stage = ring + (t % R::DEPTH) * R::STAGE;
    mma_chunk<kBASE, kAll>(chunk_acc, stage, stage + R::A_FLOATS, wm, wn,
                           mt_live);
    add_chunk(tile_acc, chunk_acc);
    if (++k == chunks) {  // the item's epilogue
      column_sums(tile_acc, red, wm, wn);
      __syncthreads();
      const int n = it.n0 + threadIdx.x;
      if (threadIdx.x < BN && n < N)
        partial[(size_t)it.rt * N + n] =
            red[threadIdx.x] + red[BN + threadIdx.x];
      k = 0;
      if (++j < mine) {
        it = at(j);
        mt_live = (it.r_end - it.r0 - wm * WM + 15) / 16;
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace tc

// groups() sizes the groups of a steps kernel to one wave of one block an
// SM (the launch bounds let a thread have the registers of two 64-float
// accumulators; the ring, xp's planes and the block's sum take 200-204 KB
// of shared memory) on an H100 SXM's 132 SMs; base launches one
// persistent block an SM (141 KB)
constexpr int kSMs = 132;

int tiles(int Mo, int No) {
  return ((Mo + tc::BM - 1) / tc::BM) * ((No + tc::BN - 1) / tc::BN);
}

// The group count for Mo x No outputs and `steps` steps: at most one wave
// of blocks (at least one group), no group empty; a function of the shapes
// only, so that the sums' order is fixed.
int groups(int Mo, int No, int steps) {
  const int wave = kSMs / tiles(Mo, No);
  const int g = std::max(1, std::min({steps, wave, 65535}));
  const int per = (steps + g - 1) / g;
  return (steps + per - 1) / per;
}

// base's items at m rows a step, N columns, G steps: G ceil(m / BM) row
// tiles by ceil(N / BN) column tiles
int base_items(int m, int N, int G) {
  return G * tiles(m, N);
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
    for (int t = 0; t < tps; ++t)
      step += partial[((size_t)g * tps + t) * N + n];
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

// The partial sums' floats for one launch of a steps kernel: groups x Mo x
// No (none for one group, which writes out directly).
long long scratch(int Mo, int No, int steps) {
  const int g = groups(Mo, No, steps);
  return g == 1 ? 0 : (long long)g * Mo * No;
}

using StepsKernel = void (*)(const float*, int, const float*, int, float*,
                             int, int, int, int, int, int);
using BaseKernel = void (*)(const float*, const float*, float*, int, int, int,
                            int, int);

// the kernels copy 16 bytes at a time when every row of both operands
// starts on 16 bytes, else 4
bool vec4(const void* a, int lda, const void* b, int ldb) {
  return lda % 4 == 0 && ldb % 4 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

template <int LAYOUT>
StepsKernel steps_entry(bool vec) {
  return vec ? tc::steps_kernel<LAYOUT, 4, tc::kAll>
             : tc::steps_kernel<LAYOUT, 1, tc::kAll>;
}

BaseKernel base_entry(bool vec) {
  return vec ? tc::base_kernel<4> : tc::base_kernel<1>;
}

// a kernel's dynamic shared memory above the default 48 KB, allowed
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
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
  constexpr int SMEM = tc::Ring<LAYOUT>::BYTES;
  if (Mo < 1 || No < 1 || m < 1 || G < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int n_groups = groups(Mo, No, steps);
  const int per_group = (steps + n_groups - 1) / n_groups;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kernel) kernel = steps_entry<LAYOUT>(vec4(a, lda, b, ldb));
  cudaError_t err = allow_smem(kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(n_groups == 1 ? out : partial);
  kernel<<<dim3(tiles(Mo, No), n_groups), tc::THREADS, SMEM, st>>>(
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

// out[0..9] as bwd_dot_plan gives them for LAYOUT; `kernel`'s occupancy
template <int LAYOUT, typename Kernel>
int plan_fields(Kernel kernel, int tiles, int groups, int per, int* out) {
  using R = tc::Ring<LAYOUT>;
  const int smem = R::BYTES;
  const int fields[] = {tc::BM, tc::BN, tc::BK, tc::THREADS, R::DEPTH,
                        smem,   tiles,  groups, per};
  std::copy(std::begin(fields), std::end(fields), out);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[9], kernel,
                                                        tc::THREADS, smem);
  return (int)err;
}

template <int LAYOUT>
int plan(int Mo, int No, int steps, int* out) {
  const int g = groups(Mo, No, steps);
  return plan_fields<LAYOUT>(steps_entry<LAYOUT>(true), tiles(Mo, No), g,
                             (steps + g - 1) / g, out);
}

int plan_base(int m, int N, int G, int* out) {
  const int items = base_items(m, N, G), blocks = std::min(items, kSMs);
  return plan_fields<kBASE>(base_entry(true), items, blocks,
                            (items + blocks - 1) / blocks, out);
}

}  // namespace

// The scratch floats that bwd_dot_tt (layout 0), bwd_dot_nn (1),
// bwd_dot_xp (2) or bwd_dot_base (3) needs for `partial` at these shapes:
// a steps kernel's (0-2) for Mo x No outputs over `steps` steps; base's
// (3) for Mo = m rows a step, No = N columns and steps = G steps, a row of
// N a 128-row tile of a step; -1 for an unknown layout. Launches nothing.
extern "C" long long bwd_dot_scratch(int layout, int Mo, int No, int steps) {
  if (Mo < 1 || No < 1 || steps < 1) return 0;
  switch (layout) {
    case kTT:
    case kNN:
    case kXP: return scratch(Mo, No, steps);
    case kBASE: return (long long)steps * ((Mo + tc::BM - 1) / tc::BM) * No;
    default: return -1;
  }
}

// The launch plan of `layout`'s kernel (shapes as bwd_dot_scratch takes
// them), out[0..9]: the output tile's rows and columns, the contraction
// rows a chunk, threads a block, ring stages, dynamic shared memory bytes,
// output tiles (base: its items, row tiles x column tiles), groups (base:
// its persistent blocks), steps a group (base: items a block, at most),
// and the blocks an SM holds by the occupancy query (groups() and base
// assume 1). Returns the cudaError_t of the query.
extern "C" int bwd_dot_plan(int layout, int Mo, int No, int steps, int* out) {
  if (Mo < 1 || No < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case kTT: return plan<kTT>(Mo, No, steps, out);
    case kNN: return plan<kNN>(Mo, No, steps, out);
    case kXP: return plan<kXP>(Mo, No, steps, out);
    case kBASE: return plan_base(Mo, No, steps, out);
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

// bwd_dot_tt's function through an explicit transpose of each p chunk,
// bitwise bwd_dot_tt's result at the same arguments; partial:
// bwd_dot_scratch(2, K, N, steps) floats
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
// the column sums of p[g m : g m + m] @ w, contiguous; partial:
// bwd_dot_scratch(3, m, N, G) floats, the row tiles' column sums
extern "C" int bwd_dot_base(const void* p, const void* w, void* out,
                            void* partial, int K, int N, int m, int G,
                            void* stream) {
  constexpr int SMEM = tc::Ring<kBASE>::BYTES;
  if (K < 1 || N < 1 || m < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tps = (m + tc::BM - 1) / tc::BM;
  const int items = base_items(m, N, G);
  const BaseKernel kernel = base_entry(vec4(p, K, w, N));
  cudaError_t err = allow_smem(kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<std::min(items, kSMs), tc::THREADS, SMEM, st>>>(
      static_cast<const float*>(p), static_cast<const float*>(w),
      static_cast<float*>(partial), K, N, m, tps, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  base_reduce<<<N, THREADS, 0, st>>>(static_cast<const float*>(partial),
                                     static_cast<float*>(out), N, G, tps);
  return (int)cudaGetLastError();
}
