// The 3xTF32 mma.sync mainloop on a ring of cp.async stages: a 128 x 128
// output tile in 8 warps fed by chunks of 32 contraction rows, each operand
// split hi/lo in registers as its fragments are loaded. Shared by the
// backward-dot kernels (bwd_dots.cu: tt, xp, nn, base) and LP's product
// body (layout_micro.cu), which keep their own walks over the tiles and
// their own epilogues.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

// where A lies: tt's and xp's p contraction-major [c][mm]; nn's pk, base's
// p and LP's v row-major [mm][c]
enum Layout { kTT = 0, kNN = 1, kXP = 2, kBASE = 3 };

// The mainloop's block (tt, xp, nn, base; LP's product): a BM x BN output tile
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
// [WARPS_M][BN] (LP's product keeps its sums in registers: TOTAL alone).
// The A fragments are read from a [contraction][row] stage
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

}  // namespace tc

}  // namespace
