// The 3xTF32 wgmma mainloop: out (M, N) = a (M, K) b^T (+ bias), f32 in
// and f32 out, both operands holding the contraction (K) on their fast
// axis, the one form in which wgmma takes TF32 from shared memory (B
// K-major only). Shared by gru_proj.cu's large route (K2p: x Wi + bi, B =
// Wi^T packed once) and bwd_dots.cu's nt (dy w^T, B = w split at every
// call), which keep their own planes, plans and launches.
//
// x = hi + lo, each rounded as mma_tf32.cuh's split; a k8 step takes three
// wgmmas, lo*hi, hi*lo and hi*hi (PASSES 3; 1: hi*hi alone, one TF32 pass,
// another function, to time what the two extra passes cost). B comes as
// planes bt (2, N, KP): hi then lo, KP = K padded to whole chunks of 32
// with zeros, and is copied into shared memory in the 128-byte swizzle;
// a's rows come raw and each warp splits its 16 rows' fragments in
// registers (wgmma's A). A block of two warpgroups computes a 128 x BN tile
// of out, each warpgroup 64 rows; chunks of 32 k come through a ring of
// cp.async stages (zeros past M and K); two register sets, so that chunk
// t's fragments are split while chunk t - 1's wgmmas run. Persistent
// blocks walk the tiles (tile i: rows (i / tiles_n) BM, columns (i %
// tiles_n) BN; the column tile the fast index, so that the blocks at work
// together read the same rows of a) as one stream of chunks, so that a
// tile's store runs while the next tile's chunks land.
//
// The sum of a tile's chunks (SUM): kOne, one wgmma f32 sum over them all
// (K2p's), or kChunks, each chunk's wgmmas from zero and the chunk's sum
// added into the tile's in f32 (nt's, as TT's mma.sync steps: the tensor
// cores' accumulation truncates, and one sum over 8-16 chunks read 6-11x
// the chunked order's error on an H100). kChunks keeps a second BN / 2
// floats a thread: at BN 192 the two sums and the two register sets
// would not fit in 255 registers. Every output's order is fixed: repeated
// launches are bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "tc_mainloop.cuh"
#include "wgmma.cuh"

namespace {

namespace wgl {
constexpr int THREADS = 256, BM = 128, BK = 32, ROW = 4 * BK;  // 128 bytes
constexpr int A_LD = BK + 4;  // a's raw rows (4 mod 32: fragment loads)
constexpr int ALIGN = 1024;   // the 128-byte swizzle's period
constexpr int MAX_STAGES = 4;
enum Sum { kOne = 0, kChunks = 1 };
static_assert(THREADS == tc::THREADS, "tc::copy_tile spreads over a block");

// a stage: bt's hi and lo planes of the tile's BN rows for 32 k ([BN][ROW],
// K-major, 16-byte unit u of row n at u ^ (n % 8): wgmma's 128-byte
// swizzle), then a's raw chunk [BM][A_LD]; as many stages as fit, up to 4
template <int BN>
struct Geo {
  static constexpr int B_PLANE = BN * ROW, A_RAW = BM * A_LD * 4;
  static constexpr int STAGE = 2 * B_PLANE + A_RAW;
  static constexpr int FIT = (232448 - ALIGN) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BYTES = ALIGN + STAGES * STAGE;
  static constexpr int NACC = BN / 2;  // a thread's sums (64 x BN a group)
  static_assert(STAGES >= 3 && B_PLANE % ALIGN == 0 && STAGE % ALIGN == 0,
                "a ring of 3, planes on the swizzle's period");
};

// a chunk's wgmmas (wgmma.cuh's wgmma_chunk, the lo plane B_PLANE bytes
// after the hi one); `first`: the chunk's first wgmma overwrites the sums
template <int BN, int PASSES>
__device__ __forceinline__ void mma_chunk(float (&acc)[Geo<BN>::NACC],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          uint32_t b_hi, bool first) {
  wgmma_chunk<BN, PASSES>(acc, ah, al, b_hi, Geo<BN>::B_PLANE, first);
}

// the thread's outputs of the tile at (m0, n0), + bias[c] where BIAS, rows
// below M and columns below N
template <int BN, int VEC, bool BIAS>
__device__ __forceinline__ void store_tile(const float (&s)[Geo<BN>::NACC],
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int M,
                                           int N, int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + (lane >> 2);
#pragma unroll
  for (int e = 0; e < Geo<BN>::NACC; e += 2) {
    const int r = row + 8 * ((e & 3) >> 1);
    const int c = n0 + e / 4 * 8 + 2 * (lane & 3);
    if (r >= M) continue;
    float* o = out + (size_t)r * N + c;
    if (VEC == 4 && c + 2 <= N) {
      *reinterpret_cast<float2*>(o) =
          BIAS ? make_float2(s[e] + bias[c], s[e + 1] + bias[c + 1])
               : make_float2(s[e], s[e + 1]);
    } else {
      if (c < N) o[0] = BIAS ? s[e] + bias[c] : s[e];
      if (c + 1 < N) o[1] = BIAS ? s[e + 1] + bias[c + 1] : s[e + 1];
    }
  }
}

// out (M, N) = a (M, K) bt[0..1]^T (+ bias): the mainloop above. VEC 4:
// a's rows and out's start on 16 bytes (K and N multiples of 4), else 1;
// grid at most the tiles, dynamic shared memory Geo<BN>::BYTES
template <int BN, int VEC, int PASSES, int SUM, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_3xtf32(const float* __restrict__ a, const float* __restrict__ bt,
             const float* __restrict__ bias, float* __restrict__ out, int M,
             int K, int N, int KP) {
  using G = Geo<BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                              (ALIGN - 1));
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n, chunks = KP / BK;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int count = mine * chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp / 4, wl = warp % 4, g = lane >> 2, t4 = lane & 3;
  int load_tile = blockIdx.x, load_k = 0;
  auto fetch = [&](int t) {  // chunk t, the one after the last fetched
    uint8_t* st = ring + (t % G::STAGES) * G::STAGE;
    const int m0 = load_tile / tiles_n * BM, n0 = load_tile % tiles_n * BN;
    const int k0 = load_k * BK;
    for (int e = threadIdx.x; e < 2 * BN * 8; e += THREADS) {
      const int pl = e / (BN * 8), n = e / 8 % BN, u = e % 8;
      const bool live = n0 + n < N;
      const float* src =
          live ? bt + ((size_t)pl * N + n0 + n) * KP + k0 + 4 * u : bt;
      cp_async16_fill(st + pl * G::B_PLANE + n * ROW + ((u ^ (n & 7)) << 4),
                      src, live ? 16 : 0);
    }
    tc::copy_tile<BM, BK, VEC>(reinterpret_cast<float*>(st + 2 * G::B_PLANE),
                               A_LD, a, K, m0, M, k0, K);
    if (++load_k == chunks) {
      load_k = 0;
      load_tile += gridDim.x;
    }
  };
#pragma unroll
  for (int t = 0; t < G::STAGES - 1; ++t) {
    if (t < count) fetch(t);
    cp_async_commit();
  }
  int tile = blockIdx.x, k = 0;
  float acc[G::NACC];
  float total[SUM == kChunks ? G::NACC : 1];
#pragma unroll
  for (int i = 0; i < (SUM == kChunks ? G::NACC : 1); ++i) total[i] = 0.f;
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  auto fence_all = [&] {
    fence_acc(acc);
    fence_regs(ah0);
    fence_regs(al0);
    fence_regs(ah1);
    fence_regs(al1);
  };
  auto refill = [&](int t) {  // chunk t - 1's stage takes chunk t + S - 1
    __syncthreads();          // ... once both groups' wgmmas are done with it
    if (t + G::STAGES - 1 < count) fetch(t + G::STAGES - 1);
    cp_async_commit();
  };
  auto step = [&](int t, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    cp_async_wait<G::STAGES - 2>();  // chunk t has landed, for this thread
    __syncthreads();                 // ... for all
    const uint8_t* st = ring + (t % G::STAGES) * G::STAGE;
    const float* af = reinterpret_cast<const float*>(st + 2 * G::B_PLANE) +
                      (h * 64 + wl * 16 + g) * A_LD + t4;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {  // the set chunk t - 2 read
      const float v[4] = {af[k8 * 8], af[8 * A_LD + k8 * 8], af[k8 * 8 + 4],
                          af[8 * A_LD + k8 * 8 + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[k8][i], al[k8][i]);
    }
    if constexpr (SUM == kChunks) {  // chunk t's split ran first: it overlaps
      wgmma_wait<0>();               // chunk t - 1's wgmmas, now done
      fence_all();
      if (k > 0) {  // chunk t - 1 was this tile's: its sum joins the tile's
#pragma unroll
        for (int i = 0; i < G::NACC; ++i) total[i] += acc[i];
      }
      refill(t);
    }
    fence_acc(acc);
    wgmma_fence();
    mma_chunk<BN, PASSES>(acc, ah, al, smem_u32(st),
                          SUM == kChunks || k == 0);
    wgmma_commit();
    if constexpr (SUM == kOne) {
      wgmma_wait<1>();  // chunk t - 1's wgmmas are done
      fence_all();
      refill(t);
    }
    if (++k < chunks) return;
    wgmma_wait<0>();
    fence_all();
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    if constexpr (SUM == kChunks) {
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) total[i] += acc[i];
      store_tile<BN, VEC, BIAS>(total, bias, out, M, N, m0, n0);
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) total[i] = 0.f;
    } else {
      store_tile<BN, VEC, BIAS>(acc, bias, out, M, N, m0, n0);
    }
    k = 0;
    tile += gridDim.x;
  };
  for (int t = 0; t < count; ++t) {
    if (t & 1)
      step(t, ah1, al1);
    else
      step(t, ah0, al0);
  }
  cp_async_wait_all();
  wgmma_wait<0>();
}
}  // namespace wgl

}  // namespace
