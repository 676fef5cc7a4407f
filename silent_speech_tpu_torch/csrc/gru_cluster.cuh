// The cluster recurrence: the masked GRU time loop with Wh held on chip
// across a thread-block cluster. K2's recurrence (gru_seq.cu) and the GRU
// design probes (gru_proto.cu: P2a / P2b's recurrence over a hoisted
// projection, P4's dual-chain layer) run these two bodies; a configuration
// type (Cfg) says what a launch reads and rounds, and K2's (K2Cfg) leaves
// every body as gru_seq.cu had it.
//
// Gate order r, z, n:
//   hp = h Wh + bh;  r = sig(xr + hr), z = sig(xz + hz), n = tanh(xn + r hn)
//   h' = (1 - z) n + z h, frozen at t >= len, y zero there.
//
// - One cluster of C blocks runs one (direction or weight set, tile of BT
//   rows). Block c holds, in shared memory for all T steps, the Wh columns
//   of all three gates for hidden units [c U, c U + U), U = ceil(H / C), in
//   the order (Hk/4, 3, Up, 4) the threads read them (ops/cuda_gru.pack_wh:
//   K2 packs it once per model; the probes read the caller's (H, 3H) in the
//   prologue, Cfg::PROBE).
// - Every block holds the whole h of its BT rows, double-buffered. Each step
//   a block computes its units' gates and writes its new h slice into the
//   next-step buffer of every block of the cluster (distributed shared
//   memory, map_shared_rank), then takes one cluster barrier (arrive with
//   release, wait with acquire); the step's y stores and the next step's xp
//   loads go between the arrive and the wait.
// - Two bodies, chosen from the tile: for 1 or 2 rows (latency) four lanes
//   share a hidden unit, each taking every fourth float4 of its k range, and
//   add their sums with two xor shuffles, ((a0 + a1) + (a2 + a3)); for 4 n
//   rows (throughput) a thread computes 4 rows x 1-4 units x 3 gates from
//   float4s of h (k-major) and Wh: over the whole k range in order (K2), or,
//   with Cfg::PROBE, in the split body's four strided partial sums added as
//   its shuffles add them, so that a row's bits do not depend on the tile.
// - Cfg::BF16 (the probes' bf16_mm): Wh rounded to bf16 as it enters shared
//   memory, h rounded as it is written to the cluster's buffers; the f32
//   carry stays in registers and y is the f32 h. Cfg::HALF (P2a / P2b's
//   bf16_mm): Wh held as bf16, half the f32 slice (so C may be smaller),
//   each four k in 8 bytes widened exactly to a float4 as they are read.
// - Cfg::PROJ (P4): the block also holds its units' columns of Wi (D, 3H)
//   and, before every chunk of K steps, computes its units' columns of the
//   chunk's projection x Wi + bi for its BT rows on the tensor cores (3xTF32
//   on mma.sync; one exact pass on bf16 values under BF16), x streamed from
//   device memory into the warps' registers a piece ahead (project_chunk);
//   the steps then read xp from shared memory. The chunks after the first
//   are projected between a step's cluster arrive and wait.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KS = 4;          // lanes that share one hidden unit's k range
constexpr int UW = 32 / KS;    // hidden units a warp
constexpr int KQ = 4 * KS;     // H is padded to a multiple of this
constexpr int MAX_THREADS = 512;
constexpr int TR = 4;  // rows a thread, tiled instantiation
// its largest block: 512 threads for 1 or 2 units a thread, 256 for 4 (whose
// 48 accumulators and 48 prefetched xp values need the registers)
__host__ __device__ constexpr int tile_threads(int tv) {
  return tv == 4 ? 256 : 512;
}
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block, opt-in

// P4's projection: x is read a piece of PK columns ahead; Wi's slice is
// [Dp][WLD], Dp = D rounded up to PK, WLD = 3 Up rounded up to 8 mod 32
// (conflict-free B fragments); xp's chunk is [K BT][3 Up]
constexpr int PK = 32;

// K2's arguments (gru_seq.cu): the directions side by side in one row of
// xp and of y
struct SeqArgs {
  const float* xp;      // (B, T, ldx): direction d's gates at d*3H + g*H + j
  const int* lengths;   // (B,)
  const float* whp;     // (ndir, C, Hk/4, 3, Up, 4): each block's Wh slice
  const float* bh;      // (ndir, 3H)
  float* y;             // (B, T, ldy): direction d writes [d*H, d*H + H)
  int B, T, H, C, U, Up, Hk, BT, ldx, ldy, rev0, rev1;
};

// The probes' (gru_proto.cu): set or chain d's rows one after another, at
// xp + d xoff, y + d yoff and lengths + d loff; Wh (H, 3H) from wh[d]; PROJ
// chain d's input x[d] (B, T, D), wi[d] (D, 3H), bi[d] and bh (bhs[d],
// 3H), D wide, K steps a chunk, Wi's slice [Dp][WLD]; stop (timing only):
// bit 0 skips the chunks' projections, bit 1 the recurrent products
struct ProbeArgs : SeqArgs {
  size_t xoff, yoff;
  int loff;
  const float* wh[2];
  const float* x[2];
  const float* wi[2];
  const float* bi[2];
  const float* bhs[2];
  int D, K, Dp, WLD, stop;
};

// What a launch reads, rounds and holds (see the header note), and its
// arguments. PROBE: Wh from the caller's (H, 3H) and the tiled body in the
// split body's order. K2: none, and K2's arguments.
struct K2Cfg {
  static constexpr bool PROBE = false, BF16 = false, PROJ = false,
                        HALF = false;
  using Args = SeqArgs;
};
template <bool BF16_, bool PROJ_, bool HALF_>
struct ProbeCfg {
  static constexpr bool PROBE = true, BF16 = BF16_, PROJ = PROJ_,
                        HALF = HALF_;
  static_assert(BF16 || !HALF, "Wh is held as bf16 only under bf16_mm");
  using Args = ProbeArgs;
};

// Direction or set d's xp, y and lengths
__device__ __forceinline__ size_t x_off(const SeqArgs& a, int d) {
  return (size_t)d * 3 * a.H;
}
__device__ __forceinline__ size_t x_off(const ProbeArgs& a, int d) {
  return (size_t)d * a.xoff;
}
__device__ __forceinline__ size_t y_off(const SeqArgs& a, int d) {
  return (size_t)d * a.H;
}
__device__ __forceinline__ size_t y_off(const ProbeArgs& a, int d) {
  return (size_t)d * a.yoff;
}
__device__ __forceinline__ const int* lengths_of(const SeqArgs& a, int) {
  return a.lengths;
}
__device__ __forceinline__ const int* lengths_of(const ProbeArgs& a, int d) {
  return a.lengths + (size_t)d * a.loff;
}

// What project_chunk reads, by value (a kernel parameter passed by
// reference would be copied to local memory)
struct ProjArgs {
  const float* x;
  const float* bi;
  int T, D, BT, H, U, Up, Dp, WLD;
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Row groups a warp of the tiled instantiation covers: 4, or fewer when
// the tile has fewer (1, 2), so that few lanes idle
__host__ __device__ constexpr int tile_warp(int nrg) {
  return nrg >= 4 ? 4 : nrg >= 2 ? 2 : 1;
}

// The tiled instantiation's block: whole warps of tile_warp(nrg) row
// groups x 32 / tile_warp(nrg) unit groups
__host__ __device__ constexpr int tile_block(int nrg, int nug) {
  return 32 * ceil_div(nrg, tile_warp(nrg)) *
         ceil_div(nug, 32 / tile_warp(nrg));
}

// Floats of the PROJ block's Wi slice and its chunk of xp, a multiple of 4
// (the h buffers after them stay 16-byte aligned)
__host__ __device__ inline size_t proj_floats(const ProbeArgs& a) {
  return (size_t)a.Dp * a.WLD + (size_t)a.K * a.BT * 3 * a.Up;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// The probes' cast: round to bf16 and back (identity in f32).
template <bool BF16>
__device__ __forceinline__ float cast(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// HALF: a float's bf16 bits, and four k of a Wh column held as four bf16 in
// 8 bytes, widened exactly
__device__ __forceinline__ uint32_t bf16_of(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// PROBE: the block's Wh slice (wq float4s; HALF: wq groups of four bf16 in
// 8 bytes) read from set d's (H, 3H) in the order of K2's pack
// (ops/cuda_gru.pack_wh), zero past H and past the block's units, rounded
// under BF16
template <bool BF16, bool HALF>
__device__ __forceinline__ void load_raw_wh(const float* __restrict__ w,
                                            int H, int U, int Up, int c,
                                            float4* ws, size_t wq) {
  const int H3 = 3 * H;
  for (size_t i = threadIdx.x; i < wq; i += blockDim.x) {
    const int q = (int)(i / (3 * Up)), rem = (int)(i % (3 * Up));
    const int g = rem / Up, u = rem % Up, j = c * U + u;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      v[e] = (k < H && u < U && j < H)
                 ? cast<BF16>(__ldg(w + (size_t)k * H3 + g * H + j))
                 : 0.f;
    }
    if constexpr (HALF)
      reinterpret_cast<uint2*>(ws)[i] =
          make_uint2(bf16_of(v[0]) | bf16_of(v[1]) << 16,
                     bf16_of(v[2]) | bf16_of(v[3]) << 16);
    else
      ws[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// PROJ: the block's Wi slice, [Dp][WLD]: column g Up + u is Wi's column
// g H + c U + u, zero past D, past the block's units and in the padding;
// rounded under BF16
template <bool BF16>
__device__ __forceinline__ void load_wi(const float* __restrict__ w,
                                        const ProjArgs& p, int c,
                                        float* wis) {
  const int H = p.H, Up = p.Up, N = 3 * Up;
  for (int i = threadIdx.x; i < p.Dp * p.WLD; i += blockDim.x) {
    const int e = i / p.WLD, n = i % p.WLD;
    const int g = n / Up, u = n % Up, j = c * p.U + u;
    wis[i] = (e < p.D && n < N && u < p.U && j < H)
                 ? cast<BF16>(__ldg(w + (size_t)e * 3 * H + g * H + j))
                 : 0.f;
  }
}

// PROJ: xs[m][3 Up] = x[row b0 + b, step t0 + k] Wi + bi over the block's
// columns, m = k BT + b, for the chunk's kn steps (rows past their length
// read as zeros and are never used), by every warp of the block (stop bit
// 0: zeros instead), between block barriers: the first chunk before any
// step, each later one between the cluster arrive and wait of the step
// before it. The warps walk (m16 tile, group of n8 tiles) items, the
// groups as small as keeps every warp busy (at most NG tiles: 3 Up / 8 = 9
// at C=8, H=192). Each lane loads its A fragments (rows g and g + 8, four
// columns a k8 slice) from device memory into registers, a PK-column piece
// ahead of the piece its MMAs consume, and its B fragments from the Wi
// slice, split as they are loaded. One f32 accumulator over all of D, each
// k8 slice adding lo*hi, hi*lo and hi*hi (mma_3xtf32; under BF16 the one
// exact pass); then bi.
constexpr int NG = 9;
template <bool BF16>
__device__ void project_chunk(const ProjArgs p, int c, int b0, int t0,
                              int kn, const int* lens, const float* wis,
                              float* xs, int stop) {
  const int BT = p.BT, D = p.D, Up = p.Up, N = 3 * Up, WLD = p.WLD;
  const int M = kn * BT, mtiles = ceil_div(M, 16), n8 = N / 8;
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  int groups = mtiles >= nw ? 1 : min(n8, nw / mtiles);
  groups = max(groups, ceil_div(n8, NG));
  const int ng = ceil_div(n8, groups), pieces = p.Dp / PK;

  __syncthreads();  // every read of the last chunk is done
  if (stop & 1) {
    for (int i = threadIdx.x; i < M * N; i += blockDim.x) xs[i] = 0.f;
    __syncthreads();
    return;
  }
  for (int it = threadIdx.x >> 5; it < mtiles * groups; it += nw) {
    const int mt = it / groups, n0 = (it % groups) * ng;
    const float* row[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 16 + g + 8 * h, k = m / BT, b = m - k * BT;
      live[h] = m < M && t0 + k < lens[b];
      row[h] = p.x + ((size_t)(b0 + (live[h] ? b : 0)) * p.T +
                      (live[h] ? t0 + k : 0)) * D;
    }
    // a piece's A values: [k8 slice][a0..a3] of rows g, g + 8
    auto load_piece = [&](int pc, float (&v)[PK / 8][4]) {
#pragma unroll
      for (int q = 0; q < PK / 8; ++q) {
        const int e = pc * PK + 8 * q + tq;
        v[q][0] = live[0] && e < D ? __ldg(row[0] + e) : 0.f;
        v[q][1] = live[1] && e < D ? __ldg(row[1] + e) : 0.f;
        v[q][2] = live[0] && e + 4 < D ? __ldg(row[0] + e + 4) : 0.f;
        v[q][3] = live[1] && e + 4 < D ? __ldg(row[1] + e + 4) : 0.f;
      }
    };
    float acc[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float cur[PK / 8][4], nxt[PK / 8][4];
    load_piece(0, cur);
    for (int pc = 0; pc < pieces; ++pc) {
      if (pc + 1 < pieces) load_piece(pc + 1, nxt);
#pragma unroll
      for (int q = 0; q < PK / 8; ++q) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (BF16)
            ah[e] = tf32(cast<true>(cur[q][e]));  // exact: a bf16 value
          else
            split(cur[q][e], ah[e], al[e]);
        }
        const float* wrow = wis + (size_t)(pc * PK + 8 * q + tq) * WLD + g;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int nt = n0 + i;
          if (i >= ng || nt >= n8) continue;
          const float w0 = wrow[nt * 8], w1 = wrow[4 * WLD + nt * 8];
          if constexpr (BF16) {
            mma_tf32(acc[i], ah, tf32(w0), tf32(w1));
          } else {
            uint32_t bh[2], bl[2];
            split(w0, bh[0], bl[0]);
            split(w1, bh[1], bl[1]);
            mma_3xtf32(acc[i], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < PK / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[q][e] = nxt[q][e];
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int nt = n0 + i;
      if (i >= ng || nt >= n8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + (e >> 1) * 8;
        const int n = nt * 8 + 2 * tq + (e & 1);
        const int gg = n / Up, u = n % Up, j = c * p.U + u;
        const float bias =
            (u < p.U && j < p.H) ? __ldg(p.bi + gg * p.H + j) : 0.f;
        if (m < M) xs[(size_t)m * N + n] = acc[i][e] + bias;
      }
    }
  }
  __syncthreads();  // xs holds the chunk
}

// The split instantiation, for tiles of 1 or 2 rows (latency): KS lanes
// share a hidden unit's k range, eight units a warp, so a quarter-warp's Wh
// loads are eight consecutive float4s and its h loads one broadcast
// float4; after the shuffles every lane of a unit holds the same bits.
// grid (C * ceil(B / BT), ndir), cluster
// (C, 1, 1), block KS * Up threads; dynamic shared memory: [Wh slice
// (SMEM_W)] [PROJ: Wi slice, xp chunk] [h: 2 x BT x Hk, row-major]
// [lengths: BT]
template <int BT, bool SMEM_W, class Cfg>
__global__ void __launch_bounds__(MAX_THREADS)
    gru_seq_kernel(const typename Cfg::Args a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, H = a.H, Hk = a.Hk, Up = a.Up, T = a.T;
  const int c = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int rev = d ? a.rev1 : a.rev0;
  const int nq = Hk / 4;                       // float4 chunks of k
  const size_t wq = (size_t)nq * 3 * Up;       // float4s of a block's slice
  const float4* w =
      reinterpret_cast<const float4*>(a.whp) + ((size_t)d * C + c) * wq;
  float* pbuf = reinterpret_cast<float*>(
      smem4 + (SMEM_W ? wq / (Cfg::HALF ? 2 : 1) : 0));
  float* hbuf = pbuf;
  if constexpr (Cfg::PROJ) hbuf += proj_floats(a);
  int* lens = reinterpret_cast<int*>(hbuf + 2 * BT * Hk);

  ProjArgs pa = {};
  if constexpr (Cfg::PROJ)
    pa = {d ? a.x[1] : a.x[0], d ? a.bi[1] : a.bi[0], T, a.D, BT, H, a.U,
          Up, a.Dp, a.WLD};
  if constexpr (SMEM_W) {
    if constexpr (Cfg::PROBE)
      load_raw_wh<Cfg::BF16, Cfg::HALF>(d ? a.wh[1] : a.wh[0], H, a.U, Up,
                                        c, smem4, wq);
    else
      for (size_t i = threadIdx.x; i < wq; i += blockDim.x)
        smem4[i] = __ldg(w + i);
    w = smem4;
  }
  if constexpr (Cfg::PROJ)
    load_wi<Cfg::BF16>(d ? a.wi[1] : a.wi[0], pa, c, pbuf);
  const int* lengths = lengths_of(a, d);
  for (int i = threadIdx.x; i < 2 * BT * Hk; i += blockDim.x) hbuf[i] = 0.f;
  if (threadIdx.x < BT) {
    const int b = b0 + threadIdx.x;
    lens[threadIdx.x] = b < a.B ? min(max(lengths[b], 0), T) : 0;
  }
  // every block's buffers are zero (and the block resident) before any
  // block stores into them
  cluster.sync();

  int tmax = 0;  // the same in every block of the cluster
#pragma unroll
  for (int b = 0; b < BT; ++b) tmax = max(tmax, lens[b]);

  const int lane = threadIdx.x & 31;
  const int s = lane / UW;                       // this lane's k split
  const int u = (threadIdx.x >> 5) * UW + lane % UW;  // unit in the block
  const int j = c * a.U + u;                     // hidden unit
  const bool own = u < a.U && j < H;
  const float* bh = a.bh + (size_t)d * 3 * H;
  if constexpr (Cfg::PROJ) bh = d ? a.bhs[1] : a.bhs[0];
  const float bhr = own ? bh[j] : 0.f, bhz = own ? bh[H + j] : 0.f,
              bhn = own ? bh[2 * H + j] : 0.f;
  const float* xpd = a.xp + x_off(a, d) + j;
  float* yd = a.y + y_off(a, d) + j;
  float* xs = nullptr;  // PROJ: the chunk's xp
  if constexpr (Cfg::PROJ) xs = pbuf + (size_t)a.Dp * a.WLD;

  // lane s finishes rows b = s, s + KS, ...; arrays indexed b / KS
  constexpr int RPL = (BT + KS - 1) / KS;
  int len[RPL] = {};
  float xr[RPL], xz[RPL], xn[RPL], hy[RPL];
#pragma unroll
  for (int b = 0; b < BT; ++b)
    if (b % KS == s) len[b / KS] = lens[b];
  if constexpr (Cfg::BF16) {  // hy carries the f32 h
#pragma unroll
    for (int m = 0; m < RPL; ++m) hy[m] = 0.f;
  }

  auto load_x = [&](int t) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b % KS != s) continue;
      const int L = len[b / KS];
      float vr = 0.f, vz = 0.f, vn = 0.f;
      if (own && t < L) {
        if constexpr (Cfg::PROJ) {
          const float* p = xs + ((size_t)(t % a.K) * BT + b) * 3 * Up + u;
          vr = p[0];
          vz = p[Up];
          vn = p[2 * Up];
        } else {
          const float* p =
              xpd + ((size_t)(b0 + b) * T + (rev ? L - 1 - t : t)) * a.ldx;
          vr = p[0];
          vz = p[H];
          vn = p[2 * H];
        }
      }
      xr[b / KS] = vr;
      xz[b / KS] = vz;
      xn[b / KS] = vn;
    }
  };
  // PROJ: at a step t0 that starts a chunk, the chunk's projection, by
  // every warp of the block
  auto project = [&](int t0) {
    if constexpr (Cfg::PROJ)
      if (t0 % a.K == 0)
        project_chunk<Cfg::BF16>(pa, c, b0, t0, min(a.K, tmax - t0), lens,
                                 pbuf, xs, a.stop);
  };
  if (Cfg::PROJ && tmax > 0) project(0);
  load_x(0);
  int qn = nq;  // the timing stop's bit 1: no recurrent product
  if constexpr (Cfg::PROJ)
    if (a.stop & 2) qn = 0;

  for (int t = 0; t < tmax; ++t) {
    const float* hc = hbuf + (t & 1) * BT * Hk;
    float* hnext = hbuf + ((t + 1) & 1) * BT * Hk;

    float acc[3][BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[0][b] = acc[1][b] = acc[2][b] = 0.f;
    for (int q = s; q < qn; q += KS) {
      float4 wv[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4* p = w + ((size_t)q * 3 + g) * Up + u;
        if constexpr (Cfg::HALF)
          wv[g] = widen(reinterpret_cast<const uint2*>(w)[p - w]);
        else if constexpr (SMEM_W)
          wv[g] = *p;
        else
          wv[g] = __ldg(p);
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 hv = *reinterpret_cast<const float4*>(hc + b * Hk + 4 * q);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float v = acc[g][b];
          v = fmaf(hv.x, wv[g].x, v);
          v = fmaf(hv.y, wv[g].y, v);
          v = fmaf(hv.z, wv[g].z, v);
          v = fmaf(hv.w, wv[g].w, v);
          acc[g][b] = v;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        float v = acc[g][b];
        v += __shfl_xor_sync(0xffffffffu, v, UW);
        v += __shfl_xor_sync(0xffffffffu, v, 2 * UW);
        acc[g][b] = v;
      }

#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b % KS != s || !own) continue;
      const int m = b / KS;
      float hold;
      if constexpr (Cfg::BF16)
        hold = hy[m];
      else
        hold = hc[b * Hk + j];
      float h = hold;
      if (t < len[m]) {
        const float r = sigmoid(xr[m] + (acc[0][b] + bhr));
        const float z = sigmoid(xz[m] + (acc[1][b] + bhz));
        const float n = tanhf(xn[m] + r * (acc[2][b] + bhn));
        h = (1.f - z) * n + z * hold;
      }
      hy[m] = h;
      if (t + 1 < tmax) {
        const float hw = cast<Cfg::BF16>(h);
        for (int r = 0; r < C; ++r)
          cluster.map_shared_rank(hnext, r)[b * Hk + j] = hw;
      }
    }
    cluster_arrive();
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b % KS != s || !own || b0 + b >= a.B) continue;
      const int L = len[b / KS];
      const bool valid = t < L;
      const int tt = (valid && rev) ? L - 1 - t : t;
      yd[((size_t)(b0 + b) * T + tt) * a.ldy] = valid ? hy[b / KS] : 0.f;
    }
    if (Cfg::PROJ && t + 1 < tmax) project(t + 1);
    if (t + 1 < tmax) load_x(t + 1);
    cluster_wait();
  }

  // every row is past its length from tmax on
  for (int t = tmax; t < T; ++t)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b % KS == s && own && b0 + b < a.B)
        yd[((size_t)(b0 + b) * T + t) * a.ldy] = 0.f;
}

// The tiled instantiation, for tiles of BT = 4 n rows (throughput): each
// thread computes TR = 4 rows x TV hidden units x 3 gates over the whole k
// range, so four k of its 4 rows of h (four float4s: h is k-major here)
// and 3 TV float4s of Wh feed 48 TV FMAs, and the new h of a unit's 4 rows
// leaves as one float4 store a cluster block. Thread (rg, ug) takes rows
// [TR rg, TR rg + TR) and units ug, ug + NUG, ... (NUG = Up / TV). A warp
// covers WR row groups x 32 / WR unit groups (tile_warp), so its h loads
// are WR float4s, its Wh loads 32 / WR consecutive float4s shared by the
// WR row groups, and its xp loads and y stores whole 32-byte runs of
// consecutive units. TV is the smallest of 1, 2, 4 whose block fits
// tile_threads(TV) (1 at B=256, 2 at B=1024 for H=192). grid and cluster
// as the split instantiation, block tile_block(BT / TR, NUG) threads (PROJ:
// at least KS Up, whose extra warps only project); dynamic shared memory:
// [Wh slice (SMEM_W)] [PROJ: Wi slice, xp chunk] [h: 2 x Hk x BT,
// k-major] [lengths]
template <int TV, bool SMEM_W, class Cfg>
__global__ void __launch_bounds__(tile_threads(TV))
    gru_seq_tile_kernel(const typename Cfg::Args a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, H = a.H, Hk = a.Hk, Up = a.Up, T = a.T, BT = a.BT;
  const int c = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int rev = d ? a.rev1 : a.rev0;
  const int nq = Hk / 4;
  const size_t wq = (size_t)nq * 3 * Up;
  const float4* w =
      reinterpret_cast<const float4*>(a.whp) + ((size_t)d * C + c) * wq;
  float* pbuf = reinterpret_cast<float*>(
      smem4 + (SMEM_W ? wq / (Cfg::HALF ? 2 : 1) : 0));
  float* hbuf = pbuf;
  if constexpr (Cfg::PROJ) hbuf += proj_floats(a);
  int* lens = reinterpret_cast<int*>(hbuf + 2 * BT * Hk);

  ProjArgs pa = {};
  if constexpr (Cfg::PROJ)
    pa = {d ? a.x[1] : a.x[0], d ? a.bi[1] : a.bi[0], T, a.D, BT, H, a.U,
          Up, a.Dp, a.WLD};
  if constexpr (SMEM_W) {
    if constexpr (Cfg::PROBE)
      load_raw_wh<Cfg::BF16, Cfg::HALF>(d ? a.wh[1] : a.wh[0], H, a.U, Up,
                                        c, smem4, wq);
    else
      for (size_t i = threadIdx.x; i < wq; i += blockDim.x)
        smem4[i] = __ldg(w + i);
    w = smem4;
  }
  if constexpr (Cfg::PROJ)
    load_wi<Cfg::BF16>(d ? a.wi[1] : a.wi[0], pa, c, pbuf);
  const int* lengths = lengths_of(a, d);
  for (int i = threadIdx.x; i < 2 * BT * Hk; i += blockDim.x) hbuf[i] = 0.f;
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    const int b = b0 + i;
    lens[i] = b < a.B ? min(max(lengths[b], 0), T) : 0;
  }
  cluster.sync();

  int tmax = 0;  // the same in every block of the cluster
  for (int b = 0; b < BT; ++b) tmax = max(tmax, lens[b]);

  // this lane's row group and unit group; lanes past either edge compute
  // on the last group's operands and store nothing
  const int nrg = BT / TR, nug = Up / TV, wr = tile_warp(nrg),
            wu = 32 / wr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nub = ceil_div(nug, wu);
  const int rg = (warp / nub) * wr + lane / wu;
  const int ug = (warp % nub) * wu + lane % wu;
  const bool live = rg < nrg && ug < nug;
  // PROJ's extra warps (past the body's block) only project, and the
  // timing stop's bit 1 skips the products
  bool steps = true;
  if constexpr (Cfg::PROJ)
    steps = warp < ceil_div(nrg, wr) * nub && !(a.stop & 2);
  const int r0 = TR * min(rg, nrg - 1), u0 = min(ug, nug - 1);
  int len[TR], jv[TV];
  bool own[TV];
  float bhv[3][TV];
#pragma unroll
  for (int r = 0; r < TR; ++r) len[r] = live ? lens[r0 + r] : 0;
  const float* bh = a.bh + (size_t)d * 3 * H;
  if constexpr (Cfg::PROJ) bh = d ? a.bhs[1] : a.bhs[0];
#pragma unroll
  for (int v = 0; v < TV; ++v) {
    const int u = u0 + v * nug;
    jv[v] = c * a.U + u;
    own[v] = live && u < a.U && jv[v] < H;
#pragma unroll
    for (int g = 0; g < 3; ++g) bhv[g][v] = own[v] ? bh[g * H + jv[v]] : 0.f;
  }
  const float* xpd = a.xp + x_off(a, d);
  float* yd = a.y + y_off(a, d);
  float* xs = nullptr;  // PROJ: the chunk's xp
  if constexpr (Cfg::PROJ) xs = pbuf + (size_t)a.Dp * a.WLD;

  float xv[3][TV][TR];
  float hcar[TV][TR];  // BF16: the f32 carry
  if constexpr (Cfg::BF16) {
#pragma unroll
    for (int v = 0; v < TV; ++v)
#pragma unroll
      for (int r = 0; r < TR; ++r) hcar[v][r] = 0.f;
  }
  auto load_x = [&](int t) {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int L = len[r];
      if constexpr (Cfg::PROJ) {
        const float* p = xs + ((size_t)(t % a.K) * BT + r0 + r) * 3 * Up;
#pragma unroll
        for (int v = 0; v < TV; ++v)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xv[g][v][r] =
                (t < L && own[v]) ? p[g * Up + u0 + v * nug] : 0.f;
      } else {
        const float* p =
            xpd + ((size_t)(b0 + r0 + r) * T + (rev ? L - 1 - t : t)) * a.ldx;
#pragma unroll
        for (int v = 0; v < TV; ++v)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xv[g][v][r] = (t < L && own[v]) ? p[g * H + jv[v]] : 0.f;
      }
    }
  };
  // PROJ: at a step t0 that starts a chunk, the chunk's projection, by
  // every warp of the block
  auto project = [&](int t0) {
    if constexpr (Cfg::PROJ)
      if (t0 % a.K == 0)
        project_chunk<Cfg::BF16>(pa, c, b0, t0, min(a.K, tmax - t0), lens,
                                 pbuf, xs, a.stop);
  };
  if (Cfg::PROJ && tmax > 0) project(0);
  load_x(0);

  // the sum over q = q0, q0 + dq, ... of this thread's 4 rows x TV units
  auto product = [&](const float* hc, int q0, int dq,
                     float (&acc)[3][TV][TR]) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int v = 0; v < TV; ++v)
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[g][v][r] = 0.f;
    for (int q = q0; q < nq; q += dq) {
      float hk[4][TR];  // rows r0.. at k = 4q + i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(hc + (4 * q + i) * BT + r0);
        hk[i][0] = h4.x;
        hk[i][1] = h4.y;
        hk[i][2] = h4.z;
        hk[i][3] = h4.w;
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int v = 0; v < TV; ++v) {
          const float4* p = w + ((size_t)q * 3 + g) * Up + u0 + v * nug;
          float4 wv;
          if constexpr (Cfg::HALF)
            wv = widen(reinterpret_cast<const uint2*>(w)[p - w]);
          else if constexpr (SMEM_W)
            wv = *p;
          else
            wv = __ldg(p);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            float x = acc[g][v][r];
            x = fmaf(hk[0][r], wv.x, x);
            x = fmaf(hk[1][r], wv.y, x);
            x = fmaf(hk[2][r], wv.z, x);
            x = fmaf(hk[3][r], wv.w, x);
            acc[g][v][r] = x;
          }
        }
    }
  };

  for (int t = 0; t < tmax; ++t) {
    const float* hc = hbuf + (t & 1) * Hk * BT;
    float* hnext = hbuf + ((t + 1) & 1) * Hk * BT;

    float acc[3][TV][TR];
    if constexpr (Cfg::PROBE) {
      if (steps) {
        // the split body's order: ((a0 + a1) + (a2 + a3)), a_s the sum
        // over q = s mod KS
        float p0[3][TV][TR], p1[3][TV][TR];
        product(hc, 0, KS, p0);
        product(hc, 1, KS, p1);
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int v = 0; v < TV; ++v)
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[g][v][r] = p0[g][v][r] + p1[g][v][r];
        product(hc, 2, KS, p0);
        product(hc, 3, KS, p1);
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int v = 0; v < TV; ++v)
#pragma unroll
            for (int r = 0; r < TR; ++r)
              acc[g][v][r] = acc[g][v][r] + (p0[g][v][r] + p1[g][v][r]);
      } else {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int v = 0; v < TV; ++v)
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[g][v][r] = 0.f;
      }
    } else {
      product(hc, 0, 1, acc);
    }

    float hy[TV][TR];
#pragma unroll
    for (int v = 0; v < TV; ++v)
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        float hold;
        if constexpr (Cfg::BF16)
          hold = hcar[v][r];
        else
          hold = own[v] ? hc[jv[v] * BT + r0 + r] : 0.f;
        float h = hold;
        if (own[v] && t < len[r]) {
          const float rg = sigmoid(xv[0][v][r] + (acc[0][v][r] + bhv[0][v]));
          const float z = sigmoid(xv[1][v][r] + (acc[1][v][r] + bhv[1][v]));
          const float n =
              tanhf(xv[2][v][r] + rg * (acc[2][v][r] + bhv[2][v]));
          h = (1.f - z) * n + z * hold;
        }
        hy[v][r] = h;
        if constexpr (Cfg::BF16) hcar[v][r] = h;
      }
    if (t + 1 < tmax) {
#pragma unroll
      for (int v = 0; v < TV; ++v) {
        if (!own[v]) continue;
        const float4 h4 =
            make_float4(cast<Cfg::BF16>(hy[v][0]), cast<Cfg::BF16>(hy[v][1]),
                        cast<Cfg::BF16>(hy[v][2]), cast<Cfg::BF16>(hy[v][3]));
        for (int k = 0; k < C; ++k)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(hnext, k) +
                                     jv[v] * BT + r0) = h4;
      }
    }
    cluster_arrive();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (b0 + r0 + r >= a.B) continue;
      const int L = len[r];
      const bool valid = t < L;
      float* yr =
          yd + ((size_t)(b0 + r0 + r) * T + (valid && rev ? L - 1 - t : t)) *
                   a.ldy;
#pragma unroll
      for (int v = 0; v < TV; ++v)
        if (own[v]) yr[jv[v]] = valid ? hy[v][r] : 0.f;
    }
    if (Cfg::PROJ && t + 1 < tmax) project(t + 1);
    if (t + 1 < tmax) load_x(t + 1);
    cluster_wait();
  }

  for (int t = tmax; t < T; ++t)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (b0 + r0 + r >= a.B) continue;
      float* yr = yd + ((size_t)(b0 + r0 + r) * T + t) * a.ldy;
#pragma unroll
      for (int v = 0; v < TV; ++v)
        if (own[v]) yr[jv[v]] = 0.f;
    }
}

template <class Cfg>
using Kernel = void (*)(const typename Cfg::Args);

// The tiles a plan tries, in order: 1, 2, then multiples of TR
constexpr int next_tile(int bt) { return bt < 2 ? 2 : bt < TR ? TR : bt + TR; }

// Units a thread of the tiled instantiation: the smallest of 1, 2, 4 that
// keeps the block to tile_threads (0: none does)
int tile_units(int BT, int Up) {
  for (int tv = 1; tv <= 4; tv *= 2)
    if (tile_block(BT / TR, Up / tv) <= tile_threads(tv)) return tv;
  return 0;
}

// Each body with Wh in shared memory or read from device memory (K2's
// route for H above 384); the probes hold it in shared memory only
template <int BT, class Cfg>
Kernel<Cfg> split_body(bool smem_w) {
  if constexpr (Cfg::PROBE)
    return gru_seq_kernel<BT, true, Cfg>;
  else
    return smem_w ? gru_seq_kernel<BT, true, Cfg>
                  : gru_seq_kernel<BT, false, Cfg>;
}
template <int TV, class Cfg>
Kernel<Cfg> tile_body(bool smem_w) {
  if constexpr (Cfg::PROBE)
    return gru_seq_tile_kernel<TV, true, Cfg>;
  else
    return smem_w ? gru_seq_tile_kernel<TV, true, Cfg>
                  : gru_seq_tile_kernel<TV, false, Cfg>;
}

// The instantiation for a tile of BT rows: split for 1 or 2, tiled for a
// multiple of TR (nullptr for any other BT, and for the probes without
// smem_w).
template <class Cfg>
Kernel<Cfg> pick(int BT, int Up, bool smem_w) {
  if (Cfg::PROBE && !smem_w) return nullptr;
  if (BT == 1) return split_body<1, Cfg>(smem_w);
  if (BT == 2) return split_body<2, Cfg>(smem_w);
  if (BT < TR || BT % TR) return nullptr;
  switch (tile_units(BT, Up)) {
    case 1: return tile_body<1, Cfg>(smem_w);
    case 2: return tile_body<2, Cfg>(smem_w);
    case 4: return tile_body<4, Cfg>(smem_w);
  }
  return nullptr;
}

// The arguments' derived sizes, the launch's block size and shared memory;
// false if the shapes are not ones the kernel takes. PROJ reads a.D and a.K
// and sets a.Dp and a.WLD.
template <class Cfg>
bool layout(typename Cfg::Args& a, int H, int C, int BT, bool smem_w,
            int* threads, size_t* smem) {
  if (H < 1 || H > 1024 || !(C == 1 || C == 2 || C == 4 || C == 8))
    return false;
  a.H = H;
  a.C = C;
  a.BT = BT;
  a.U = ceil_div(H, C);
  a.Up = ceil_div(a.U, UW) * UW;
  a.Hk = ceil_div(H, KQ) * KQ;
  if (!pick<Cfg>(BT, a.Up, smem_w)) return false;
  const int tv = BT <= 2 ? 0 : tile_units(BT, a.Up);
  *threads = BT <= 2 ? KS * a.Up : tile_block(BT / TR, a.Up / tv);
  size_t extra = 0;
  if constexpr (Cfg::PROJ) {
    if (a.D < 1 || a.K < 1) return false;
    a.Dp = ceil_div(a.D, PK) * PK;
    a.WLD = 3 * a.Up + ((8 - 3 * a.Up) % 32 + 32) % 32;
    extra = proj_floats(a) * sizeof(float);
    // at least KS Up threads: the split body's, Up / 8 warps to project
    *threads = *threads > KS * a.Up ? *threads : KS * a.Up;
  }
  const size_t wbytes =
      smem_w ? (size_t)a.Hk * 3 * a.Up * (Cfg::HALF ? 2 : sizeof(float)) : 0;
  *smem = wbytes + extra + (size_t)2 * BT * a.Hk * sizeof(float) +
          (size_t)ceil_div(BT, 4) * 16;
  return *threads <= (BT <= 2 ? MAX_THREADS : tile_threads(tv)) &&
         *smem <= SMEM_LIMIT;
}

cudaLaunchConfig_t config(const SeqArgs& a, int ndir, size_t smem,
                          int threads, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * ceil_div(a.B, a.BT), ndir, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of a launch of this kernel, block size and shared memory
// that the card runs at once (cudaOccupancyMaxActiveClusters, the shared
// memory limit raised first), asked once per (device, instantiation, shared
// memory, cluster, block size).
std::mutex clusters_mutex;
std::map<std::tuple<int, void*, size_t, int, int>, int> clusters_seen;

template <class Cfg>
cudaError_t max_clusters(Kernel<Cfg> kernel, const cudaLaunchConfig_t& cfg,
                         int* clusters) {
  std::lock_guard<std::mutex> lock(clusters_mutex);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const auto key =
      std::make_tuple(device, (void*)kernel, cfg.dynamicSmemBytes,
                      (int)cfg.attrs[0].val.clusterDim.x, (int)cfg.blockDim.x);
  const auto seen = clusters_seen.find(key);
  if (seen != clusters_seen.end()) {
    *clusters = seen->second;
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  clusters_seen[key] = *clusters;
  return cudaSuccess;
}

// A launch as a plan chooses it.
struct Plan {
  int U, Up, Hk, BT, smem_w, smem, threads, blocks, clusters, waves;
};

}  // namespace
