// GRU recurrence kernel for Hopper (sm_90a): the masked GRU time loop of one
// layer (one direction or both) over an input projection computed before it
// (csrc/gru_proj.cu), with Wh held on chip across a thread-block cluster.
//
// With gru_proj it replaces the TPU kernel silent_speech_tpu/ops/
// pallas_gru.py::_gru_fusedproj_kernel (reached through gru_sequence_pallas
// / bigru_pallas). Same function, gate order r, z, n:
//
//   xp = x_t Wi + bi (gru_proj), hp = h Wh + bh    (Wh (H, 3H))
//   r = sig(xr + hr), z = sig(xz + hz), n = tanh(xn + r * hn)
//   h' = (1 - z) n + z h
//
// with h frozen for t >= len and y zero there. The reverse direction reads
// xp at L-1-t and writes y there (for t < L), which equals flip_padded
// around a forward pass, without the two gathers.
//
// What bounds it on the H100: the chain of T dependent steps. A step's
// work is small (a (BT, H) x (H, 3H) product) and cannot start before the
// last step's h is everywhere, so the time is T x (a step's latency) at
// small batch and T x (a step's FMAs over the SMs that run them) at large.
// Wh in f32 is 442 KB a direction at H=192: more than the 227 KB of shared
// memory one block can hold, so a single block would stream it from L2
// every step (what this kernel's first design did, 61 us a step).
//
// What the design does about it:
// - One cluster of C blocks runs one (direction, tile of BT batch rows).
//   Block c holds, in shared memory for all T steps, the Wh columns of all
//   three gates for hidden units [c U, c U + U), U = ceil(H / C), packed
//   once per model by ops/cuda_gru.pack_wh in the order the threads read
//   them; no weight is read from device memory inside the time loop.
// - Every block holds the whole h of its BT rows, double-buffered. Each
//   step a block computes its units' gates and writes its new h slice into
//   the next-step buffer of every block of the cluster (distributed shared
//   memory, map_shared_rank), then takes one cluster barrier (arrive with
//   release, wait with acquire); the step's y stores and the next step's
//   xp loads go between the arrive and the wait.
// - Two bodies, chosen from the tile: for 1 or 2 rows (latency; the live
//   B=1 path) four lanes share a hidden unit, each taking every fourth
//   float4 of its k range, and add their sums with two xor shuffles; for
//   4 n rows (throughput) a thread computes 4 rows x 1-4 units x 3 gates
//   over the whole k range from float4s of h (k-major) and Wh. At B=1 the
//   first takes 2.0 us a step, the second 5.6; at B=1024 the second runs
//   72-row tiles in one wave. Each sum runs in a fixed order: repeated
//   calls are bitwise equal.
// - C is chosen with the weights' layout (ops/cuda_gru.cluster_size: the
//   smallest of 1, 2, 4, 8 whose Wh slice is at most 128 KiB, 4 at H=192).
//   gru_seq_plan chooses the rest from the shapes and the card: Wh in
//   shared memory whenever its slice fits beside one row's h, and BT the
//   smallest tile (1, 2, then multiples of 4) whose clusters the card runs
//   in one wave, by cudaOccupancyMaxActiveClusters (the GPCs hold fewer
//   clusters of 4 large blocks than 132 / 4), else the largest that fits.
//   Where the slice does not fit (H above 384), the SMEM_W=false
//   instantiations read it from device memory each step instead: a route
//   chosen from the shape, never a fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

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

struct SeqArgs {
  const float* xp;      // (B, T, ldx): direction d's gates at d*3H + g*H + j
  const int* lengths;   // (B,)
  const float* whp;     // (ndir, C, Hk/4, 3, Up, 4): each block's Wh slice
  const float* bh;      // (ndir, 3H)
  float* y;             // (B, T, ldy): direction d writes [d*H, d*H + H)
  int B, T, H, C, U, Up, Hk, BT, ldx, ldy, rev0, rev1;
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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The split instantiation, for tiles of 1 or 2 rows (latency): KS lanes
// share a hidden unit's k range, eight units a warp, so a quarter-warp's Wh
// loads are eight consecutive float4s and its h loads one broadcast
// float4; after the shuffles every lane of a unit holds the same bits.
// grid (C * ceil(B / BT), ndir), cluster
// (C, 1, 1), block KS * Up threads; dynamic shared memory: [Wh slice
// (SMEM_W)] [h: 2 x BT x Hk, row-major] [lengths: BT]
template <int BT, bool SMEM_W>
__global__ void __launch_bounds__(MAX_THREADS)
    gru_seq_kernel(const SeqArgs a) {
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
  float* hbuf = reinterpret_cast<float*>(smem4 + (SMEM_W ? wq : 0));
  int* lens = reinterpret_cast<int*>(hbuf + 2 * BT * Hk);

  if constexpr (SMEM_W) {
    for (size_t i = threadIdx.x; i < wq; i += blockDim.x)
      smem4[i] = __ldg(w + i);
    w = smem4;
  }
  for (int i = threadIdx.x; i < 2 * BT * Hk; i += blockDim.x) hbuf[i] = 0.f;
  if (threadIdx.x < BT) {
    const int b = b0 + threadIdx.x;
    lens[threadIdx.x] = b < a.B ? min(max(a.lengths[b], 0), T) : 0;
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
  const float bhr = own ? bh[j] : 0.f, bhz = own ? bh[H + j] : 0.f,
              bhn = own ? bh[2 * H + j] : 0.f;
  const float* xpd = a.xp + (size_t)d * 3 * H + j;
  float* yd = a.y + (size_t)d * H + j;

  // lane s finishes rows b = s, s + KS, ...; arrays indexed b / KS
  constexpr int RPL = (BT + KS - 1) / KS;
  int len[RPL] = {};
  float xr[RPL], xz[RPL], xn[RPL], hy[RPL];
#pragma unroll
  for (int b = 0; b < BT; ++b)
    if (b % KS == s) len[b / KS] = lens[b];

  auto load_x = [&](int t) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b % KS != s) continue;
      const int L = len[b / KS];
      float vr = 0.f, vz = 0.f, vn = 0.f;
      if (own && t < L) {
        const float* p =
            xpd + ((size_t)(b0 + b) * T + (rev ? L - 1 - t : t)) * a.ldx;
        vr = p[0];
        vz = p[H];
        vn = p[2 * H];
      }
      xr[b / KS] = vr;
      xz[b / KS] = vz;
      xn[b / KS] = vn;
    }
  };
  load_x(0);

  for (int t = 0; t < tmax; ++t) {
    const float* hc = hbuf + (t & 1) * BT * Hk;
    float* hnext = hbuf + ((t + 1) & 1) * BT * Hk;

    float acc[3][BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[0][b] = acc[1][b] = acc[2][b] = 0.f;
    for (int q = s; q < nq; q += KS) {
      float4 wv[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4* p = w + ((size_t)q * 3 + g) * Up + u;
        if constexpr (SMEM_W)
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
      const float hold = hc[b * Hk + j];
      float h = hold;
      if (t < len[m]) {
        const float r = sigmoid(xr[m] + (acc[0][b] + bhr));
        const float z = sigmoid(xz[m] + (acc[1][b] + bhz));
        const float n = tanhf(xn[m] + r * (acc[2][b] + bhn));
        h = (1.f - z) * n + z * hold;
      }
      hy[m] = h;
      if (t + 1 < tmax)
        for (int r = 0; r < C; ++r)
          cluster.map_shared_rank(hnext, r)[b * Hk + j] = h;
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
// as the split instantiation, block tile_block(BT / TR, NUG) threads; dynamic
// shared memory: [Wh slice (SMEM_W)] [h: 2 x Hk x BT, k-major] [lengths]
template <int TV, bool SMEM_W>
__global__ void __launch_bounds__(tile_threads(TV))
    gru_seq_tile_kernel(const SeqArgs a) {
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
  float* hbuf = reinterpret_cast<float*>(smem4 + (SMEM_W ? wq : 0));
  int* lens = reinterpret_cast<int*>(hbuf + 2 * BT * Hk);

  if constexpr (SMEM_W) {
    for (size_t i = threadIdx.x; i < wq; i += blockDim.x)
      smem4[i] = __ldg(w + i);
    w = smem4;
  }
  for (int i = threadIdx.x; i < 2 * BT * Hk; i += blockDim.x) hbuf[i] = 0.f;
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    const int b = b0 + i;
    lens[i] = b < a.B ? min(max(a.lengths[b], 0), T) : 0;
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
  const int r0 = TR * min(rg, nrg - 1), u0 = min(ug, nug - 1);
  int len[TR], jv[TV];
  bool own[TV];
  float bhv[3][TV];
#pragma unroll
  for (int r = 0; r < TR; ++r) len[r] = live ? lens[r0 + r] : 0;
  const float* bh = a.bh + (size_t)d * 3 * H;
#pragma unroll
  for (int v = 0; v < TV; ++v) {
    const int u = u0 + v * nug;
    jv[v] = c * a.U + u;
    own[v] = live && u < a.U && jv[v] < H;
#pragma unroll
    for (int g = 0; g < 3; ++g) bhv[g][v] = own[v] ? bh[g * H + jv[v]] : 0.f;
  }
  const float* xpd = a.xp + (size_t)d * 3 * H;
  float* yd = a.y + (size_t)d * H;

  float xv[3][TV][TR];
  auto load_x = [&](int t) {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int L = len[r];
      const float* p =
          xpd + ((size_t)(b0 + r0 + r) * T + (rev ? L - 1 - t : t)) * a.ldx;
#pragma unroll
      for (int v = 0; v < TV; ++v)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xv[g][v][r] = (t < L && own[v]) ? p[g * H + jv[v]] : 0.f;
    }
  };
  load_x(0);

  for (int t = 0; t < tmax; ++t) {
    const float* hc = hbuf + (t & 1) * Hk * BT;
    float* hnext = hbuf + ((t + 1) & 1) * Hk * BT;

    float acc[3][TV][TR];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int v = 0; v < TV; ++v)
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[g][v][r] = 0.f;
    for (int q = 0; q < nq; ++q) {
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
          if constexpr (SMEM_W)
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

    float hy[TV][TR];
#pragma unroll
    for (int v = 0; v < TV; ++v)
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float hold = own[v] ? hc[jv[v] * BT + r0 + r] : 0.f;
        float h = hold;
        if (own[v] && t < len[r]) {
          const float rg = sigmoid(xv[0][v][r] + (acc[0][v][r] + bhv[0][v]));
          const float z = sigmoid(xv[1][v][r] + (acc[1][v][r] + bhv[1][v]));
          const float n =
              tanhf(xv[2][v][r] + rg * (acc[2][v][r] + bhv[2][v]));
          h = (1.f - z) * n + z * hold;
        }
        hy[v][r] = h;
      }
    if (t + 1 < tmax) {
#pragma unroll
      for (int v = 0; v < TV; ++v) {
        if (!own[v]) continue;
        const float4 h4 = make_float4(hy[v][0], hy[v][1], hy[v][2], hy[v][3]);
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


using Kernel = void (*)(const SeqArgs);

// Units a thread of the tiled instantiation: the smallest of 1, 2, 4 that
// keeps the block to tile_threads (0: none does)
int tile_units(int BT, int Up) {
  for (int tv = 1; tv <= 4; tv *= 2)
    if (tile_block(BT / TR, Up / tv) <= tile_threads(tv)) return tv;
  return 0;
}

// The instantiation for a tile of BT rows: split for 1 or 2, tiled for a
// multiple of TR (nullptr for any other BT).
Kernel pick(int BT, int Up, bool smem_w) {
  if (BT == 1) return smem_w ? gru_seq_kernel<1, true> : gru_seq_kernel<1, false>;
  if (BT == 2) return smem_w ? gru_seq_kernel<2, true> : gru_seq_kernel<2, false>;
  if (BT < TR || BT % TR) return nullptr;
  switch (tile_units(BT, Up)) {
    case 1: return smem_w ? gru_seq_tile_kernel<1, true> : gru_seq_tile_kernel<1, false>;
    case 2: return smem_w ? gru_seq_tile_kernel<2, true> : gru_seq_tile_kernel<2, false>;
    case 4: return smem_w ? gru_seq_tile_kernel<4, true> : gru_seq_tile_kernel<4, false>;
  }
  return nullptr;
}

// The arguments' derived sizes, the launch's block size and shared memory;
// false if the shapes are not ones the kernel takes.
bool layout(SeqArgs& a, int H, int C, int BT, bool smem_w, int* threads,
            size_t* smem) {
  if (H < 1 || H > 1024 || !(C == 1 || C == 2 || C == 4 || C == 8))
    return false;
  a.H = H;
  a.C = C;
  a.BT = BT;
  a.U = ceil_div(H, C);
  a.Up = ceil_div(a.U, UW) * UW;
  a.Hk = ceil_div(H, KQ) * KQ;
  if (!pick(BT, a.Up, smem_w)) return false;
  const int tv = BT <= 2 ? 0 : tile_units(BT, a.Up);
  *threads = BT <= 2 ? KS * a.Up : tile_block(BT / TR, a.Up / tv);
  const size_t wbytes = smem_w ? (size_t)a.Hk * 3 * a.Up * sizeof(float) : 0;
  *smem = wbytes + (size_t)2 * BT * a.Hk * sizeof(float) +
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

cudaError_t max_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg,
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

// A launch as gru_seq_plan chooses it.
struct Plan {
  int U, Up, Hk, BT, smem_w, smem, threads, blocks, clusters, waves;
};

// The launch of B rows, hidden size H, ndir directions, clusters of C: Wh in
// shared memory whenever its slice fits beside one row's h; BT the smallest
// tile (1, 2, 4, 8, ..., 256) whose clusters the card runs in one wave,
// else the largest that fits.
cudaError_t make_plan(int B, int H, int ndir, int C, Plan* p) {
  SeqArgs a = {};
  int threads = 0;
  size_t smem = 0;
  if (B < 1 || ndir < 1 || ndir > 2 ||
      !layout(a, H, C, 1, false, &threads, &smem))
    return cudaErrorInvalidValue;
  const bool smem_w = layout(a, H, C, 1, true, &threads, &smem);
  bool found = false;
  for (int bt = 1; bt <= 256; bt = bt < 2 ? 2 : bt < TR ? TR : bt + TR) {
    if (!layout(a, H, C, bt, smem_w, &threads, &smem)) continue;
    a.B = bt;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(a, 1, smem, threads, 0, attr);
    int clusters = 0;
    const cudaError_t e =
        max_clusters(pick(bt, a.Up, smem_w), cfg, &clusters);
    if (e != cudaSuccess) return e;
    if (clusters < 1) continue;
    const int tiles = ceil_div(B, bt) * ndir;
    *p = {a.U, a.Up, a.Hk, bt, smem_w, (int)smem, threads, C * tiles,
          clusters, ceil_div(tiles, clusters)};
    found = true;
    if (p->waves <= 1) break;
  }
  return found ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// xp: (B, T, ndir * 3H) f32 (gru_proj's output: x Wi + bi, the directions
// side by side); lengths: (B,) int32; whp: (ndir, C, Hk/4, 3, Up, 4) f32
// (ops/cuda_gru.pack_wh); bh: (ndir, 3H) f32; y: (B, T, ldy) f32, ldy >=
// ndir * H. C in {1, 2, 4, 8}; BT 1 or 2 (the split instantiation) or a
// multiple of 4 (the tiled one); smem_w: hold the Wh slices in shared
// memory (else read them from device memory); as gru_seq_plan chooses
// them. All contiguous on the device. Returns the cudaError_t of the
// launch.
extern "C" int gru_seq_forward(const void* xp, const void* lengths,
                               const void* whp, const void* bh, int rev0,
                               int rev1, int ndir, void* y, int B, int T,
                               int H, int ldy, int C, int BT, int smem_w,
                               void* stream) {
  SeqArgs a = {};
  int threads = 0;
  size_t smem = 0;
  if (ndir < 1 || ndir > 2 || B < 0 || T < 0 || ldy < ndir * H ||
      !layout(a, H, C, BT, smem_w, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  a.xp = static_cast<const float*>(xp);
  a.lengths = static_cast<const int*>(lengths);
  a.whp = static_cast<const float*>(whp);
  a.bh = static_cast<const float*>(bh);
  a.y = static_cast<float*>(y);
  a.B = B;
  a.T = T;
  a.ldx = ndir * 3 * H;
  a.ldy = ldy;
  a.rev0 = rev0;
  a.rev1 = rev1;
  const Kernel kernel = pick(BT, a.Up, smem_w);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      a, ndir, smem, threads, static_cast<cudaStream_t>(stream), attr);
  int clusters = 0;
  cudaError_t e = max_clusters(kernel, cfg, &clusters);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch gru_seq_forward takes for B rows, hidden size H, ndir
// directions and clusters of C (the weights' layout, ops/cuda_gru.
// cluster_size), chosen on the current card: out[0..9] = U, Up, Hk, BT,
// smem_w, shared memory bytes a block, threads a block, blocks, the
// clusters of that shape the card runs at once, and the waves they take.
// Returns the cudaError_t of the occupancy queries (cudaErrorInvalidValue
// for shapes the kernel does not take).
extern "C" int gru_seq_plan(int B, int H, int ndir, int C, int* out) {
  Plan p = {};
  const cudaError_t e = make_plan(B, H, ndir, C, &p);
  if (e != cudaSuccess) return (int)e;
  const int v[10] = {p.U,      p.Up,   p.Hk,      p.BT,       p.smem_w,
                     p.smem,   p.threads, p.blocks, p.clusters, p.waves};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
