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
// sums; split and mma_tf32 from mma_tf32.cuh, as K1, K3 and K5; the
// mainloop's pieces in tc_mainloop.cuh, shared with LP's product), so the
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
// nt: out = dy w^T holds the contraction (N) on the fast axis of both
// operands, the one form here that wgmma takes directly (TF32 B only
// K-major from shared memory), so it runs wgmma_mainloop.cuh's 3xTF32
// mainloop, as gru_proj.cu's large route does: dy split hi / lo in
// registers (wgmma's A), w split into hi and lo planes by a small kernel
// at every call (ntk::nt_prep, which also writes the zero tail rows;
// nothing is kept across calls) and brought into shared memory K-major in
// the 128-byte swizzle. Persistent blocks of two warpgroups walk 128 x BN
// tiles of out (BN 104 for K <= 104, else 128: dots1's K 104, 256, 512 in
// whole tiles), chunks of 32 of N through a ring of 4 cp.async stages. A
// chunk's wgmmas sum from zero and the chunks' sums are added in f32, TT's
// order, which keeps compare()'s float64 bar by its derivation (one wgmma
// sum over a tile's chunks read 6-11x its error on an H100).
// bwd_dot_nt_stop runs one TF32 pass, to time the two extra passes.
// Bound at 232 TFLOP/s: 0.111 ms at K=512, N=256 over 98,304 rows (the
// bytes, 302 MB, 0.090 ms); at K=104, the bytes (142 MB, 0.042 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <iterator>

#include "tc_mainloop.cuh"
#include "wgmma_mainloop.cuh"


namespace {

namespace tc {

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

using tc::THREADS;

// ---------------------------------------------------------------- nt

// nt runs wgmma_mainloop.cuh's mainloop with a = dy and bt = w's hi and lo
// planes, which nt_prep makes at every call
namespace ntk {
// wt (2, K, NP) = w (K, N) split hi (plane 0) and lo (plane 1) as the
// mainloop splits dy, zeros for N <= n < NP; and out's rows [Gm, rows) zeros
__global__ void __launch_bounds__(256)
nt_prep(const float* __restrict__ w, float* __restrict__ wt,
        float* __restrict__ out, int K, int N, int NP, int Gm, int rows) {
  const size_t planes = (size_t)K * NP, tail = (size_t)(rows - Gm) * K;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       i < planes + tail; i += (size_t)gridDim.x * blockDim.x) {
    if (i < planes) {
      const int k = (int)(i / NP), n = (int)(i % NP);
      uint32_t hi = 0, lo = 0;
      if (n < N) split(w[(size_t)k * N + n], hi, lo);
      wt[i] = __uint_as_float(hi);
      wt[planes + i] = __uint_as_float(lo);
    } else {
      out[(size_t)Gm * K + (i - planes)] = 0.f;
    }
  }
}
}  // namespace ntk

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

// out[0..9] as bwd_dot_plan gives them: the tile's rows and columns, the
// chunk, threads, stages and shared memory bytes of `kernel`, then its
// tiles, groups and steps a group, and its occupancy
template <typename Kernel>
int plan_fields(Kernel kernel, int bm, int bn, int stages, int smem,
                int tiles, int groups, int per, int* out) {
  const int fields[] = {bm, bn, tc::BK, THREADS, stages, smem, tiles, groups,
                        per};
  std::copy(std::begin(fields), std::end(fields), out);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[9], kernel,
                                                        THREADS, smem);
  return (int)err;
}

template <int LAYOUT>
int plan(int Mo, int No, int steps, int* out) {
  using R = tc::Ring<LAYOUT>;
  const int g = groups(Mo, No, steps);
  return plan_fields(steps_entry<LAYOUT>(true), tc::BM, tc::BN, R::DEPTH,
                     R::BYTES, tiles(Mo, No), g, (steps + g - 1) / g, out);
}

int plan_base(int m, int N, int G, int* out) {
  using R = tc::Ring<kBASE>;
  const int items = base_items(m, N, G), blocks = std::min(items, kSMs);
  return plan_fields(base_entry(true), tc::BM, tc::BN, R::DEPTH, R::BYTES,
                     items, blocks, (items + blocks - 1) / blocks, out);
}

// nt (layout 4 of the C interface): its tile width, 104 columns of out
// where K <= 104 (dots1's K = 104 in one tile), else 128 (K = 256 and 512
// in whole tiles); N padded to whole chunks in w's planes
constexpr int kNT = 4;

int nt_bn(int K) { return K <= 104 ? 104 : 128; }
int nt_np(int N) { return (N + wgl::BK - 1) / wgl::BK * wgl::BK; }
int nt_smem(int bn) {
  return bn == 104 ? wgl::Geo<104>::BYTES : wgl::Geo<128>::BYTES;
}
int nt_stages(int bn) {
  return bn == 104 ? wgl::Geo<104>::STAGES : wgl::Geo<128>::STAGES;
}
int nt_tiles(int Gm, int K) {
  const int bn = nt_bn(K);
  return (Gm + wgl::BM - 1) / wgl::BM * ((K + bn - 1) / bn);
}

using NtKernel = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, int);

// the route's kernel (VEC 4 or 1), or at VEC 4 bwd_dot_nt_stop's passes;
// each chunk of N from zero, the chunks added in f32
template <int BN>
NtKernel nt_entry_bn(bool vec, int passes) {
  using wgl::kChunks;
  using wgl::wgmma_3xtf32;
  if (!vec) return wgmma_3xtf32<BN, 1, 3, kChunks, false>;
  return passes == 1 ? wgmma_3xtf32<BN, 4, 1, kChunks, false>
                     : wgmma_3xtf32<BN, 4, 3, kChunks, false>;
}
NtKernel nt_entry(int K, bool vec, int passes = 3) {
  return nt_bn(K) == 104 ? nt_entry_bn<104>(vec, passes)
                         : nt_entry_bn<128>(vec, passes);
}

// nt_prep (w's planes into wt, out's tail rows zeros), then `kernel` in
// persistent blocks, at most one an SM
int launch_nt(const void* dy, const void* w, void* out, void* wt, int rows,
              int Gm, int N, int K, NtKernel kernel, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NP = nt_np(N), smem = nt_smem(nt_bn(K));
  const long long work = (long long)K * NP + (long long)(rows - Gm) * K;
  const int prep_blocks = (int)std::min<long long>((work + 255) / 256,
                                                   4 * kSMs);
  ntk::nt_prep<<<prep_blocks, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float*>(wt),
      static_cast<float*>(out), K, N, NP, Gm, rows);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<std::min(nt_tiles(Gm, K), kSMs), wgl::THREADS, smem, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(wt), nullptr,
      static_cast<float*>(out), Gm, N, K, NP);
  return (int)cudaGetLastError();
}

int plan_nt(int Gm, int K, int* out) {
  const int tiles = nt_tiles(Gm, K), blocks = std::min(tiles, kSMs);
  return plan_fields(nt_entry(K, true), wgl::BM, nt_bn(K),
                     nt_stages(nt_bn(K)), nt_smem(nt_bn(K)), tiles, blocks,
                     (tiles + blocks - 1) / blocks, out);
}

}  // namespace

// The scratch floats that bwd_dot_tt (layout 0), bwd_dot_nn (1),
// bwd_dot_xp (2), bwd_dot_base (3) or bwd_dot_nt (4) needs for `partial`
// (nt: `wt`) at these shapes: a steps kernel's (0-2) for Mo x No outputs
// over `steps` steps; base's (3) for Mo = m rows a step, No = N columns
// and steps = G steps, a row of N a 128-row tile of a step; nt's (4) for
// w (Mo = K, No = N), its hi and lo planes with N padded to 32 (steps not
// read); -1 for an unknown layout. Launches nothing.
extern "C" long long bwd_dot_scratch(int layout, int Mo, int No, int steps) {
  if (Mo < 1 || No < 1 || steps < 1) return 0;
  switch (layout) {
    case kTT:
    case kNN:
    case kXP: return scratch(Mo, No, steps);
    case kBASE: return (long long)steps * ((Mo + tc::BM - 1) / tc::BM) * No;
    case kNT: return 2LL * Mo * nt_np(No);
    default: return -1;
  }
}

// The launch plan of `layout`'s kernel (shapes as bwd_dot_scratch takes
// them), out[0..9]: the output tile's rows and columns, the contraction
// rows a chunk, threads a block, ring stages, dynamic shared memory bytes,
// output tiles (base: its items, row tiles x column tiles), groups (base
// and nt: their persistent blocks), steps a group (base and nt: items or
// tiles a block, at most), and the blocks an SM holds by the occupancy
// query (groups(), base and nt assume 1); nt's for Mo = G m rows, No = K
// columns of out (steps not read). Returns the cudaError_t of the query.
extern "C" int bwd_dot_plan(int layout, int Mo, int No, int steps, int* out) {
  if (Mo < 1 || No < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case kTT: return plan<kTT>(Mo, No, steps, out);
    case kNN: return plan<kNN>(Mo, No, steps, out);
    case kXP: return plan<kXP>(Mo, No, steps, out);
    case kBASE: return plan_base(Mo, No, steps, out);
    case kNT: return plan_nt(Mo, No, out);
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

// dy: (rows, N) f32, w: (K, N) f32, out: (rows, K) f32, contiguous; wt:
// bwd_dot_scratch(4, K, N, 1) floats, 16-byte aligned; 1 <= Gm = G m <=
// rows: out rows below Gm are dy w^T, the rest zeros. Returns the
// cudaError_t of the launches.
extern "C" int bwd_dot_nt(const void* dy, const void* w, void* out, void* wt,
                          int rows, int Gm, int N, int K, void* stream) {
  if (rows < 1 || Gm < 1 || Gm > rows || N < 1 || K < 1 ||
      (uintptr_t)wt % 16)
    return (int)cudaErrorInvalidValue;
  return launch_nt(dy, w, out, wt, rows, Gm, N, K,
                   nt_entry(K, vec4(dy, N, out, K)), stream);
}

// bwd_dot_nt's launch with `passes` 3 (bwd_dot_nt's function, bitwise
// it) or 1 (hi*hi alone, one TF32 pass, another function), to time what
// the two extra passes cost; rows of 16 bytes only (N and K multiples of
// 4). Arguments as bwd_dot_nt's.
extern "C" int bwd_dot_nt_stop(const void* dy, const void* w, void* out,
                               void* wt, int rows, int Gm, int N, int K,
                               int passes, void* stream) {
  if (rows < 1 || Gm < 1 || Gm > rows || N < 1 || K < 1 ||
      (uintptr_t)wt % 16 || (passes != 1 && passes != 3) ||
      !vec4(dy, N, out, K))
    return (int)cudaErrorInvalidValue;
  return launch_nt(dy, w, out, wt, rows, Gm, N, K,
                   nt_entry(K, true, passes), stream);
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
