// Chained-dot rate probe for Hopper (sm_90a): out = sum over r < reps of
// roll(A, r % 8, lanes) @ B, A (M, K) and B (K, N) f32, f32 sums, computed
// anew in each of `grid` steps.
//
// Replaces scripts/bench_fused_cnn.py::_mm_kernel (:63, the pallas_call of
// ::mxu_rate at :78): there A and B stay in VMEM, the grid's steps run in
// order and each overwrites the one (M, N) output block. Here every step's
// sum is computed (the steps are work items of their own) and only the
// step `store_step` (a runtime argument, the last step by default) stores
// it: no two steps race on the output, and the compiler cannot drop the
// steps whose results are not stored. The reps are not folded into eight
// rolled copies and no product is reused: the kernel runs all reps x grid
// products on the tensor cores.
//
// What bounds it: the multiply-adds, M K N reps grid, at the f32 FMAs and
// 3xTF32 together (67 + 495/3 = 232 TFLOP/s): 0.0903 ms at (192, 104, 128)
// with reps = grid = 64, 37.91 ms at 1024^3. A and B (at most 4 MB each)
// stay in L2.
//
// The products run as 3xTF32 on wgmma m64nBNk8 (x = hi + lo, each rounded
// as mma_tf32.cuh's split; lo*hi, hi*lo, hi*hi). wgmma takes B from shared
// memory K-major only, through a descriptor whose start address is in
// 16-byte units, so a roll of 1-7 elements along k can only go on A, which
// each warp loads into registers and splits (wgmma's A): the roll is an
// index of the fragment loads. B is the same in every product, so
// mr_prep splits it once a call into b^T's hi and lo planes, bt (2, N, KP),
// KP = K rounded up to 32 with zeros (inside the call and its time).
//
// A block is one warpgroup; a work item is one (step, 64-row tile,
// BN-column tile) of out, BN 64 or 128 (mm_rate_plan: whichever's items
// take an SM the less time, on 132 SMs, the wider at a tie); persistent
// blocks
// walk the items as one stream of 32-k chunks through two cp.async stages:
// the chunk's two B planes (BN rows of 128 bytes, the 128-byte swizzle)
// and A's 64 rows with an 8-column halo, columns [k0 - 8, k0 + 32) mod K,
// so that rep r's fragments start at column 8 - r % 8. The rep loop runs
// inside the chunk loop: a chunk comes from L2 once an item, not once a
// rep, and rep r + 1's fragments are loaded and split while rep r's
// wgmmas run. Each (chunk, rep) group of 12 wgmmas sums from zero and is
// added into the item's f32 total (the tensor cores' accumulation
// truncates: one sum over reps K products would drift), so an output's
// order is chunks outer, reps inner, fixed: repeated launches are bitwise
// equal. The k8 steps past K (B's zero rows) are left out (at K = 104, 3
// of the last chunk's 4). The STOP instantiations time the parts: one TF32
// pass (hi*hi alone, another function), or the feed alone (the copies,
// loads, splits and adds, the split values folded into the sums by one XOR
// each).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <iterator>

#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace {

namespace mr {

constexpr int THREADS = 128;  // one warpgroup
constexpr int BM = 64, BK = 32, ROW = 4 * BK;  // a B plane's row: 128 bytes
constexpr int ROLLS = 8, HALO = ROLLS;         // r % 8: 8 columns of halo
constexpr int A_COLS = HALO + BK;
constexpr int A_LD = A_COLS + 4;  // 12 mod 32: conflict-free fragment loads
constexpr int ALIGN = 1024;       // the 128-byte swizzle's period
constexpr int STAGES = 2;
constexpr int kSMs = 132;  // the plan's H100 SXM, as bwd_dots.cu's
constexpr int BNS[] = {128, 64};
enum Stop { kAll = 0, kOnePass = 1, kFeed = 2 };

// a stage: B's hi and lo planes of the item's BN columns for 32 k, then
// A's 64 rows of the chunk and its halo, raw
template <int BN>
struct Geo {
  static constexpr int B_PLANE = BN * ROW, A_BYTES = BM * A_LD * 4;
  static constexpr int STAGE = 2 * B_PLANE + A_BYTES;
  static constexpr int BYTES = ALIGN + STAGES * STAGE;
  static constexpr int NACC = BN / 2;  // a thread's sums (64 x BN a group)
  static_assert(B_PLANE % ALIGN == 0 && STAGE % ALIGN == 0 &&
                    A_LD % 32 == 12,
                "planes on the swizzle's period, conflict-free A loads");
};

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int items_of(int M, int N, int bn, int grid) {
  return ceil_div(M, BM) * ceil_div(N, bn) * grid;
}

// the column tile: of BNS, the one whose items an SM take the least time,
// ceil(items / 132) BN columns, a BN-64 column weighed at 5/4 of a BN-128
// one (on an H100 80GB HBM3 at 700 W, 512^3 in BN 64 took 1.21x its time
// in BN 128, chip_smoke.time_mr_dc_f32); the wider first: it wins a tie
int tile_bn(int M, int N, int grid) {
  int best = BNS[0];
  long long cost = -1;
  for (int bn : BNS) {
    const long long c = (long long)ceil_div(items_of(M, N, bn, grid), kSMs) *
                        bn * (bn == 64 ? 5 : 4);
    if (cost < 0 || c < cost) best = bn, cost = c;
  }
  return best;
}

// bt (2, N, KP): b^T split hi (plane 0) and lo (plane 1) as the kernel's A
// is split, zeros for K <= k < KP; a 32 x 32 tile a block through shared
// memory, read along n and written along k
__global__ void __launch_bounds__(256)
mr_prep(const float* __restrict__ b, float* __restrict__ bt, int K, int N,
        int KP) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    t[i][tx] = k < K && n < N ? b[(size_t)k * N + n] : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)N * KP;
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= N) continue;
    uint32_t hi, lo;
    split(t[tx][i], hi, lo);
    bt[(size_t)n * KP + k0 + tx] = __uint_as_float(hi);
    bt[plane + (size_t)n * KP + k0 + tx] = __uint_as_float(lo);
  }
}

// the thread's outputs of the 64 x BN tile at (m0, n0), masked to (M, N)
template <int BN>
__device__ __forceinline__ void store(const float (&s)[Geo<BN>::NACC],
                                      float* __restrict__ out, int M, int N,
                                      int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int e = 0; e < Geo<BN>::NACC; e += 2) {
    const int r = row + 8 * ((e & 3) >> 1);
    const int c = n0 + e / 4 * 8 + 2 * (lane & 3);
    if (r >= M) continue;
    float* o = out + (size_t)r * N + c;
    if (N % 2 == 0 && c + 2 <= N) {
      *reinterpret_cast<float2*>(o) = make_float2(s[e], s[e + 1]);
    } else {
      if (c < N) o[0] = s[e];
      if (c + 1 < N) o[1] = s[e + 1];
    }
  }
}

template <int BN, int STOP>
__global__ void __launch_bounds__(THREADS)
mm_rate_kernel(const float* __restrict__ a, const float* __restrict__ bt,
               float* __restrict__ out, int M, int K, int N, int KP,
               int reps, int grid, int store_step) {
  using G = Geo<BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                              (ALIGN - 1));
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n, items = tiles * grid;
  const int chunks = KP / BK;
  const int mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int count = mine * chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int load_item = blockIdx.x, load_k = 0;
  auto fetch = [&](int t) {  // chunk t, the one after the last fetched
    uint8_t* st = ring + (t % STAGES) * G::STAGE;
    const int tile = load_item % tiles;
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    const int k0 = load_k * BK;
    for (int e = threadIdx.x; e < 2 * BN * 8; e += THREADS) {
      const int pl = e / (BN * 8), n = e / 8 % BN, u = e % 8;
      const bool live = n0 + n < N;
      const float* src =
          live ? bt + ((size_t)pl * N + n0 + n) * KP + k0 + 4 * u : bt;
      cp_async16_fill(st + pl * G::B_PLANE + n * ROW + ((u ^ (n & 7)) << 4),
                      src, live ? 16 : 0);
    }
    float* sa = reinterpret_cast<float*>(st + 2 * G::B_PLANE);
    for (int e = threadIdx.x; e < BM * A_COLS; e += THREADS) {
      const int r = e / A_COLS, j = e % A_COLS;
      int c = (k0 - HALO + j) % K;  // past K: any column (B's rows are 0)
      if (c < 0) c += K;
      const bool live = m0 + r < M;
      cp_async4_fill(sa + r * A_LD + j,
                     live ? a + (size_t)(m0 + r) * K + c : a, live ? 4 : 0);
    }
    if (++load_k == chunks) {
      load_k = 0;
      load_item += gridDim.x;
    }
  };
  fetch(0);
  cp_async_commit();
  int item = blockIdx.x, k = 0;
  float acc[G::NACC], total[G::NACC];
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) total[i] = acc[i] = 0.f;
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  auto fence_all = [&] {
    fence_acc(acc);
    fence_regs(ah0);
    fence_regs(al0);
    fence_regs(ah1);
    fence_regs(al1);
  };
  for (int t = 0; t < count; ++t) {
    cp_async_wait<0>();  // chunk t has landed, for this thread
    __syncthreads();     // ... for all, and chunk t - 1's stage is free
    if (t + 1 < count) fetch(t + 1);
    cp_async_commit();
    const uint8_t* st = ring + (t % STAGES) * G::STAGE;
    const uint32_t b_hi = smem_u32(st);
    const int live = min(4, (K - k * BK + 7) / 8);  // k8 steps below K
    const float* af = reinterpret_cast<const float*>(st + 2 * G::B_PLANE) +
                      (warp * 16 + g) * A_LD + HALO + t4;
    // rep r's fragments: A'[m, k] = A[m, (k - r % 8) mod K]
    auto load = [&](uint32_t (&ah)[4][4], uint32_t (&al)[4][4], int r) {
      const float* p = af - r % ROLLS;
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        const float v[4] = {p[k8 * 8], p[8 * A_LD + k8 * 8], p[k8 * 8 + 4],
                            p[8 * A_LD + k8 * 8 + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(v[i], ah[k8][i], al[k8][i]);
      }
    };
    // rep r on the set it loaded; rep r + 1's set loaded while it runs
    auto rep = [&](int r, uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                   uint32_t (&nh)[4][4], uint32_t (&nl)[4][4]) {
      if constexpr (STOP == kFeed) {
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[(k8 * 4 + i) % G::NACC] =
                __uint_as_float(ah[k8][i] ^ al[k8][i]);
        if (r + 1 < reps) load(nh, nl, r + 1);
      } else {
        fence_acc(acc);
        wgmma_fence();
        wgmma_chunk<BN, STOP == kOnePass ? 1 : 3>(acc, ah, al, b_hi,
                                                  G::B_PLANE, true, live);
        wgmma_commit();
        if (r + 1 < reps) load(nh, nl, r + 1);
        wgmma_wait<0>();
        fence_all();
      }
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) total[i] += acc[i];
    };
    if (reps > 0) load(ah0, al0, 0);
    for (int r = 0; r < reps; r += 2) {
      rep(r, ah0, al0, ah1, al1);
      if (r + 1 < reps) rep(r + 1, ah1, al1, ah0, al0);
    }
    if (++k < chunks) continue;
    const int tile = item % tiles;
    if (item / tiles == store_step)
      store<BN>(total, out, M, N, tile / tiles_n * BM, tile % tiles_n * BN);
#pragma unroll
    for (int i = 0; i < G::NACC; ++i) total[i] = 0.f;
    k = 0;
    item += gridDim.x;
  }
  cp_async_wait_all();
}

using Kernel = void (*)(const float*, const float*, float*, int, int, int,
                        int, int, int, int);

template <int STOP>
Kernel entry_stop(int bn) {
  return bn == 128 ? mm_rate_kernel<128, STOP> : mm_rate_kernel<64, STOP>;
}

Kernel entry(int bn, int stop) {
  return stop == kOnePass ? entry_stop<kOnePass>(bn)
         : stop == kFeed  ? entry_stop<kFeed>(bn)
                          : entry_stop<kAll>(bn);
}

int smem_of(int bn) { return bn == 128 ? Geo<128>::BYTES : Geo<64>::BYTES; }

// the blocks the card holds at once with the BN tile, asked once a device
// (the dynamic shared memory attributes of every instantiation set with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_slots[kMaxDevices][2];

cudaError_t slots_of(int bn, int* slots) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_slots[dev][bn == 64];
  if (!slot.load()) {
    for (int stop : {kAll, kOnePass, kFeed}) {
      e = cudaFuncSetAttribute(entry(bn, stop),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_of(bn));
      if (e != cudaSuccess) return e;
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry(bn, kAll),
                                                      THREADS, smem_of(bn));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slot.store(per_sm * sms);
  }
  *slots = slot.load();
  return cudaSuccess;
}

int kp_of(int K) { return (K + BK - 1) / BK * BK; }

bool args_ok(int M, int K, int N, int reps, int grid) {
  return M >= 1 && K >= 1 && N >= 1 && reps >= 0 && grid >= 1 &&
         (long long)ceil_div(M, BM) * ceil_div(N, 64) * grid < (1LL << 31);
}

}  // namespace mr

}  // namespace

// a: (M, K) f32, b: (K, N) f32, out: (M, N) f32, bt: (2, N, KP) f32
// scratch (KP = K rounded up to 32), all contiguous on the device; grid
// steps of reps products each; store_step: the step whose result is stored
// (0 <= store_step < grid); stop: 0 the function, 1 one TF32 pass, 2 the
// feed alone (timing stops; out then holds other values); bn: the column
// tile, 64 or 128, 0 for mm_rate_plan's (every tile sums each output in
// the same order: the same bits). Launches mr_prep then the products.
// Returns the cudaError_t of the launches.
extern "C" int mm_rate(const void* a, const void* b, void* out, void* bt,
                       int M, int K, int N, int reps, int grid,
                       int store_step, int stop, int bn, void* stream) {
  using namespace mr;
  if (!args_ok(M, K, N, reps, grid) || store_step < 0 || store_step >= grid ||
      stop < kAll || stop > kFeed || (bn != 0 && bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int KP = kp_of(K);
  if (bn == 0) bn = tile_bn(M, N, grid);
  int slots = 0;
  cudaError_t e = slots_of(bn, &slots);
  if (e != cudaSuccess) return (int)e;
  mr_prep<<<dim3(KP / 32, ceil_div(N, 32)), 256, 0, st>>>(
      static_cast<const float*>(b), static_cast<float*>(bt), K, N, KP);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = std::min(items_of(M, N, bn, grid), slots);
  entry(bn, stop)<<<blocks, THREADS, smem_of(bn), st>>>(
      static_cast<const float*>(a), static_cast<const float*>(bt),
      static_cast<float*>(out), M, K, N, KP, reps, grid, store_step);
  return (int)cudaGetLastError();
}

// mm_rate's launch at (M, K, N, grid) on the current card; out[0..6]: BN,
// the items ((step, 64-row tile, BN-column tile)), the blocks launched, the
// blocks the card holds at once, dynamic shared memory bytes a block,
// cp.async stages, threads a block. Returns the cudaError_t of the
// occupancy query.
extern "C" int mm_rate_plan(int M, int K, int N, int grid, int* out) {
  using namespace mr;
  if (!args_ok(M, K, N, 0, grid)) return (int)cudaErrorInvalidValue;
  const int bn = tile_bn(M, N, grid);
  int slots = 0;
  const cudaError_t e = slots_of(bn, &slots);
  if (e != cudaSuccess) return (int)e;
  const int items = items_of(M, N, bn, grid);
  const int fields[] = {bn, items, std::min(items, slots), slots,
                        smem_of(bn), STAGES, THREADS};
  std::copy(std::begin(fields), std::end(fields), out);
  return 0;
}
