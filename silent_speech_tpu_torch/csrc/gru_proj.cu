// GRU input projection for Hopper (sm_90a): xp = x Wi + bi for every
// (batch row, step) of a layer and both its directions at once, x (M, K),
// Wi (K, N), f32 in and f32 out, in f32's class of error (one TF32 pass
// would be another function).
//
// With gru_seq (csrc/gru_seq.cu) it replaces the TPU kernel
// silent_speech_tpu/ops/pallas_gru.py::_gru_fusedproj_kernel, whose body
// computes this product itself (pallas_gru.py:95-99); here it leaves the
// serial chain: it depends on no h, so it runs as one (B T, K) x (K, 6H)
// product before the recurrence, whose steps then read their xp row.
//
// Two routes, chosen from the shapes (gru_proj_plan; the Python mirror is
// ops/cuda_gru.proj_geometry):
//
// small M (M <= SMALL_M, K <= smallm::KMAX; the live path, M = T = 32):
// what bounds it is latency, not work (7.8 M multiply-adds at M=32, K=212,
// N=1152: 0.2 us at the f32 peak; Wi, 0.98 MB, 0.3 us at the memory
// rate). So it spreads Wi over many blocks: a 32 x 32 output tile a block
// of 8 warps (36 blocks at M=32), the tile's whole K of x and of Wi staged
// at once by cp.async (zeros past K, M and N), the K sum split across the
// 8 warps (K/8 rows each, rounded up to 4; a lane 4 rows x 8 columns,
// float4 loads from shared memory), the warps' partial tiles then added in
// warp order in shared memory and bi added once, at the store.
//
// large M: what bounds it is the multiply-adds (2.0 G at M=8192, K=212: at
// the f32 FMAs and 3xTF32 together, 67 + 495/3 = 232 TFLOP/s, 0.0172 ms;
// the bytes, 44.6 MB, 0.0133 ms). They run wgmma_mainloop.cuh's 3xTF32
// mainloop (x = hi + lo, each rounded as csrc/mma_tf32.cuh's split; lo*hi,
// hi*lo and hi*hi, f32 sums) on wgmma m64nNk8 TF32, which reads B from
// shared memory K-major only, and whose operands' bytes, at 4 a value and
// three passes, are what shared memory can serve: so Wi^T is split into hi
// and lo planes once, when the weights are packed (ops/cuda_gru.pack_wi_tc),
// and x is split in registers, wgmma's A. A block of two warpgroups
// computes a 128 x BN tile (BN 192 or 144, whichever leaves the fewer waves
// of tiles on 132 SMs: 1152 = 6 x 192 = 8 x 144), each warpgroup 64 rows;
// chunks of 32 k come through a ring of cp.async stages, and one wgmma f32
// sum takes a tile's chunks (the chunked order, nt's, needs a second
// accumulator that BN 192 has no registers for); the tile's epilogue adds
// bi. Persistent blocks, one an SM, walk the tiles as one stream of
// chunks. (An mma.sync 3xTF32 version, the tensor-core kernels' mainloop
// elsewhere in this package, was slower than torch.addmm here: its
// fragment loads and splits, not its MMAs, took most of its time.)
//
// Both routes sum each output over k in a fixed order: repeated calls are
// bitwise equal. Where K or N is not a multiple of 4 (or a pointer not 16-
// byte aligned) x's copies are 4 bytes each instead of 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <initializer_list>
#include <iterator>

#include "mma_tf32.cuh"
#include "wgmma_mainloop.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int kSMs = 132;  // H100 SXM: the tile choice is the shapes' alone
constexpr int SMALL_M = 512;
enum Route { kAuto = -1, kSmall = 0, kLarge = 1 };

// 16-byte copies where every row starts on 16 bytes
bool vec4(const void* x, int K, const void* w, int N) {
  return K % 4 == 0 && N % 4 == 0 &&
         reinterpret_cast<size_t>(x) % 16 == 0 &&
         reinterpret_cast<size_t>(w) % 16 == 0;
}

// dst[r][c] (row stride ld) = src[(r0 + r) lds + c0 + c] for r < ROWS,
// c < COLS, by cp.async of VEC floats a copy (4: 16 bytes, src 16-byte
// aligned), zeros where r0 + r >= r_end or c0 + c >= c_end; copies spread
// over the block's THREADS
template <int VEC>
__device__ __forceinline__ void copy_rows(float* dst, int ld, int rows,
                                          int cols,
                                          const float* __restrict__ src,
                                          int lds, int r0, int r_end, int c0,
                                          int c_end) {
  const int per_row = cols / VEC, n = rows * per_row;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int r = e / per_row, c = (e % per_row) * VEC;
    const int row = r0 + r, col = c0 + c;
    const int k = row < r_end ? max(0, min(VEC, c_end - col)) : 0;
    const float* g = k > 0 ? src + (size_t)row * lds + col : src;
    if constexpr (VEC == 4)
      cp_async16_fill(dst + r * ld + c, g, 4 * k);
    else
      cp_async4_fill(dst + r * ld + c, g, 4 * k);
  }
}

// ---------------------------------------------------------- small M

namespace smallm {
constexpr int BM = 32, BN = 32, W_LD = BN + 4;
constexpr int KMAX = 832;  // the tile's whole K in 227 KB of shared memory

// rows of K a warp (a multiple of 4; WARPS of them cover K), the x tile's
// row stride (4 mod 32 floats: a warp's two rows in a phase on other banks)
// and the block's dynamic shared memory: the x tile [BM][x_ld] and the Wi
// tile [WARPS kw][W_LD], or the warps' partial tiles [WARPS][BM][BN] after
__host__ __device__ constexpr int kw(int K) {
  return (K + 4 * WARPS - 1) / (4 * WARPS) * 4;
}
__host__ __device__ constexpr int x_ld(int K) { return WARPS * kw(K) + 4; }
__host__ __device__ constexpr int smem_bytes(int K) {
  return 4 * (BM * x_ld(K) + WARPS * kw(K) * W_LD > WARPS * BM * BN
                  ? BM * x_ld(K) + WARPS * kw(K) * W_LD
                  : WARPS * BM * BN);
}

// grid (ceil(M / BM), ceil(N / BN)): warp w sums k in [w kw, w kw + kw)
// for its lane's 4 rows (4 (lane / 4) ...) by 8 columns (8 (lane % 4) ...)
template <int VEC>
__global__ void __launch_bounds__(THREADS)
gru_proj_small(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ xp, int M,
             int K, int N) {
  extern __shared__ __align__(16) float sm[];
  const int KW = kw(K), KP = WARPS * KW, XLD = x_ld(K);
  float* xs = sm;              // [BM][XLD]: x rows, zeros from K (and M)
  float* ws = sm + BM * XLD;   // [KP][W_LD]: Wi rows, zeros from K (and N)
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  copy_rows<VEC>(xs, XLD, BM, KP, x, K, m0, M, 0, K);
  copy_rows<VEC>(ws, W_LD, KP, BN, w, N, 0, K, n0, N);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 2, cg = lane & 3;
  float acc[4][8] = {};
  const float* xa = xs + 4 * rg * XLD;
  const float* wb = ws + 8 * cg;
#pragma unroll 1
  for (int k = warp * KW; k < warp * KW + KW; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(xa + i * XLD + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(wb + (k + q) * W_LD);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wb + (k + q) * W_LD + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with xs and ws
  float* red = sm;  // [WARPS][BM][BN]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* r = red + (warp * BM + 4 * rg + i) * BN + 8 * cg;
    *reinterpret_cast<float4*>(r) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(r + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
  float4 s = *reinterpret_cast<const float4*>(red + r * BN + c);
#pragma unroll
  for (int v = 1; v < WARPS; ++v) {  // the warps' partials in warp order
    const float4 p =
        *reinterpret_cast<const float4*>(red + (v * BM + r) * BN + c);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const int m = m0 + r, n = n0 + c;
  if (m >= M) return;
  const float sv[4] = {s.x, s.y, s.z, s.w};
  float* out = xp + (size_t)m * N + n;
  if (VEC == 4 && n + 4 <= N) {
    *reinterpret_cast<float4*>(out) =
        make_float4(sv[0] + bias[n], sv[1] + bias[n + 1], sv[2] + bias[n + 2],
                    sv[3] + bias[n + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) out[j] = sv[j] + bias[n + j];
  }
}
}  // namespace smallm

// the launch of one (M, K, N): route, tile, grid
struct Plan {
  int route, bm, bn, tiles, blocks, smem, stages;
};

// the large route's BN: the one whose waves of 132 tiles cost the least,
// a tile's time about that of BN + 64 columns (its x rows, split and
// epilogue do not shrink with BN), ties to the wider tile; on the H100 it
// picks the faster width at every M that chip_smoke.time_k2p times
// (gru_proj_stop runs either)
constexpr int TILE_COST = 64;
int large_bn(int M, int N) {
  int best = 0, best_cost = 0;
  for (int bn : {192, 144}) {
    const int tiles = (M + wgl::BM - 1) / wgl::BM * ((N + bn - 1) / bn);
    const int cost = (tiles + kSMs - 1) / kSMs * (bn + TILE_COST);
    if (!best || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

int route_of(int M, int K, int route) {
  if (route == kAuto)
    return M <= SMALL_M && K <= smallm::KMAX ? kSmall : kLarge;
  return route;
}

int large_smem(int bn) {
  return bn == 192 ? wgl::Geo<192>::BYTES : wgl::Geo<144>::BYTES;
}
int large_stages(int bn) {
  return bn == 192 ? wgl::Geo<192>::STAGES : wgl::Geo<144>::STAGES;
}

// the route's shapes; blocks: the large route's persistent grid for
// `slots` resident blocks (its tiles where slots is 0)
Plan make_plan(int M, int K, int N, int route, int slots) {
  if (route_of(M, K, route) == kSmall) {
    const int tiles =
        (M + smallm::BM - 1) / smallm::BM * ((N + smallm::BN - 1) / smallm::BN);
    return {kSmall, smallm::BM, smallm::BN, tiles, tiles,
            smallm::smem_bytes(K), 1};
  }
  const int bn = large_bn(M, N);
  const int tiles = (M + wgl::BM - 1) / wgl::BM * ((N + bn - 1) / bn);
  return {kLarge, wgl::BM, bn, tiles, slots ? std::min(tiles, slots) : tiles,
          large_smem(bn), large_stages(bn)};
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

using SmallKernel = void (*)(const float*, const float*, const float*, float*,
                             int, int, int);
using LargeKernel = void (*)(const float*, const float*, const float*, float*,
                             int, int, int, int);

// wgmma_mainloop.cuh's kernel with the bias, one wgmma sum over a tile's
// chunks
template <int BN>
LargeKernel large_entry_bn(bool vec, bool one_pass) {
  using wgl::kOne;
  using wgl::wgmma_3xtf32;
  if (one_pass) return wgmma_3xtf32<BN, 4, 1, kOne, true>;
  return vec ? wgmma_3xtf32<BN, 4, 3, kOne, true>
             : wgmma_3xtf32<BN, 1, 3, kOne, true>;
}
LargeKernel large_entry(int bn, bool vec, bool one_pass) {
  return bn == 192 ? large_entry_bn<192>(vec, one_pass)
                   : large_entry_bn<144>(vec, one_pass);
}

// Once a device: the kernels' shared-memory attributes (the small route's
// at KMAX), and the large route's resident blocks at each BN (the launch
// paths must not pay the occupancy query every call)
constexpr int kMaxDevices = 64;
std::atomic<int> g_slots[kMaxDevices][2];  // BN 192, 144; 0: not yet known

cudaError_t device_setup(int dev) {
  const int small = smallm::smem_bytes(smallm::KMAX);
  cudaError_t err = allow_smem(smallm::gru_proj_small<4>, small);
  if (err == cudaSuccess) err = allow_smem(smallm::gru_proj_small<1>, small);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    const int bn = i == 0 ? 192 : 144;
    for (int v = 0; v < 3 && err == cudaSuccess; ++v)
      err = allow_smem(large_entry(bn, v != 1, v == 2), large_smem(bn));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, large_entry(bn, true, false), THREADS, large_smem(bn));
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) g_slots[dev][i].store(sms * per_sm);
  }
  return err;
}

// the card's resident blocks of the large route's kernel at this BN (and
// every kernel's attributes set, once a device)
cudaError_t large_slots(int bn, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int i = bn == 192 ? 0 : 1;
  if (!g_slots[dev][i].load()) err = device_setup(dev);
  *slots = g_slots[dev][i].load();
  return err;
}

}  // namespace

// The launch of gru_proj_forward at (M, K, N) on the current card, route
// -1 (the shapes' choice), 0 (small M) or 1 (large M); out[0..7]: the
// route, the output tile's rows and columns, the tiles, the blocks
// launched, dynamic shared memory bytes a block, cp.async stages (1: the
// small route stages all of K at once) and threads a block. Returns the
// cudaError_t of the occupancy query.
extern "C" int gru_proj_plan(int M, int K, int N, int route, int* out) {
  if (M < 1 || K < 1 || N < 1 || route < kAuto || route > kLarge ||
      (route_of(M, K, route) == kSmall && K > smallm::KMAX))
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  if (route_of(M, K, route) == kLarge) {
    const cudaError_t err = large_slots(large_bn(M, N), &slots);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan p = make_plan(M, K, N, route, slots);
  const int fields[] = {p.route, p.bm,   p.bn,     p.tiles,
                        p.blocks, p.smem, p.stages, THREADS};
  std::copy(std::begin(fields), std::end(fields), out);
  return 0;
}

// x: (M, K) f32, w: (K, N) f32 (the small route's), wt: (2, N, KP) f32,
// KP = K rounded up to 32, Wi^T split hi / lo as the kernel splits
// (ops/cuda_gru.pack_wi_tc; the large route's), bias: (N,) f32, xp: (M, N)
// f32, all contiguous on the device; route as gru_proj_plan takes it.
// Returns the cudaError_t of the launch.
extern "C" int gru_proj_forward(const void* x, const void* w, const void* wt,
                                const void* bias, void* xp, int M, int K,
                                int N, int route, void* stream) {
  if (M < 0 || K < 1 || N < 1 || route < kAuto || route > kLarge)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const bool vec = vec4(x, K, w, N);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *wf = static_cast<const float*>(w),
              *bf = static_cast<const float*>(bias);
  float* out = static_cast<float*>(xp);
  const int route_taken = route_of(M, K, route);
  const int bn = route_taken == kSmall ? 0 : large_bn(M, N);
  int slots = 0;  // and the attributes, once a device
  cudaError_t err = large_slots(bn == 0 ? 192 : bn, &slots);
  if (err != cudaSuccess) return (int)err;
  if (route_taken == kSmall) {
    if (K > smallm::KMAX) return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(M, K, N, kSmall, 0);
    const dim3 grid((M + smallm::BM - 1) / smallm::BM,
                    (N + smallm::BN - 1) / smallm::BN);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const SmallKernel kernel =
        vec ? smallm::gru_proj_small<4> : smallm::gru_proj_small<1>;
    kernel<<<grid, THREADS, p.smem, st>>>(xf, wf, bf, out, M, K, N);
    return (int)cudaGetLastError();
  }
  if (!wt || reinterpret_cast<size_t>(wt) % 16 ||
      reinterpret_cast<size_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N, kLarge, slots);
  large_entry(bn, vec, false)<<<p.blocks, THREADS, p.smem, st>>>(
      xf, static_cast<const float*>(wt), bf, out, M, K, N, (K + 31) / 32 * 32);
  return (int)cudaGetLastError();
}

// The large route at a tile width of the caller's, to time the parts and
// the tile choice: bn 192 or 144 (0: the shapes' choice), passes 3 (the
// route's function, bitwise gru_proj_forward's at the same bn) or 1
// (hi*hi alone, one TF32 pass: another function); arguments as
// gru_proj_forward's less w and route, rows of 16 bytes only (K and N
// multiples of 4). Returns the cudaError_t of the launch.
extern "C" int gru_proj_stop(const void* x, const void* wt, const void* bias,
                             void* xp, int M, int K, int N, int bn,
                             int passes, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (bn != 0 && bn != 192 && bn != 144) ||
      (passes != 1 && passes != 3) || !wt || !vec4(x, K, wt, N) ||
      reinterpret_cast<size_t>(wt) % 16)
    return (int)cudaErrorInvalidValue;
  if (bn == 0) bn = large_bn(M, N);
  int slots = 0;
  const cudaError_t err = large_slots(bn, &slots);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + wgl::BM - 1) / wgl::BM * ((N + bn - 1) / bn);
  large_entry(bn, true, passes == 1)<<<std::min(tiles, slots), THREADS,
                                        large_smem(bn),
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(xp), M, K, N,
      (K + 31) / 32 * 32);
  return (int)cudaGetLastError();
}
