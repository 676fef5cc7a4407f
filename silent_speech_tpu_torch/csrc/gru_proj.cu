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
// the bytes, 44.6 MB, 0.0133 ms). They run on the tensor cores as 3xTF32
// (x = hi + lo, each rounded as csrc/mma_tf32.cuh's split; lo*hi, hi*lo
// and hi*hi, f32 sums) on wgmma m64nNk8 TF32, which reads B from shared
// memory K-major only, and whose operands' bytes, at 4 a value and three
// passes, are what shared memory can serve: so Wi^T is split into hi and lo
// planes once, when the weights are packed (ops/cuda_gru.pack_wi_tc), and
// x is split in registers, wgmma's A. A block of two warpgroups computes a
// 128 x BN tile (BN 192 or 144, whichever leaves the fewer waves of tiles
// on 132 SMs: 1152 = 6 x 192 = 8 x 144), each warpgroup 64 rows; chunks of
// 32 k come through a ring of cp.async stages (the planes' 128-byte rows
// into wgmma's 128-byte swizzle, x's rows raw, zeros past M and K), each
// warp loads its 16 rows' fragments from x's raw rows and splits them (two
// register sets: chunk t's are split while chunk t - 1's wgmmas run), and
// one f32 sum takes a tile's chunks. Persistent blocks, one an SM, walk
// the tiles (column tile the fast index, so that blocks at work together
// read the same x rows) as one stream of chunks, so that a tile's bias
// epilogue runs while the next tile's chunks land. (An mma.sync 3xTF32
// version, the tensor-core kernels' mainloop elsewhere in this package,
// was slower than torch.addmm here: its fragment loads and splits, not its
// MMAs, took most of its time.)
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
#include "wgmma.cuh"

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

// ---------------------------------------------------------- large M

namespace wg {
constexpr int BM = 128, BK = 32, ROW = 4 * BK;  // a chunk's k: 128 bytes
constexpr int A_LD = BK + 4;  // x's raw rows (4 mod 32: fragment loads)
constexpr int ALIGN = 1024;   // the 128-byte swizzle's period
constexpr int MAX_STAGES = 4;

// a stage: Wi^T's hi and lo planes of the tile's BN columns for 32 k
// ([BN][ROW], K-major, 16-byte unit u of row n at u ^ (n % 8): wgmma's
// 128-byte swizzle), then x's raw chunk [BM][A_LD]
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

// keeps registers live and in place across the asynchronous wgmmas
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// this warp's share of d (64 x 192 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n192k8 tf32, A (this warp's 16 rows) in registers, B
// K-major in shared memory
__device__ __forceinline__ void wgmma_n192(float* d, const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, {%96,%97,%98,%99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// this warp's share of d (64 x 144 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n144k8 tf32, A (this warp's 16 rows) in registers, B
// K-major in shared memory
__device__ __forceinline__ void wgmma_n144(float* d, const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71"
      "}, {%72,%73,%74,%75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int BN, int PASSES>
__device__ __forceinline__ void mma_chunk(float (&acc)[Geo<BN>::NACC],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          uint32_t b_hi, int first) {
  constexpr uint32_t LO = Geo<BN>::B_PLANE;
#pragma unroll
  for (int k8 = 0; k8 < BK / 8; ++k8) {
    const uint64_t bh = wgmma_desc(b_hi + 32 * k8),
                   bl = wgmma_desc(b_hi + LO + 32 * k8);
    const int scale = !first || k8 > 0;
    if constexpr (BN == 192) {
      if constexpr (PASSES == 3) {
        wgmma_n192(acc, al[k8], bh, scale);
        wgmma_n192(acc, ah[k8], bl, 1);
        wgmma_n192(acc, ah[k8], bh, 1);
      } else {
        wgmma_n192(acc, ah[k8], bh, scale);
      }
    } else {
      if constexpr (PASSES == 3) {
        wgmma_n144(acc, al[k8], bh, scale);
        wgmma_n144(acc, ah[k8], bl, 1);
        wgmma_n144(acc, ah[k8], bh, 1);
      } else {
        wgmma_n144(acc, ah[k8], bh, scale);
      }
    }
  }
}

// persistent blocks walk the tiles (tile i: rows (i / tiles_n) BM, columns
// (i % tiles_n) BN) as one stream of 32-k chunks through a ring of cp.async
// stages: Wi^T's hi and lo planes (packed once, pack_wi_tc) copied into
// their swizzled places, x's raw rows; warp group h (warps 4 h .. 4 h + 3)
// multiplies rows [64 h, 64 h + 64) of the tile: each warp loads its 16
// rows' fragments of the chunk from x's raw rows and splits them hi / lo
// in registers (two register sets: chunk t's are loaded while chunk t - 1's
// wgmmas still read theirs), then a k8 step takes three wgmmas (lo*hi,
// hi*lo, hi*hi), the tile's chunks into one f32 sum; a tile's last chunk
// ends in its epilogue, sum + bi to xp
template <int BN, int VEC, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
gru_proj_large(const float* __restrict__ x, const float* __restrict__ wt,
          const float* __restrict__ bias, float* __restrict__ xp, int M,
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
          live ? wt + ((size_t)pl * N + n0 + n) * KP + k0 + 4 * u : wt;
      cp_async16_fill(st + pl * G::B_PLANE + n * ROW + ((u ^ (n & 7)) << 4),
                      src, live ? 16 : 0);
    }
    copy_rows<VEC>(reinterpret_cast<float*>(st + 2 * G::B_PLANE), A_LD, BM,
                   BK, x, K, m0, M, k0, K);
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
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  auto step = [&](int t, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    cp_async_wait<G::STAGES - 2>();  // chunk t has landed, for this thread
    __syncthreads();                 // ... for all
    const uint8_t* st = ring + (t % G::STAGES) * G::STAGE;
    const float* a = reinterpret_cast<const float*>(st + 2 * G::B_PLANE) +
                     (h * 64 + wl * 16 + g) * A_LD + t4;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {  // the set chunk t - 2 read
      const float v[4] = {a[k8 * 8], a[8 * A_LD + k8 * 8], a[k8 * 8 + 4],
                          a[8 * A_LD + k8 * 8 + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[k8][i], al[k8][i]);
    }
    fence_acc(acc);
    wgmma_fence();
    mma_chunk<BN, PASSES>(acc, ah, al, smem_u32(st), k == 0);
    wgmma_commit();
    wgmma_wait<1>();  // chunk t - 1's wgmmas are done
    fence_acc(acc);
    fence_regs(ah0);
    fence_regs(al0);
    fence_regs(ah1);
    fence_regs(al1);
    __syncthreads();  // ... in both groups: its stage takes chunk t + S - 1
    if (t + G::STAGES - 1 < count) fetch(t + G::STAGES - 1);
    cp_async_commit();
    if (++k < chunks) return;
    wgmma_wait<0>();
    fence_acc(acc);
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int e = 0; e < G::NACC; e += 2) {  // the tile's epilogue
      const int r = m0 + h * 64 + wl * 16 + g + 8 * ((e & 3) >> 1);
      const int c = n0 + e / 4 * 8 + 2 * t4;
      if (r >= M) continue;
      float* out = xp + (size_t)r * N + c;
      if (VEC == 4 && c + 2 <= N) {
        *reinterpret_cast<float2*>(out) =
            make_float2(acc[e] + bias[c], acc[e + 1] + bias[c + 1]);
      } else {
        if (c < N) out[0] = acc[e] + bias[c];
        if (c + 1 < N) out[1] = acc[e + 1] + bias[c + 1];
      }
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
}  // namespace wg

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
    const int tiles = (M + wg::BM - 1) / wg::BM * ((N + bn - 1) / bn);
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
  return bn == 192 ? wg::Geo<192>::BYTES : wg::Geo<144>::BYTES;
}
int large_stages(int bn) {
  return bn == 192 ? wg::Geo<192>::STAGES : wg::Geo<144>::STAGES;
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
  const int tiles = (M + wg::BM - 1) / wg::BM * ((N + bn - 1) / bn);
  return {kLarge, wg::BM, bn, tiles, slots ? std::min(tiles, slots) : tiles,
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

template <int BN>
LargeKernel large_entry_bn(bool vec, bool one_pass) {
  if (one_pass) return wg::gru_proj_large<BN, 4, 1>;
  return vec ? wg::gru_proj_large<BN, 4, 3> : wg::gru_proj_large<BN, 1, 3>;
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
  const int tiles = (M + wg::BM - 1) / wg::BM * ((N + bn - 1) / bn);
  large_entry(bn, true, passes == 1)<<<std::min(tiles, slots), THREADS,
                                        large_smem(bn),
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(xp), M, K, N,
      (K + 31) / 32 * 32);
  return (int)cudaGetLastError();
}
