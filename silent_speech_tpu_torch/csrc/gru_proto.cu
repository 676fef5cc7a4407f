// The GRU design probes' kernels for Hopper (sm_90a): the alternatives the
// TPU design weighed for the GRU sequence kernel, run on K2's cluster
// recurrence (gru_cluster.cuh, which gru_seq.cu instantiates as K2).
//
// 1. The recurrence over a projection xp = x Wi + bi computed outside the
//    kernel. Replaces scripts/proto_gru2.py::_gru_kstep_kernel
//    (gru_sequence_kstep) and, with two weight sets, ::_gru_kstep2w_kernel
//    (gru_sequence_kstep_2w: the two directions of a layer stacked along the
//    batch). Rows [s R, (s + 1) R) take weight set s (R = rows_per_set);
//    gridDim.y is the set.
// 2. The dual-chain layer: both directions of one layer in one launch, as
//    two independent chains (gridDim.y), each projecting its own input.
//    Replaces scripts/proto_gru4.py::_gru_dual_kernel (gru_layer_dual). It
//    takes x and x_flip (flip_padded(x)) and writes y_f and y_b, y_b in the
//    flipped order, as the TPU kernel does: both chains run forward.
//
// With bf16_mm (BF16) the instantiations round with __float2bfloat16_rn
// exactly where the TPU kernels apply their `cast`: h and Wh in both
// (proto_gru2.py:54-57, proto_gru4.py:45-47), x and Wi in the dual kernel
// (proto_gru4.py:76-84). Products of bf16 values are exact in f32 (and in
// TF32: the dual kernel's projection takes one pass) and every sum is f32.
// The recurrence's blocks hold the rounded Wh as bf16, half the f32 slice.
//
// What bounds them on the H100: the chain of T dependent steps. At B=512 a
// step's 3H x H product over the rows (67 TFLOP/s of f32 FMAs; the dual
// kernel's projection on the tensor cores, 232 TFLOP/s as 3xTF32, 989 as the
// bf16_mm pass); at B=1 a step's latency. The design (gru_cluster.cuh):
// - A cluster of C blocks a (weight set or chain, tile of BT rows) keeps Wh
//   in its blocks' shared memory for all T steps, read from the caller's
//   (H, 3H) in the prologue (nothing is kept across calls), and exchanges h
//   through distributed shared memory with one cluster barrier a step.
// - The dual kernel's blocks also keep their units' columns of Wi and
//   project each chunk of k_steps steps on the tensor cores before its
//   steps, each warp loading its rows of x from device memory straight into
//   registers a 32-column piece ahead of the piece its MMAs consume: no
//   block needs another block's xp, and the projection leaves the per-step
//   chain.
// - Both take K2's two bodies (1 or 2 rows: split; 4 n: tiled), the tiled
//   one summing in the split body's order: a row's f32 bits do not depend
//   on batch_tile or k_steps.
// - The plan (rec_plan / dual_plan) takes C from the slices (the smallest
//   of 1, 2, 4, 8 whose Wh, and the dual kernel's Wi, slices are at most 128
//   KiB; at H=192, D=180: 4 and 8; the recurrence's 2 under bf16_mm) and,
//   unless the caller gives a tile, BT:
//   of the tiles that fit (1, 2, 4 n up to 64), the smallest whose clusters
//   take the fewest waves of the clusters the card runs at once
//   (cudaOccupancyMaxActiveClusters). ops/cuda_gru_proto mirrors it.

#include <cuda_runtime.h>

#include "gru_cluster.cuh"

namespace {

// bf16_mm: the recurrence holds Wh as bf16 (HALF); the dual kernel holds
// the rounded Wh and Wi as f32 (with them as bf16 its plan took clusters of
// 4 and ran slower than on clusters of 8, PERF.md)
using RecF32 = ProbeCfg<false, false, false>;
using RecBf16 = ProbeCfg<true, false, true>;
using DualF32 = ProbeCfg<false, true, false>;
using DualBf16 = ProbeCfg<true, true, false>;

constexpr size_t SLICE_TARGET = 128 << 10;
constexpr int MAX_TILE = 64;  // rows a cluster: 1, 2 and 4 n up to this

// C: the smallest cluster whose Wh slice (f32, or bf16 under HALF; and,
// PROJ, Wi slice: D x 3 Up f32) is at most SLICE_TARGET, else 8
template <class Cfg>
int cluster_of(int H, int D) {
  for (int C = 1; C < 8; C *= 2) {
    const int Up = ceil_div(ceil_div(H, C), UW) * UW;
    size_t bytes =
        (size_t)ceil_div(H, KQ) * KQ * 3 * Up * (Cfg::HALF ? 2 : 4);
    if constexpr (Cfg::PROJ) bytes += (size_t)D * 3 * Up * 4;
    if (bytes <= SLICE_TARGET) return C;
  }
  return 8;
}

// The launch of S sets of R rows, hidden size H (PROJ: a.D, a.T and a.K
// set, a.K 0 for the plan's chunk): the tile bt, or (bt 0) of the tiles
// that fit, the smallest whose clusters take the fewest waves on the card;
// PROJ's chunk, unless given, the largest of CHUNKS (at most T, or the
// last) with the fewest waves: a chunk of one step would project between
// every two steps. Leaves a's layout, the block and its shared memory as the
// plan's.
constexpr int CHUNKS[] = {8, 4, 2};

template <class Cfg>
cudaError_t plan_tiles(ProbeArgs& a, int C, int R, int S, int H, int bt,
                       Plan* p, int* chosen) {
  *chosen = 0;
  int threads = 0;
  size_t smem = 0;
  for (int tile = 1; tile <= MAX_TILE; tile = next_tile(tile)) {
    if (bt && tile != bt) continue;
    if (!layout<Cfg>(a, H, C, tile, true, &threads, &smem)) continue;
    a.B = tile;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(a, 1, smem, threads, 0, attr);
    int clusters = 0;
    const cudaError_t e =
        max_clusters<Cfg>(pick<Cfg>(tile, a.Up, true), cfg, &clusters);
    if (e != cudaSuccess) return e;
    if (clusters < 1) continue;
    const int tiles = ceil_div(R, tile) * S, waves = ceil_div(tiles, clusters);
    if (*chosen && waves >= p->waves) continue;
    *p = {a.U, a.Up, a.Hk, tile, 1, (int)smem, threads, C * tiles,
          clusters, waves};
    *chosen = tile;
    if (waves <= 1) break;
  }
  return cudaSuccess;
}

template <class Cfg>
cudaError_t make_plan(ProbeArgs& a, int R, int S, int H, int bt, Plan* p,
                      int* threads, size_t* smem) {
  const int C = cluster_of<Cfg>(H, a.D);
  int chosen = 0;
  if (Cfg::PROJ && a.K == 0) {
    int best_k = 0;
    for (const int k : CHUNKS) {
      if (k > a.T && k > CHUNKS[2]) continue;
      a.K = k;
      Plan q = {};
      int tile = 0;
      const cudaError_t e = plan_tiles<Cfg>(a, C, R, S, H, bt, &q, &tile);
      if (e != cudaSuccess) return e;
      if (tile && (!chosen || q.waves < p->waves)) {
        *p = q;
        chosen = tile;
        best_k = k;
      }
    }
    a.K = best_k;
  } else {
    const cudaError_t e = plan_tiles<Cfg>(a, C, R, S, H, bt, p, &chosen);
    if (e != cudaSuccess) return e;
  }
  if (!chosen) return bt ? cudaErrorInvalidValue
                         : cudaErrorInvalidConfiguration;
  layout<Cfg>(a, H, C, chosen, true, threads, smem);
  return cudaSuccess;
}

template <class Cfg>
int launch(ProbeArgs& a, int R, int S, int H, int bt, cudaStream_t stream) {
  Plan p = {};
  int threads = 0;
  size_t smem = 0;
  cudaError_t e = make_plan<Cfg>(a, R, S, H, bt, &p, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  a.B = R;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a, S, smem, threads, stream, attr);
  e = cudaLaunchKernelEx(&cfg, pick<Cfg>(a.BT, a.Up, true), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

bool tile_ok(int bt) {
  return bt == 0 || bt == 1 || bt == 2 ||
         (bt % TR == 0 && bt >= TR && bt <= MAX_TILE);
}

int write_plan(cudaError_t e, const ProbeArgs& a, const Plan& p, int* out) {
  if (e != cudaSuccess) return (int)e;
  const int v[11] = {a.C,    p.U,       p.Up,     p.Hk,       p.BT, a.K,
                     p.smem, p.threads, p.blocks, p.clusters, p.waves};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// xp: (nsets * R, T, 3H) f32; lengths: (nsets * R,) int32; wh: (nsets, H,
// 3H), bh: (nsets, 3H) f32; y: (nsets * R, T, H) f32. Row r takes weight
// set r / R. bt: rows a cluster (1, 2 or 4 n up to 64), or 0 for the
// plan's tile. All contiguous on the device. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int gru_rec_forward(const void* xp, const void* lengths,
                               const void* wh, const void* bh, void* y,
                               int rows_per_set, int nsets, int T, int H,
                               int bt, int bf16, void* stream) {
  if (rows_per_set < 0 || nsets < 1 || nsets > 2 || T < 0 || H < 1 ||
      H > 1024 || !tile_ok(bt))
    return (int)cudaErrorInvalidValue;
  if (rows_per_set == 0 || T == 0) return 0;
  const int R = rows_per_set, H3 = 3 * H;
  ProbeArgs a = {};
  a.xp = static_cast<const float*>(xp);
  a.lengths = static_cast<const int*>(lengths);
  a.bh = static_cast<const float*>(bh);
  a.y = static_cast<float*>(y);
  a.xoff = (size_t)R * T * H3;  // set s's rows follow set s - 1's
  a.yoff = (size_t)R * T * H;
  a.loff = R;
  for (int s = 0; s < nsets; ++s)
    a.wh[s] = static_cast<const float*>(wh) + (size_t)s * H * H3;
  a.T = T;
  a.ldx = H3;
  a.ldy = H;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<RecBf16>(a, R, nsets, H, bt, st)
              : launch<RecF32>(a, R, nsets, H, bt, st);
}

namespace {

int dual(const void* x, const void* x_flip, const void* lengths,
         const void* const* dirs, void* y_f, void* y_b, int B, int T, int D,
         int H, int bt, int k_steps, int bf16, int stop, void* stream) {
  if (B < 0 || T < 0 || D < 1 || H < 1 || H > 1024 || k_steps < 0 ||
      !tile_ok(bt) ||
      static_cast<float*>(y_b) != static_cast<float*>(y_f) + (size_t)B * T * H)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  ProbeArgs a = {};
  a.lengths = static_cast<const int*>(lengths);
  a.y = static_cast<float*>(y_f);
  a.yoff = (size_t)B * T * H;
  for (int d = 0; d < 2; ++d) {
    a.x[d] = static_cast<const float*>(d ? x_flip : x);
    a.wi[d] = static_cast<const float*>(dirs[4 * d]);
    a.bi[d] = static_cast<const float*>(dirs[4 * d + 1]);
    a.wh[d] = static_cast<const float*>(dirs[4 * d + 2]);
    a.bhs[d] = static_cast<const float*>(dirs[4 * d + 3]);
  }
  a.T = T;
  a.ldy = H;
  a.D = D;
  a.K = k_steps < T ? k_steps : T;  // 0: the plan's
  a.stop = stop;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<DualBf16>(a, B, 2, H, bt, st)
              : launch<DualF32>(a, B, 2, H, bt, st);
}

}  // namespace

// x, x_flip: (B, T, D) f32; lengths: (B,) int32; per direction wi (D, 3H),
// bi (3H,), wh (H, 3H), bh (3H,) f32, forward then backward; y_f, y_b:
// (B, T, H) f32, one allocation: y_b = y_f + B T H. bt: rows a cluster (1,
// 2 or 4 n up to 64), or 0 for the plan's; k_steps: steps a chunk (at most
// T), or 0 for the plan's. All contiguous on the device. Returns the
// cudaError_t of the launch.
extern "C" int gru_dual_forward(const void* x, const void* x_flip,
                                const void* lengths, const void* wif,
                                const void* bif, const void* whf,
                                const void* bhf, const void* wib,
                                const void* bib, const void* whb,
                                const void* bhb, void* y_f, void* y_b, int B,
                                int T, int D, int H, int bt, int k_steps,
                                int bf16, void* stream) {
  const void* dirs[8] = {wif, bif, whf, bhf, wib, bib, whb, bhb};
  return dual(x, x_flip, lengths, dirs, y_f, y_b, B, T, D, H, bt, k_steps,
              bf16, 0, stream);
}

// gru_dual_forward with parts left out, to time the others (its output is
// not the layer's): stop bit 0 leaves every chunk's projection at zero,
// bit 1 skips the recurrent products.
extern "C" int gru_dual_stop(const void* x, const void* x_flip,
                             const void* lengths, const void* wif,
                             const void* bif, const void* whf,
                             const void* bhf, const void* wib,
                             const void* bib, const void* whb,
                             const void* bhb, void* y_f, void* y_b, int B,
                             int T, int D, int H, int bt, int k_steps,
                             int bf16, int stop, void* stream) {
  const void* dirs[8] = {wif, bif, whf, bhf, wib, bib, whb, bhb};
  return dual(x, x_flip, lengths, dirs, y_f, y_b, B, T, D, H, bt, k_steps,
              bf16, stop, stream);
}

// The launch gru_rec_forward takes for nsets sets of R rows, hidden size H,
// tile bt (0: the plan's), on the current card: out[0..10] = C, U, Up, Hk,
// BT, the chunk K (0: the recurrence has none), shared memory bytes a
// block, threads a block, blocks, the clusters of that shape the card runs
// at once, and the waves they take. Returns the cudaError_t of the
// occupancy queries (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int gru_rec_plan(int R, int nsets, int H, int bt, int bf16,
                            int* out) {
  if (R < 1 || nsets < 1 || nsets > 2 || H < 1 || H > 1024 || !tile_ok(bt))
    return (int)cudaErrorInvalidValue;
  ProbeArgs a = {};
  Plan p = {};
  int threads = 0;
  size_t smem = 0;
  const cudaError_t e =
      bf16 ? make_plan<RecBf16>(a, R, nsets, H, bt, &p, &threads, &smem)
           : make_plan<RecF32>(a, R, nsets, H, bt, &p, &threads, &smem);
  return write_plan(e, a, p, out);
}

// The launch gru_dual_forward takes for B rows of T steps, width D, hidden
// size H, tile bt and chunk k_steps (each 0 for the plan's): out as
// gru_rec_plan's.
extern "C" int gru_dual_plan(int B, int T, int D, int H, int bt,
                             int k_steps, int bf16, int* out) {
  if (B < 1 || T < 1 || D < 1 || H < 1 || H > 1024 || k_steps < 0 ||
      !tile_ok(bt))
    return (int)cudaErrorInvalidValue;
  ProbeArgs a = {};
  a.T = T;
  a.D = D;
  a.K = k_steps < T ? k_steps : T;
  Plan p = {};
  int threads = 0;
  size_t smem = 0;
  const cudaError_t e =
      bf16 ? make_plan<DualBf16>(a, B, 2, H, bt, &p, &threads, &smem)
           : make_plan<DualF32>(a, B, 2, H, bt, &p, &threads, &smem);
  return write_plan(e, a, p, out);
}
