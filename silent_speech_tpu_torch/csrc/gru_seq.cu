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
//
// The two bodies live in gru_cluster.cuh, which the GRU design probes
// (gru_proto.cu) share; this file instantiates them as K2 (K2Cfg).

#include <cuda_runtime.h>

#include "gru_cluster.cuh"

namespace {

// The launch of B rows, hidden size H, ndir directions, clusters of C: Wh in
// shared memory whenever its slice fits beside one row's h; BT the smallest
// tile (1, 2, 4, 8, ..., 256) whose clusters the card runs in one wave,
// else the largest that fits.
cudaError_t make_plan(int B, int H, int ndir, int C, Plan* p) {
  SeqArgs a = {};
  int threads = 0;
  size_t smem = 0;
  if (B < 1 || ndir < 1 || ndir > 2 ||
      !layout<K2Cfg>(a, H, C, 1, false, &threads, &smem))
    return cudaErrorInvalidValue;
  const bool smem_w = layout<K2Cfg>(a, H, C, 1, true, &threads, &smem);
  bool found = false;
  for (int bt = 1; bt <= 256; bt = next_tile(bt)) {
    if (!layout<K2Cfg>(a, H, C, bt, smem_w, &threads, &smem)) continue;
    a.B = bt;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(a, 1, smem, threads, 0, attr);
    int clusters = 0;
    const cudaError_t e =
        max_clusters<K2Cfg>(pick<K2Cfg>(bt, a.Up, smem_w), cfg, &clusters);
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
      !layout<K2Cfg>(a, H, C, BT, smem_w, &threads, &smem))
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
  const Kernel<K2Cfg> kernel = pick<K2Cfg>(BT, a.Up, smem_w);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      a, ndir, smem, threads, static_cast<cudaStream_t>(stream), attr);
  int clusters = 0;
  cudaError_t e = max_clusters<K2Cfg>(kernel, cfg, &clusters);
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
