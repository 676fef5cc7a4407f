// Chained-dot rate probe for Hopper (sm_90a): out = sum over r < reps of
// roll(A, r % 8, lanes) @ B, A (M, K) and B (K, N) f32, f32 sums, computed
// anew in each of `grid` steps.
//
// Replaces scripts/bench_fused_cnn.py::_mm_kernel (:63, the pallas_call of
// ::mxu_rate at :78): there A and B stay in VMEM, the grid's steps run in
// order and each overwrites the one (M, N) output block. Here the steps
// run in parallel (blockIdx.z), every block computes its (64 x 64) output
// tile through all reps products (csrc/sgemm_tile.cuh, the roll an index
// of the A loads), and only the step `store_step` (a runtime argument, the
// last step by default) stores it: no two steps race on the output, and
// the compiler cannot drop the steps whose results are not stored. The
// reps are not folded into eight rolled copies: the kernel runs all
// reps x grid products.
//
// What bounds it: the multiply-adds, M K N reps grid, at the f32 FMA peak
// (67 TFLOP/s): 0.313 ms at (192, 104, 128) with reps = grid = 64, 131.3 ms
// at 1024^3. A and B (at most 8 MB) stay in L2; each block re-reads its A
// rows and B columns from L2 once a product. The tile is a simple SGEMM
// (4 x 4 outputs a thread): right first, fast in a later change.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

namespace {

__global__ void __launch_bounds__(sgemm::THREADS)
mm_rate_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int K, int N, int reps,
               int store_step) {
  __shared__ __align__(16) sgemm::Smem s;
  const int n0 = blockIdx.x * sgemm::BN, m0 = blockIdx.y * sgemm::BM;
  float acc[4][4] = {};
  for (int r = 0; r < reps; ++r)
    sgemm::tile(acc, a, K, b, N, M, N, K, m0, n0, r % 8, s);
  if ((int)blockIdx.z == store_step) sgemm::store(acc, out, N, M, N, m0, n0);
}

}  // namespace

// a: (M, K) f32, b: (K, N) f32, out: (M, N) f32, all contiguous; grid steps
// of reps products each; store_step: the step whose result is stored
// (0 <= store_step < grid). Returns the cudaError_t of the launch.
extern "C" int mm_rate(const void* a, const void* b, void* out, int M, int K,
                       int N, int reps, int grid, int store_step,
                       void* stream) {
  if (M < 1 || K < 1 || N < 1 || reps < 0 || grid < 1 || grid > 65535 ||
      store_step < 0 || store_step >= grid)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((N + sgemm::BN - 1) / sgemm::BN,
                    (M + sgemm::BM - 1) / sgemm::BM, grid);
  mm_rate_kernel<<<blocks, sgemm::THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N, reps, store_step);
  return (int)cudaGetLastError();
}
