// The 3xTF32 products on mma.sync and the 16-byte cp.async, shared by the
// ROI CNN kernels (roi_cnn_stages.cuh and the kernels that include it) and
// the backward-dot steps kernel (bwd_dots.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x = hi + lo, both TF32, each rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero). sm_90 has no instruction for that cvt:
// ptxas expands it into compares and selects that also handle NaN. For a
// finite x the same rounding is half a TF32 ulp added to the magnitude bits
// and the 13 low bits cleared, two integer operations (16% off K1 f32 at
// N=8192 on an H100).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b: m16n8k8 TF32, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: the small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// cp.async: 16 bytes (the commit included), or 16 or 4 bytes of which the
// first `bytes` are read and the rest zero-filled (a ragged edge; `src`
// must be a valid address even when `bytes` is 0), committed apart
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               "cp.async.commit_group;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src,
                                                int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4_fill(void* dst, const void* src,
                                               int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
