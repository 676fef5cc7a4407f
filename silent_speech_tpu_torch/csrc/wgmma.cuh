// Hopper's warpgroup MMA (wgmma) from shared memory: the operand
// descriptor and the fences, shared by the kernels that run it
// (gru_proj.cu's large route, dot_chain.cu's bf16 chain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a K-major operand in the 128-byte swizzle: rows of 128 bytes from
// `addr` (a plane starting on 1,024 bytes, plus the k step's offset in
// the row), 16-byte unit u of row r at u ^ (r % 8), 8-row groups 1,024
// bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace
