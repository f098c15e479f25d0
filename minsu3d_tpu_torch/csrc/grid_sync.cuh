// Grid-wide barrier of the persistent cooperative kernels (K3/K18 in
// connected_components.cu, K9 in unit_compact.cu).
//
// `bar` points at two zeroed uint32 words in device memory: an arrival
// counter and a generation word. Valid only under a cooperative launch,
// which makes every block of the grid co-resident; a block spins on the
// generation word until the last block to arrive raises it. The counter is
// back at 0 when the barrier opens, so the words serve every barrier of a
// launch without a reset.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ms3d {

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void grid_sync(uint32_t* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t* count = bar;
    uint32_t* gen = bar + 1;
    const uint32_t g = ld_acquire(gen);
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (ld_acquire(gen) == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace ms3d
