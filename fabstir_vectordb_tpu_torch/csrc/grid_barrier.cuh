// A grid-wide barrier for a persistent kernel whose blocks are all resident
// (launched by cudaLaunchCooperativeKernel, which refuses a grid past the
// occupancy limit): an arrive counter and a generation word in global
// memory, bar[0] and bar[1]. bar[0] is 0 before the first barrier (the
// launcher zeroes it); bar[1] may hold anything.
//
// Each block's thread 0 reads the generation, arrives, and spins until the
// last block to arrive has reset the counter and moved the generation on.
// The fences order every write the block made before the barrier (its
// threads' writes, gathered by __syncthreads) before the arrival, and the
// reads after it after the release. Data that other blocks wrote before
// the barrier is read after it with __ldcg (L2, not a stale L1 line).
// scripts/time_tile_routes.py --only k7 times one barrier of a full grid.
#pragma once

#include <cuda_runtime.h>

namespace fvdb {

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire_gpu(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (ld_acquire_gpu(bar + 1) == gen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace fvdb
