// Named barriers (PTX bar.arrive / bar.sync): producer warps arrive without
// waiting, consumer warps wait until `count` threads of the block have
// arrived at barrier `id` (1..15; __syncthreads takes 0).  Both order the
// shared-memory accesses made before them, as __syncthreads does.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
