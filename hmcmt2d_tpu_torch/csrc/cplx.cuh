// Complex float32 helpers on interleaved float2 (re, im), the memory layout
// of torch.complex64.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc + a * b
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(acc.x + a.x * b.x - a.y * b.y,
                     acc.y + a.x * b.y + a.y * b.x);
}

// s - a * b
__device__ __forceinline__ float2 cfms(float2 s, float2 a, float2 b) {
  return make_float2(s.x - (a.x * b.x - a.y * b.y),
                     s.y - (a.x * b.y + a.y * b.x));
}

__device__ __forceinline__ float2 cinv(float2 a) {
  const float d = a.x * a.x + a.y * a.y;
  return make_float2(a.x / d, -a.y / d);
}

__device__ __forceinline__ float2 warp_csum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  return v;
}
