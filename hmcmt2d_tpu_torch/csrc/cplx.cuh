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

// 1 / z by Smith's algorithm, the complex division of PyTorch (c10::complex)
// applied to 1 / z, so that a pivot inverse rounds as in the plain versions
__device__ __forceinline__ float2 crcp(float2 z) {
  if (fabsf(z.x) >= fabsf(z.y)) {
    const float rat = z.y / z.x;
    const float scl = 1.f / (z.x + z.y * rat);
    return make_float2(scl, -rat * scl);
  }
  const float rat = z.x / z.y;
  const float scl = 1.f / (z.y + z.x * rat);
  return make_float2(rat * scl, -scl);
}
