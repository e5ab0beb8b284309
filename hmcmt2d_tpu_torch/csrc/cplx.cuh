// Complex helpers on interleaved (re, im) pairs: float2 is the memory layout
// of torch.complex64, double2 that of torch.complex128.
#pragma once
#include <cuda_runtime.h>

template <typename V>
__device__ __forceinline__ V cmake(decltype(V::x) re, decltype(V::x) im) {
  V z;
  z.x = re;
  z.y = im;
  return z;
}

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return cmake<V>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc + a * b
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(acc.x + a.x * b.x - a.y * b.y,
                     acc.y + a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cfma(double2 a, double2 b, double2 acc) {
  return make_double2(acc.x + a.x * b.x - a.y * b.y,
                      acc.y + a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float rabs(float x) { return fabsf(x); }
__device__ __forceinline__ double rabs(double x) { return fabs(x); }

// 1 / z by Smith's algorithm, the complex division of PyTorch (c10::complex)
// applied to 1 / z, so that a pivot inverse rounds as in the plain versions
template <typename V>
__device__ __forceinline__ V crcp(V z) {
  using R = decltype(V::x);
  if (rabs(z.x) >= rabs(z.y)) {
    const R rat = z.y / z.x;
    const R scl = R(1) / (z.x + z.y * rat);
    return cmake<V>(scl, -rat * scl);
  }
  const R rat = z.x / z.y;
  const R scl = R(1) / (z.y + z.x * rat);
  return cmake<V>(rat * scl, -scl);
}
