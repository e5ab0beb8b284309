// The two triangular sweeps of the block-Thomas solve, given the inverse
// Schur complements G_j of schur_factor.cu:
//
//   forward :  y_0 = G_0 b_0,        y_j = G_j (b_j + c_{j-1} * y_{j-1})
//   backward:  x_{n-1} = y_{n-1},    x_j = y_j + G_j (c_j * x_{j+1})
//
// with c_j = offz_j the diagonal z-coupling and * elementwise.
//
// Replace the Pallas TPU kernels _sweep_fwd_kernel and _sweep_bwd_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:357-380 and :383-408).  Design: one
// thread block per system, the sequential z-line axis a loop inside the
// block, the carried vector in shared memory.  Each warp takes rows of G_j,
// its lanes read a row coalesced and reduce with shuffles.
//
// Bound: each sweep reads all of G once (B * nzi * q^2 complex floats:
// 0.7 GB at the flagship) for 8 flops per 8 bytes, so memory bandwidth
// bounds it.  This first version keeps one block per system and one row
// load in flight per warp; it is right first, not fast.

#include <cuda_runtime.h>
#include "cplx.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float2 row_dot(const float2* __restrict__ row,
                                          const float2* w, int q, int lane) {
  float2 acc = make_float2(0.f, 0.f);
  for (int c = lane; c < q; c += 32) acc = cfma(row[c], w[c], acc);
  return warp_csum(acc);
}

__global__ void __launch_bounds__(THREADS)
bt_sweep_fwd_kernel(const float2* __restrict__ G,    // (B, nzi, q, q)
                    const float* __restrict__ offz,  // (B, nzi-1, q)
                    const float2* __restrict__ rhs,  // (B, nzi, q)
                    float2* __restrict__ y,          // (B, nzi, q)
                    int nzi, int q) {
  extern __shared__ float2 smem[];
  float2* w = smem;          // b_j + c_{j-1} * y_{j-1}
  float2* carry = smem + q;  // y_{j-1}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const size_t b = blockIdx.x;
  const size_t qq = (size_t)q * q;
  const float2* G_b = G + b * nzi * qq;
  const float* oz_b = offz + b * (nzi - 1) * q;
  const float2* rhs_b = rhs + b * nzi * q;
  float2* y_b = y + b * nzi * q;

  for (int j = 0; j < nzi; ++j) {
    for (int r = tid; r < q; r += blockDim.x) {
      float2 v = rhs_b[(size_t)j * q + r];
      if (j > 0) {
        const float c = oz_b[(size_t)(j - 1) * q + r];
        v.x += c * carry[r].x;
        v.y += c * carry[r].y;
      }
      w[r] = v;
    }
    __syncthreads();
    const float2* Gj = G_b + (size_t)j * qq;
    for (int r = warp; r < q; r += nwarp) {
      const float2 acc = row_dot(Gj + (size_t)r * q, w, q, lane);
      if (lane == 0) {
        y_b[(size_t)j * q + r] = acc;
        carry[r] = acc;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
bt_sweep_bwd_kernel(const float2* __restrict__ G,    // (B, nzi, q, q)
                    const float* __restrict__ offz,  // (B, nzi-1, q)
                    const float2* __restrict__ y,    // (B, nzi, q)
                    float2* __restrict__ x,          // (B, nzi, q)
                    int nzi, int q) {
  extern __shared__ float2 smem[];
  float2* w = smem;          // c_j * x_{j+1}
  float2* carry = smem + q;  // x_{j+1}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const size_t b = blockIdx.x;
  const size_t qq = (size_t)q * q;
  const float2* G_b = G + b * nzi * qq;
  const float* oz_b = offz + b * (nzi - 1) * q;
  const float2* y_b = y + b * nzi * q;
  float2* x_b = x + b * nzi * q;

  const size_t last = (size_t)(nzi - 1) * q;
  for (int r = tid; r < q; r += blockDim.x) {
    const float2 v = y_b[last + r];
    x_b[last + r] = v;
    carry[r] = v;
  }
  __syncthreads();
  for (int j = nzi - 2; j >= 0; --j) {
    for (int r = tid; r < q; r += blockDim.x) {
      const float c = oz_b[(size_t)j * q + r];
      w[r] = make_float2(c * carry[r].x, c * carry[r].y);
    }
    __syncthreads();
    const float2* Gj = G_b + (size_t)j * qq;
    for (int r = warp; r < q; r += nwarp) {
      const float2 acc = row_dot(Gj + (size_t)r * q, w, q, lane);
      if (lane == 0) {
        const float2 yv = y_b[(size_t)j * q + r];
        const float2 v = make_float2(yv.x + acc.x, yv.y + acc.y);
        x_b[(size_t)j * q + r] = v;
        carry[r] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int hmc_bt_sweep_fwd(const void* G, const void* offz,
                                const void* rhs, void* y, int B, int nzi,
                                int q, void* stream) {
  const size_t smem = 2 * (size_t)q * sizeof(float2);
  bt_sweep_fwd_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)G, (const float*)offz, (const float2*)rhs, (float2*)y,
      nzi, q);
  return (int)cudaGetLastError();
}

extern "C" int hmc_bt_sweep_bwd(const void* G, const void* offz,
                                const void* y, void* x, int B, int nzi,
                                int q, void* stream) {
  const size_t smem = 2 * (size_t)q * sizeof(float2);
  bt_sweep_bwd_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)G, (const float*)offz, (const float2*)y, (float2*)x,
      nzi, q);
  return (int)cudaGetLastError();
}
