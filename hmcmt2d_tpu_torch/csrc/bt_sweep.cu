// The forward sweep of the block-Thomas solve, given the inverse Schur
// complements G_j of schur_factor.cu:
//
//   y_0 = G_0 b_0,        y_j = G_j (b_j + c_{j-1} * y_{j-1})
//
// with c_j = offz_j the diagonal z-coupling and * elementwise.  (The
// backward sweep has its own source, bt_sweep_bwd.cu.)
//
// Replaces the Pallas TPU kernel _sweep_fwd_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:357-380).  Design: one thread block per
// system, the sequential z-line axis a loop inside the block, the carried
// vector in shared memory.  Each warp takes rows of G_j, its lanes read a
// row coalesced and reduce with shuffles.
//
// Bound: the sweep reads all of G once (B * nzi * q^2 complex floats:
// 0.7 GB at the flagship) for 8 flops per 8 bytes, so memory bandwidth
// bounds it.  This first version keeps one block per system and one row
// load in flight per warp, issued after the line barrier; it is right
// first, not fast.  bt_sweep_bwd.cu streams G ahead of the carry instead.

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
