// Fused block-Thomas Schur chain: for every system b of the batch,
//
//   G_0 = inv(T_0),   G_j = inv(T_j - diag(c_{j-1}) G_{j-1} diag(c_{j-1}))
//
// where T_j is the tridiagonal diagonal block of z-line j (diagonal diag_j,
// off-diagonal entries -offy_j) and c_{j-1} = offz_{j-1} the diagonal
// z-coupling.  Each line is inverted in place by unpivoted complex
// Gauss-Jordan, which is stable here only because the caller passes the
// equilibrated operator (real part positive definite, so every Schur
// complement keeps a nonzero pivot).
//
// Replaces the Pallas TPU kernel _factor_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:137-194).  Design: one thread block per
// system; the TPU's sequential z-line grid axis becomes a loop inside the
// block, because blocks run in no order and cannot pass scratch to each
// other.  S lives in dynamic shared memory (q*q complex floats: 72 KB at
// q = 95, at most 128 KB at q = 128).  G_{j-1} is read back from global
// memory, where this block wrote it one line earlier, so it is hot in L2.
//
// Bound: about q^3 complex multiply-adds per line (8 q^3 flops), on the
// fp32 CUDA cores; at the flagship (q = 95, 55 lines, 176 systems) that is
// 66 GFLOP against 0.7 GB of output, so operations bound it.  This first
// version does every update through shared memory with two barriers per
// pivot step and one block per system; it is right first, not fast.

#include <cuda_runtime.h>
#include "cplx.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 16;

__global__ void __launch_bounds__(TX * TY)
schur_factor_kernel(const float2* __restrict__ diag,  // (B, nzi, q)
                    const float* __restrict__ offy,   // (B, nzi, q-1)
                    const float* __restrict__ offz,   // (B, nzi-1, q)
                    float2* __restrict__ G,           // (B, nzi, q, q)
                    int nzi, int q) {
  extern __shared__ float2 smem[];
  float2* S = smem;           // q*q, row-major
  float2* colk = S + q * q;   // pivot column before the step
  float2* rowk = colk + q;    // pivot row scaled by 1/pivot

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int nthr = TX * TY;
  const int qq = q * q;
  const size_t b = blockIdx.x;
  const float2* d_b = diag + b * nzi * q;
  const float* oy_b = offy + b * nzi * (q - 1);
  const float* oz_b = offz + b * (nzi - 1) * q;
  float2* G_b = G + b * nzi * (size_t)qq;

  for (int j = 0; j < nzi; ++j) {
    const float2* dj = d_b + (size_t)j * q;
    const float* oyj = oy_b + (size_t)j * (q - 1);
    // S = T_j - diag(c) G_{j-1} diag(c)
    for (int e = tid; e < qq; e += nthr) {
      const int r = e / q;
      const int c = e - r * q;
      float2 v = make_float2(0.f, 0.f);
      if (r == c) v = dj[r];
      else if (c == r + 1) v.x = -oyj[r];
      else if (r == c + 1) v.x = -oyj[c];
      if (j > 0) {
        const float* cz = oz_b + (size_t)(j - 1) * q;
        const float cc = cz[r] * cz[c];
        const float2 g = G_b[(size_t)(j - 1) * qq + e];
        v.x -= cc * g.x;
        v.y -= cc * g.y;
      }
      S[e] = v;
    }
    __syncthreads();

    // in-place Gauss-Jordan inverse of S, no pivoting
    for (int k = 0; k < q; ++k) {
      const float2 p = cinv(S[k * q + k]);
      for (int i = tid; i < q; i += nthr) {
        colk[i] = S[i * q + k];
        rowk[i] = cmul(S[k * q + i], p);
      }
      __syncthreads();
      for (int r = ty; r < q; r += TY) {
        const float2 cr = colk[r];
        for (int c = tx; c < q; c += TX) {
          float2 v;
          if (r == k) {
            v = (c == k) ? p : rowk[c];
          } else if (c == k) {
            const float2 t = cmul(cr, p);
            v = make_float2(-t.x, -t.y);
          } else {
            v = cfms(S[r * q + c], cr, rowk[c]);
          }
          S[r * q + c] = v;
        }
      }
      __syncthreads();
    }

    float2* Gj = G_b + (size_t)j * qq;
    for (int e = tid; e < qq; e += nthr) Gj[e] = S[e];
    // the next line reads G_j back from global memory and rewrites S
    __syncthreads();
  }
}

}  // namespace

extern "C" int hmc_schur_factor(const void* diag, const void* offy,
                                const void* offz, void* G, int B, int nzi,
                                int q, void* stream) {
  const size_t smem = (size_t)(q * q + 2 * q) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      schur_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  schur_factor_kernel<<<B, dim3(TX, TY), smem, (cudaStream_t)stream>>>(
      (const float2*)diag, (const float*)offy, (const float*)offz,
      (float2*)G, nzi, q);
  return (int)cudaGetLastError();
}
