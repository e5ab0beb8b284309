// Batched unpivoted Gauss-Jordan inverse: X_b = inv(A_b) for every matrix
// A_b (n x n, complex64 or complex128) of a batch, rank-1 steps k = 0..n-1
// in the order of the plain version (ops/fused_factor.py
// gj_inverse_nopivot).  No pivoting is stable only on the equilibrated MT
// operator (real part positive definite, so every pivot stays nonzero),
// which is what ops/solver.py factorize passes.
//
// Replaces inv_nopivot (hmcmt2d_tpu/ops/blockinv.py:41), which the JAX
// package builds from XLA ops: a panel-16 blocked Gauss-Jordan of batched
// matrix products, written to keep the TPU's matrix unit busy where its LU
// custom call left it idle.  As torch ops on the card that order is ~800
// small launches an inverse, so here the whole elimination of a matrix is
// one block of one launch.
//
// Bound: n pivot steps of n^2 complex multiply-adds (8 n^3 flops a matrix)
// against 2 n^2 complex values read and written, so operations bound it:
// at the flagship's thomas line (B = 176, n = 95) 1.2 GFLOP, 18 us at the
// H100 SXM's 67 TFLOP/s, its fp32 rate and its best fp64 rate (the tensor
// cores') alike; this kernel's complex128 path runs on the CUDA cores,
// whose fp64 rate is half that.
//
// Design: schur_factor's line loop (csrc/schur_factor.cu) with the Schur
// downdate dropped and A read from device memory, on the elimination both
// share (csrc/gj_core.cuh).  One block of 16 x 32 threads holds one matrix
// in registers: row r belongs to warp r % 16 and column c to lane c % 32,
// so each thread holds an RT x CT tile; the pivot row and column go
// through shared memory, double-buffered, one barrier a step.  Padded rows
// and columns stay zero.
//
// complex128 doubles the tile's registers: at n <= 96 the 6 x 3 tile of
// double2 takes 72 of a thread's 128 registers at one block an SM; at
// n > 96 the 8 x 4 tile (128 registers alone) cannot fit in the register
// file, whose 256 KB equal the matrix, and spills to local memory (L1/L2).
// That path is right and slow; no caller in the port inverts blocks wider
// than the flagship's 95 in complex128.

#include <cuda_runtime.h>
#include "gj_core.cuh"

namespace {

using gj::THREADS;
using gj::TX;
using gj::TY;

template <typename V, int RT, int CT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
gj_inverse_kernel(const V* __restrict__ A,   // (B, n, n)
                  V* __restrict__ X,         // (B, n, n)
                  int n) {
  constexpr int QP = RT * TY;
  static_assert(QP == CT * TX, "the thread tile must cover a square");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* rowk = reinterpret_cast<V*>(smem_raw);   // [2][QP] scaled pivot row
  V* colk = rowk + 2 * QP;                    // [2][QP] pivot column

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TX + lane;
  const size_t nn = (size_t)n * n;
  const V* A_b = A + blockIdx.x * nn;
  V* X_b = X + blockIdx.x * nn;

  // padded pivot entries stay zero, so padded rows and columns stay zero
  for (int e = tid; e < 4 * QP; e += THREADS) rowk[e] = gj::zero<V>();

  V S[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      S[i][cc] = (r < n && c < n) ? A_b[(size_t)r * n + c] : gj::zero<V>();
    }
  }
  __syncthreads();   // the buffers are clear before step 0 is published
  gj::invert(S, rowk, colk, lane, warp, n);

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      if (r < n && c < n) X_b[(size_t)r * n + c] = S[i][cc];
    }
  }
}

template <typename V, int RT, int CT, int MINB>
int launch(const void* A, void* X, int B, int n, int smem, cudaStream_t s) {
  gj_inverse_kernel<V, RT, CT, MINB><<<B, dim3(TX, TY), smem, s>>>(
      (const V*)A, (V*)X, n);
  return (int)cudaGetLastError();
}

template <typename V, int MINB_WIDE>
int dispatch(const void* A, void* X, int B, int n, int qp, int smem,
             cudaStream_t s) {
  switch (qp) {
    case 32: return launch<V, 2, 1, 2>(A, X, B, n, smem, s);
    case 64: return launch<V, 4, 2, 2>(A, X, B, n, smem, s);
    case 96: return launch<V, 6, 3, MINB_WIDE>(A, X, B, n, smem, s);
    case 128: return launch<V, 8, 4, 1>(A, X, B, n, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qp, threads and smem come from the launch plan (ops/fused_factor.py
// gj_inverse_plan); a plan this file does not compile is refused.  dbl
// selects complex128 (double2) over complex64 (float2).
extern "C" int hmc_gj_inverse(const void* A, void* X, int B, int n, int qp,
                              int threads, int smem, int dbl, void* stream) {
  const int want = 4 * qp * (dbl ? 16 : 8);
  if (threads != THREADS || n < 1 || n > qp || qp - n >= 32 || smem != want ||
      B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? dispatch<double2, 1>(A, X, B, n, qp, smem, s)
             : dispatch<float2, 2>(A, X, B, n, qp, smem, s);
}
