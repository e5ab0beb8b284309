// Batched unpivoted Gauss-Jordan inverse, blocked in panels: X_b = inv(A_b)
// for every matrix A_b (n x n, complex64 or complex128) of a batch, NB = 16
// pivots a step, in place, in the order of the plain version
// (ops/fused_factor.py gj_inverse_blocked).  For each panel K of NB pivots:
//
//   R = inv(A[K, K]) A[K, :],  R[:, K] = inv(A[K, K]);
//   A[r, :] = A[r, :] - A[r, K] R  for r outside K, with A[r, K] cleared
//   first (so that column K becomes -A[r, K] inv(A[K, K]));  A[K, :] = R.
//
// No pivoting is stable only on the equilibrated MT operator (real part
// positive definite, so every pivot block stays invertible), which is what
// ops/solver.py factorize passes.
//
// Replaces inv_nopivot (hmcmt2d_tpu/ops/blockinv.py:41), which the JAX
// package builds from XLA ops: the same panel-16 blocked Gauss-Jordan, as
// batched matrix products on an augmented [A | I], written to keep the
// TPU's matrix unit busy.  As torch ops on the card that order is ~800
// small launches an inverse, so here the whole elimination of a matrix is
// one block of one launch.
//
// Bound: 8 n^3 flops a matrix (the n pivots' rank-1 updates, gathered here
// into n / NB rank-NB updates) against 2 n^2 complex values read and
// written, so operations bound it: at the flagship's thomas line (B = 176,
// n = 95) 1.2 GFLOP, 18 us at the H100 SXM's 67 TFLOP/s, its fp32 rate and
// its best fp64 rate (the tensor cores') alike; the complex128 path runs on
// the CUDA cores, whose fp64 rate is half that.
//
// What bounded the first design, one pivot a step (the elimination that
// schur_factor.cu shares, csrc/gj_core.cuh): a block-wide barrier at every
// pivot, behind a serial chain (the owner warp's update, a shuffle, the
// exact pivot inverse, the stores), with one RT x CT tile of updates a
// thread to cover it.
//
// Design.  One block of 16 x 32 threads holds one matrix in registers:
// each warp holds one row of every panel and lane l the columns l + 32 cc,
// an RT x CT tile a thread, indexed only by unrolled constant loops.  The
// tile's rows rotate by one each panel, so that tile row 0 always holds
// the current panel's rows and tile row 1 the next one's: at panel p, tile
// row t holds matrix row warp + 16 ((t + p) mod RT).  A panel:
//   1. every warp updates its row of the next panel first, stores it into
//      rowp, and arrives at a named barrier;
//   2. warp 0 waits there and inverts the next pivot block in its
//      registers (lane l holds column l % 16 of rows l / 16 + 2 m),
//      warp-synchronously with shuffles, in gj_inverse_nopivot's steps
//      (indices past n take the identity, as JAX pads its tail), then
//      arrives at a second named barrier; meanwhile every warp applies the
//      rank-16 update to the rest of its tile: per pivot RT + CT shared
//      loads (a pair of pivots' columns in one 16-byte load) for RT * CT
//      complex FMAs, independent accumulators; the panel's own rows take R;
//   3. each warp waits for the pivot block's inverse and forms its row of
//      the next R = inv(P) A[K, :] (R[:, K] = inv(P)); the lanes that hold
//      the next panel's columns store them, negated; one block barrier.
// One block-wide barrier a panel (8 at n = 95, against 95 one pivot at a
// time); the pivot block's serial chain and R run beside the update.  The
// panel's columns and R are double-buffered; its rows are read only before
// the barrier.  Padded rows and columns stay zero.
//
// What bounds it now, on the H100 SXM: warp 0's pivot block, a serial
// chain of 16 warp-synchronous steps (~3.2 us a panel), longer than the
// whole tile's rank-16 update it overlaps (~2.9 us); 0.11 ms at the
// flagship's line, a sixth of the bound, and 1.7 ms at B = 5,632, a third
// (scripts/torch_kernel_scaling.py times each step).
//
// complex128 doubles the tile's registers: at n <= 96 the 6 x 3 tile of
// double2 takes 72 of a thread's 128 registers at one block an SM; at
// n > 96 the 8 x 4 tile (128 registers alone) cannot fit in the register
// file, whose 256 KB equal the matrix, and spills to local memory (L1/L2).
// That path is right and slow; no caller in the port inverts blocks wider
// than the flagship's 95 in complex128.

#include <cuda_runtime.h>
#include "gj_core.cuh"
#include "named_barrier.cuh"

namespace {

using gj::FULL;
using gj::THREADS;
using gj::TX;
using gj::TY;

constexpr int NB = TY;   // pivots a panel, one row a warp (ops/fused_factor.py GJ_PANEL)
// named barriers: the next panel's rows are in rowp; its pivot block's
// inverse is in pinv
constexpr int NEXT_ROWS = 1;
constexpr int PINV_READY = 2;

template <typename V>
__device__ __forceinline__ V shfl(V v, int src) {
  v.x = __shfl_sync(FULL, v.x, src);
  v.y = __shfl_sync(FULL, v.y, src);
  return v;
}

template <typename V>
__device__ __forceinline__ V neg(V v) {
  return cmake<V>(-v.x, -v.y);
}

// two neighbouring entries p[0], p[1] (p 16-byte aligned)
__device__ __forceinline__ void load2(const float2* p, float2& a, float2& b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = make_float2(v.x, v.y);
  b = make_float2(v.z, v.w);
}
__device__ __forceinline__ void load2(const double2* p, double2& a, double2& b) {
  a = p[0];
  b = p[1];
}

// 1 / z as conj(z) / |z|^2, one correctly rounded reciprocal (the plain
// version's complex division rounds otherwise, within the tolerance)
__device__ __forceinline__ float2 crcp_fast(float2 z) {
  const float s = __frcp_rn(z.x * z.x + z.y * z.y);
  return make_float2(z.x * s, -z.y * s);
}
__device__ __forceinline__ double2 crcp_fast(double2 z) {
  const double s = __drcp_rn(z.x * z.x + z.y * z.y);
  return make_double2(z.x * s, -z.y * s);
}

// tile row t's matrix row at panel p
template <int RT>
__device__ __forceinline__ int row_of(int t, int p, int warp) {
  return warp + TY * ((t + p) % RT);
}

// The lanes that hold the columns of panel K (k0..k0+NB-1) store them,
// negated, into colp [QP][NB].
template <typename V, int RT, int CT>
__device__ __forceinline__ void publish_cols(const V (&S)[RT][CT], V* colp,
                                             int k0, int p, int lane,
                                             int warp) {
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) {
    const int kk = lane + TX * cc - k0;
    if ((unsigned)kk < (unsigned)NB) {
#pragma unroll
      for (int t = 0; t < RT; ++t) colp[row_of<RT>(t, p, warp) * NB + kk] = neg(S[t][cc]);
    }
  }
}

// By one warp: inv(P) of the pivot block P = A[K, K] of the panel at k0,
// read from rowp [NB][QP], into pinv [NB][NB].  Lane l holds column
// c = l % NB of rows g + 2 m (g = l / NB); row k lives on lanes
// (k % 2) NB + c, entry k / 2, and column k on lanes g NB + k.  Rows past n
// take the identity.  Each step is gj_inverse_nopivot's.
template <typename V, int QP>
__device__ __forceinline__ void invert_pivot_block(const V* rowp, V* pinv,
                                                   int k0, int n, int lane) {
  constexpr int G = TX / NB;
  constexpr int M = NB / G;
  const int c = lane % NB, g = lane / NB;
  V P[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = g + G * m;
    P[m] = k0 + r < n ? rowp[r * QP + k0 + c] : cmake<V>(r == c ? 1 : 0, 0);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int src = (k % G) * NB;
    const V d = shfl(P[k / G], src + k);
    const V rv = shfl(P[k / G], src + c);
    V cv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) cv[m] = shfl(P[m], g * NB + k);
    const V p = crcp_fast(d);
    const V row = c == k ? p : cmul(rv, p);
    // one update for every entry, as gj_core.cuh's: with row k and column
    // k cleared and the pivot's column entry -1, P - col row gives row k
    // the scaled row and column k -col p; selects, not branches on the
    // lane, so the step's shuffles and products overlap
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = g + G * m;
      const V base = (r == k || c == k) ? gj::zero<V>() : P[m];
      P[m] = gj::upd(base, r == k ? cmake<V>(-1, 0) : cv[m], row);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) pinv[(g + G * m) * NB + c] = P[m];
  __syncwarp();   // the warp's own lanes read pinv next, with no barrier
}

// R [NB][QP] = inv(P) A[K, :] (rowp), with R[:, K] = inv(P); warp w forms
// row w, each lane its columns lane + 32 cc.
template <typename V, int CT>
__device__ __forceinline__ void form_R(const V* rowp, const V* pinv, V* R,
                                       int k0, int lane, int warp) {
  constexpr int QP = CT * TX;
  V acc[CT];
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) acc[cc] = gj::zero<V>();
#pragma unroll
  for (int j = 0; j < NB; j += 2) {
    V p0, p1;
    load2(pinv + warp * NB + j, p0, p1);
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      acc[cc] = cfma(p0, rowp[j * QP + lane + TX * cc], acc[cc]);
      acc[cc] = cfma(p1, rowp[(j + 1) * QP + lane + TX * cc], acc[cc]);
    }
  }
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) {
    const int c = lane + TX * cc;
    R[warp * QP + c] = (unsigned)(c - k0) < (unsigned)NB ? pinv[warp * NB + c - k0] : acc[cc];
  }
}

// The rank-NB update of tile rows T0..T1-1 (not row 0, the panel's own):
// columns K cleared, then S += colp[r, :] R (colp holds -A[r, K]).
template <int T0, int T1, typename V, int RT, int CT>
__device__ __forceinline__ void update_rows(V (&S)[RT][CT], const V* colp,
                                            const V* R, int k0, int p,
                                            int lane, int warp) {
  constexpr int QP = RT * TY;
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) {
    if ((unsigned)(lane + TX * cc - k0) < (unsigned)NB) {
#pragma unroll
      for (int t = T0; t < T1; ++t) S[t][cc] = gj::zero<V>();
    }
  }
#pragma unroll
  for (int k = 0; k < NB; k += 2) {
    V b0[CT], b1[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      b0[cc] = R[k * QP + lane + TX * cc];
      b1[cc] = R[(k + 1) * QP + lane + TX * cc];
    }
#pragma unroll
    for (int t = T0; t < T1; ++t) {
      V a0, a1;
      load2(colp + row_of<RT>(t, p, warp) * NB + k, a0, a1);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        S[t][cc] = cfma(a0, b0[cc], S[t][cc]);
        S[t][cc] = cfma(a1, b1[cc], S[t][cc]);
      }
    }
  }
}

template <typename V, int RT, int CT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
gj_inverse_kernel(const V* __restrict__ A,   // (B, n, n)
                  V* __restrict__ X,         // (B, n, n)
                  int n) {
  constexpr int QP = RT * TY;
  static_assert(QP == CT * TX, "the thread tile must cover a square");
  static_assert(RT >= 2, "a tile holds this panel's and the next one's rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* rowp = reinterpret_cast<V*>(smem_raw);   // [NB][QP] the panel's rows
  V* colp = rowp + NB * QP;                   // [2][QP][NB] its columns, negated
  V* pinv = colp + 2 * QP * NB;               // [NB][NB] inv(A[K, K])
  V* R = pinv + NB * NB;                      // [2][NB][QP]

  const int lane = threadIdx.x, warp = threadIdx.y;
  const size_t nn = (size_t)n * n;
  const V* A_b = A + blockIdx.x * nn;
  V* X_b = X + blockIdx.x * nn;

  V S[RT][CT];
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int r = warp + TY * t;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      S[t][cc] = (r < n && c < n) ? A_b[(size_t)r * n + c] : gj::zero<V>();
    }
  }

  // panel 0: its rows and columns, its pivot block's inverse, its R
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) rowp[warp * QP + lane + TX * cc] = S[0][cc];
  publish_cols(S, colp, 0, 0, lane, warp);
  __syncthreads();
  if (warp == 0) invert_pivot_block<V, QP>(rowp, pinv, 0, n, lane);
  __syncthreads();
  form_R<V, CT>(rowp, pinv, R, 0, lane, warp);
  __syncthreads();

  int p = 0;
  for (int k0 = 0;; k0 += NB, ++p) {
    const int k1 = k0 + NB;
    const V* cp = colp + (p & 1) * QP * NB;
    const V* Rp = R + (p & 1) * NB * QP;
    // 1. the next panel's rows (tile row 1) first; warp 0 inverts its pivot
    // block as soon as every warp has stored its row
    update_rows<1, 2>(S, cp, Rp, k0, p, lane, warp);
    if (k1 < n) {
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) rowp[warp * QP + lane + TX * cc] = S[1][cc];
      if (warp == 0) {
        bar_sync(NEXT_ROWS, THREADS);
        invert_pivot_block<V, QP>(rowp, pinv, k1, n, lane);
        bar_arrive(PINV_READY, THREADS);
      } else {
        bar_arrive(NEXT_ROWS, THREADS);
      }
    }
    // 2. the rest of the tile; the panel's own rows take R
    update_rows<2, RT>(S, cp, Rp, k0, p, lane, warp);
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[0][cc] = Rp[warp * QP + lane + TX * cc];
    if (k1 >= n) break;
    // 3. the next panel's R, a row a warp, once its pivot block's inverse
    // is in pinv; its columns; one barrier
    if (warp != 0) bar_sync(PINV_READY, THREADS);
    form_R<V, CT>(rowp, pinv, R + ((p + 1) & 1) * NB * QP, k1, lane, warp);
    publish_cols(S, colp + ((p + 1) & 1) * QP * NB, k1, p, lane, warp);
    __syncthreads();
    // rotate: tile row t takes row t + 1's
    V first[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) first[cc] = S[0][cc];
#pragma unroll
    for (int t = 0; t + 1 < RT; ++t)
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) S[t][cc] = S[t + 1][cc];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[RT - 1][cc] = first[cc];
  }

#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int r = row_of<RT>(t, p, warp);
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      if (r < n && c < n) X_b[(size_t)r * n + c] = S[t][cc];
    }
  }
}

template <typename V, int RT, int CT, int MINB>
int launch(const void* A, void* X, int B, int n, int smem, cudaStream_t s) {
  const auto kernel = gj_inverse_kernel<V, RT, CT, MINB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, dim3(TX, TY), smem, s>>>((const V*)A, (V*)X, n);
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

// qp, threads, smem and panel come from the launch plan (ops/fused_factor.py
// gj_inverse_plan); a plan this file does not compile is refused.  dbl
// selects complex128 (double2) over complex64 (float2).
extern "C" int hmc_gj_inverse(const void* A, void* X, int B, int n, int qp,
                              int threads, int smem, int panel, int dbl,
                              void* stream) {
  const int want = panel * (5 * qp + panel) * (dbl ? 16 : 8);
  if (threads != THREADS || panel != NB || n < 1 || n > qp || qp - n >= 32 ||
      smem != want || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? dispatch<double2, 1>(A, X, B, n, qp, smem, s)
             : dispatch<float2, 2>(A, X, B, n, qp, smem, s);
}
