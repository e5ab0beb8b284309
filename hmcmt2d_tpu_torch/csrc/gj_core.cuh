// In-place unpivoted Gauss-Jordan inversion of a matrix held in registers by
// a block of TY x TX threads, one pivot a step: schur_factor.cu's
// elimination of each line's Schur complement, in complex64 (float2) or
// complex128 (double2).  gj_inverse.cu, which eliminates a panel of pivots
// a step, shares its thread layout and helpers.
//
// Row r belongs to warp r % TY and column c to lane c % TX, so each thread
// holds an RT x CT tile, indexed only by unrolled constant loops.  Only the
// pivot row (scaled by 1/pivot) and the pivot column go through shared
// memory, double-buffered: after step k the warp that holds row k+1 and the
// lanes that hold column k+1 publish them into the other buffer and clear
// them in registers, so each step is one barrier and one uniform rank-1
// update, each thread reading RT + CT shared values for its RT * CT
// updates.  The steps k = 0..n-1 and every rounding follow the plain version
// (ops/fused_factor.py gj_inverse_nopivot).  No pivoting: the caller passes
// matrices whose pivots stay nonzero (the equilibrated MT operator).
#pragma once
#include <cuda_runtime.h>
#include "cplx.cuh"

namespace gj {

constexpr int TX = 32;   // lanes: column c = lane + TX * cc
constexpr int TY = 16;   // warps: row r = warp + TY * i
constexpr int THREADS = TX * TY;
constexpr unsigned FULL = 0xffffffffu;

template <typename V>
__device__ __forceinline__ V zero() {
  return cmake<V>(0, 0);
}

// s - a * b with the product rounded first, as the plain version's
// A - col * row
template <typename V>
__device__ __forceinline__ V upd(V s, V a, V b) {
  const V t = cmul(a, b);
  return cmake<V>(s.x - t.x, s.y - t.y);
}

// The row of pivot step k, held by warp k % TY (row: its tile row, after
// the step's update): write it scaled by 1/pivot into rowk, entry k being
// 1/pivot itself.
template <typename V, int CT>
__device__ __forceinline__ void publish_row(const V (&row)[CT], int k, V* rowk,
                                            int lane, int n) {
  const int kc = k / TX;
  V d = row[0];
#pragma unroll
  for (int cc = 1; cc < CT; ++cc) d = (cc == kc) ? row[cc] : d;
  d.x = __shfl_sync(FULL, d.x, k % TX);
  d.y = __shfl_sync(FULL, d.y, k % TX);
  const V p = crcp(d);
#pragma unroll
  for (int cc = 0; cc < CT; ++cc) {
    const int c = lane + TX * cc;
    if (c < n) rowk[c] = (c == k) ? p : cmul(row[cc], p);
  }
}

// The column of pivot step k, held by lane k % TX of every warp: write it
// into colk, entry k being -1, and clear it in registers.
template <typename V, int RT, int CT>
__device__ __forceinline__ void publish_col(V (&S)[RT][CT], int k, V* colk,
                                            int lane, int warp, int n) {
#pragma unroll
  for (int cc = 0; cc < CT; ++cc)
    if (cc == k / TX) {
      if (lane == k % TX) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = warp + TY * i;
          if (r < n) colk[r] = (r == k) ? cmake<V>(-1, 0) : S[i][cc];
          S[i][cc] = zero<V>();
        }
      }
    }
}

// Publish pivot step k into the pivot buffers and clear row and column k in
// registers.  With row and column k cleared, the step is one rank-1 update
// S - column * row for every entry: row k becomes the scaled row, column k
// becomes -column / pivot, and entry (k, k) becomes 1/pivot, as in
// gj_inverse_nopivot.  Every branch on k is uniform across a warp except
// the lane test of the column.
template <typename V, int RT, int CT>
__device__ __forceinline__ void publish(V (&S)[RT][CT], int k, V* rowk, V* colk,
                                        int lane, int warp, int n) {
  const int ki = k / TY;
  if (warp == k % TY) {
    V row[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      row[cc] = S[0][cc];
#pragma unroll
      for (int i = 1; i < RT; ++i) row[cc] = (i == ki) ? S[i][cc] : row[cc];
    }
    publish_row(row, k, rowk, lane, n);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (i == ki) {
#pragma unroll
        for (int cc = 0; cc < CT; ++cc) S[i][cc] = zero<V>();
      }
  }
  publish_col(S, k, colk, lane, warp, n);
}

// Invert the n x n matrix in S (zero beyond n) in place.  rowk and colk are
// [2][RT * TY] buffers in shared memory whose entries at n and beyond are
// zero, so padded rows and columns stay zero; every thread of the block
// calls this, and it ends on a barrier.
template <typename V, int RT, int CT>
__device__ __forceinline__ void invert(V (&S)[RT][CT], V* rowk, V* colk,
                                       int lane, int warp, int n) {
  constexpr int QP = RT * TY;
  publish(S, 0, rowk, colk, lane, warp, n);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const V* rk = rowk + (k & 1) * QP;
    const V* ck = colk + (k & 1) * QP;
    V rw[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) rw[cc] = rk[lane + TX * cc];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const V a = ck[warp + TY * i];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) S[i][cc] = upd(S[i][cc], a, rw[cc]);
    }
    if (k + 1 < n)
      publish(S, k + 1, rowk + ((k + 1) & 1) * QP, colk + ((k + 1) & 1) * QP,
              lane, warp, n);
    __syncthreads();
  }
}

}  // namespace gj
