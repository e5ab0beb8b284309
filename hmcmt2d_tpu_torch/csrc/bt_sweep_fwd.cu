// The forward sweep of the block-Thomas solve, given the inverse Schur
// complements G_j of schur_factor.cu:
//
//   y_0 = G_0 b_0,        y_j = G_j (b_j + c_{j-1} * y_{j-1}),  j = 1 .. n-1
//
// with c_j = offz_j the diagonal z-coupling and * elementwise.
//
// Replaces the Pallas TPU kernel _sweep_fwd_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:357-380).
//
// Bound: the sweep reads every line of G once (8 q^2 bytes a line, 0.70 GB
// at the flagship: q = 95, 55 lines, 176 systems) for 8 flops per 8 bytes,
// so device-memory bandwidth bounds it: 0.2141 ms at 3.35 TB/s, with offz,
// b and y.
//
// Design.  The first version (0.4887 ms at the flagship on an H100 SXM)
// issued a line's loads of G_j only after the previous line's barrier, one
// 760-byte row in flight per warp, so it paid device-memory latency several
// times per line.  G_j does not depend on the carried y_{j-1}, so here, as
// in bt_sweep_bwd.cu, a producer warp keeps the next lines of G in flight
// while 16 consumer warps multiply the current one: G streams through a
// ring of NC slots in shared memory, one TMA bulk copy a slot (a line up to
// qp = 96, half a line at 128), each slot with an mbarrier that counts its
// bytes.  The
// producer refills the slots of line j - 1 right after the barrier that
// ends it, so the loads of later lines are issued before the current
// line's barrier and stay in flight across it.  b_j and c_{j-1} come
// through the same producer (cp.async, two lines ahead).  Consumer warp w
// multiplies rows RPW w .. RPW w + RPW - 1, lane l columns l + 32 cc, with
// b_j + c_{j-1} * y_{j-1} formed in registers from the double-buffered
// carry, rounded as the plain version rounds it (product, then sum); the
// row sums are reduced by a transposing butterfly, and one barrier per line
// publishes y_j.  Padding is zeroed once, so the consumers' loops have no
// bounds tests.
//
// The end of G.  A bulk copy needs 16-byte aligned addresses and sizes, and
// a line of G (8 q^2 bytes) starts 8 bytes off a 16-byte boundary on every
// other line at odd q, so a chunk is copied as the 16-byte aligned span
// around it, at most 8 bytes either side.  Unlike the backward sweep, this
// one reads the last line of G, and when B nzi q is odd the span of the
// chunk that ends G would end 8 bytes past G.  Those bytes would land in
// the slot entry after the line, which the last row multiplies by a zero
// weight, so a NaN there would poison y.  The copy of that one chunk stops
// at the last 16-byte boundary inside G instead; the producer lane loads
// the element left over with an ordinary load and zeroes the entry after
// it, both before the mbarrier arrive whose release makes them visible to
// the consumers.  Nothing outside G is read, and the fix stays inside this
// kernel: spare bytes at the end of G's allocation or a padded row stride
// would reach into the factor, the backward sweep and the plain versions,
// and the first would still read outside the tensor the sweep is given.
//
// The plan (ops/fused_factor.py bt_sweep_fwd_plan) is the backward sweep's:
// three whole-line slots up to qp = 96, three half-line slots at 128, one
// block an SM.  Half-line slots at qp = 96, so that two blocks fit and all
// 176 systems are resident on 132 SMs at once, were measured against it
// and lost (H100 SXM, 700 W, queued CUDA-event timing): 0.277 ms against
// 0.267 ms at the flagship.  A block alone then has only a line and a half
// in flight and issues the second half of each line when the line starts
// (0.073 ms against 0.058 ms for one system), which costs more than the
// second wave of 44 blocks saves.
//
// Registers (nvcc 12.8, -Xptxas -v, as scripts/torch_kernel_scaling.py
// prints them): 56 a thread at q = 95, 64 at q = 128, no spills; 226 KB of
// shared memory at q = 95.

#include <cuda_runtime.h>
#include <stdint.h>
#include "cplx.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int E = 3;                 // lines of b and c in the ring
constexpr unsigned FULL = 0xffffffffu;

template <int RPW, int NC>
__global__ void __launch_bounds__(THREADS + 32, 1)
bt_sweep_fwd_kernel(const float2* __restrict__ G,    // (B, nzi, q, q)
                    const float* __restrict__ offz,  // (B, nzi-1, q)
                    const float2* __restrict__ rhs,  // (B, nzi, q)
                    float2* __restrict__ y,          // (B, nzi, q)
                    int nzi, int q) {
  constexpr int CT = RPW / 2;        // columns per lane
  constexpr int QP = 32 * CT;        // = WARPS * RPW, q padded
  using C = Chunks<QP>;
  constexpr int P = RPW <= 2 ? 2 : RPW <= 4 ? 4 : 8;   // partial sums, padded
  constexpr int GAP = 32 / P;        // lanes between the final sums
  static_assert(NC > C::PER_LINE, "the ring must reach past a line");
  extern __shared__ __align__(16) float2 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* ring = smem;                                 // [NC][SLOT] chunks of G
  float2* carry = ring + NC * C::SLOT;                 // [2][QP] y_{j-1}, y_j
  float2* bv = carry + 2 * QP;                         // [E][QP] b lines
  float* cv = reinterpret_cast<float*>(bv + E * QP);   // [E][QP] c lines
  uint64_t* bars = reinterpret_cast<uint64_t*>(cv + E * QP);   // [NC]
  constexpr int WORDS = (NC * C::SLOT + 2 * QP + E * QP) * 2 + E * QP;

  const size_t b = blockIdx.x;
  const size_t qq = (size_t)q * q;
  const float2* G_b = G + b * nzi * qq;
  const float* oz_b = offz + b * (nzi - 1) * q;
  const float2* rhs_b = rhs + b * nzi * q;
  float2* y_b = y + b * nzi * q;
  const size_t g_end = (size_t)gridDim.x * nzi * qq;   // elements in G
  const int n_chunks = nzi * C::PER_LINE;
  const bool producer = warp == WARPS;

  // chunk u: rows ROWS h .. of line j = u / PER_LINE, h = u % PER_LINE; the
  // 16-byte aligned span around them, one bulk copy, cut at the end of G
  auto issue_chunk = [&](int u) {
    const int j = u / C::PER_LINE;
    const int r0 = C::ROWS * (u % C::PER_LINE);
    const int rows = min(C::ROWS, q - r0);
    const size_t off = (b * nzi + j) * qq + (size_t)r0 * q;   // in G
    const int m = span_shift(G + off);
    const int n = rows * q + m;      // slot entries the chunk fills
    float2* slot = ring + (u % NC) * C::SLOT;
    int pairs = (n + 1) / 2;         // 16-byte units of the span
    if (off - m + 2 * (size_t)pairs > g_end) {   // only the chunk ending G
      pairs = n / 2;
      slot[n - 1] = G[off + (size_t)rows * q - 1];
      slot[n] = make_float2(0.f, 0.f);
    }
    uint64_t* bar = bars + u % NC;
    mbar_expect(bar, 16u * (unsigned)pairs);
    if (pairs > 0) bulk_copy(slot, G + off - m, 16u * (unsigned)pairs, bar);
  };
  // b_j and c_{j-1} of line j into slot j % E; one commit group per line
  auto issue_vec = [&](int j) {
    if (j < nzi)
      for (int c = lane; c < q; c += 32) {
        cp_async8(bv + (j % E) * QP + c, rhs_b + (size_t)j * q + c);
        if (j > 0)
          cp_async4(cv + (j % E) * QP + c, oz_b + (size_t)(j - 1) * q + c);
      }
    cp_async_commit();
  };

  // padding reads as zero: the consumers' loops need no bounds
  for (int e = threadIdx.x; e < WORDS; e += THREADS + 32)
    reinterpret_cast<float*>(smem)[e] = 0.f;
  fence_proxy_async();
  __syncthreads();
  if (producer) {
    if (lane == 0) {
      for (int s = 0; s < NC; ++s) mbar_init(bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int u = 0; u < min(NC, n_chunks); ++u) issue_chunk(u);
    }
    for (int j = 0; j < E - 1; ++j) issue_vec(j);
    cp_async_wait<E - 2>();            // b of line 0
  }
  __syncthreads();

  // after the reduction lane l holds the sum of row t = l / GAP
  const int my_t = lane / GAP;
  const bool writer = !producer && lane % GAP == 0 && my_t < RPW;
  const int my_row = warp * RPW + my_t;
  for (int j = 0; j < nzi; ++j) {
    if (producer) {
      // refill the chunks of line j - 1, free since the last barrier, and
      // fetch b and c two lines ahead
      if (lane == 0 && j > 0)
        for (int h = 0; h < C::PER_LINE; ++h) {
          const int u = (j - 1) * C::PER_LINE + h + NC;
          if (u < n_chunks) issue_chunk(u);
        }
      issue_vec(j + E - 1);
      cp_async_wait<E - 2>();          // b and c of line j + 1
    } else {
      const float2* yin = carry + ((j + 1) & 1) * QP;   // y_{j-1}
      float2* yout = carry + (j & 1) * QP;
      const float2* b_j = bv + (j % E) * QP;
      const float* c_j = cv + (j % E) * QP;            // c_{j-1}
      float2 w[CT];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int c = lane + 32 * cc;
        w[cc] = b_j[c];
        if (j > 0) {
          const float2 v = yin[c];
          w[cc].x = __fadd_rn(w[cc].x, __fmul_rn(c_j[c], v.x));
          w[cc].y = __fadd_rn(w[cc].y, __fmul_rn(c_j[c], v.y));
        }
      }
      const int r0 = warp * RPW;
      const int u = j * C::PER_LINE + r0 / C::ROWS;
      mbar_wait(bars + u % NC, (unsigned)(u / NC) & 1u);
      const float2* blk = ring + (u % NC) * C::SLOT
                          + span_shift(G_b + ((size_t)j * q + r0 - r0 % C::ROWS) * q)
                          + (r0 % C::ROWS) * q;
      float2 acc[P];
#pragma unroll
      for (int t = 0; t < P; ++t) acc[t] = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < RPW; ++t)
#pragma unroll
        for (int cc = 0; cc < CT; ++cc)
          acc[t] = cfma(blk[t * q + lane + 32 * cc], w[cc], acc[t]);

      // transposing butterfly: each round a lane keeps half of its sums and
      // adds its partner's half of the same rows
#pragma unroll
      for (int half = P / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
        const bool up = (lane & off) != 0;
#pragma unroll
        for (int t = 0; t < half; ++t) {
          const float2 send = up ? acc[t] : acc[t + half];
          const float2 keep = up ? acc[t + half] : acc[t];
          acc[t].x = keep.x + __shfl_xor_sync(FULL, send.x, off);
          acc[t].y = keep.y + __shfl_xor_sync(FULL, send.y, off);
        }
      }
#pragma unroll
      for (int off = GAP / 2; off > 0; off >>= 1) {
        acc[0].x += __shfl_xor_sync(FULL, acc[0].x, off);
        acc[0].y += __shfl_xor_sync(FULL, acc[0].y, off);
      }
      if (writer && my_row < q) {
        y_b[(size_t)j * q + my_row] = acc[0];
        yout[my_row] = acc[0];
      }
    }
    __syncthreads();
  }
  if (producer) cp_async_wait<0>();
}

template <int RPW, int NC>
int launch(const void* G, const void* offz, const void* rhs, void* y, int B,
           int nzi, int q, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bt_sweep_fwd_kernel<RPW, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bt_sweep_fwd_kernel<RPW, NC><<<B, THREADS + 32, smem, stream>>>(
      (const float2*)G, (const float*)offz, (const float2*)rhs, (float2*)y,
      nzi, q);
  return (int)cudaGetLastError();
}

// Shared memory of a (qp, ring) plan: the chunk slots, the carry, the b and
// c lines and one mbarrier per slot; the launch plan computes the same.
int plan_smem(int qp, int ring) {
  const int per_line = qp <= 96 ? 1 : 2;
  return ring * ((qp / per_line) * qp + 2) * 8 + 2 * qp * 8 + E * qp * 8
         + E * qp * 4 + ring * 8;
}

}  // namespace

// qp, ring (chunk slots), threads and smem come from the launch plan
// (ops/fused_factor.py bt_sweep_fwd_plan); a plan this file does not
// compile is refused, and so is a G that is not 16-byte aligned (the bulk
// copies need it).
extern "C" int hmc_bt_sweep_fwd(const void* G, const void* offz,
                                const void* rhs, void* y, int B, int nzi,
                                int q, int qp, int ring, int threads,
                                int smem, void* stream) {
  if (threads != THREADS + 32 || q < 1 || q > qp || ring != 3 ||
      smem != plan_smem(qp, ring) ||
      (reinterpret_cast<size_t>(G) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nzi == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qp) {
    case 32: return launch<2, 3>(G, offz, rhs, y, B, nzi, q, smem, s);
    case 64: return launch<4, 3>(G, offz, rhs, y, B, nzi, q, smem, s);
    case 96: return launch<6, 3>(G, offz, rhs, y, B, nzi, q, smem, s);
    case 128: return launch<8, 3>(G, offz, rhs, y, B, nzi, q, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
