// The backward sweep of the block-Thomas solve, given the inverse Schur
// complements G_j of schur_factor.cu:
//
//   x_{n-1} = y_{n-1},    x_j = y_j + G_j (c_j * x_{j+1}),  j = n-2 .. 0
//
// with c_j = offz_j the diagonal z-coupling and * elementwise.
//
// Replaces the Pallas TPU kernel _sweep_bwd_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:383-408).
//
// Bound: the sweep reads G_0 .. G_{n-2} once (8 q^2 bytes a line, 0.69 GB
// at the flagship: q = 95, 55 lines, 176 systems) for 8 flops per 8 bytes,
// so device-memory bandwidth bounds it (0.21 ms at 3.35 TB/s).
//
// Design.  One block per system, the z-line loop inside.  The first version
// (0.509 ms at the flagship on an H100 SXM) issued a line's loads of G_j
// only after the previous line's barrier, one 760-byte row in flight per
// warp, so it paid device-memory latency several times per line.  G_j does
// not depend on the carried x_{j+1}, so here a producer warp keeps the next
// lines of G in flight while 16 consumer warps multiply the current one:
// G streams through a ring of NC slots in shared memory, one TMA bulk copy
// a slot (a line up to q = 96, half a line at 128), each slot with an
// mbarrier that counts its bytes.  The producer refills the slots of line
// j + 1 right after the barrier that ends it, so the loads of later lines
// are issued before the current line's barrier and stay in flight across
// it.  A bulk copy needs 16-byte aligned addresses and sizes, and a line of
// G (8 q^2 bytes) starts 8 bytes off a 16-byte boundary on every other line
// for odd q, so the copy takes the 16-byte aligned span around it (at most
// 8 bytes either side, still inside G: the backward sweep never reads the
// last line) and the line sits one element into its slot.  Small copies
// are what held the first attempts back: per-thread cp.async and per-row
// bulk copies both left a block alone far slower than whole-line copies,
// and with 176 blocks on 132 SMs the second wave of blocks sets the time.
// y_j and c_j come through the same producer (cp.async, two lines ahead).  Consumer warp w multiplies rows RPW w .. RPW w + RPW - 1,
// lane l columns l + 32 cc, with c_j * x_{j+1} formed in registers from
// the double-buffered carry; the row sums are reduced by a transposing
// butterfly (each round a lane sends half of its partial sums), and one
// barrier per line publishes x_j.  Padding is zeroed once, so the
// consumers' loops have no bounds tests.  The ring size comes from the
// launch plan (ops/fused_factor.py bt_sweep_bwd_plan).
//
// Registers (nvcc 12.8, -Xptxas -v, as scripts/torch_kernel_scaling.py
// prints them): 48 a thread at q = 95, 55 at q = 128, no spills; 226 KB of
// shared memory at q = 95, one block an SM.

#include <cuda_runtime.h>
#include <stdint.h>
#include "cplx.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int E = 3;                 // lines of y and c in the ring
constexpr unsigned FULL = 0xffffffffu;

template <int RPW, int NC>
__global__ void __launch_bounds__(THREADS + 32, 1)
bt_sweep_bwd_kernel(const float2* __restrict__ G,    // (B, nzi, q, q)
                    const float* __restrict__ offz,  // (B, nzi-1, q)
                    const float2* __restrict__ y,    // (B, nzi, q)
                    float2* __restrict__ x,          // (B, nzi, q)
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
  float2* carry = ring + NC * C::SLOT;                 // [2][QP] x_{j+1}, x_j
  float2* yv = carry + 2 * QP;                         // [E][QP] y lines
  float* cv = reinterpret_cast<float*>(yv + E * QP);   // [E][QP] c lines
  uint64_t* bars = reinterpret_cast<uint64_t*>(cv + E * QP);   // [NC]
  constexpr int WORDS = (NC * C::SLOT + 2 * QP + E * QP) * 2 + E * QP;

  const size_t b = blockIdx.x;
  const float2* G_b = G + b * nzi * (size_t)q * q;
  const float* oz_b = offz + b * (nzi - 1) * q;
  const float2* y_b = y + b * nzi * q;
  float2* x_b = x + b * nzi * q;
  const int n_chunks = (nzi - 1) * C::PER_LINE;
  const bool producer = warp == WARPS;

  // chunk u: rows ROWS h .. of line L = u / PER_LINE (j = nzi - 2 - L),
  // h = u % PER_LINE; the 16-byte aligned span around them, one bulk copy
  auto issue_chunk = [&](int u) {
    const int j = nzi - 2 - u / C::PER_LINE;
    const int r0 = C::ROWS * (u % C::PER_LINE);
    const int rows = min(C::ROWS, q - r0);
    const float2* src = G_b + ((size_t)j * q + r0) * q;
    const int m = span_shift(src);
    const unsigned bytes = 16u * (unsigned)((rows * q + m + 1) / 2);
    uint64_t* bar = bars + u % NC;
    mbar_expect(bar, bytes);
    bulk_copy(ring + (u % NC) * C::SLOT, src - m, bytes, bar);
  };
  // c and y of line L into slot L % E; one commit group per line
  auto issue_vec = [&](int L) {
    const int j = nzi - 2 - L;
    if (j >= 0)
      for (int c = lane; c < q; c += 32) {
        cp_async4(cv + (L % E) * QP + c, oz_b + (size_t)j * q + c);
        cp_async8(yv + (L % E) * QP + c, y_b + (size_t)j * q + c);
      }
    cp_async_commit();
  };

  // padding reads as zero: the consumers' loops need no bounds
  for (int e = threadIdx.x; e < WORDS; e += THREADS + 32)
    reinterpret_cast<float*>(smem)[e] = 0.f;
  fence_proxy_async();
  __syncthreads();
  const size_t last = (size_t)(nzi - 1) * q;
  if (producer) {
    if (lane == 0) {
      for (int s = 0; s < NC; ++s) mbar_init(bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int u = 0; u < min(NC, n_chunks); ++u) issue_chunk(u);
    }
    for (int L = 0; L < E - 1; ++L) issue_vec(L);
    cp_async_wait<E - 2>();            // c and y of line 0
  } else {
    for (int r = threadIdx.x; r < q; r += THREADS) {
      const float2 v = y_b[last + r];
      x_b[last + r] = v;
      carry[((nzi - 1) & 1) * QP + r] = v;
    }
  }
  __syncthreads();

  // after the reduction lane l holds the sum of row t = l / GAP
  const int my_t = lane / GAP;
  const bool writer = !producer && lane % GAP == 0 && my_t < RPW;
  const int my_row = warp * RPW + my_t;
  for (int L = 0; L < nzi - 1; ++L) {
    const int j = nzi - 2 - L;
    if (producer) {
      // refill the chunks of line L - 1, free since the last barrier, and
      // fetch c and y two lines ahead
      if (lane == 0 && L > 0)
        for (int h = 0; h < C::PER_LINE; ++h) {
          const int u = (L - 1) * C::PER_LINE + h + NC;
          if (u < n_chunks) issue_chunk(u);
        }
      issue_vec(L + E - 1);
      cp_async_wait<E - 2>();          // c and y of line L + 1
    } else {
      const float2* xin = carry + ((j + 1) & 1) * QP;
      float2* xout = carry + (j & 1) * QP;
      const float* c_j = cv + (L % E) * QP;
      float2 w[CT];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int c = lane + 32 * cc;
        const float2 v = xin[c];
        w[cc] = make_float2(c_j[c] * v.x, c_j[c] * v.y);
      }
      const int r0 = warp * RPW;
      const int u = L * C::PER_LINE + r0 / C::ROWS;
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
        const float2 yj = yv[(L % E) * QP + my_row];
        const float2 v = make_float2(yj.x + acc[0].x, yj.y + acc[0].y);
        x_b[(size_t)j * q + my_row] = v;
        xout[my_row] = v;
      }
    }
    __syncthreads();
  }
  if (producer) cp_async_wait<0>();
}

template <int RPW, int NC>
int launch(const void* G, const void* offz, const void* y, void* x, int B,
           int nzi, int q, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bt_sweep_bwd_kernel<RPW, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bt_sweep_bwd_kernel<RPW, NC><<<B, THREADS + 32, smem, stream>>>(
      (const float2*)G, (const float*)offz, (const float2*)y, (float2*)x,
      nzi, q);
  return (int)cudaGetLastError();
}

// Shared memory of a (qp, ring) plan: the chunk slots, the carry, the y
// and c lines and one mbarrier per slot; the launch plan computes the same.
int plan_smem(int qp, int ring) {
  const int per_line = qp <= 96 ? 1 : 2;
  return ring * ((qp / per_line) * qp + 2) * 8 + 2 * qp * 8 + E * qp * 8
         + E * qp * 4 + ring * 8;
}

}  // namespace

// qp, ring (chunk slots), threads and smem come from the launch plan
// (ops/fused_factor.py bt_sweep_bwd_plan); a plan this file does not
// compile is refused, and so is a G that is not 16-byte aligned (the bulk
// copies need it).
extern "C" int hmc_bt_sweep_bwd(const void* G, const void* offz,
                                const void* y, void* x, int B, int nzi,
                                int q, int qp, int ring, int threads,
                                int smem, void* stream) {
  if (threads != THREADS + 32 || q < 1 || q > qp || ring != 3 ||
      smem != plan_smem(qp, ring) ||
      (reinterpret_cast<size_t>(G) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nzi == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qp) {
    case 32: return launch<2, 3>(G, offz, y, x, B, nzi, q, smem, s);
    case 64: return launch<4, 3>(G, offz, y, x, B, nzi, q, smem, s);
    case 96: return launch<6, 3>(G, offz, y, x, B, nzi, q, smem, s);
    case 128: return launch<8, 3>(G, offz, y, x, B, nzi, q, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
