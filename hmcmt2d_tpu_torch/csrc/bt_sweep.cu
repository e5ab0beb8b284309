// The two triangular sweeps of the block-Thomas solve, given the inverse
// Schur complements G_j of schur_factor.cu (c_j = offz_j the diagonal
// z-coupling, * elementwise), in one body, sweep_block<BWD, ...>:
//
//   forward   y_0 = G_0 b_0,      y_j = G_j (b_j + c_{j-1} * y_{j-1}),  j = 1 .. n-1
//   backward  x_{n-1} = y_{n-1},  x_j = y_j + G_j (c_j * x_{j+1}),      j = n-2 .. 0
//
// Replace the Pallas TPU kernels _sweep_fwd_kernel and _sweep_bwd_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:357-380, :383-408).
//
// Bound: a sweep reads each line of G it needs once (8 q^2 bytes a line:
// 0.70 GB forward, 0.69 GB backward at the flagship, q = 95, 55 lines, 176
// systems) for 8 flops per 8 bytes, so device-memory bandwidth bounds it:
// 0.2141 ms forward at 3.35 TB/s with offz, b and y, 0.21 ms backward.
//
// Design.  One block per system, the line loop inside.  The first versions
// (0.4887 ms forward, 0.509 ms backward at the flagship on an H100 SXM)
// issued a line's loads of G_j only after the previous line's barrier, one
// 760-byte row in flight per warp, so they paid device-memory latency
// several times per line.  G_j does not depend on the carried vector, so a
// producer warp keeps the next lines of G in flight while 16 consumer warps
// multiply the current one: G streams through a ring of NC slots in shared
// memory, one TMA bulk copy a slot (a line up to qp = 96, half a line at
// 128), each slot with an mbarrier that counts its bytes.  The producer
// refills the slots of the previous line right after the barrier that ends
// it, so the loads of later lines stay in flight across the current line's
// barrier.  Small copies held the first attempts back: per-thread cp.async
// and per-row bulk copies both left a block alone far slower than
// whole-line copies, and with 176 blocks on 132 SMs the second wave of
// blocks sets the time.  The right-hand side and c come through the same
// producer (cp.async, two lines ahead).  Consumer warp w multiplies rows
// RPW w .. RPW w + RPW - 1, lane l columns l + 32 cc, with the weights
// formed in registers from the double-buffered carry (forward
// b_j + c_{j-1} * y_{j-1}, rounded as the plain version rounds it: product,
// then sum); a transposing butterfly (each round a lane sends half of its
// partial sums) reduces the rows, and one barrier per line publishes the
// line.  Padding is zeroed once, so the consumers' loops have no bounds
// tests.
//
// The end of G.  A bulk copy needs 16-byte aligned addresses and sizes, and
// a line of G starts 8 bytes off a 16-byte boundary on every other line at
// odd q, so a chunk is copied as the 16-byte aligned span around it (at
// most 8 bytes either side) and sits one element into its slot.  The
// backward sweep never reads the last line, so its spans stay inside G.
// The forward sweep does, and when B nzi q is odd the span of the chunk
// that ends G would end 8 bytes past G, in the slot entry after the line,
// which the last row multiplies by a zero weight: a NaN there would poison
// y.  The copy of that one chunk stops at the last 16-byte boundary inside
// G instead; the producer lane loads the element left over with an
// ordinary load and zeroes the entry after it, both before the mbarrier
// arrive whose release makes them visible to the consumers.  Nothing
// outside G is read, and the fix stays here: spare bytes at the end of G's
// allocation or a padded row stride would reach into the factor and the
// plain versions, and the first would still read outside the tensor.
//
// The plan (ops/fused_factor.py bt_sweep_bwd_plan, also the forward
// sweep's): three whole-line slots up to qp = 96, three half-line slots at
// 128, one block an SM.  Half-line slots at qp = 96, so that two blocks fit
// and all 176 systems are resident on 132 SMs at once, were measured on the
// forward sweep and lost (H100 SXM, 700 W, queued CUDA-event timing): 0.277
// ms against 0.267 ms at the flagship.  A block alone then has only a line
// and a half in flight and issues the second half of each line when the
// line starts (0.073 ms against 0.058 ms for one system), which costs more
// than the second wave of 44 blocks saves.
//
// Registers (nvcc 12.8, -Xptxas -v, as scripts/torch_kernel_scaling.py
// prints them): forward 56 a thread at q = 95, 64 at q = 128; backward 48
// and 55; no spills; 226 KB of shared memory at q = 95.

#include <cuda_runtime.h>
#include <stdint.h>
#include "cplx.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int E = 3;                 // lines of the right-hand side and c in the ring
constexpr unsigned FULL = 0xffffffffu;

// One system's sweep: forward, v = b and out = y; backward (BWD), v = y and
// out = x.  Step L of the line loop works on line j = L forward, nzi - 2 - L
// backward.  Where the two directions form one value in two ways (G_b, a
// chunk's address and its slot's, the step count, the last line's offset,
// the epilogue), each keeps its own form and order: nvcc's register
// allocation follows them, and these are the forms each kernel was measured
// with (scripts/torch_kernel_scaling.py --sass-against compares the SASS).
template <bool BWD, int RPW, int NC>
__device__ __forceinline__ void sweep_block(const float2* G,    // (B, nzi, q, q)
                                            const float* offz,  // (B, nzi-1, q)
                                            const float2* v,    // (B, nzi, q)
                                            float2* out,        // (B, nzi, q)
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
  float2* carry = ring + NC * C::SLOT;                 // [2][QP] the last line, this one
  float2* vv = carry + 2 * QP;                         // [E][QP] lines of v
  float* cv = reinterpret_cast<float*>(vv + E * QP);   // [E][QP] c lines
  uint64_t* bars = reinterpret_cast<uint64_t*>(cv + E * QP);   // [NC]
  constexpr int WORDS = (NC * C::SLOT + 2 * QP + E * QP) * 2 + E * QP;

  const size_t b = blockIdx.x;
  const size_t qq = (size_t)q * q;
  const float2* G_b = BWD ? G + b * nzi * (size_t)q * q : G + b * nzi * qq;
  const float* oz_b = offz + b * (nzi - 1) * q;
  const float2* v_b = v + b * nzi * q;
  float2* out_b = out + b * nzi * q;
  const size_t g_end = (size_t)gridDim.x * nzi * qq;   // elements in G
  const int n_chunks = (BWD ? nzi - 1 : nzi) * C::PER_LINE;
  const bool producer = warp == WARPS;

  // chunk u: rows ROWS h .. of the line of step u / PER_LINE, h = u %
  // PER_LINE; the 16-byte aligned span around them, one bulk copy, cut at
  // the end of G
  auto issue_chunk = [&](int u) {
    const int j = BWD ? nzi - 2 - u / C::PER_LINE : u / C::PER_LINE;
    const int r0 = C::ROWS * (u % C::PER_LINE);
    const int rows = min(C::ROWS, q - r0);
    const size_t off = (b * nzi + j) * qq + (size_t)r0 * q;   // in G
    const float2* src = BWD ? G_b + ((size_t)j * q + r0) * q : G + off;
    const int m = span_shift(src);
    const int n = rows * q + m;      // slot entries the chunk fills
    float2* slot = BWD ? nullptr : ring + (u % NC) * C::SLOT;
    int pairs = (n + 1) / 2;         // 16-byte units of the span
    if (!BWD && off - m + 2 * (size_t)pairs > g_end) {   // only the chunk ending G
      pairs = n / 2;
      slot[n - 1] = G[off + (size_t)rows * q - 1];
      slot[n] = make_float2(0.f, 0.f);
    }
    uint64_t* bar = bars + u % NC;
    mbar_expect(bar, 16u * (unsigned)pairs);
    if (BWD || pairs > 0)
      bulk_copy(BWD ? ring + (u % NC) * C::SLOT : slot, src - m, 16u * (unsigned)pairs, bar);
  };
  // v_j and the c line step L weighs by (c_{j-1} forward, c_j backward)
  // into slot L % E; one commit group per line
  auto issue_vec = [&](int L) {
    const int j = BWD ? nzi - 2 - L : L;
    if (BWD ? j >= 0 : j < nzi)
      for (int c = lane; c < q; c += 32) {
        if (BWD) cp_async4(cv + (L % E) * QP + c, oz_b + (size_t)j * q + c);
        cp_async8(vv + (L % E) * QP + c, v_b + (size_t)j * q + c);
        if (!BWD && j > 0)
          cp_async4(cv + (L % E) * QP + c, oz_b + (size_t)(j - 1) * q + c);
      }
    cp_async_commit();
  };

  // padding reads as zero: the consumers' loops need no bounds
  for (int e = threadIdx.x; e < WORDS; e += THREADS + 32)
    reinterpret_cast<float*>(smem)[e] = 0.f;
  fence_proxy_async();
  __syncthreads();
  const size_t last = (size_t)(nzi - 1) * q;   // backward: x_{n-1} = y_{n-1}
  if (producer) {
    if (lane == 0) {
      for (int s = 0; s < NC; ++s) mbar_init(bars + s);
      mbar_init_fence();
      for (int u = 0; u < min(NC, n_chunks); ++u) issue_chunk(u);
    }
    for (int L = 0; L < E - 1; ++L) issue_vec(L);
    cp_async_wait<E - 2>();            // the lines of step 0
  } else if (BWD) {
    for (int r = threadIdx.x; r < q; r += THREADS) {
      const float2 y = v_b[last + r];
      out_b[last + r] = y;
      carry[((nzi - 1) & 1) * QP + r] = y;
    }
  }
  __syncthreads();

  // after the reduction lane l holds the sum of row t = l / GAP
  const int my_t = lane / GAP;
  const bool writer = !producer && lane % GAP == 0 && my_t < RPW;
  const int my_row = warp * RPW + my_t;
  for (int L = 0; L < (BWD ? nzi - 1 : nzi); ++L) {
    const int j = BWD ? nzi - 2 - L : L;
    if (producer) {
      // refill the chunks of step L - 1, free since the last barrier, and
      // fetch v and c two lines ahead
      if (lane == 0 && L > 0)
        for (int h = 0; h < C::PER_LINE; ++h) {
          const int u = (L - 1) * C::PER_LINE + h + NC;
          if (u < n_chunks) issue_chunk(u);
        }
      issue_vec(L + E - 1);
      cp_async_wait<E - 2>();          // the lines of step L + 1
    } else {
      const float2* cin = carry + ((j + 1) & 1) * QP;   // y_{j-1}, or x_{j+1}
      float2* cout = carry + (j & 1) * QP;
      const float2* v_j = vv + (L % E) * QP;
      const float* c_j = cv + (L % E) * QP;
      float2 w[CT];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int c = lane + 32 * cc;
        if (BWD) {
          const float2 x = cin[c];
          w[cc] = make_float2(c_j[c] * x.x, c_j[c] * x.y);
        } else {
          w[cc] = v_j[c];
          if (j > 0) {
            const float2 y = cin[c];
            w[cc].x = __fadd_rn(w[cc].x, __fmul_rn(c_j[c], y.x));
            w[cc].y = __fadd_rn(w[cc].y, __fmul_rn(c_j[c], y.y));
          }
        }
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
        if (BWD) {
          const float2 yj = vv[(L % E) * QP + my_row];
          const float2 o = make_float2(yj.x + acc[0].x, yj.y + acc[0].y);
          out_b[(size_t)j * q + my_row] = o;
          cout[my_row] = o;
        } else {
          out_b[(size_t)j * q + my_row] = acc[0];
          cout[my_row] = acc[0];
        }
      }
    }
    __syncthreads();
  }
  if (producer) cp_async_wait<0>();
}

template <int RPW, int NC>
__global__ void __launch_bounds__(THREADS + 32, 1)
bt_sweep_fwd_kernel(const float2* __restrict__ G, const float* __restrict__ offz,
                    const float2* __restrict__ rhs, float2* __restrict__ y, int nzi, int q) {
  sweep_block<false, RPW, NC>(G, offz, rhs, y, nzi, q);
}

template <int RPW, int NC>
__global__ void __launch_bounds__(THREADS + 32, 1)
bt_sweep_bwd_kernel(const float2* __restrict__ G, const float* __restrict__ offz,
                    const float2* __restrict__ y, float2* __restrict__ x, int nzi, int q) {
  sweep_block<true, RPW, NC>(G, offz, y, x, nzi, q);
}

template <bool BWD, int RPW, int NC>
int launch(const void* G, const void* offz, const void* v, void* out, int B,
           int nzi, int q, int smem, cudaStream_t stream) {
  const auto kernel = BWD ? bt_sweep_bwd_kernel<RPW, NC> : bt_sweep_fwd_kernel<RPW, NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, THREADS + 32, smem, stream>>>(
      (const float2*)G, (const float*)offz, (const float2*)v, (float2*)out, nzi, q);
  return (int)cudaGetLastError();
}

// Shared memory of a (qp, ring) plan: the chunk slots, the carry, the
// right-hand side and c lines and one mbarrier per slot; the launch plan
// computes the same.
int plan_smem(int qp, int ring) {
  const int per_line = qp <= 96 ? 1 : 2;
  return ring * ((qp / per_line) * qp + 2) * 8 + 2 * qp * 8 + E * qp * 8
         + E * qp * 4 + ring * 8;
}

// qp, ring (chunk slots), threads and smem come from the launch plan
// (ops/fused_factor.py bt_sweep_fwd_plan, bt_sweep_bwd_plan); a plan this
// file does not compile is refused, and so is a G that is not 16-byte
// aligned (the bulk copies need it).
template <bool BWD>
int entry(const void* G, const void* offz, const void* v, void* out, int B, int nzi,
          int q, int qp, int ring, int threads, int smem, void* stream) {
  if (threads != THREADS + 32 || q < 1 || q > qp || ring != 3 ||
      smem != plan_smem(qp, ring) || (reinterpret_cast<size_t>(G) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nzi == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qp) {
    case 32: return launch<BWD, 2, 3>(G, offz, v, out, B, nzi, q, smem, s);
    case 64: return launch<BWD, 4, 3>(G, offz, v, out, B, nzi, q, smem, s);
    case 96: return launch<BWD, 6, 3>(G, offz, v, out, B, nzi, q, smem, s);
    case 128: return launch<BWD, 8, 3>(G, offz, v, out, B, nzi, q, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hmc_bt_sweep_fwd(const void* G, const void* offz, const void* rhs, void* y,
                                int B, int nzi, int q, int qp, int ring, int threads,
                                int smem, void* stream) {
  return entry<false>(G, offz, rhs, y, B, nzi, q, qp, ring, threads, smem, stream);
}

extern "C" int hmc_bt_sweep_bwd(const void* G, const void* offz, const void* y, void* x,
                                int B, int nzi, int q, int qp, int ring, int threads,
                                int smem, void* stream) {
  return entry<true>(G, offz, y, x, B, nzi, q, qp, ring, threads, smem, stream);
}
