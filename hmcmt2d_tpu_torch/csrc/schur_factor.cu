// Fused block-Thomas Schur chain: for every system b of the batch,
//
//   G_0 = inv(T_0),   G_j = inv(T_j - diag(c_{j-1}) G_{j-1} diag(c_{j-1}))
//
// where T_j is the tridiagonal diagonal block of z-line j (diagonal diag_j,
// off-diagonal entries -offy_j) and c_{j-1} = offz_{j-1} the diagonal
// z-coupling.  Each line is inverted in place by unpivoted complex
// Gauss-Jordan, rank-1 steps k = 0..q-1 in the order of the plain version
// (ops/fused_factor.py gj_inverse_nopivot).  That is stable here only
// because the caller passes the equilibrated operator (real part positive
// definite, so every Schur complement keeps a nonzero pivot).
//
// With polish > 0, each line's inverse then takes that many Newton-Schulz
// steps G_j <- G_j + G_j (I - S_j G_j) before it feeds line j+1's downdate
// (ops/fused_factor.py ns_polish).
//
// Replaces the Pallas TPU kernel _factor_kernel
// (hmcmt2d_tpu/ops/pallas_factor.py:137-194), polish (_ns_polish, :120-134)
// included.
//
// Bound: q pivot steps of q^2 complex multiply-adds per line (8 q^3 flops)
// on the fp32 CUDA cores: 66 GFLOP at the flagship (q = 95, 55 lines, 176
// systems) against 0.7 GB of output, so operations bound it (0.99 ms at
// 67 TFLOP/s).  One block per system: a block uses one SM's 128 fp32 lanes,
// so with 176 systems on 132 SMs the floor is two systems on one SM, about
// 1.5 ms.
//
// Design.  The first version (15.8 ms at the flagship on an H100 SXM) kept
// S in shared memory: every update read and wrote S there, capping it near
// 1/6 of the fp32 rate, with two barriers per pivot step and G_{j-1} read
// back from global memory.  Here S lives in registers (the elimination of
// csrc/gj_core.cuh, shared with gj_inverse.cu): row r belongs to warp
// r % 16 and column c to lane c % 32, so each of the 512 threads holds an
// RT x CT complex tile (6 x 3 at q = 95), indexed only by unrolled constant
// loops.  Only the pivot row (scaled by 1/pivot) and the pivot column go
// through shared memory, double-buffered: after step k the warp that holds
// row k+1 and the lanes that hold column k+1 publish them into the other
// buffer and clear them in registers, so each step is one barrier and one
// uniform rank-1 update, each thread reading RT + CT shared values for its
// RT * CT updates.  At the end of a line each thread stores its part of G_j
// from registers (neighbouring lanes on neighbouring columns) and forms the
// next S = T - c_r c_c G_j in place: G is never read back.  Every product
// is rounded where the plain version rounds it (the pivot inverse by the
// same complex division), so the two agree to the last bit on the card.
//
// Registers (nvcc 12.8, -Xptxas -v, as scripts/torch_kernel_scaling.py
// prints them): 64 a thread for q <= 96, where two blocks share an SM
// (the 6 x 3 tile spills 84 bytes), 128 at q = 128, one block an SM, no
// spills.  What bounds it now is the chain of each pivot step, not the
// fp32 rate: the warp that holds row k+1 issues its whole update, then the
// shuffle, the two divisions of the exact pivot inverse and the stores,
// before the barrier can open; and with 64 registers the compiler keeps
// one temporary for the update.  A block alone takes as long as one on
// each SM.  The launch plan (ops/fused_factor.py schur_factor_plan) picks
// the tile from q padded to 32, 64, 96 or 128.
//
// Polish (a template variant; polish = 0 runs the code above unchanged).
// Bound: two more complex q^3 products a step, 24 q^3 flops a line at
// polish = 1, so 3x the factor's.  The first design rebuilt S_j into one
// QP x QP buffer of shared memory after the elimination (from T_j and
// G_{j-1} read back from G), read G_j from L1/L2 inside both products' k
// loops, one dependent load a step with nothing ahead, and passed over
// G_j in device memory twice more (15.7 ms at the flagship on an H100 SXM,
// against the factor's 7.0).  Up to QP = 96 the variant now keeps two buffers: S_j,
// stored from registers just before the elimination (no rebuild, no read
// of G_{j-1}), and G_j, staged once after it.  Both products are register
// tiles from shared memory: each thread keeps its RT x CT accumulators and
// reads RT + CT values a pivot (a pair of k in one 16-byte load of its
// rows), so nothing in the k loop waits on L2.  R = I - S_j G_j goes over
// the S_j buffer, G_j + G_j R stays in registers for the next downdate and
// is stored once.  A second step (polish >= 2) rebuilds S_j as the first
// design did.  The buffers take 16 QP^2 bytes (144 KB at QP = 96), so the
// variant runs one block an SM there, with 128 registers a thread.  At
// QP = 128 two buffers do not fit (256 KB): that width keeps the first
// design (one 128 KB buffer, G_j from L2).  On the H100 SXM the products
// now add ~1.9 ms a wave, near one SM's fp32 rate (13.4 ms at the
// flagship): what bounds the variant is one block an SM, so 176 systems
// take two waves of the one-pivot-a-barrier elimination above.

#include <cuda_runtime.h>
#include "cplx.cuh"
#include "gj_core.cuh"

namespace {

using gj::THREADS;
using gj::TX;
using gj::TY;

// S_j into Ssh (QP x QP), rebuilt by the operations that formed it in
// registers: T_j from the line's staged diag/offy/offz, and G_{j-1} read
// back from G (Gprev, null at j = 0).  Starts and ends on a barrier.
template <int QP>
__device__ __forceinline__ void rebuild_S(float2* Ssh, const float2* Gprev,
                                          const float2* dg, const float* oyv,
                                          const float* ozv, int q, int tid) {
  __syncthreads();   // every read of Ssh is done
  for (int e = tid; e < QP * QP; e += THREADS) {
    const int r = e / QP, c = e % QP;
    float2 t = make_float2(0.f, 0.f);
    if (r < q && c < q) {
      if (r == c) t = dg[r];
      else if (c == r + 1) t.x = -oyv[r];
      else if (r == c + 1) t.x = -oyv[c];
      if (Gprev != nullptr) {
        const float s = ozv[r] * ozv[c];
        const float2 g = Gprev[(size_t)r * q + c];
        t.x -= __fmul_rn(s, g.x);
        t.y -= __fmul_rn(s, g.y);
      }
    }
    Ssh[e] = t;
  }
  __syncthreads();
}

// acc += L R over k < q, L and R QP x QP in shared memory: each thread its
// tile (rows warp + TY i of L, columns lane + TX cc of R), k in pairs (for
// odd q the pair's second k is q, whose entries are zero padding).
template <int RT, int CT>
__device__ __forceinline__ void tile_product(float2 (&acc)[RT][CT],
                                             const float2* L, const float2* R,
                                             int q, int lane, int warp) {
  constexpr int QP = RT * TY;
#pragma unroll 2
  for (int k = 0; k < q; k += 2) {
    float2 b0[CT], b1[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      b0[cc] = R[k * QP + lane + TX * cc];
      b1[cc] = R[(k + 1) * QP + lane + TX * cc];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(L + (warp + TY * i) * QP + k);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        acc[i][cc] = cfma(make_float2(a.x, a.y), b0[cc], acc[i][cc]);
        acc[i][cc] = cfma(make_float2(a.z, a.w), b1[cc], acc[i][cc]);
      }
    }
  }
}

// One Newton-Schulz step from shared memory (QP <= 96): G_j in S on entry,
// S_j in Ssh.  Stages G_j into Gsh, forms R = I - S_j G_j, writes it over
// Ssh, and ends with G_j + G_j R in S.
template <int RT, int CT>
__device__ __forceinline__ void ns_polish_shared(float2 (&S)[RT][CT],
                                                 float2* Ssh, float2* Gsh,
                                                 int q, int lane, int warp) {
  constexpr int QP = RT * TY;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      Gsh[(warp + TY * i) * QP + lane + TX * cc] = S[i][cc];
      S[i][cc] = make_float2(0.f, 0.f);
    }
  __syncthreads();   // G_j staged (and S_j in Ssh)
  tile_product(S, Ssh, Gsh, q, lane, warp);
  __syncthreads();   // every read of S_j is done
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      float2 t = make_float2(0.f, 0.f);
      if (r < q && c < q)
        t = make_float2((r == c ? 1.f : 0.f) - S[i][cc].x, -S[i][cc].y);
      Ssh[r * QP + c] = t;
      S[i][cc] = make_float2(0.f, 0.f);
    }
  }
  __syncthreads();   // R is in Ssh
  tile_product(S, Gsh, Ssh, q, lane, warp);
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const float2 g = Gsh[(warp + TY * i) * QP + lane + TX * cc];
      S[i][cc] = make_float2(g.x + S[i][cc].x, g.y + S[i][cc].y);
    }
}

// One Newton-Schulz step of the first design (QP = 128): G_j <- G_j +
// G_j (I - S_j G_j), with G_j stored in Gj (and in S, which it overwrites)
// and S_j rebuilt in Ssh.  Ends with G_j + G_j R stored in Gj and held in S.
template <int RT, int CT>
__device__ __forceinline__ void ns_polish(float2 (&S)[RT][CT], float2* Ssh,
                                          float2* Gj, const float2* Gprev,
                                          const float2* dg, const float* oyv,
                                          const float* ozv, int q, int lane,
                                          int warp, int tid) {
  constexpr int QP = RT * TY;
  rebuild_S<QP>(Ssh, Gprev, dg, oyv, ozv, q, tid);

  // R = I - S_j G_j, accumulated in S
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[i][cc] = make_float2(0.f, 0.f);
  for (int k = 0; k < q; ++k) {
    float2 g[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      g[cc] = c < q ? Gj[(size_t)k * q + c] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float2 a = Ssh[(warp + TY * i) * QP + k];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) S[i][cc] = cfma(a, g[cc], S[i][cc]);
    }
  }
  __syncthreads();   // every read of S_j in Ssh is done
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      float2 t = make_float2(0.f, 0.f);
      if (r < q && c < q)
        t = make_float2((r == c ? 1.f : 0.f) - S[i][cc].x, -S[i][cc].y);
      Ssh[r * QP + c] = t;
    }
  }
  __syncthreads();

  // G_j + G_j R, accumulated in S
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[i][cc] = make_float2(0.f, 0.f);
  for (int k = 0; k < q; ++k) {
    float2 rk[CT];
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) rk[cc] = Ssh[k * QP + lane + TX * cc];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = warp + TY * i;
      const float2 a = r < q ? Gj[(size_t)r * q + k] : make_float2(0.f, 0.f);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) S[i][cc] = cfma(a, rk[cc], S[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      if (r < q && c < q) {
        const float2 g = Gj[(size_t)r * q + c];
        S[i][cc] = make_float2(g.x + S[i][cc].x, g.y + S[i][cc].y);
      }
    }
  }
  __syncthreads();   // every read of G_j is done before it is overwritten
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = warp + TY * i;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int c = lane + TX * cc;
      if (r < q && c < q) Gj[(size_t)r * q + c] = S[i][cc];
    }
  }
}

template <int RT, int CT, int MINB, bool POLISH>
__global__ void __launch_bounds__(THREADS, MINB)
schur_factor_kernel(const float2* __restrict__ diag,  // (B, nzi, q)
                    const float* __restrict__ offy,   // (B, nzi, q-1)
                    const float* __restrict__ offz,   // (B, nzi-1, q)
                    float2* __restrict__ G,           // (B, nzi, q, q)
                    int nzi, int q, int polish) {
  constexpr int QP = RT * TY;
  static_assert(QP == CT * TX, "the thread tile must cover a square");
  extern __shared__ float2 smem[];
  float2* rowk = smem;             // [2][QP] scaled pivot row
  float2* colk = smem + 2 * QP;    // [2][QP] pivot column
  float2* dg = smem + 4 * QP;      // [QP] diag of the line
  float* oyv = reinterpret_cast<float*>(smem + 5 * QP);  // [QP] offy of the line
  float* ozv = oyv + QP;           // [QP] offz between this line and the last
  float2* Ssh = reinterpret_cast<float2*>(ozv + QP);  // [QP][QP] S_j (POLISH only)
  float2* Gsh = Ssh + QP * QP;     // [QP][QP] G_j (POLISH, QP <= 96 only)

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TX + lane;
  const size_t b = blockIdx.x;
  const size_t qq = (size_t)q * q;
  const float2* d_b = diag + b * nzi * q;
  const float* oy_b = offy + b * nzi * (q - 1);
  const float* oz_b = offz + b * (nzi - 1) * q;
  float2* G_b = G + b * nzi * qq;

  // padded pivot entries stay zero, so padded rows and columns stay zero
  for (int e = tid; e < 4 * QP; e += THREADS) smem[e] = make_float2(0.f, 0.f);

  float2 S[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[i][cc] = make_float2(0.f, 0.f);

  for (int j = 0; j < nzi; ++j) {
    for (int e = tid; e < q; e += THREADS) {
      dg[e] = d_b[(size_t)j * q + e];
      if (e < q - 1) oyv[e] = oy_b[(size_t)j * (q - 1) + e];
      if (j > 0) ozv[e] = oz_b[(size_t)(j - 1) * q + e];
    }
    __syncthreads();

    // S = T_j - diag(c) G_{j-1} diag(c), with G_{j-1} still in registers
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = warp + TY * i;
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int c = lane + TX * cc;
        float2 t = make_float2(0.f, 0.f);
        if (r < q && c < q) {
          if (r == c) t = dg[r];
          else if (c == r + 1) t.x = -oyv[r];
          else if (r == c + 1) t.x = -oyv[c];
          if (j > 0) {   // products rounded apart, as the plain version
            const float s = ozv[r] * ozv[c];
            t.x -= __fmul_rn(s, S[i][cc].x);
            t.y -= __fmul_rn(s, S[i][cc].y);
          }
        }
        S[i][cc] = t;
      }
    }
    if constexpr (POLISH && QP <= 96) {
      // S_j kept for the Newton-Schulz products; every read of Ssh from the
      // last line ended before the barrier after staging
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int cc = 0; cc < CT; ++cc)
          Ssh[(warp + TY * i) * QP + lane + TX * cc] = S[i][cc];
    }
    // in-place Gauss-Jordan inverse, no pivoting; one barrier per step
    gj::invert(S, rowk, colk, lane, warp, q);

    float2* Gj = G_b + (size_t)j * qq;
    if constexpr (POLISH && QP <= 96) {
      for (int p = 0; p < polish; ++p) {
        if (p > 0) rebuild_S<QP>(Ssh, j > 0 ? Gj - qq : nullptr, dg, oyv, ozv, q, tid);
        ns_polish_shared(S, Ssh, Gsh, q, lane, warp);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = warp + TY * i;
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int c = lane + TX * cc;
        if (r < q && c < q) Gj[(size_t)r * q + c] = S[i][cc];
      }
    }
    if constexpr (POLISH && QP > 96) {
      for (int p = 0; p < polish; ++p)
        ns_polish(S, Ssh, Gj, j > 0 ? Gj - qq : nullptr, dg, oyv, ozv, q, lane,
                  warp, tid);
    }
  }
}

// MINB blocks an SM for polish = 0, MINBP for the polish variant
template <int RT, int CT, int MINB, int MINBP>
int launch(const void* diag, const void* offy, const void* offz, void* G,
           int B, int nzi, int q, int smem, int polish, cudaStream_t stream) {
  const dim3 block(TX, TY);
  if (polish == 0) {
    schur_factor_kernel<RT, CT, MINB, false><<<B, block, smem, stream>>>(
        (const float2*)diag, (const float*)offy, (const float*)offz,
        (float2*)G, nzi, q, 0);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      schur_factor_kernel<RT, CT, MINBP, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  schur_factor_kernel<RT, CT, MINBP, true><<<B, block, smem, stream>>>(
      (const float2*)diag, (const float*)offy, (const float*)offz, (float2*)G,
      nzi, q, polish);
  return (int)cudaGetLastError();
}

}  // namespace

// qp, threads and smem come from the launch plan (ops/fused_factor.py
// schur_factor_plan, whose shared memory grows by the S_j and G_j buffers
// when polish > 0, S_j alone at qp = 128); a plan this file does not
// compile is refused.
extern "C" int hmc_schur_factor(const void* diag, const void* offy,
                                const void* offz, void* G, int B, int nzi,
                                int q, int qp, int threads, int smem,
                                int polish, void* stream) {
  const int want = 48 * qp + (polish > 0 ? (qp <= 96 ? 16 : 8) * qp * qp : 0);
  if (threads != THREADS || q < 1 || q > qp || polish < 0 || smem != want)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nzi == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qp) {
    case 32: return launch<2, 1, 2, 2>(diag, offy, offz, G, B, nzi, q, smem, polish, s);
    case 64: return launch<4, 2, 2, 2>(diag, offy, offz, G, B, nzi, q, smem, polish, s);
    case 96: return launch<6, 3, 2, 1>(diag, offy, offz, G, B, nzi, q, smem, polish, s);
    case 128: return launch<8, 4, 1, 1>(diag, offy, offz, G, B, nzi, q, smem, polish, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
