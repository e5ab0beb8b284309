// The boundary fields' 1-D propagation (ops/mt1d.py analytic_field) and its
// two derivatives, one thread a column.  A column is one 1-D profile at one
// frequency: angular frequency w, layer conductivities sigma_j and
// thicknesses dz_j, j = 0..n-1 top first, the bottom layer extended as a
// halfspace.  In the plain version's steps and order:
//
//   k_j  = sqrt(mu0 eps0 w^2 - i mu0 sigma_j w)        (the principal root)
//   zp_j = w mu0 / k_j,  th_j = tanh(i k_j dz_j), Re of the argument clamped
//          to +-20 (safe_tanh)
//   Z_n = zp_{n-1},  Z_j = zp_j (Z_{j+1} + zp_j th_j) / (zp_j + Z_{j+1} th_j)
//   q = w mu0 / (Z_0 k_0),  U_0 = (1 - q) / 2,  D_0 = (1 + q) / 2
//   for i = 0..n-1, with ka_i = k_i, ka_n = k_{n-1}, kr = ka_i / ka_{i+1},
//   P = exp(i k_i dz_i) and M = exp(-i k_i dz_i) (Re clamped to +-60):
//     U_{i+1} = ((1 + kr) P U_i + (1 - kr) M D_i) / 2
//     D_{i+1} = ((1 - kr) P U_i + (1 + kr) M D_i) / 2
//   and every interface at and below the first one where |U + D| grows (or
//   is NaN) is zero; `cut` counts the interfaces above it;
//   e_i = U_i + D_i,  h_i = (-ka_i U_i + ka_i D_i) / (w mu0).
//
// Entry points:
//   hmc_mt1d_field   e, h and cut; or, given a tangent dsigma and the
//                    forward's cut, the forward-mode tangents de, dh (dual
//                    numbers through the same steps, the mask held fixed)
//   hmc_mt1d_vjp     d/dsigma of Re <g, (e, h)>: the reverse-mode product,
//                    the same steps run backwards under the forward's cut
// Gradients flow to sigma only.  The mask is a constant; a clamped real
// part passes no derivative (torch.clamp's backward, bounds inclusive).
//
// Replaces no Pallas kernel: the JAX package runs this recursion as two
// lax.scan (hmcmt2d_tpu/ops/mt1d.py surface_impedance and analytic_field),
// which XLA compiles into loops.  The port's plain version unrolls them
// into ~50 elementwise torch ops a layer, forward and backward: ~9,400
// kernels an eval on the card, each over ~8.5k columns.
//
// Bound: neither bytes nor operations.  A column is ~100 flops a layer and
// step (a few hundred with the transcendentals), 2 x n dependent steps
// forward and ~4 x n in the vjp (its forward again, then back); the bytes
// (sigma in; e, h or the cotangents; the vjp's scratch) are a few tens of
// MB, ~10 us at 3.35 TB/s.  Each column's chain of dependent steps is the
// limit.  So: one thread a column, everything of a layer recomputed where
// it is needed rather than stored (it is off the chain and overlaps it),
// and blocks of one warp: the flagship's ~8.5k columns are ~267 warps,
// two or three on each of the 132 SMs, each on its own scheduler, where
// larger blocks would leave SMs idle.  The vjp keeps the chain's values
// (Z, U, D) in a scratch buffer laid out a row a value (rows x N), so that
// a warp's stores and loads are coalesced.  IEEE division, square root
// and transcendentals (no fast math): the mask compares |E| between steps.

#include <cuda_runtime.h>
#include "cplx.cuh"

namespace {

constexpr int THREADS = 32;   // a warp a block (ops/mt1d.py MT1D_THREADS)
constexpr double MU0 = 4.0e-7 * 3.141592653589793;   // constants.py
constexpr double EPS0 = 8.85e-12;
constexpr double TANH_CLAMP = 20.0;   // ops/mt1d.py _TANH_CLAMP
constexpr double EXP_CLAMP = 60.0;    // ops/mt1d.py _EXP_CLAMP

template <typename R> struct CxOf;
template <> struct CxOf<float> { using type = float2; };
template <> struct CxOf<double> { using type = double2; };
template <typename R> using Cx = typename CxOf<R>::type;

__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_hypot(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double r_hypot(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float r_copysign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double r_copysign(double x, double y) { return copysign(x, y); }
__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_sinh(float x) { return sinhf(x); }
__device__ __forceinline__ double r_sinh(double x) { return sinh(x); }
__device__ __forceinline__ float r_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double r_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float r_sin(float x) { return sinf(x); }
__device__ __forceinline__ double r_sin(double x) { return sin(x); }
__device__ __forceinline__ float r_cos(float x) { return cosf(x); }
__device__ __forceinline__ double r_cos(double x) { return cos(x); }

template <typename V>
__device__ __forceinline__ V cadd(V a, V b) { return cmake<V>(a.x + b.x, a.y + b.y); }
template <typename V>
__device__ __forceinline__ V csub(V a, V b) { return cmake<V>(a.x - b.x, a.y - b.y); }
template <typename V>
__device__ __forceinline__ V cconj(V a) { return cmake<V>(a.x, -a.y); }
template <typename V>
__device__ __forceinline__ V cscale(V a, decltype(V::x) s) { return cmake<V>(a.x * s, a.y * s); }
template <typename V>
__device__ __forceinline__ V cfrom_real(decltype(V::x) r) { return cmake<V>(r, 0); }

// a / b by Smith's algorithm, PyTorch's complex division (c10::complex)
template <typename V>
__device__ __forceinline__ V cdiv(V a, V b) {
  using R = decltype(V::x);
  const R c = b.x, d = b.y;
  if (rabs(c) >= rabs(d)) {
    if (c == R(0) && d == R(0)) return cmake<V>(a.x / rabs(c), a.y / rabs(d));
    const R rat = d / c, scl = R(1) / (c + d * rat);
    return cmake<V>((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const R rat = c / d, scl = R(1) / (d + c * rat);
  return cmake<V>((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

// the principal square root
template <typename V>
__device__ __forceinline__ V csqrt(V z) {
  using R = decltype(V::x);
  if (z.x == R(0) && z.y == R(0)) return cmake<V>(R(0), z.y);
  const R t = r_sqrt((rabs(z.x) + r_hypot(z.x, z.y)) * R(0.5));
  if (z.x >= R(0)) return cmake<V>(t, z.y / (R(2) * t));
  return cmake<V>(rabs(z.y) / (R(2) * t), r_copysign(t, z.y));
}

template <typename R>
__device__ __forceinline__ R clampr(R x, R c) {   // NaN passes, as torch.clamp
  return x < -c ? -c : (x > c ? c : x);
}

template <typename R>
__device__ __forceinline__ bool passes(R x, R c) {   // torch.clamp's backward
  return x >= -c && x <= c;
}

// tanh(z), Re z clamped to +-20 (ops/mt1d.py safe_tanh)
template <typename V>
__device__ __forceinline__ V safe_tanh(V z) {
  using R = decltype(V::x);
  const R x = clampr(z.x, R(TANH_CLAMP)), y = z.y;
  const R sx = r_sinh(x), cy = r_cos(y);
  const R den = sx * sx + cy * cy;
  return cmake<V>(R(0.5) * r_sinh(R(2) * x) / den, R(0.5) * r_sin(R(2) * y) / den);
}

// sech^2 at the clamped point: (conj(cosh z) / |cosh z|^2)^2, with
// |cosh z|^2 = sinh^2 x + cos^2 y (safe_tanh's denominator); the tanh's
// derivative without 1 - tanh^2's cancellation
template <typename V>
__device__ __forceinline__ V sech2(V z) {
  using R = decltype(V::x);
  const R x = clampr(z.x, R(TANH_CLAMP)), y = z.y;
  const R sx = r_sinh(x), cy = r_cos(y);
  const R den = sx * sx + cy * cy;
  const V s = cmake<V>(r_cosh(x) * cy / den, -(sx * r_sin(y)) / den);
  return cmul(s, s);
}

// exp(z), Re z clamped to +-60 (ops/mt1d.py _clamped_exp)
template <typename V>
__device__ __forceinline__ V clamped_exp(V z) {
  using R = decltype(V::x);
  const R mag = r_exp(clampr(z.x, R(EXP_CLAMP)));
  return cmake<V>(mag * r_cos(z.y), mag * r_sin(z.y));
}

// The adjoint of a clamped function's argument from c = conj(adjoint) f':
// conj(c), whose real part the clamp stops where it engaged.
template <typename V>
__device__ __forceinline__ V arg_adjoint(V c, decltype(V::x) x, decltype(V::x) clamp) {
  return cmake<V>(passes(x, clamp) ? c.x : decltype(V::x)(0), -c.y);
}

// A tangent through a clamped function's argument: its real part stopped
// where the clamp engaged.
template <typename V>
__device__ __forceinline__ V arg_tangent(V t, decltype(V::x) x, decltype(V::x) clamp) {
  return cmake<V>(passes(x, clamp) ? t.x : decltype(V::x)(0), t.y);
}

// i z dz and -i z dz, as the plain version rounds them
template <typename V>
__device__ __forceinline__ V times_i(V z, decltype(V::x) dz) { return cmake<V>(-z.y * dz, z.x * dz); }
template <typename V>
__device__ __forceinline__ V times_minus_i(V z, decltype(V::x) dz) { return cmake<V>(z.y * dz, -z.x * dz); }

template <typename R>
__device__ __forceinline__ Cx<R> wavenumber(R w, R s) {
  return csqrt(cmake<Cx<R>>(R(MU0 * EPS0) * (w * w), -((R(MU0) * s) * w)));
}

// k of a layer and, with a tangent ds of sigma (TANGENT), dk
template <typename R, bool TANGENT>
__device__ __forceinline__ void wave(R w, R s, R ds, Cx<R>& k, Cx<R>& dk) {
  k = wavenumber(w, s);
  if constexpr (TANGENT) dk = cdiv(cmake<Cx<R>>(R(0), -((R(MU0) * ds) * w)), cscale(k, R(2)));
}

// A layer's coefficients: wavenumber, intrinsic impedance, the tanh's
// argument i k dz and the tanh; with a tangent ds of sigma, theirs.
template <typename R>
struct Layer {
  Cx<R> k, zp, arg, th;
  Cx<R> dk, dzp, dth;
};

template <typename R, bool TANGENT>
__device__ __forceinline__ Layer<R> layer(R w, R omu0, R s, R ds, R dz) {
  using V = Cx<R>;
  Layer<R> L;
  L.dk = L.dzp = L.dth = cmake<V>(R(0), R(0));
  wave<R, TANGENT>(w, s, ds, L.k, L.dk);
  L.zp = cdiv(cfrom_real<V>(omu0), L.k);
  L.arg = times_i(L.k, dz);
  L.th = safe_tanh(L.arg);
  if constexpr (TANGENT) {
    L.dzp = cscale(cdiv(cmul(L.zp, L.dk), L.k), R(-1));
    L.dth = cmul(sech2(L.arg), arg_tangent(times_i(L.dk, dz), L.arg.x, R(TANH_CLAMP)));
  }
  return L;
}

// Z_j from Z_{j+1} = z
template <typename V>
__device__ __forceinline__ V impedance_step(V z, V zp, V th) {
  return cdiv(cmul(zp, cadd(z, cmul(zp, th))), cadd(zp, cmul(z, th)));
}

// One step of the top-down propagation: (U, D) at interface i -> i + 1.
template <typename V>
struct Step {
  V kr, P, M, u, d, un, dn;
};

template <typename V>
__device__ __forceinline__ Step<V> prop_step(V k, V k_next, decltype(V::x) dz, V U, V D) {
  using R = decltype(V::x);
  Step<V> s;
  s.kr = cdiv(k, k_next);
  s.P = clamped_exp(times_i(k, dz));
  s.M = clamped_exp(times_minus_i(k, dz));
  s.u = cmul(s.P, U);
  s.d = cmul(s.M, D);
  const V onep = cmake<V>(R(1) + s.kr.x, s.kr.y), onem = cmake<V>(R(1) - s.kr.x, -s.kr.y);
  s.un = cscale(cadd(cmul(onep, s.u), cmul(onem, s.d)), R(0.5));
  s.dn = cscale(cadd(cmul(onem, s.u), cmul(onep, s.d)), R(0.5));
  return s;
}

// h at an interface: (-ka U + ka D) / (w mu0)
template <typename V>
__device__ __forceinline__ V h_of(V ka, V U, V D, decltype(V::x) omu0) {
  return cdiv(cadd(cmul(cscale(ka, decltype(V::x)(-1)), U), cmul(ka, D)), cfrom_real<V>(omu0));
}

// e and h (or, TANGENT, de and dh) of every interface of a column, and its
// cut (TANGENT: read, as the forward wrote it).
template <typename R, bool TANGENT>
__global__ void __launch_bounds__(THREADS)
mt1d_field_kernel(const R* __restrict__ omega,   // (N,)
                  const R* __restrict__ sigma,   // (N, n)
                  const R* __restrict__ dz,      // (n,) or (N, n): row stride dz_stride
                  int dz_stride,
                  const R* __restrict__ dsigma,  // (N, n), TANGENT only
                  int* __restrict__ cut,         // (N,)
                  Cx<R>* __restrict__ e,         // (N, n + 1): e or de
                  Cx<R>* __restrict__ h,         // (N, n + 1): h or dh
                  int N, int n) {
  using V = Cx<R>;
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= N) return;
  const R w = omega[col], omu0 = w * R(MU0);
  const R* sg = sigma + (size_t)col * n;
  const R* ds = TANGENT ? dsigma + (size_t)col * n : nullptr;
  const R* dzc = dz + (size_t)col * dz_stride;
  V* ec = e + (size_t)col * (n + 1);
  V* hc = h + (size_t)col * (n + 1);
  const V zero = cmake<V>(R(0), R(0));

  // the surface impedance, bottom up
  V z = zero, dZ = zero;
  for (int j = n - 1; j >= 0; --j) {
    const Layer<R> L = layer<R, TANGENT>(w, omu0, sg[j], TANGENT ? ds[j] : R(0), dzc[j]);
    if (j == n - 1) {
      z = L.zp;
      if constexpr (TANGENT) dZ = L.dzp;
    }
    const V zn = impedance_step(z, L.zp, L.th);
    if constexpr (TANGENT) {
      const V s = cadd(z, cmul(L.zp, L.th));
      const V den = cadd(L.zp, cmul(z, L.th));
      const V dsum = cadd(cadd(dZ, cmul(L.dzp, L.th)), cmul(L.zp, L.dth));
      const V dnum = cadd(cmul(L.dzp, s), cmul(L.zp, dsum));
      const V dden = cadd(cadd(L.dzp, cmul(dZ, L.th)), cmul(z, L.dth));
      dZ = cdiv(csub(dnum, cmul(zn, dden)), den);
    }
    z = zn;
  }

  // the amplitudes, top down
  V k, dk = zero;
  wave<R, TANGENT>(w, sg[0], TANGENT ? ds[0] : R(0), k, dk);
  const V b = cmul(z, k);
  const V q = cdiv(cfrom_real<V>(omu0), b);
  V U = cmake<V>(R(0.5) * (R(1) - q.x), R(0.5) * (-q.y));
  V D = cmake<V>(R(0.5) * (R(1) + q.x), R(0.5) * q.y);
  V dU = zero, dD = zero;
  if constexpr (TANGENT) {
    const V db = cadd(cmul(dZ, k), cmul(z, dk));
    const V dq = cscale(cdiv(cmul(q, db), b), R(-1));
    dU = cscale(dq, R(-0.5));
    dD = cscale(dq, R(0.5));
  }
  const int alive = TANGENT ? cut[col] : n + 1;
  int i = 0;
  for (;; ++i) {
    if constexpr (TANGENT) {
      ec[i] = cadd(dU, dD);
      hc[i] = cdiv(cadd(cmul(dk, csub(D, U)), cmul(k, csub(dD, dU))), cfrom_real<V>(omu0));
    } else {
      ec[i] = cadd(U, D);
      hc[i] = h_of(k, U, D, omu0);
    }
    if (i == n || i + 1 >= alive) break;
    V k_next = k, dk_next = dk;
    if (i + 1 < n) wave<R, TANGENT>(w, sg[i + 1], TANGENT ? ds[i + 1] : R(0), k_next, dk_next);
    const Step<V> s = prop_step(k, k_next, dzc[i], U, D);
    if constexpr (TANGENT) {
      const R dzi = dzc[i];
      const V dkr = cdiv(csub(dk, cmul(s.kr, dk_next)), k_next);
      const V dP = cmul(s.P, arg_tangent(times_i(dk, dzi), times_i(k, dzi).x, R(EXP_CLAMP)));
      const V dM = cmul(s.M, arg_tangent(times_minus_i(dk, dzi), times_minus_i(k, dzi).x,
                                          R(EXP_CLAMP)));
      const V du = cadd(cmul(dP, U), cmul(s.P, dU));
      const V dd = cadd(cmul(dM, D), cmul(s.M, dD));
      const V onep = cmake<V>(R(1) + s.kr.x, s.kr.y), onem = cmake<V>(R(1) - s.kr.x, -s.kr.y);
      const V skew = cmul(dkr, csub(s.u, s.d));
      dU = cscale(cadd(cadd(cmul(onep, du), cmul(onem, dd)), skew), R(0.5));
      dD = cscale(csub(cadd(cmul(onem, du), cmul(onep, dd)), skew), R(0.5));
    } else {
      const R e_prev = r_hypot(U.x + D.x, U.y + D.y);
      const R e_new = r_hypot(s.un.x + s.dn.x, s.un.y + s.dn.y);
      if (e_new - e_prev > R(0) || isnan(e_new)) break;
    }
    U = s.un;
    D = s.dn;
    k = k_next;
    dk = dk_next;
  }
  // i is the last live interface: the rest are zero
  for (int j = i + 1; j <= n; ++j) {
    ec[j] = zero;
    hc[j] = zero;
  }
  if constexpr (!TANGENT) cut[col] = i + 1;
}

// gsigma = d/dsigma Re(<ge, e> + <gh, h>) of a column, under its cut.  work
// holds Z_1..Z_n, U_0..U_n and D_0..D_n a row each (3 n + 2 rows of N); a
// layer's adjoint of k from the propagation goes into U's row once U is
// spent.
template <typename R>
__global__ void __launch_bounds__(THREADS)
mt1d_vjp_kernel(const R* __restrict__ omega, const R* __restrict__ sigma,
                const R* __restrict__ dz, int dz_stride, const int* __restrict__ cut,
                const Cx<R>* __restrict__ ge,   // (N, n + 1) or null
                const Cx<R>* __restrict__ gh,   // (N, n + 1) or null
                Cx<R>* __restrict__ work,       // (3 n + 2, N)
                R* __restrict__ gsigma,         // (N, n)
                int N, int n) {
  using V = Cx<R>;
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= N) return;
  const R w = omega[col], omu0 = w * R(MU0);
  const R* sg = sigma + (size_t)col * n;
  const R* dzc = dz + (size_t)col * dz_stride;
  const size_t stride = (size_t)N;
  V* Zrow = work + col;                           // Z_j at row j - 1
  V* Urow = work + (size_t)n * stride + col;      // U_i at row n + i, then k's adjoint
  V* Drow = work + (size_t)(2 * n + 1) * stride + col;
  const V zero = cmake<V>(R(0), R(0));
  const int c = cut[col];

  // forward again: Z, then U and D down to the last live interface
  V z = zero;
  for (int j = n - 1; j >= 0; --j) {
    const Layer<R> L = layer<R, false>(w, omu0, sg[j], R(0), dzc[j]);
    if (j == n - 1) z = L.zp;
    Zrow[(size_t)j * stride] = z;
    z = impedance_step(z, L.zp, L.th);
  }
  const V z0 = z;
  const V k0 = wavenumber(w, sg[0]);
  const V b = cmul(z0, k0);
  const V q = cdiv(cfrom_real<V>(omu0), b);
  V U = cmake<V>(R(0.5) * (R(1) - q.x), R(0.5) * (-q.y));
  V D = cmake<V>(R(0.5) * (R(1) + q.x), R(0.5) * q.y);
  Urow[0] = U;
  Drow[0] = D;
  V k = k0;
  for (int i = 0; i + 1 < c; ++i) {
    const V k_next = i + 1 < n ? wavenumber(w, sg[i + 1]) : k;
    const Step<V> s = prop_step(k, k_next, dzc[i], U, D);
    U = s.un;
    D = s.dn;
    Urow[(size_t)(i + 1) * stride] = U;
    Drow[(size_t)(i + 1) * stride] = D;
    k = k_next;
  }

  // an interface's cotangents: the adjoints of its U, D and ka
  const V* gec = ge ? ge + (size_t)col * (n + 1) : nullptr;
  const V* ghc = gh ? gh + (size_t)col * (n + 1) : nullptr;
  auto iface = [&](int i, V ka, V Ui, V Di, V& Ub, V& Db, V& kab) {
    const V g = gec ? gec[i] : zero;
    const V gt = ghc ? cdiv(ghc[i], cfrom_real<V>(omu0)) : zero;
    const V t = cmul(gt, cconj(ka));
    Ub = csub(g, t);
    Db = cadd(g, t);
    kab = cmul(gt, cconj(csub(Di, Ui)));
  };

  // back up the propagation: (Ubn, Dbn, kbn) are the adjoints of interface
  // i + 1's U, D and ka
  V Ubn, Dbn, kbn;
  const int top = c - 1;
  V k_next = top < n ? wavenumber(w, sg[top]) : wavenumber(w, sg[n - 1]);
  iface(top, k_next, Urow[(size_t)top * stride], Drow[(size_t)top * stride], Ubn, Dbn, kbn);
  for (int i = top - 1; i >= 0; --i) {
    const R dzi = dzc[i];
    const V ki = wavenumber(w, sg[i]);
    const V Ui = Urow[(size_t)i * stride], Di = Drow[(size_t)i * stride];
    V Ub, Db, kb;
    iface(i, ki, Ui, Di, Ub, Db, kb);
    const Step<V> s = prop_step(ki, k_next, dzi, Ui, Di);
    const V a = cscale(Ubn, R(0.5)), bb = cscale(Dbn, R(0.5));
    const V onep = cmake<V>(R(1) + s.kr.x, s.kr.y), onem = cmake<V>(R(1) - s.kr.x, -s.kr.y);
    const V ub = cadd(cmul(a, cconj(onep)), cmul(bb, cconj(onem)));
    const V db = cadd(cmul(a, cconj(onem)), cmul(bb, cconj(onep)));
    const V krb = cmul(csub(a, bb), cconj(csub(s.u, s.d)));
    Ub = cadd(Ub, cmul(ub, cconj(s.P)));
    Db = cadd(Db, cmul(db, cconj(s.M)));
    // kr = ka_i / ka_{i+1}
    const V t = cdiv(krb, cconj(k_next));
    kb = cadd(kb, t);
    kbn = csub(kbn, cmul(t, cconj(s.kr)));
    // P = exp(i k dz), M = exp(-i k dz), clamped
    const V wp = arg_adjoint(cmul(cconj(cmul(ub, cconj(Ui))), s.P), times_i(ki, dzi).x,
                             R(EXP_CLAMP));
    const V wm = arg_adjoint(cmul(cconj(cmul(db, cconj(Di))), s.M), times_minus_i(ki, dzi).x,
                             R(EXP_CLAMP));
    kb = cadd(kb, cmake<V>(wp.y * dzi - wm.y * dzi, -wp.x * dzi + wm.x * dzi));
    // ka_{i+1} is complete; ka_n is k_{n-1}
    if (i + 1 == n) kb = cadd(kb, kbn);
    else Urow[(size_t)(i + 1) * stride] = kbn;
    Ubn = Ub;
    Dbn = Db;
    kbn = kb;
    k_next = ki;
  }

  // U_0, D_0 from q = w mu0 / (Z_0 k_0)
  const V qb = csub(cscale(Dbn, R(0.5)), cscale(Ubn, R(0.5)));
  const V bbar = cscale(cmul(qb, cconj(cdiv(q, b))), R(-1));
  V Zb = cmul(bbar, cconj(k0));
  Urow[0] = cadd(kbn, cmul(bbar, cconj(z0)));

  // back down the impedance recurrence, and each layer's gradient
  for (int j = 0; j < n; ++j) {
    const R dzj = dzc[j];
    const Layer<R> L = layer<R, false>(w, omu0, sg[j], R(0), dzj);
    const V A = Zrow[(size_t)j * stride];
    const V s = cadd(A, cmul(L.zp, L.th));
    const V num = cmul(L.zp, s), den = cadd(L.zp, cmul(A, L.th));
    const V Zj = cdiv(num, den);
    const V numb = cdiv(Zb, cconj(den));
    const V denb = cscale(cmul(Zb, cconj(cdiv(Zj, den))), R(-1));
    V zpb = cmul(numb, cconj(s));
    const V sb = cmul(numb, cconj(L.zp));
    V Ab = sb;
    zpb = cadd(zpb, cmul(sb, cconj(L.th)));
    V thb = cmul(sb, cconj(L.zp));
    zpb = cadd(zpb, denb);
    Ab = cadd(Ab, cmul(denb, cconj(L.th)));
    thb = cadd(thb, cmul(denb, cconj(A)));
    if (j == n - 1) zpb = cadd(zpb, Ab);   // Z_n = zp_{n-1}
    const V argb = arg_adjoint(cmul(cconj(thb), sech2(L.arg)), L.arg.x, R(TANH_CLAMP));
    V kb = cmake<V>(argb.y * dzj, -argb.x * dzj);   // arg = i k dz
    kb = csub(kb, cmul(zpb, cconj(cdiv(L.zp, L.k))));   // zp = w mu0 / k
    if (j < c) kb = cadd(kb, Urow[(size_t)j * stride]);
    const V sqb = cdiv(kb, cscale(cconj(L.k), R(2)));   // k = sqrt(.)
    gsigma[(size_t)col * n + j] = -(R(MU0) * w) * sqb.y;
    Zb = Ab;
  }
}

}  // namespace

// One thread a column, blocks of THREADS (ops/mt1d.py MT1D_THREADS); dbl
// selects float64 / complex128 over float32 / complex64; dz_batched says
// whether dz is (N, n) or one (n,) for every column.  With dsigma (not
// null) the launch is the tangent variant: cut is read, e and h receive de
// and dh.  A plan this file does not compile is refused.
extern "C" int hmc_mt1d_field(const void* omega, const void* sigma, const void* dz,
                              const void* dsigma, void* cut, void* e, void* h, int N,
                              int n, int dz_batched, int threads, int dbl, void* stream) {
  if (threads != THREADS || n < 1 || N < 0 || (dz_batched != 0 && dz_batched != 1) ||
      (dbl != 0 && dbl != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  const int stride = dz_batched ? n : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl) {
    using R = double;
    if (dsigma)
      mt1d_field_kernel<R, true><<<grid, THREADS, 0, s>>>(
          (const R*)omega, (const R*)sigma, (const R*)dz, stride, (const R*)dsigma, (int*)cut,
          (Cx<R>*)e, (Cx<R>*)h, N, n);
    else
      mt1d_field_kernel<R, false><<<grid, THREADS, 0, s>>>(
          (const R*)omega, (const R*)sigma, (const R*)dz, stride, nullptr, (int*)cut,
          (Cx<R>*)e, (Cx<R>*)h, N, n);
  } else {
    using R = float;
    if (dsigma)
      mt1d_field_kernel<R, true><<<grid, THREADS, 0, s>>>(
          (const R*)omega, (const R*)sigma, (const R*)dz, stride, (const R*)dsigma, (int*)cut,
          (Cx<R>*)e, (Cx<R>*)h, N, n);
    else
      mt1d_field_kernel<R, false><<<grid, THREADS, 0, s>>>(
          (const R*)omega, (const R*)sigma, (const R*)dz, stride, nullptr, (int*)cut,
          (Cx<R>*)e, (Cx<R>*)h, N, n);
  }
  return (int)cudaGetLastError();
}

// ge or gh may be null (a cotangent of zero); work is (3 n + 2) x N of the
// complex type.
extern "C" int hmc_mt1d_vjp(const void* omega, const void* sigma, const void* dz,
                            const void* cut, const void* ge, const void* gh, void* work,
                            void* gsigma, int N, int n, int dz_batched, int threads, int dbl,
                            void* stream) {
  if (threads != THREADS || n < 1 || N < 0 || (dz_batched != 0 && dz_batched != 1) ||
      (dbl != 0 && dbl != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  const int stride = dz_batched ? n : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl) {
    using R = double;
    mt1d_vjp_kernel<R><<<grid, THREADS, 0, s>>>(
        (const R*)omega, (const R*)sigma, (const R*)dz, stride, (const int*)cut,
        (const Cx<R>*)ge, (const Cx<R>*)gh, (Cx<R>*)work, (R*)gsigma, N, n);
  } else {
    using R = float;
    mt1d_vjp_kernel<R><<<grid, THREADS, 0, s>>>(
        (const R*)omega, (const R*)sigma, (const R*)dz, stride, (const int*)cut,
        (const Cx<R>*)ge, (const Cx<R>*)gh, (Cx<R>*)work, (R*)gsigma, N, n);
  }
  return (int)cudaGetLastError();
}
