"""Batched block-tridiagonal direct solver.

PyTorch counterpart of ``hmcmt2d_tpu/ops/solver.py``.  With nodes ordered
y-fastest the interior operator is block tridiagonal over z-lines: the
diagonal blocks are tridiagonal (y-coupling) and the off-diagonal blocks
diagonal (z-coupling).  A factorisation is computed once and serves the
forward and the adjoint solve, since the operator is complex-symmetric.

Four engines (``factorize(method=...)``):

* ``"thomas"``: block-Thomas elimination, the Schur chain of per-line
  inverses, in the system's dtype (complex128 on the CPU: exact to
  rounding);
* ``"thomas_blocked"``: the thomas factor with the within-group prefix
  products of its recurrences, so each triangular sweep takes about
  g + nzi/g sequential steps (groups of g = 8 lines) instead of nzi;
* ``"bcr"``: block cyclic reduction, ceil(log2(nzi + 1)) rounds of batched
  inverses and matrix products;
* ``"fused"``: the hand-written CUDA kernels of :mod:`.fused_factor` on a
  complex64 factor, with iterative refinement against the matrix-free
  operator (the production setting on the GPU).  Its lines run along the
  system's longer axis, each of min(ny_i, nz_i) unknowns, the ordering of
  least work (:func:`.fused_factor.line_axis`): along z when ny_i <= nz_i,
  else along y, where the system is factorised transposed and each
  right-hand side is transposed into that layout and its solution back.

thomas, thomas_blocked and bcr invert their blocks with LU
(:func:`lu_inverse`, ``inv_method="lu"``) or by unpivoted Gauss-Jordan
(``inv_method="gj"``: :func:`.fused_factor.gj_inverse`, the CUDA kernel on
the GPU and its plain version on the CPU).  Neither reads the device from
the host, so every engine's factor and solve can be captured in a CUDA
graph (``sampler/graphed.py``).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from .. import mesh as M
from .fused_factor import (FusedFactor, fused_bt_solve, fused_schur_factor, gj_inverse,
                           line_axis)

REAL_DTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64}


class InteriorSystem(NamedTuple):
    """Interior (Dirichlet-eliminated) operator in block-tridiagonal form.

    Leading batch dims broadcast together:
      diag : (..., nzi, nyi) complex, main diagonal (includes i*omega*m)
      offy : (..., nzi, nyi-1) real, y-coupling (matrix entry is ``-offy``)
      offz : (..., nzi-1, nyi) real, z-coupling (matrix entry is ``-offz``)
    """

    diag: torch.Tensor
    offy: torch.Tensor
    offz: torch.Tensor


def interior_system(st: M.Stencil, omega, dtype=None) -> InteriorSystem:
    """The interior block-tridiagonal system of a 5-point stencil."""
    cy, cz, m = st.cy, st.cz, st.m
    d_real = (cy[..., 1:-1, :-1] + cy[..., 1:-1, 1:]
              + cz[..., :-1, 1:-1] + cz[..., 1:, 1:-1])
    d_imag = omega * m[..., 1:-1, 1:-1]
    rdt = d_real.dtype if dtype is None else REAL_DTYPE[dtype]
    d_real, d_imag = torch.broadcast_tensors(d_real.to(rdt), d_imag.to(rdt))
    diag = torch.complex(d_real, d_imag)
    offy = cy[..., 1:-1, 1:-1].to(rdt)
    offz = cz[..., 1:-1, 1:-1].to(rdt)
    return InteriorSystem(diag, offy, offz)


def apply_interior(sys: InteriorSystem, x: torch.Tensor) -> torch.Tensor:
    """Matrix-free application of the interior operator to x (..., nzi, nyi)."""
    diag, offy, offz = sys
    zy = torch.zeros_like(x[..., :, :1])
    left = torch.cat([zy, offy * x[..., :, :-1]], dim=-1)
    right = torch.cat([offy * x[..., :, 1:], zy], dim=-1)
    zz = torch.zeros_like(x[..., :1, :])
    up = torch.cat([zz, offz * x[..., :-1, :]], dim=-2)
    down = torch.cat([offz * x[..., 1:, :], zz], dim=-2)
    return diag * x - left - right - up - down


class BTFactor(NamedTuple):
    """Block-Thomas factorisation: per-line inverse Schur complements."""

    G: torch.Tensor     # (..., nzi, nyi, nyi)
    offz: torch.Tensor  # (..., nzi-1, nyi)


def _dense_blocks(diag: torch.Tensor, offy: torch.Tensor) -> torch.Tensor:
    """Dense tridiagonal blocks T_j: (..., nzi, nyi, nyi)."""
    nyi = diag.shape[-1]
    kw = dict(dtype=diag.dtype, device=diag.device)
    eye = torch.eye(nyi, **kw)
    up = torch.diag(torch.ones(nyi - 1, **kw), 1)
    lo = torch.diag(torch.ones(nyi - 1, **kw), -1)
    offy_p = torch.cat([offy, torch.zeros_like(offy[..., :1])], dim=-1).to(diag.dtype)
    return (diag[..., :, None] * eye - offy_p[..., :, None] * up
            - offy_p[..., None, :] * lo)


# PyTorch's CUDA backend for :func:`lu_inverse`, chosen once for every
# batch: the default backend gives the engines' batches (176 to 5,632
# blocks of 95) to MAGMA's batched getrf, which a CUDA graph's capture
# refuses; "cusolver" gives a batch to cuBLAS's getrfBatched and
# getrsBatched (a single matrix to cuSOLVER's getrf), which capture, with
# results equal to torch.linalg.inv's under the same backend
# (scripts/torch_lu_capture.py, PERF.md)
LU_LIBRARY = "cusolver"


def lu_inverse(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of A (..., n, n) by partial-pivoting LU:
    ``torch.linalg.inv_ex`` with its error check left out, so it never
    reads ``info`` back to the host and a CUDA graph can capture it.  The
    same factorisation as ``torch.linalg.inv`` (which is ``inv_ex`` plus
    that check), so the same numbers.  A singular block gives non-finite
    values instead of raising, as JAX's ``jnp.linalg.inv`` does; the HMC
    step never accepts a non-finite proposal.  On a CUDA tensor it runs
    under the :data:`LU_LIBRARY` backend."""
    if A.device.type != "cuda":
        return torch.linalg.inv_ex(A).inverse
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(LU_LIBRARY)
    try:
        return torch.linalg.inv_ex(A).inverse
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def bt_factor(sys: InteriorSystem, inv_fn=lu_inverse) -> BTFactor:
    """G_0 = inv(T_0), G_j = inv(T_j - C_{j-1} G_{j-1} C_{j-1}); ``inv_fn``
    is the batched inverse (LU, or :func:`.fused_factor.gj_inverse`)."""
    diag, offy, offz = sys
    T = _dense_blocks(diag, offy)
    batch = torch.broadcast_shapes(T.shape[:-3], offz.shape[:-2])
    T = T.expand(batch + T.shape[-3:])
    c = offz.to(diag.dtype).expand(batch + offz.shape[-2:])
    Gs = [inv_fn(T[..., 0, :, :])]
    for j in range(1, T.shape[-3]):
        cj = c[..., j - 1, :]
        S = T[..., j, :, :] - cj[..., :, None] * Gs[-1] * cj[..., None, :]
        Gs.append(inv_fn(S))
    return BTFactor(torch.stack(Gs, dim=-3), offz)


def rhs_axes(fac_batch: torch.Size, b: torch.Tensor) -> list[int]:
    """The batch axes of ``b`` (..., nzi, nyi) on which the factor's batch
    is 1 and b's is wider: right-hand sides that share one factor (the
    Jacobian's slab of basis vectors)."""
    bb = b.shape[:-2]
    fb = (1,) * (len(bb) - len(fac_batch)) + tuple(fac_batch)
    return [i for i, (f, n) in enumerate(zip(fb, bb)) if f == 1 and n > 1]


def _as_columns(fac_batch: torch.Size, b: torch.Tensor):
    """b (..., nzi, nyi) as column blocks v (..., nzi, nyi, k), and the map
    back.  Right-hand sides on the :func:`rhs_axes` become the k columns
    of one matrix product per block, so a factor shared by them is never
    expanded (or copied) to their batch; elsewhere k = 1."""
    wide = rhs_axes(fac_batch, b)
    if not wide:
        return b[..., None], lambda x: x[..., 0]
    bb, nd = b.shape[:-2], b.ndim
    last = list(range(nd - len(wide), nd))
    narrow = tuple(1 if i in wide else n for i, n in enumerate(bb))
    v = b.movedim(wide, last).reshape(narrow + b.shape[-2:] + (-1,))

    def restore(x):
        x = x.reshape(x.shape[:-1] + tuple(bb[i] for i in wide)).squeeze(tuple(wide))
        return x.movedim(last, wide)

    return v, restore


def bt_solve(fac: BTFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the factorisation; b is (..., nzi, nyi).  The
    operator is complex-symmetric, so this also solves the transpose."""
    G, offz = fac
    c = offz.to(G.dtype)[..., None]
    v, restore = _as_columns(G.shape[:-3], b.to(G.dtype))
    nzi = G.shape[-3]
    ys = [G[..., 0, :, :] @ v[..., 0, :, :]]
    for j in range(1, nzi):
        ys.append(G[..., j, :, :] @ (v[..., j, :, :] + c[..., j - 1, :, :] * ys[-1]))
    xs = [ys[-1]]
    for j in range(nzi - 2, -1, -1):
        xs.append(ys[j] + G[..., j, :, :] @ (c[..., j, :, :] * xs[-1]))
    return restore(torch.stack(xs[::-1], dim=-3))


class BTFactorBlocked(NamedTuple):
    """Block-Thomas factorisation with the grouped sweeps' prefix products.

    The forward sweep is the affine recurrence y_j = u_j + H_j y_{j-1}
    (u_j = G_j b_j, H_j = G_j diag(c_{j-1})), the backward one
    x_j = y_j + H~_j x_{j+1} (H~_j = G_j diag(c_j)).  Lines are grouped
    in blocks of g; the products of the H within each group are taken at
    factor time, so a sweep is (A) the g in-group steps with no incoming
    carry, all groups batched, (B) the nzi/g carries across groups, and
    (C) one batched fix-up.  ``Qb`` is in line order (JAX stores it
    reversed), so the backward sweep slices G and Qb as they lie and
    copies neither."""

    G: torch.Tensor      # (..., N, q, q) padded inverse Schur complements
    offz: torch.Tensor   # (..., nzi-1, q) original couplings
    cf: torch.Tensor     # (..., N, q) forward coupling c_{j-1} (0 at j=0 / pad)
    cb: torch.Tensor     # (..., N, q) backward coupling c_j (0 at j=nzi-1 / pad)
    Qf: torch.Tensor     # (..., N, q, q) H_j ... H_{first line of j's group}
    Qb: torch.Tensor     # (..., N, q, q) H~_j ... H~_{last line of j's group}


BT_GROUP = 8


def _group_prefix(H: torch.Tensor, g: int, reverse: bool = False) -> torch.Tensor:
    """Within-group products of H (..., N, q, q), N a multiple of g:
    Q_{k,i} = H_{k,i} ... H_{k,0}, or with ``reverse`` H_{k,i} ... H_{k,g-1}
    (g - 1 batched products, all groups at once)."""
    shape = H.shape
    N, q = shape[-3], shape[-1]
    Hk = H.reshape(shape[:-3] + (N // g, g, q, q))
    order = range(g - 1, -1, -1) if reverse else range(g)
    Q = [None] * g
    prev = None
    for i in order:
        Q[i] = Hk[..., i, :, :] if prev is None else Hk[..., i, :, :] @ Q[prev]
        prev = i
    return torch.stack(Q, dim=-3).reshape(shape)


def bt_factor_blocked(sys: InteriorSystem, inv_fn=lu_inverse,
                      g: int = BT_GROUP) -> BTFactorBlocked:
    """The thomas factor, padded to a multiple of g lines (zero blocks and
    couplings), and its groups' prefix products."""
    G, offz = bt_factor(sys, inv_fn=inv_fn)
    batch, (nzi, q) = G.shape[:-3], G.shape[-3:-1]
    N = -(-nzi // g) * g
    c = offz.to(G.dtype).expand(batch + offz.shape[-2:])
    zline, tail = G.new_zeros(batch + (1, q)), G.new_zeros(batch + (N - nzi, q))
    cf = torch.cat([zline, c, tail], dim=-2)
    cb = torch.cat([c, zline, tail], dim=-2)
    if N > nzi:
        G = torch.cat([G, G.new_zeros(batch + (N - nzi, q, q))], dim=-3)
    Qf = _group_prefix(G * cf[..., None, :], g)
    Qb = _group_prefix(G * cb[..., None, :], g, reverse=True)
    return BTFactorBlocked(G, offz, cf, cb, Qf, Qb)


def _blocked_affine_scan(u: torch.Tensor, G: torch.Tensor, c: torch.Tensor,
                         Q: torch.Tensor, g: int, reverse: bool = False) -> torch.Tensor:
    """y_j = u_j + G_j diag(c_j) y_{j-1} for j = 0..N-1 (y_{-1} = 0), or with
    ``reverse`` y_j = u_j + G_j diag(c_j) y_{j+1} from j = N-1 down
    (y_N = 0), in about g + N/g sequential steps; u is (..., N, q, k) column
    blocks and Q the matching :func:`_group_prefix`."""
    N, q, k = u.shape[-3:]
    K = N // g
    uk = u.reshape(u.shape[:-3] + (K, g, q, k))
    Gk = G.reshape(G.shape[:-3] + (K, g, q, q))
    ck = c.reshape(c.shape[:-2] + (K, g, q, 1))
    Qk = Q.reshape(Q.shape[:-3] + (K, g, q, q))
    order = range(g - 1, -1, -1) if reverse else range(g)

    # (A) the in-group steps with no incoming carry, groups batched
    z = [None] * g
    prev = None
    for i in order:
        z[i] = (uk[..., i, :, :] if prev is None
                else uk[..., i, :, :] + Gk[..., i, :, :] @ (ck[..., i, :, :] * z[prev]))
        prev = i
    z = torch.stack(z, dim=-3)                        # (..., K, g, q, k)

    # (B) the carries across groups: carry_k = z at the group's end +
    # (the whole group's product) carry of the group before
    cin = [None] * K
    carry = torch.zeros_like(z[..., 0, 0, :, :])
    for kk in (range(K - 1, -1, -1) if reverse else range(K)):
        cin[kk] = carry
        carry = z[..., kk, prev, :, :] + Qk[..., kk, prev, :, :] @ carry
    cin = torch.stack(cin, dim=-3)                    # (..., K, q, k)

    # (C) the fix-up y_{k,i} = z_{k,i} + Q_{k,i} cin_k, one batched product
    y = z + Qk @ cin[..., None, :, :]
    return y.reshape(y.shape[:-4] + (N, q, k))


def bt_solve_blocked(fac: BTFactorBlocked, b: torch.Tensor,
                     g: int = BT_GROUP) -> torch.Tensor:
    """Grouped triangular sweeps; the same result as :func:`bt_solve`.
    Right-hand sides sharing the factor are the columns of each product
    (:func:`_as_columns`), so no product copies G, Qf or Qb per row."""
    G = fac.G
    N, nzi = G.shape[-3], b.shape[-2]
    v, restore = _as_columns(G.shape[:-3], b.to(G.dtype))
    if N > nzi:
        v = torch.cat([v, v.new_zeros(v.shape[:-3] + (N - nzi,) + v.shape[-2:])], dim=-3)
    y = _blocked_affine_scan(G @ v, G, fac.cf, fac.Qf, g)
    x = _blocked_affine_scan(y, G, fac.cb, fac.Qb, g, reverse=True)
    return restore(x[..., :nzi, :, :])


def equilibrate(sys: InteriorSystem) -> tuple[InteriorSystem, torch.Tensor]:
    """Symmetric diagonal scaling s A s with s = 1/sqrt(|diag|): compresses
    the TM operator's dynamic range so a complex64 factor stays accurate,
    and makes the real part positive definite, which unpivoted elimination
    relies on."""
    s = torch.rsqrt(sys.diag.abs())
    diag = sys.diag * (s * s)
    sy = s[..., :, 1:] * s[..., :, :-1]
    sz = s[..., 1:, :] * s[..., :-1, :]
    return InteriorSystem(diag, sys.offy * sy, sys.offz * sz), s


def direct_solve(sys: InteriorSystem, b: torch.Tensor, dtype=None) -> torch.Tensor:
    """One-shot equilibrated thomas factor and solve (no reuse); b is
    (..., nzi, nyi); ``dtype`` casts the scaled diagonal."""
    ssys, s = equilibrate(sys)
    if dtype is not None:
        ssys = InteriorSystem(ssys.diag.to(dtype), ssys.offy, ssys.offz)
    return s * bt_solve(bt_factor(ssys), s * b)


class BCRLevel(NamedTuple):
    """One block-cyclic-reduction level: the inverses of the eliminated
    (0-based even) diagonal blocks and their left and right couplings.

    Level 0 keeps the couplings in their natural diagonal form (the z-edge
    coupling of the 5-point stencil is diagonal): ``L`` and ``R`` are
    (..., ne, q) vectors there and dense (..., ne, q, q) blocks at deeper
    levels.  The last level holds the one remaining block inverse, with
    ``L = R = None``."""

    Dinv: torch.Tensor
    L: torch.Tensor | None
    R: torch.Tensor | None


class BCRFactor(NamedTuple):
    """Block cyclic reduction of the interior operator: the same reusable
    direct factorisation as :class:`BTFactor`, built in log2 rounds of
    batched inverses and products instead of nzi sequential Schur steps.
    Complex-symmetric throughout, so it solves the transpose too."""

    levels: tuple


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def bcr_factor(sys: InteriorSystem, inv_fn=None) -> BCRFactor:
    """Cyclic reduction of the interior block-tridiagonal system;
    ``inv_fn`` is the batched inverse (default :func:`lu_inverse`).

    Pads the nzi z-lines to N = 2^m - 1 with identity blocks and zero
    couplings (decoupled), then eliminates the 0-based even blocks level
    by level: for kept (odd) j,
        D'_j = D_j - C_{j-1}^T Dinv_{j-1} C_{j-1} - C_j Dinv_{j+1} C_j^T
        C'_(j-1)/2 = C_j Dinv_{j+1} C_{j+1}
    (matrix blocks (j, j+1) are -C_j; complex symmetry is preserved)."""
    diag, offy, offz = sys
    T = _dense_blocks(diag, offy)
    batch = torch.broadcast_shapes(T.shape[:-3], offz.shape[:-2])
    T = T.expand(batch + T.shape[-3:])
    nzi, q = T.shape[-3], T.shape[-1]
    inv_fn = lu_inverse if inv_fn is None else inv_fn
    N = 2 ** nzi.bit_length() - 1          # the smallest 2^m - 1 >= nzi
    if N == 1:
        return BCRFactor((BCRLevel(inv_fn(T), None, None),))
    eye = torch.eye(q, dtype=T.dtype, device=T.device)
    T = torch.cat([T, eye.expand(batch + (N - nzi, q, q))], dim=-3)
    c = torch.cat([offz.to(T.dtype).expand(batch + offz.shape[-2:]),
                   T.new_zeros(batch + (N - nzi, q))], dim=-2)     # (..., N-1, q)
    levels = []

    # level 0: diagonal couplings
    Dinv = inv_fn(T[..., 0::2, :, :])
    zv = torch.zeros_like(c[..., :1, :])
    levels.append(BCRLevel(Dinv, torch.cat([zv, c[..., 1::2, :]], dim=-2),  # C_{i-1}, even i
                           torch.cat([c[..., 0::2, :], zv], dim=-2)))       # C_i
    cL, cR = c[..., 0::2, :], c[..., 1::2, :]      # C_{j-1}, C_j for kept (odd) j
    k0, k1 = Dinv[..., :(N - 1) // 2, :, :], Dinv[..., 1:, :, :]   # Dinv_{j-1}, Dinv_{j+1}
    Dl = (T[..., 1::2, :, :]
          - cL[..., :, None] * k0 * cL[..., None, :]
          - cR[..., :, None] * k1 * cR[..., None, :])
    # C'_k = diag(c_j) Dinv_{j+1} diag(c_{j+1}): c_j is cR, c_{j+1} the next
    # kept block's cL
    Cl = cR[..., :-1, :, None] * k1[..., :-1, :, :] * cL[..., 1:, None, :]

    # dense levels
    while Dl.shape[-3] > 1:
        nl = Dl.shape[-3]
        Dinv = inv_fn(Dl[..., 0::2, :, :])
        zb = torch.zeros_like(Cl[..., :1, :, :])
        levels.append(BCRLevel(Dinv, torch.cat([zb, Cl[..., 1::2, :, :]], dim=-3),
                               torch.cat([Cl[..., 0::2, :, :], zb], dim=-3)))
        CL, CR = Cl[..., 0::2, :, :], Cl[..., 1::2, :, :]
        k0, k1 = Dinv[..., :(nl - 1) // 2, :, :], Dinv[..., 1:, :, :]
        Dn = Dl[..., 1::2, :, :] - _T(CL) @ (k0 @ CL) - CR @ (k1 @ _T(CR))
        # at nl == 3 a single block remains, with no couplings
        Cl = (CR[..., :-1, :, :] @ (k1[..., :-1, :, :] @ Cl[..., 2::2, :, :])
              if nl > 3 else Cl[..., :0, :, :])
        Dl = Dn
    levels.append(BCRLevel(inv_fn(Dl), None, None))
    return BCRFactor(tuple(levels))


def bcr_solve(fac: BCRFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve given a :func:`bcr_factor`; b is (..., nzi, q): the
    right-hand side reduced level by level, the one-block solve, then the
    back substitution.  Solves the transpose too (complex symmetry).

    Products take the whole of a level's coupling blocks and drop the
    unused end block of the result, rather than slice the factor first:
    a slice of a batched factor is not one strided batch, and
    ``torch.matmul`` would copy it on every solve."""
    levels = fac.levels
    D0 = levels[0].Dinv
    nzi = b.shape[-2]
    N = 2 * D0.shape[-3] - 1
    v, restore = _as_columns(D0.shape[:-3], b.to(D0.dtype))
    if N > nzi:
        v = torch.cat([v, v.new_zeros(v.shape[:-3] + (N - nzi,) + v.shape[-2:])], dim=-3)

    ys = []
    bl = v
    for Dinv, L, R in levels[:-1]:
        y = Dinv @ bl[..., 0::2, :, :]
        ys.append(y)
        # b'_j = b_j + C_{j-1}^T y_{j-1} + C_j y_{j+1}: C_{j-1} is R of the
        # eliminated j-1, C_j is L of the eliminated j+1
        if L.ndim < Dinv.ndim:          # level 0: diagonal couplings
            bl = (bl[..., 1::2, :, :] + R[..., :-1, :, None] * y[..., :-1, :, :]
                  + L[..., 1:, :, None] * y[..., 1:, :, :])
        else:
            bl = (bl[..., 1::2, :, :] + (_T(R) @ y)[..., :-1, :, :]
                  + (L @ y)[..., 1:, :, :])

    x = levels[-1].Dinv @ bl
    for (Dinv, L, R), y in zip(levels[-2::-1], ys[::-1]):
        zx = torch.zeros_like(x[..., :1, :, :])
        xl = torch.cat([zx, x], dim=-3)              # x_{i-1} for even i
        xr = torch.cat([x, zx], dim=-3)              # x_{i+1}
        if L.ndim < Dinv.ndim:
            rhs = L[..., None] * xl + R[..., None] * xr
        else:
            rhs = _T(L) @ xl + R @ xr
        xe = y + Dinv @ rhs
        # interleave the eliminated (even) and kept (odd) blocks
        ne = xe.shape[-3]
        out = xe.new_zeros(torch.broadcast_shapes(xe.shape[:-3], x.shape[:-3])
                           + (2 * ne - 1,) + xe.shape[-2:])
        out[..., 0::2, :, :] = xe
        out[..., 1::2, :, :] = x
        x = out
    return restore(x[..., :nzi, :, :])


class Factorization(NamedTuple):
    """Equilibrated factorisation reusable across solves: ``fac`` is a
    :class:`BTFactor` (thomas), a :class:`BTFactorBlocked`
    (thomas_blocked), a :class:`BCRFactor` (bcr) or a :class:`FusedFactor`
    (the fused kernels)."""

    fac: BTFactor | BTFactorBlocked | BCRFactor | FusedFactor
    s: torch.Tensor


FACTOR_FN = {"thomas": bt_factor, "thomas_blocked": bt_factor_blocked,
             "bcr": bcr_factor}
INV_FN = {"lu": lu_inverse, "gj": gj_inverse}


def uses_kernels(method: str, inv_method: str) -> bool:
    """Whether :func:`factorize` with these names launches the hand-written
    CUDA kernels on a CUDA tensor (so a process group builds them once)."""
    return method == "fused" or inv_method == "gj"


def transposed(sys: InteriorSystem) -> InteriorSystem:
    """The system with its unknowns ordered z-fastest, as block-tridiagonal
    over y-lines: the within-line coupling is the z-coupling, the
    between-line coupling the y-coupling."""
    return InteriorSystem(sys.diag.mT, sys.offz.mT, sys.offy.mT)


def factorize(sys: InteriorSystem, dtype=None, method: str = "thomas",
              inv_method: str = "lu") -> Factorization:
    """Equilibrate ``sys``, cast it to ``dtype`` and factorise it with the
    engine ``method``, whose blocks are inverted by ``inv_method`` (the
    fused engine inverts in its own kernel, on the lines of least work
    that :func:`.fused_factor.line_axis` picks from the system's shape:
    along its longer axis, transposed where that is y).  An unknown name
    raises: no engine falls back to another."""
    if method not in FACTOR_FN and method != "fused":
        raise ValueError(f"unknown solver method {method!r}")
    if inv_method not in INV_FN:
        raise ValueError(f"unknown inverse method {inv_method!r}")
    ssys, s = equilibrate(sys)
    if dtype is not None:
        rdt = REAL_DTYPE[dtype]
        ssys = InteriorSystem(ssys.diag.to(dtype), ssys.offy.to(rdt),
                              ssys.offz.to(rdt))
    if method == "fused":
        lines = line_axis(*ssys.diag.shape[-2:])
        fac = fused_schur_factor(*(transposed(ssys) if lines == "y" else ssys), lines=lines)
    else:
        fac = FACTOR_FN[method](ssys, inv_fn=INV_FN[inv_method])
    return Factorization(fac, s)


def _fused_solve(fac: FusedFactor, b: torch.Tensor) -> torch.Tensor:
    """``fused_bt_solve`` for a b (..., nzi, nyi) whose batch may be wider
    than the factor's: the kernels take one G per system, so right-hand
    sides that share a factor are swept one index of the wide axes at a
    time.  A factor of lines along y takes b transposed and gives x back
    in b's layout."""
    if fac.lines == "y":
        return _fused_sweeps(fac, b.mT).mT
    return _fused_sweeps(fac, b)


def _fused_sweeps(fac: FusedFactor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_fused_solve` on a b in the factor's layout."""
    wide = rhs_axes(fac.batch, b)
    if not wide:
        return fused_bt_solve(fac, b)
    out = torch.empty_like(b)
    for idx in itertools.product(*(range(b.shape[i]) for i in wide)):
        sl = [slice(None)] * b.ndim
        for i, k in zip(wide, idx):
            sl[i] = slice(k, k + 1)
        sl = tuple(sl)
        out[sl] = fused_bt_solve(fac, b[sl].reshape(fac.batch + b.shape[-2:])
                                 ).reshape(b[sl].shape)
    return out


SOLVE_FN = {FusedFactor: _fused_solve, BCRFactor: bcr_solve, BTFactor: bt_solve,
            BTFactorBlocked: bt_solve_blocked}


def factor_solve(f: Factorization, b: torch.Tensor) -> torch.Tensor:
    return f.s * SOLVE_FN[type(f.fac)](f.fac, f.s * b)


def refined_solve(sys: InteriorSystem, f: Factorization, b: torch.Tensor,
                  iters: int = 2) -> torch.Tensor:
    """Iterative refinement: factor in low precision, residual from the
    matrix-free operator ``apply_interior`` in ``sys``' precision."""
    x = factor_solve(f, b).to(b.dtype)
    for _ in range(iters):
        r = b - apply_interior(sys, x)
        x = x + factor_solve(f, r).to(b.dtype)
    return x
