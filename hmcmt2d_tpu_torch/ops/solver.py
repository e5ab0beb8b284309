"""Batched block-tridiagonal direct solver.

PyTorch counterpart of ``hmcmt2d_tpu/ops/solver.py``.  With nodes ordered
y-fastest the interior operator is block tridiagonal over z-lines: the
diagonal blocks are tridiagonal (y-coupling) and the off-diagonal blocks
diagonal (z-coupling).  Block-Thomas elimination computes the per-line
inverse Schur complements once; they serve the forward and the adjoint solve,
since the operator is complex-symmetric.

Two engines:

* ``"thomas"``: the Schur chain with batched ``torch.linalg.inv`` in the
  system's dtype (complex128 on the CPU: exact to rounding);
* ``"fused"``: the hand-written CUDA kernels of :mod:`.fused_factor` on a
  complex64 factor, with iterative refinement against the matrix-free
  operator (the production setting on the GPU).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from .. import mesh as M
from .fused_factor import FusedFactor, fused_bt_solve, fused_schur_factor

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


def bt_factor(sys: InteriorSystem, inv_fn=torch.linalg.inv) -> BTFactor:
    """G_0 = inv(T_0), G_j = inv(T_j - C_{j-1} G_{j-1} C_{j-1})."""
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


def bt_solve(fac: BTFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the factorisation; b is (..., nzi, nyi).  The
    operator is complex-symmetric, so this also solves the transpose.

    Right-hand sides on axes where the factor's batch is 1 become the
    columns of one matrix product per line (G is never copied per column)."""
    G, offz = fac
    b = b.to(G.dtype)
    c = offz.to(G.dtype)[..., None]
    nzi, nyi = G.shape[-3], G.shape[-1]
    wide = rhs_axes(G.shape[:-3], b)
    bb, nd = b.shape[:-2], b.ndim
    last = list(range(nd - len(wide), nd))
    if wide:
        narrow = tuple(1 if i in wide else n for i, n in enumerate(bb))
        v = b.movedim(wide, last).reshape(narrow + (nzi, nyi, -1))
    else:
        v = b[..., None]
    ys = [G[..., 0, :, :] @ v[..., 0, :, :]]
    for j in range(1, nzi):
        ys.append(G[..., j, :, :] @ (v[..., j, :, :] + c[..., j - 1, :, :] * ys[-1]))
    xs = [ys[-1]]
    for j in range(nzi - 2, -1, -1):
        xs.append(ys[j] + G[..., j, :, :] @ (c[..., j, :, :] * xs[-1]))
    x = torch.stack(xs[::-1], dim=-3)     # (..., nzi, nyi, columns)
    if not wide:
        return x[..., 0]
    x = x.reshape(x.shape[:-1] + tuple(bb[i] for i in wide)).squeeze(tuple(wide))
    return x.movedim(last, wide)


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


class Factorization(NamedTuple):
    """Equilibrated factorisation reusable across solves: ``fac`` is a
    :class:`BTFactor` (thomas) or a :class:`FusedFactor` (fused kernels)."""

    fac: BTFactor | FusedFactor
    s: torch.Tensor


def factorize(sys: InteriorSystem, dtype=None, method: str = "thomas") -> Factorization:
    ssys, s = equilibrate(sys)
    if dtype is not None:
        rdt = REAL_DTYPE[dtype]
        ssys = InteriorSystem(ssys.diag.to(dtype), ssys.offy.to(rdt),
                              ssys.offz.to(rdt))
    if method == "fused":
        fac = fused_schur_factor(*ssys)
    elif method == "thomas":
        fac = bt_factor(ssys)
    else:
        raise ValueError(f"unknown solver method {method!r}")
    return Factorization(fac, s)


def _fused_solve(fac: FusedFactor, b: torch.Tensor) -> torch.Tensor:
    """``fused_bt_solve`` for a b whose batch may be wider than the
    factor's: the kernels take one G per system, so right-hand sides that
    share a factor are swept one index of the wide axes at a time."""
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


def factor_solve(f: Factorization, b: torch.Tensor) -> torch.Tensor:
    if isinstance(f.fac, FusedFactor):
        return f.s * _fused_solve(f.fac, f.s * b)
    return f.s * bt_solve(f.fac, f.s * b)


def refined_solve(sys: InteriorSystem, f: Factorization, b: torch.Tensor,
                  iters: int = 2) -> torch.Tensor:
    """Iterative refinement: factor in low precision, residual from the
    matrix-free operator ``apply_interior`` in ``sys``' precision."""
    x = factor_solve(f, b).to(b.dtype)
    for _ in range(iters):
        r = b - apply_interior(sys, x)
        x = x + factor_solve(f, r).to(b.dtype)
    return x
