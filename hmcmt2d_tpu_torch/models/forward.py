"""2-D MT forward modelling: TE/TM Dirichlet solves and receiver responses.

PyTorch counterpart of ``hmcmt2d_tpu/models/forward.py`` (the reference's
MT2DFwdSolver.jl, mt2DTE.jl, mt2DTM.jl):

* boundary conditions from the batched 1-D analytic propagator, every
  boundary column and frequency in one call;
* the interior Dirichlet solve is a ``torch.autograd.Function`` whose
  factorisation serves the forward and the adjoint solve (the operator is
  complex-symmetric), as ``lax.custom_linear_solve(symmetric=True)`` does in
  the JAX package;
* receiver fields and responses are plain differentiable tensor code.

A survey with both modes solves TE and TM as one merged batch of (chains x
frequency x mode) systems; a TE-only or TM-only survey solves its own mode
alone.  Everything is differentiable with respect to ``sigma2d``, in
reverse mode and, through the solve's ``jvp``, in forward mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MU0
from ..device import resolve_device  # noqa: F401  (re-exported)
from .. import mesh as M
from ..ops import mt1d
from ..ops import solver as S
from .data import MTData


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Precision policy for the PDE solves.

    ``solver_method`` is ``"thomas"`` (block Thomas, exact in complex128),
    ``"thomas_blocked"`` (block Thomas with grouped sweeps), ``"bcr"``
    (block cyclic reduction) or ``"fused"`` (the CUDA kernels of
    ops/fused_factor.py on complex64 factors), with ``refine_iters`` steps
    of iterative refinement.  Unlike the JAX package, whose field default
    is ``"bcr"``, the default engine here is ``"thomas"``.
    ``inv_method`` is the batched inverse inside thomas, thomas_blocked and
    bcr: ``"lu"`` (partial-pivoting LU, ``ops/solver.py`` ``lu_inverse``)
    or ``"gj"`` (unpivoted Gauss-Jordan, the ``gj_inverse`` kernel on the
    GPU; ops/fused_factor.py).
    ``stale_refine_iters`` refinement steps serve a solve with a stale
    (trajectory-amortised) factor, see :func:`solve_dirichlet`.
    """

    solve_dtype: torch.dtype = torch.complex128
    refine_iters: int = 0
    solver_method: str = "thomas"
    inv_method: str = "lu"
    # sized so the worst measured contraction (~0.45 a step at an 8-step
    # leapfrog drift) still reaches ~1e-4 relative, and refactoring every
    # ~4 steps ~1e-7 (hmcmt2d_tpu/models/forward.py:67-71)
    stale_refine_iters: int = 10

    @property
    def real_dtype(self) -> torch.dtype:
        return S.REAL_DTYPE[self.solve_dtype]


def default_config(device=None) -> SolveConfig:
    """GPU: complex64 fused kernels with 6 refinement steps, the JAX
    package's accelerator default.  CPU: exact complex128 thomas."""
    if resolve_device(device).type == "cuda":
        return SolveConfig(torch.complex64, 6, "fused")
    return SolveConfig(torch.complex128, 0, "thomas")


class RxInterp(NamedTuple):
    """Receiver level and linear interpolation weights (mt2DTE.jl:64-71,
    195-207), as tensors on the mesh's device."""

    zid: int               # z-node index of the receiver level
    idx: torch.Tensor      # (nrx,) left node index in y
    w0: torch.Tensor       # (nrx,) weight of node idx
    w1: torch.Tensor       # (nrx,) weight of node idx+1
    cidx: torch.Tensor     # (nrx,) left cell-centre index (tipper Hz)
    c0: torch.Tensor       # (nrx,) weight of centre cidx
    c1: torch.Tensor       # (nrx,) weight of centre cidx+1


def _interp1d(x_grid: np.ndarray, x: np.ndarray):
    idx = np.searchsorted(x_grid, x, side="right") - 1
    idx = np.clip(idx, 0, len(x_grid) - 2)
    d1 = x - x_grid[idx]
    d2 = x_grid[idx + 1] - x
    w = d1 + d2
    return idx, d2 / w, d1 / w


def make_rx_interp(mesh: M.TensorMesh2D, rx_loc: np.ndarray) -> RxInterp:
    y_node = mesh.y_node().cpu().numpy()
    z_node = mesh.z_node().cpu().numpy()
    z_rx = float(rx_loc[0, 1])
    hits = np.nonzero(np.abs(z_node - z_rx) < 0.1)[0]
    if len(hits) == 0:
        raise ValueError("receivers must sit on a z-node level (no topography)")
    ry = np.asarray(rx_loc[:, 0], float)
    idx, w0, w1 = _interp1d(y_node, ry)
    y_center = 0.5 * (y_node[:-1] + y_node[1:])
    cidx, c0, c1 = _interp1d(y_center, np.clip(ry, y_center[0], y_center[-1]))
    dev = mesh.device

    def t(a):
        return torch.tensor(a, device=dev)

    return RxInterp(zid=int(hits[0]), idx=t(idx), w0=t(w0), w1=t(w1),
                    cidx=t(cidx), c0=t(c0), c1=t(c1))


def boundary_profiles(mesh: M.TensorMesh2D, sigma2d: torch.Tensor) -> torch.Tensor:
    """1-D conductivity profiles of all boundary columns: (..., ny+1, nz).
    Row 0 the left column, row ny the right, rows 1..ny-1 the y-width
    weighted averages used for the bottom boundary (mt2DTE.jl:115-131)."""
    dy = mesh.y_len
    mid = ((sigma2d[..., :, :-1] * dy[:-1] + sigma2d[..., :, 1:] * dy[1:])
           / (dy[:-1] + dy[1:]))
    cols = torch.cat([sigma2d[..., :, :1].to(mid.dtype), mid,
                      sigma2d[..., :, -1:].to(mid.dtype)], dim=-1)
    return cols.transpose(-1, -2)


def _bc_from_profile_field(mesh: M.TensorMesh2D, f: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """Scatter normalised profile fields (..., ny+1, nz+1) onto the
    Dirichlet ring of the node grid -> (..., nz+1, ny+1)."""
    ny, nz = mesh.ny, mesh.nz
    f = (f / f[..., :1]).to(dtype)
    bc = f.new_zeros(f.shape[:-2] + (nz + 1, ny + 1))
    bc[..., 0, :] = 1.0
    bc[..., 1:, 0] = f[..., 0, 1:]
    bc[..., 1:, ny] = f[..., ny, 1:]
    bc[..., nz, 1:ny] = f[..., 1:ny, nz]
    return bc


def boundary_grids_both(mesh: M.TensorMesh2D, sigma2d: torch.Tensor,
                        omegas: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """TE and TM Dirichlet grids from one 1-D propagation:
    (nfreq, ..., 2, nz+1, ny+1), mode axis [TE, TM]."""
    profiles = boundary_profiles(mesh, sigma2d)
    om = omegas.reshape((-1,) + (1,) * profiles.ndim)
    e, h = mt1d.analytic_field(om, profiles[None], mesh.z_len, with_h=True,
                               dtype=dtype)
    return torch.stack([_bc_from_profile_field(mesh, e, dtype),
                        _bc_from_profile_field(mesh, h, dtype)], dim=-3)


def boundary_grid(mesh: M.TensorMesh2D, sigma2d: torch.Tensor,
                  omegas: torch.Tensor, mode: str, dtype: torch.dtype) -> torch.Tensor:
    """One mode's Dirichlet grid (nfreq, ..., nz+1, ny+1): TE takes E, TM
    takes H from the 1-D propagation (getBoundaryMT2DTE/TM)."""
    profiles = boundary_profiles(mesh, sigma2d)
    om = omegas.reshape((-1,) + (1,) * profiles.ndim)
    if mode == "TE":
        f = mt1d.analytic_field(om, profiles[None], mesh.z_len, dtype=dtype)
    else:
        _, f = mt1d.analytic_field(om, profiles[None], mesh.z_len, with_h=True,
                                   dtype=dtype)
    return _bc_from_profile_field(mesh, f, dtype)


def _cast_stencil(st: M.Stencil, rdt: torch.dtype) -> M.Stencil:
    return M.Stencil(st.cy.to(rdt), st.cz.to(rdt), st.m.to(rdt))


def _solve(sys: S.InteriorSystem, fac: S.Factorization, b: torch.Tensor,
           iters: int) -> torch.Tensor:
    if iters > 0:
        return S.refined_solve(sys, fac, b, iters=iters)
    return S.factor_solve(fac, b)


class _DirichletSolve(torch.autograd.Function):
    """x = A^-1 rhs for the interior system A = (diag, offy, offz), given its
    factor ``fac`` (fresh, or stale from a nearby model) and ``iters``
    refinement steps against the current operator.

    Backward: A is complex-symmetric, so under torch's conjugate-Wirtinger
    convention the adjoint is lambda = conj(solve(conj(g))) on the same
    factor; rhs receives lambda and the coefficients receive -lambda pulled
    back through ``apply_interior(., x)`` (the implicit-function form that
    ``lax.custom_linear_solve`` uses).  Forward mode (``jvp``, for
    ``torch.func.jvp``): dx = A^-1 (d rhs - dA x), one more solve on the
    same factor, dA x being ``apply_interior`` of the tangent coefficients.
    The factor kernels have no derivative and need none.
    """

    @staticmethod
    def forward(diag, offy, offz, rhs, fac: S.Factorization, iters: int):
        return _solve(S.InteriorSystem(diag, offy, offz), fac, rhs, iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        diag, offy, offz, _, fac, iters = inputs
        ctx.fac, ctx.iters = fac, iters
        ctx.save_for_backward(diag, offy, offz, output)
        ctx.save_for_forward(diag, offy, offz, output)

    @staticmethod
    def backward(ctx, gx):
        diag, offy, offz, x = ctx.saved_tensors
        sys = S.InteriorSystem(diag, offy, offz)
        lam = torch.conj(_solve(sys, ctx.fac, torch.conj(gx), ctx.iters))
        need = ctx.needs_input_grad[:3]
        grads = [None, None, None]
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n)
                          for t, n in zip((diag, offy, offz), need)]
                ax = S.apply_interior(S.InteriorSystem(*leaves), x)
                wanted = [t for t, n in zip(leaves, need) if n]
                got = iter(torch.autograd.grad(ax, wanted, grad_outputs=-lam))
            grads = [next(got) if n else None for n in need]
        return (*grads, lam if ctx.needs_input_grad[3] else None, None, None)

    @staticmethod
    def jvp(ctx, d_diag, d_offy, d_offz, d_rhs, _d_fac, _d_iters):
        diag, offy, offz, x = ctx.saved_tensors
        dA = S.InteriorSystem(*(torch.zeros_like(t) if d is None else d
                                for t, d in ((diag, d_diag), (offy, d_offy),
                                             (offz, d_offz))))
        r = -S.apply_interior(dA, x)
        if d_rhs is not None:
            r = r + d_rhs
        return _solve(S.InteriorSystem(diag, offy, offz), ctx.fac, r, ctx.iters)


def solve_dirichlet(st: M.Stencil, omegas: torch.Tensor, bc: torch.Tensor,
                    cfg: SolveConfig, fac: S.Factorization | None = None) -> torch.Tensor:
    """Solve A(omega) u = 0 with Dirichlet boundary ``bc`` for every
    frequency.  ``bc`` is (nfreq, ..., nz+1, ny+1), with extra batch axes
    between frequency and grid matching those of ``st``.  Returns full node
    fields shaped like ``bc``; differentiable w.r.t. the stencil and bc.

    ``fac`` (optional, from :meth:`ForwardOperator.factor_at`) is a
    factorisation built at a nearby model, the trajectory-amortised path:
    the solve refines against the current operator instead of factorising
    afresh (:func:`interior_solve`), and the adjoint solve uses the same
    factor.  Where its batch is 1 and ``bc``'s is wider, those right-hand
    sides share it."""
    rdt = cfg.real_dtype
    st_c = _cast_stencil(st, rdt)
    n_extra = bc.ndim - 3
    om = omegas.to(rdt).reshape(omegas.shape[:1] + (1,) * (n_extra + 2))
    bc = bc.to(cfg.solve_dtype)
    sys = S.interior_system(st_c, om, dtype=cfg.solve_dtype)
    rhs = M.boundary_rhs(st_c, om, bc)
    return bc + M.embed_interior(interior_solve(*sys, rhs, cfg, fac))


def interior_solve(diag, offy, offz, rhs, cfg: SolveConfig,
                   fac: S.Factorization | None = None) -> torch.Tensor:
    """x = A^-1 rhs for the interior system (diag, offy, offz), differentiable
    in both modes (:class:`_DirichletSolve`): without ``fac`` the detached
    system is factorised here and the solve refines ``cfg.refine_iters``
    times; with a stale ``fac``, ``cfg.stale_refine_iters`` times."""
    if fac is None:
        with torch.no_grad():
            fac = S.factorize(S.InteriorSystem(diag.detach(), offy.detach(), offz.detach()),
                              dtype=cfg.solve_dtype, method=cfg.solver_method,
                              inv_method=cfg.inv_method)
        iters = cfg.refine_iters
    else:
        iters = cfg.stale_refine_iters
    return _DirichletSolve.apply(diag, offy, offz, rhs, fac, iters)


def _pair_mean(x, w):
    """Width-weighted vertical-edge average (mt2DTE.jl:183)."""
    return (x[..., :-1] * w[:-1] + x[..., 1:] * w[1:]) / (w[:-1] + w[1:])


def _om_col(omegas, fields, dtype):
    """Frequency column broadcastable against rows of ``fields``."""
    return omegas.to(dtype).reshape((-1,) + (1,) * (fields.ndim - 2))


def _real_of(fields: torch.Tensor) -> torch.dtype:
    return fields.real.dtype


def rx_fields_te(omegas, mesh: M.TensorMesh2D, sigma2d, fields, rx: RxInterp):
    """Surface Ex, Hy at the receivers (compFieldsAtRxTE, mt2DTE.jl:153-210):
    Hy from a discrete Ampere's-law correction with quarter-point Hz and Ex.
    ``fields`` is (nfreq, ..., nz+1, ny+1), ``sigma2d`` (..., nz, ny)."""
    dy = mesh.y_len.to(_real_of(fields))
    dz1 = mesh.z_len[rx.zid].to(dy.dtype)
    sigma1 = sigma2d[..., rx.zid, :].to(dy.dtype)
    om = _om_col(omegas, fields, dy.dtype)

    E0 = fields[..., rx.zid, :]
    E1 = fields[..., rx.zid + 1, :]
    iom = torch.complex(torch.zeros_like(om), om)
    Bz0 = (E0[..., 1:] - E0[..., :-1]) / dy / iom
    Bz1 = (E1[..., 1:] - E1[..., :-1]) / dy / iom
    HzQ = (0.75 * Bz0 + 0.25 * Bz1) / MU0
    HyH = -(E1[..., 1:-1] - E0[..., 1:-1]) / dz1 / (iom * MU0)
    ExQ = 0.75 * E0[..., 1:-1] + 0.25 * E1[..., 1:-1]
    sigma1v = _pair_mean(sigma1, dy)
    dHzQ = (HzQ[..., 1:] - HzQ[..., :-1]) / (0.5 * (dy[:-1] + dy[1:]))
    Hy_in = HyH - (dHzQ - sigma1v * ExQ) * (0.5 * dz1)
    Hy0 = torch.cat([Hy_in[..., :1], Hy_in, Hy_in[..., -1:]], dim=-1)

    Ex_r = rx.w0 * E0[..., rx.idx] + rx.w1 * E0[..., rx.idx + 1]
    Hy_r = rx.w0 * Hy0[..., rx.idx] + rx.w1 * Hy0[..., rx.idx + 1]
    return Ex_r, Hy_r


def rx_fields_tm(omegas, mesh: M.TensorMesh2D, sigma2d, fields, rx: RxInterp):
    """Surface Ey, Hx at the receivers: the Faraday-law dual
    (mt2DTM.jl:152-210)."""
    dy = mesh.y_len.to(_real_of(fields))
    dz1 = mesh.z_len[rx.zid].to(dy.dtype)
    sigma1 = sigma2d[..., rx.zid, :].to(dy.dtype)
    om = _om_col(omegas, fields, dy.dtype)

    H0 = fields[..., rx.zid, :]
    H1 = fields[..., rx.zid + 1, :]
    Jz0 = -(H0[..., 1:] - H0[..., :-1]) / dy
    Jz1 = -(H1[..., 1:] - H1[..., :-1]) / dy
    EzQ = (0.75 * Jz0 + 0.25 * Jz1) / sigma1
    JyH = (H1[..., 1:-1] - H0[..., 1:-1]) / dz1
    rho1v = _pair_mean(1.0 / sigma1, dy)
    EyH = JyH * rho1v
    HxQ = 0.75 * H0[..., 1:-1] + 0.25 * H1[..., 1:-1]
    dEzQ = (EzQ[..., 1:] - EzQ[..., :-1]) / (0.5 * (dy[:-1] + dy[1:]))
    iom_mu = torch.complex(torch.zeros_like(om), om * MU0)
    Ey_in = EyH - (dEzQ + iom_mu * HxQ) * (0.5 * dz1)
    Ey0 = torch.cat([Ey_in[..., :1], Ey_in, Ey_in[..., -1:]], dim=-1)

    Ey_r = rx.w0 * Ey0[..., rx.idx] + rx.w1 * Ey0[..., rx.idx + 1]
    Hx_r = rx.w0 * H0[..., rx.idx] + rx.w1 * H0[..., rx.idx + 1]
    return Ey_r, Hx_r


def rx_hz_te(omegas, mesh: M.TensorMesh2D, fields, rx: RxInterp):
    """Vertical magnetic field Hz at the receivers (TE), for the tipper
    TZY = Hz/Hy: the surface-row Bz0/mu interpolated on cell centres
    (dataFuncSens.jl:44-46, 96)."""
    dy = mesh.y_len.to(_real_of(fields))
    om = _om_col(omegas, fields, dy.dtype)
    E0 = fields[..., rx.zid, :]
    iom = torch.complex(torch.zeros_like(om), om)
    Hz0 = (E0[..., 1:] - E0[..., :-1]) / dy / iom / MU0
    return rx.c0 * Hz0[..., rx.cidx] + rx.c1 * Hz0[..., rx.cidx + 1]


def impedance_to_rho_phase(omegas, Z):
    """Apparent resistivity and phase in degrees (compMTRespTE,
    mt2DTE.jl:253-255)."""
    om = omegas.to(Z.real.dtype).reshape((-1,) + (1,) * (Z.ndim - 1))
    rho = (Z.real ** 2 + Z.imag ** 2) / (om * MU0)
    phs = torch.atan2(Z.imag, Z.real) * (180.0 / np.pi)
    return rho, phs


@dataclasses.dataclass(frozen=True)
class ForwardOperator:
    """Mesh + survey -> differentiable ``predict(sigma2d)``.

    A survey with TE and TM components solves both modes as one merged batch
    of (chains x frequency x mode) systems; a TE-only or TM-only survey
    solves its own mode alone, chains x frequency systems, as the JAX
    package does.  The one-mode path takes no stale factor: like JAX's, it
    ignores ``fac`` and factorises afresh (:meth:`response_cube`).
    """

    mesh: M.TensorMesh2D
    data: MTData
    rx: RxInterp
    cfg: SolveConfig
    # device tensors built from the survey's numpy arrays, once for each key
    # (:meth:`_cached`): a host-to-device copy in every eval would wait on
    # the host, and a CUDA graph cannot capture one
    _consts: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def _cached(self, key: tuple, make) -> torch.Tensor:
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = make()
        return t

    def _omegas(self, sigma2d: torch.Tensor, freqs=None) -> torch.Tensor:
        """Angular frequencies of ``freqs`` (default: every survey frequency)."""
        freqs = self.data.freqs if freqs is None else freqs
        key = ("omegas", np.asarray(freqs, np.float64).tobytes(), sigma2d.dtype,
               sigma2d.device)
        return self._cached(key, lambda: 2.0 * np.pi * torch.as_tensor(
            freqs, dtype=sigma2d.dtype, device=sigma2d.device))

    def mode_solution(self, sigma2d: torch.Tensor, mode: str,
                      freqs=None) -> torch.Tensor:
        """Full node fields (nfreq, ..., nz+1, ny+1) of one mode, ``"TE"`` or
        ``"TM"``, from its own factor and solve; ``freqs`` as in
        :meth:`factor_at`."""
        omegas = self._omegas(sigma2d, freqs)
        st = (M.te_stencil if mode == "TE" else M.tm_stencil)(self.mesh, sigma2d)
        bc = boundary_grid(self.mesh, sigma2d, omegas, mode, self.cfg.solve_dtype)
        return solve_dirichlet(st, omegas, bc, self.cfg)

    def mode_rx_fields(self, sigma2d: torch.Tensor, mode: str, freqs=None):
        """(E, H, fields) of one mode: the surface fields at the receivers
        (Ex, Hy for TE; Ey, Hx for TM) and the node fields."""
        omegas = self._omegas(sigma2d, freqs)
        fields = self.mode_solution(sigma2d, mode, freqs)
        rx_fields = rx_fields_te if mode == "TE" else rx_fields_tm
        E, H = rx_fields(omegas, self.mesh, sigma2d, fields, self.rx)
        return E, H, fields

    def mode_impedance(self, sigma2d: torch.Tensor, mode: str,
                       freqs=None) -> torch.Tensor:
        """Impedance Zxy (TE) or Zyx (TM), (nfreq, ..., nrx)."""
        E, H, _ = self.mode_rx_fields(sigma2d, mode, freqs)
        return E / H

    def merged_stencil(self, sigma2d: torch.Tensor) -> M.Stencil:
        """TE and TM stencils stacked on a mode axis just before the grid
        axes: (..., 2, grid), chain axes of sigma2d leading."""
        st_te = M.te_stencil(self.mesh, sigma2d)
        st_tm = M.tm_stencil(self.mesh, sigma2d)
        return M.Stencil(*(torch.stack([a, b], dim=-3)
                           for a, b in zip(st_te, st_tm)))

    @torch.no_grad()
    def factor_at(self, sigma2d: torch.Tensor, freqs=None) -> S.Factorization:
        """Factorise the merged (freq x mode) interior systems at this model:
        the reusable factor that :meth:`both_mode_solutions`,
        :meth:`response_cube` and :meth:`predict` take as ``fac``.  Not
        differentiated (it only ever preconditions the solve).  ``freqs``
        (default: the survey's) selects the frequencies, as the
        frequency-sharded path does for its own share.  It covers both
        modes whatever the survey holds, as in the JAX package; a one-mode
        survey's :meth:`response_cube` does not use it."""
        omegas = self._omegas(sigma2d, freqs)
        st = self.merged_stencil(sigma2d)
        rdt = self.cfg.real_dtype
        om = omegas.to(rdt).reshape((-1,) + (1,) * st.m.ndim)
        sys = S.interior_system(_cast_stencil(st, rdt), om,
                                dtype=self.cfg.solve_dtype)
        return S.factorize(sys, dtype=self.cfg.solve_dtype,
                           method=self.cfg.solver_method,
                           inv_method=self.cfg.inv_method)

    def both_mode_solutions(self, sigma2d: torch.Tensor, freqs=None,
                            fac: S.Factorization | None = None):
        """(fields_te, fields_tm), each (nfreq, ..., nz+1, ny+1), from one
        batched factor and solve over the stacked (freq x mode) systems;
        ``freqs`` as in :meth:`factor_at`; ``fac``: an optional stale factor
        from :meth:`factor_at` over the same frequencies."""
        omegas = self._omegas(sigma2d, freqs)
        st = self.merged_stencil(sigma2d)
        bc = boundary_grids_both(self.mesh, sigma2d, omegas, self.cfg.solve_dtype)
        fields = solve_dirichlet(st, omegas, bc, self.cfg, fac=fac)
        return fields[..., 0, :, :], fields[..., 1, :, :]

    def response_cube(self, sigma2d: torch.Tensor, freqs=None,
                      fac: S.Factorization | None = None) -> torch.Tensor:
        """(..., nfreq, nrx, ncomp) responses in ``data_comp`` order, with the
        leading chain axes of ``sigma2d``; ``freqs`` as in :meth:`factor_at`
        (then nfreq is ``len(freqs)``).  Both modes: one merged solve, with
        ``fac`` if given.  One mode: that mode's own solve, which ignores
        ``fac`` (hmcmt2d_tpu/models/forward.py:477-487); the TE branch
        takes the tipper from the TE fields."""
        omegas = self._omegas(sigma2d, freqs)
        data = self.data
        Z, T = {}, None
        want_tipper = "TZY" in data.data_comp
        if data.comp_te and data.comp_tm:
            fields_te, fields_tm = self.both_mode_solutions(sigma2d, freqs, fac)
            E, H = rx_fields_te(omegas, self.mesh, sigma2d, fields_te, self.rx)
            Ey, Hx = rx_fields_tm(omegas, self.mesh, sigma2d, fields_tm, self.rx)
            Z["XY"], Z["YX"] = E / H, Ey / Hx
        elif data.comp_te:
            E, H, fields_te = self.mode_rx_fields(sigma2d, "TE", freqs)
            Z["XY"] = E / H
        else:
            Z["YX"] = self.mode_impedance(sigma2d, "TM", freqs)
        if want_tipper:
            T = rx_hz_te(omegas, self.mesh, fields_te, self.rx) / H
        comps = []
        for name in data.data_comp:
            pol = "XY" if name.endswith("XY") else "YX"
            if name == "TZY":
                comps.append(T)
            elif name.startswith("Z"):
                comps.append(Z[pol])
            elif name.startswith("log10Rho"):
                comps.append(torch.log10(impedance_to_rho_phase(omegas, Z[pol])[0]))
            elif name.startswith("Rho"):
                comps.append(impedance_to_rho_phase(omegas, Z[pol])[0])
            elif name.startswith("Phs"):
                comps.append(impedance_to_rho_phase(omegas, Z[pol])[1])
            else:
                raise ValueError(name)
        cube = torch.stack(comps, dim=-1)          # (nfreq, ..., nrx, ncomp)
        return torch.movedim(cube, 0, -3)

    def predict(self, sigma2d: torch.Tensor,
                fac: S.Factorization | None = None) -> torch.Tensor:
        """Predicted data at the observed (freq, rx, comp) triples, chain
        axes of ``sigma2d`` leading: (..., ndata)."""
        cube = self.response_cube(sigma2d, fac=fac)
        flat = cube.reshape(cube.shape[:-3] + (-1,))
        idx = self._cached(("flat_index", flat.device), lambda: torch.as_tensor(
            self.data.flat_index, device=flat.device))
        return flat[..., idx]


def make_forward(mesh: M.TensorMesh2D, data: MTData,
                 cfg: SolveConfig | None = None) -> ForwardOperator:
    cfg = cfg or default_config(mesh.device)
    return ForwardOperator(mesh=mesh, data=data,
                           rx=make_rx_interp(mesh, data.rx_loc), cfg=cfg)
