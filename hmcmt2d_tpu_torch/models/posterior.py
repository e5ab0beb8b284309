"""Inverse problem: data misfit + smoothness prior on log-conductivity.

PyTorch counterpart of ``hmcmt2d_tpu/models/posterior.py`` (the reference's
setupInverseDataModel and getHamiltonian): the gradient of everything, the
PDE solves included, comes from autograd.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .. import mesh as M
from ..utils import transforms as T
from .data import MTData
from .forward import ForwardOperator, SolveConfig, make_forward, resolve_device


@dataclasses.dataclass(frozen=True)
class InverseProblem:
    """Survey + observations + parameterisation.  Static members are numpy;
    methods are differentiable functions of the active-cell log-conductivity
    ``m`` (..., n_param), chain axes leading."""

    fwd: ForwardOperator
    obs: np.ndarray          # (ndata,) complex or real observations
    weights: np.ndarray      # (ndata,) real 1/|err|
    active_idx: np.ndarray   # (n_active,) flat cell indices being inverted
    bg_flat: np.ndarray      # (n_cell,) frozen background conductivities

    @property
    def n_param(self) -> int:
        return len(self.active_idx)

    @property
    def mesh(self) -> M.TensorMesh2D:
        return self.fwd.mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @cached_property
    def _tensors(self):
        dev = self.device
        return (torch.tensor(self.obs, device=dev),
                torch.tensor(self.weights, device=dev),
                torch.tensor(self.active_idx, dtype=torch.long, device=dev),
                torch.tensor(self.bg_flat, device=dev))

    def sigma2d(self, m: torch.Tensor) -> torch.Tensor:
        """active log-sigma -> conductivity image (..., nz, ny)
        (sigma = activeCell * exp(m) + bg)."""
        _, _, idx, bg = self._tensors
        msh = self.mesh
        sig = T.scatter_active(T.model_transform(m), idx, msh.n_cell)
        sig = sig + bg.to(m.dtype)
        return sig.reshape(m.shape[:-1] + (msh.nz, msh.ny))

    def predict(self, m: torch.Tensor, fac=None) -> torch.Tensor:
        return self.fwd.predict(self.sigma2d(m), fac=fac)

    def factor_state(self, m: torch.Tensor):
        """Merged-mode factorisation at model m (the trajectory-amortised
        path), batched over m's leading chain axes; callers pass it back as
        ``fac``.  Not differentiated."""
        return self.fwd.factor_at(self.sigma2d(m.detach()))

    def data_misfit(self, m: torch.Tensor, fac=None):
        """0.5 ||W (F(m) - d)||^2 per chain, and the predicted data.  Complex
        residuals count re and im separately; re^2 + im^2 keeps the gradient
        clean where a residual is zero.  ``fac``: an optional stale factor
        (solved to the same accuracy by refinement)."""
        obs, w, _, _ = self._tensors
        pred = self.predict(m, fac=fac)
        res = w * (pred - obs)
        sq = res.real ** 2 + res.imag ** 2 if res.is_complex() else res ** 2
        return 0.5 * sq.sum(dim=-1), pred

    def _inject(self, v: torch.Tensor) -> torch.Tensor:
        _, _, idx, _ = self._tensors
        msh = self.mesh
        full = T.scatter_active(v, idx, msh.n_cell)
        return full.reshape(v.shape[:-1] + (msh.nz, msh.ny))

    def model_norm(self, m: torch.Tensor, m_ref: torch.Tensor) -> torch.Tensor:
        """0.5 (m - mref)' Wm (m - mref), Wm = (Gc A)'(Gc A), matrix-free."""
        return 0.5 * M.cell_gradient_sqnorm(self._inject(m - m_ref))

    def wm_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Wm @ v in active space, batched over v's leading axes."""
        _, _, idx, _ = self._tensors
        full = M.cell_gradient_normal(self._inject(v))
        return full.reshape(v.shape[:-1] + (-1,))[..., idx]

    def wm_dense(self, chunk: int = 512) -> np.ndarray:
        """Dense Wm (n_param x n_param, float64 numpy) for the non-diagonal
        mass matrix (setMassMatrix(invParam), HMCSampler.jl:478-489), built
        on the problem's device ``chunk`` columns at a time."""
        P = self.n_param
        cols = []
        for i in range(0, P, chunk):
            k = min(chunk, P - i)
            eye = torch.zeros(k, P, dtype=torch.float64, device=self.device)
            eye[torch.arange(k), torch.arange(i, i + k)] = 1.0
            cols.append(self.wm_matvec(eye).cpu())
        return torch.cat(cols).numpy().T

    # -- dense-cube data terms (the frequency-sharded path) ------------------
    def cube_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Observations and weights scattered onto the dense (nfreq, nrx,
        ncomp) cube, zeros where unobserved: the cube misfit with these
        weights equals the masked misfit, and its frequency axis splits
        across ranks."""
        d = self.fwd.data
        shape = (d.n_freq, d.n_rx, d.n_comp)
        obs_cube = np.zeros(shape, self.obs.dtype).reshape(-1)
        w_cube = np.zeros(shape, np.float64).reshape(-1)
        obs_cube[d.flat_index] = self.obs
        w_cube[d.flat_index] = self.weights
        return obs_cube.reshape(shape), w_cube.reshape(shape)

    def factor_state_cube(self, m: torch.Tensor, freqs):
        """:meth:`factor_state` over the frequencies ``freqs`` only."""
        return self.fwd.factor_at(self.sigma2d(m.detach()), freqs=freqs)

    def potential_cube(self, m: torch.Tensor, m_ref: torch.Tensor, reg: float,
                       freqs, obs_cube, w_cube, prior_scale: float = 1.0,
                       fac=None):
        """The potential with the data term over the frequencies ``freqs``
        and their rows of :meth:`cube_arrays`.  No collectives here: a rank
        of a k-way frequency split passes ``prior_scale = 1/k``, so that the
        sum over the k ranks of this value and of its gradient is the global
        potential and gradient.  Returns (U, (misfit, mnorm, cube)), the
        cube flattened to (..., nfreq_local * nrx * ncomp).  ``obs_cube``
        and ``w_cube`` are used as they are when they are tensors on the
        problem's device (the sharded sampler's, built once, so its graphs
        capture this eval); arrays are copied to the device in every
        call."""
        dev = self.device
        cube = self.fwd.response_cube(self.sigma2d(m), freqs=freqs, fac=fac)
        # flat and contiguous, as the masked misfit reduces it
        flat = cube.reshape(cube.shape[:-3] + (-1,))
        obs = torch.as_tensor(obs_cube, device=dev).reshape(-1)
        w = torch.as_tensor(w_cube, device=dev).reshape(-1)
        res = w * (flat - obs)
        sq = res.real ** 2 + res.imag ** 2 if res.is_complex() else res ** 2
        misfit = 0.5 * sq.sum(dim=-1)
        mnorm = prior_scale * reg * self.model_norm(m, m_ref)
        return misfit + mnorm, (misfit, mnorm, flat)

    def potential(self, m: torch.Tensor, m_ref: torch.Tensor, reg: float,
                  fac=None):
        """U(m) = data misfit + reg * model norm, the HMC potential energy.
        Returns (U, (misfit, mnorm, pred)); ``fac`` as in
        :meth:`data_misfit`."""
        misfit, pred = self.data_misfit(m, fac=fac)
        mnorm = reg * self.model_norm(m, m_ref)
        return misfit + mnorm, (misfit, mnorm, pred)

    def potential_value_and_grad(self, m: torch.Tensor, m_ref: torch.Tensor,
                                 reg: float, fac=None):
        """((U, aux), dU/dm): one forward and one adjoint solve per system,
        sharing the factorisation (``fac``, if given, for both).  Chains are
        independent, so the gradient of the chain-summed U stacks the
        per-chain gradients."""
        m = m.detach().requires_grad_(True)
        with torch.enable_grad():
            U, aux = self.potential(m, m_ref, reg, fac=fac)
            (g,) = torch.autograd.grad(U.sum(), m)
        return (U.detach(), tuple(a.detach() for a in aux)), g


def build_inverse_problem(mesh: M.TensorMesh2D, data: MTData, obs, err,
                          sigma_start_flat, sigma_fixed=(1e-8,),
                          cfg: SolveConfig | None = None,
                          device=None) -> tuple[InverseProblem, np.ndarray]:
    """Assemble the inverse problem on ``device`` (None: the GPU, raising
    when there is none) and its start model (active log-sigma, numpy).
    Data weights are 1/|err|."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    fwd = make_forward(mesh, data, cfg)
    active_idx, bg = T.active_cells(sigma_start_flat, sigma_fixed)
    weights = 1.0 / np.abs(np.asarray(err))
    prob = InverseProblem(fwd=fwd, obs=np.asarray(obs), weights=weights,
                          active_idx=active_idx, bg_flat=bg)
    m0 = np.log(np.asarray(sigma_start_flat)[active_idx])
    return prob, m0
