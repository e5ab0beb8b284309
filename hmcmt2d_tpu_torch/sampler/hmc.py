"""Hamiltonian Monte Carlo sampler, chains batched.

PyTorch counterpart of ``hmcmt2d_tpu/sampler/hmc.py`` (the reference's
HMCSampler.jl), with the same deliberate choices:

* the trajectory length L is drawn once per iteration and shared by all
  chains; each chain still sees L ~ U{lo..hi} i.i.d. across iterations;
* the gradient at the current state is carried across iterations, so a
  proposal costs L gradient evaluations, not L + 1;
* reflective bounds are a closed-form triangle-wave fold.

Randomness is counter-based: every draw comes from a fresh
``torch.Generator`` seeded from (seed, stream, global index), see
:func:`generator`, so a run split into segments, or resumed from a
checkpoint, gives the same samples as one unbroken run.  A chain shard of a
sharded run (``rows``) draws the numbers of the whole batch and keeps its
own rows, so it equals the single-process run of the same chains.  The
streams differ from ``jax.random``'s; tests hand both sides the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.trace import span


class MassMatrix(NamedTuple):
    """Diagonal or dense-Cholesky mass matrix (setMassMatrix).  Diagonal:
    1-D ``sqrt_m``/``inv_m``; dense: (P, P) lower Cholesky of M and M^-1."""

    sqrt_m: torch.Tensor
    inv_m: torch.Tensor
    diagonal: bool = True

    def draw(self, gen: torch.Generator, shape) -> torch.Tensor:
        """p = sqrtM @ clip(randn, +-2.5) (getMomentumVector)."""
        raw = torch.randn(shape, generator=gen, dtype=self.sqrt_m.dtype,
                          device=self.sqrt_m.device).clamp(-2.5, 2.5)
        if self.diagonal:
            return self.sqrt_m * raw
        return raw @ self.sqrt_m.T

    def apply_inv(self, p: torch.Tensor) -> torch.Tensor:
        if self.diagonal:
            return self.inv_m * p
        return p @ self.inv_m.T

    def kinetic(self, p: torch.Tensor) -> torch.Tensor:
        """0.5 p' M^-1 p (getKineticEnergy)."""
        return 0.5 * (p * self.apply_inv(p)).sum(dim=-1)


def identity_mass(n_param: int, dtype=torch.float64, device=None) -> MassMatrix:
    """Unit mass; ``device=None`` means the GPU, and raises without one."""
    one = torch.ones(n_param, dtype=dtype, device=resolve_device(device))
    return MassMatrix(sqrt_m=one, inv_m=one, diagonal=True)


def dense_mass(Wm: np.ndarray, dtype=torch.float64, device=None) -> MassMatrix:
    """Non-diagonal mass M = Wm via its dense Cholesky factor; ``device=None``
    means the GPU, and raises without one."""
    device = resolve_device(device)
    L = np.linalg.cholesky(np.asarray(Wm))
    Linv = np.linalg.inv(L)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return MassMatrix(sqrt_m=t(L), inv_m=t(Linv.T @ Linv), diagonal=False)


def reflect_bounds(m, p, lo, hi):
    """Reflect positions into [lo, hi], flipping the momentum per reflection
    (closed form of checkParameterBound!): the position folds as a triangle
    wave, the momentum flips where the unfolded position descends."""
    width = hi - lo
    t = torch.remainder(m - lo, 2.0 * width)
    m_new = lo + width - torch.abs(t - width)
    p_new = torch.where(t > width, -p, p)
    return m_new, p_new


class ChainState(NamedTuple):
    """Per-chain carried state (leading dim = chains)."""

    m: torch.Tensor         # (C, P) current log-sigma model
    grad: torch.Tensor      # (C, P) gradient of the potential at m
    misfit: torch.Tensor    # (C,)
    mnorm: torch.Tensor     # (C,)
    pred: torch.Tensor      # (C, D) predicted data at m


class HMCResult(NamedTuple):
    models: torch.Tensor       # (S, C, P) samples (current model per iter)
    stats: torch.Tensor        # (S, C, 4) [misfit, mnorm, kinetic, hamiltonian]
    accepts: torch.Tensor      # (S, C) bool
    pred: torch.Tensor         # (S, C, D) predicted data of the current model
    final: ChainState
    start_stats: torch.Tensor  # (C, 4) initial [misfit, mnorm, ke, h]
    start_pred: torch.Tensor   # (C, D) predicted data of the start model
    lf_steps: torch.Tensor     # (S, C) leapfrog steps per iteration


@dataclasses.dataclass(frozen=True)
class HMCOptions:
    """Sampler controls (reference semantics)."""

    dt: float
    steps_lo: int
    steps_hi: int
    log_sig_lo: float
    log_sig_hi: float
    reg_param: float
    max_step_size: float = 3.0  # position-step clip (HMCSampler.jl:234-243)
    # with a factor_fn (trajectory-amortised factorisation), refactorise the
    # PDE systems every this many leapfrog steps; the steps in between solve
    # with the stale factor and refinement
    refactor_every: int = 4


def _leapfrog(potential_vg: Callable, opts: HMCOptions, mass: MassMatrix,
              state: ChainState, p0, m_ref, n_steps: int, dt,
              factor_fn: Callable | None = None):
    """Leapfrog trajectory of ``n_steps`` steps (proposeLeapfrog): one
    potential gradient per step, the first half-kick from the carried
    gradient.  Returns (proposal state, final momentum).

    ``factor_fn`` (batched model -> factorisation) turns on the
    trajectory-amortised path: the factor is built at the trajectory start
    and at every step k > 0 with k % ``opts.refactor_every`` == 0, and
    ``potential_vg`` then takes it as a third argument (a None from
    ``factor_fn`` makes those evals factor afresh)."""
    p = p0 - 0.5 * dt * state.grad
    m = state.m
    aux, g = (state.misfit, state.mnorm, state.pred), state.grad
    fac = factor_fn(m) if factor_fn is not None else None
    for k in range(n_steps):
        with span("hmc.step"):
            dm = dt * mass.apply_inv(p)
            dm_max = dm.abs().amax(dim=-1, keepdim=True)
            m = m + dm * torch.clamp(opts.max_step_size / dm_max, max=1.0)
            m, p = reflect_bounds(m, p, opts.log_sig_lo, opts.log_sig_hi)
            if factor_fn is not None:
                if k > 0 and k % opts.refactor_every == 0:
                    fac = factor_fn(m)
                (_, aux), g = potential_vg(m, m_ref, fac)
            else:
                (_, aux), g = potential_vg(m, m_ref)
            p = p - (0.5 * dt if k == n_steps - 1 else dt) * g
    misfit, mnorm, pred = aux
    return ChainState(m=m, grad=g, misfit=misfit, mnorm=mnorm, pred=pred), p


def draw_shape(shape, rows: tuple[int, int] | None, n_global: int | None):
    """The shape of a batch draw: ``shape`` itself, or with ``rows`` (a
    chain shard's rows lo:hi of ``n_global`` chains) the global batch's."""
    return tuple(shape) if rows is None else (n_global,) + tuple(shape[1:])


def keep_rows(x: torch.Tensor, rows: tuple[int, int] | None) -> torch.Tensor:
    return x if rows is None else x[rows[0]:rows[1]]


def make_sample_step(potential_vg: Callable, opts: HMCOptions,
                     factor_fn: Callable | None = None,
                     rows: tuple[int, int] | None = None,
                     n_global: int | None = None):
    """The per-iteration kernel, one MH-corrected HMC proposal:
    ``sample_step(state, gen, m_ref, dt, mass, draws=None) -> (new, accept,
    stats, alpha, L)``.  ``draws = (L, p0, u)`` replaces the generator's
    draws (the seam the tests use to hand both frameworks the same numbers).
    ``dt`` and ``mass`` are arguments so that warmup can tune them between
    iterations; ``factor_fn`` as in :func:`_leapfrog`.  ``rows = (lo, hi)``
    makes the batch rows lo:hi of ``n_global`` chains: the step draws the
    momenta and uniforms of all ``n_global`` and keeps its own.
    """

    def sample_step(state: ChainState, gen: torch.Generator, m_ref, dt: float,
                    mass: MassMatrix, draws=None):
        with span("hmc.iteration"):
            c = state.m.shape[0]
            if draws is None:
                with span("hmc.draw"):
                    L = int(torch.randint(opts.steps_lo, opts.steps_hi + 1, (),
                                          generator=gen, device=gen.device))
                    p0 = keep_rows(mass.draw(gen, draw_shape(state.m.shape, rows,
                                                             n_global)), rows)
                    u = keep_rows(torch.rand(draw_shape((c,), rows, n_global),
                                             generator=gen, dtype=torch.float64,
                                             device=gen.device), rows)
            else:
                L, p0, u = draws
            ke0 = mass.kinetic(p0)
            h0 = state.misfit + state.mnorm + ke0
            prop, p1 = _leapfrog(potential_vg, opts, mass, state, p0, m_ref, L, dt,
                                 factor_fn=factor_fn)
            with span("hmc.mh"):
                h1 = prop.misfit + prop.mnorm + mass.kinetic(p1)

                # MH: accept if dH > 0 or u < exp(dH).  A proposal with any
                # non-finite component is never accepted and reports alpha =
                # 0: a finite energy with a non-finite gradient would poison
                # every later trajectory through the carried gradient.
                dh = h0 - h1
                finite = (torch.isfinite(h1) & torch.isfinite(prop.grad).all(dim=-1)
                          & torch.isfinite(prop.m).all(dim=-1))
                accept = finite & ((dh > 0) | (u < torch.exp(dh)))
                alpha = torch.where(finite, torch.exp(torch.clamp(dh, max=0.0)),
                                    torch.zeros_like(dh))

                def pick(a, b):
                    return torch.where(accept.reshape((c,) + (1,) * (a.ndim - 1)), a, b)

                new = ChainState(*(pick(a, b) for a, b in zip(prop, state)))
                h = new.misfit + new.mnorm + ke0
                stats = torch.stack([new.misfit.to(h.dtype), new.mnorm.to(h.dtype),
                                     ke0.to(h.dtype), h], dim=-1)
            return new, accept, stats, alpha, L

    return sample_step


def sample_chain_init(potential_vg: Callable, m0, m_ref) -> ChainState:
    """Potential and gradient at the start model -> initial ChainState."""
    (_, (misfit, mnorm, pred)), g = potential_vg(m0, m_ref)
    return ChainState(m=m0, grad=g, misfit=misfit, mnorm=mnorm, pred=pred)


# the streams of :func:`generator`, one for each use of randomness
STREAM_START_ROW = 0     # run_hmc's start-row momentum (index 0)
STREAM_MAIN = 1          # main-phase iteration, global sample index
STREAM_WARMUP = 2        # warmup iteration, global warmup index (it runs on
                         # through the dense-mass re-adaptation)
STREAM_WARMUP_ROW = 3    # warmup's start-row momentum (index 0)
STREAM_START_MODEL = 4   # random_homogeneous_start (index 0)
STREAM_REFRESH_WARMUP = 5   # tools.refresh_extend: step-size re-adaptation
                            # (JAX's fold_in(key, 777))
STREAM_REFRESH_MAIN = 6     # tools.refresh_extend: extension samples
                            # (JAX's fold_in(key, 778))


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    """A generator keyed on (seed, stream, index), a pure function of the
    three: the ``STREAM_*`` constants name the streams."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _pred_cast(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.complex64 if p.is_complex() else torch.float32)


def run_hmc(potential_vg: Callable, opts: HMCOptions, mass: MassMatrix,
            m0, m_ref, n_samples: int, seed: int,
            sample_dtype=torch.float32, init_state: ChainState | None = None,
            key_offset: int = 0, factor_fn: Callable | None = None,
            rows: tuple[int, int] | None = None,
            n_global: int | None = None, stream: int = STREAM_MAIN) -> HMCResult:
    """Run ``n_samples`` HMC iterations for a batch of chains.

    ``potential_vg(m (C, P), m_ref) -> ((U, (misfit, mnorm, pred)), grad)``
    is the batched potential value-and-grad.  ``init_state`` skips the
    evaluation at ``m0``; ``key_offset`` is the number of samples already
    drawn, so segmented runs reproduce an unbroken one exactly.
    ``factor_fn`` as in :func:`_leapfrog`; ``rows`` and ``n_global`` as in
    :func:`make_sample_step`; iteration i draws from ``generator(seed,
    stream, key_offset + i)``.
    """
    if n_samples < 1:
        raise ValueError("run_hmc needs n_samples >= 1")
    start = init_state if init_state is not None else sample_chain_init(
        potential_vg, m0, m_ref)
    step = make_sample_step(potential_vg, opts, factor_fn=factor_fn, rows=rows,
                            n_global=n_global)
    dev = m0.device
    p_init = mass.draw(generator(seed, STREAM_START_ROW, 0, dev),
                       draw_shape(m0.shape, rows, n_global))
    ke_init = keep_rows(mass.kinetic(p_init), rows)
    h_init = start.misfit + start.mnorm + ke_init
    start_stats = torch.stack([start.misfit.to(h_init.dtype),
                               start.mnorm.to(h_init.dtype),
                               ke_init.to(h_init.dtype), h_init], dim=-1)
    state = start
    models, stats, accepts, preds, lf = [], [], [], [], []
    for i in range(n_samples):
        state, accept, st, _alpha, L = step(
            state, generator(seed, stream, key_offset + i, dev), m_ref,
            opts.dt, mass)
        models.append(state.m.to(sample_dtype))
        stats.append(st)
        accepts.append(accept)
        preds.append(_pred_cast(state.pred))
        lf.append(torch.full((m0.shape[0],), L, dtype=torch.int32, device=dev))
    return HMCResult(models=torch.stack(models), stats=torch.stack(stats),
                     accepts=torch.stack(accepts), pred=torch.stack(preds),
                     final=state, start_stats=start_stats,
                     start_pred=_pred_cast(start.pred), lf_steps=torch.stack(lf))


def random_homogeneous_start(seed: int, m0_file: np.ndarray, n_chains: int,
                             dtype=torch.float64, device=None) -> torch.Tensor:
    """Per-chain randomised homogeneous start model: rho_ref ~ round(U(0.5,
    1.5) rho0) with rho0 from the file's start model (HMCSampler.jl:99-110),
    drawn from stream ``STREAM_START_MODEL``.  Returns (C, P) start models
    (also the reference models, HMCSampler.jl:108-109); ``device=None``
    means the GPU."""
    dev = resolve_device(device)
    rho0 = 1.0 / np.exp(float(np.asarray(m0_file)[0]))
    u = torch.rand(n_chains, generator=generator(seed, STREAM_START_MODEL, 0, dev),
                   dtype=torch.float64, device=dev)
    rho_ref = torch.round(0.5 * rho0 + u * rho0)
    m = torch.log(1.0 / rho_ref).to(dtype)
    return m[:, None].expand(n_chains, len(m0_file)).contiguous()
