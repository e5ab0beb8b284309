"""Warmup adaptation: dual-averaging step size + diagonal mass estimation.

PyTorch counterpart of ``hmcmt2d_tpu/sampler/adapt.py``: Nesterov dual
averaging of the log step size toward a target acceptance (Hoffman & Gelman
2014, Algorithm 5) and windowed diagonal mass estimation from the warmup
draws (Stan's expanding slow windows, shrunk toward unit mass).  All chains
in the batch are pooled for the acceptance statistic and the variance; with
a ``pool`` (the chains process group of a sharded run) all chains of every
rank are, so the sharded warmup adapts like the single-process one of the
same chains.

The warmup is a Python loop over iterations; the step size, the mass and
the window sums are tensors carried in a :class:`WarmupCarry`, and the
window ends are a precomputed boolean schedule.  Iteration i draws from
``generator(seed, STREAM_WARMUP, i)``, so a warmup split into segments is
bit-exact with one unbroken warmup.  All adapter state has the models'
dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.collectives import all_gather_cat, chain_rows
from ..utils.trace import span
from .hmc import (STREAM_WARMUP, STREAM_WARMUP_ROW, ChainState, HMCOptions,
                  HMCResult, MassMatrix, generator, make_sample_step,
                  sample_chain_init, _pred_cast)


@dataclasses.dataclass(frozen=True)
class WarmupOptions:
    """Dual-averaging and window-schedule controls (Stan defaults)."""

    target_accept: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75
    init_buffer: int = 75    # iterations before the first mass window
    term_buffer: int = 50    # step-size-only iterations at the end
    base_window: int = 25    # first mass window length (doubles each window)
    adapt_mass: bool = True
    # cross-chain pooling of the dual-averaging acceptance statistic:
    # "mean" (Stan's choice) or "median", robust to a minority of stuck
    # chains, which under "mean" drag the pooled alpha below the target and
    # the step size toward zero for every chain
    alpha_pool: str = "mean"


def window_schedule(n_warmup: int, w: WarmupOptions) -> np.ndarray:
    """Boolean array marking the last iteration of each mass window.

    Stan's schedule: ``init_buffer`` fast iterations, then doubling slow
    windows, then ``term_buffer`` fast iterations.  For short warmups the
    buffers are shrunk proportionally (as Stan does).
    """
    ends = np.zeros(n_warmup, bool)
    init_b, term_b, base = w.init_buffer, w.term_buffer, w.base_window
    if n_warmup < init_b + term_b + base:
        scale = n_warmup / (init_b + term_b + base)
        init_b = max(1, int(init_b * scale))
        term_b = max(1, int(term_b * scale))
        base = max(2, n_warmup - init_b - term_b)
    pos = init_b
    size = base
    last = n_warmup - term_b
    while pos < last:
        end = pos + size
        # if the next (doubled) window would not fit, absorb the remainder
        if end + 2 * size > last:
            end = last
        ends[min(end, last) - 1] = True
        pos = end
        size *= 2
    return ends


class _DualAvg(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_init(dt0: torch.Tensor) -> _DualAvg:
    log_eps = torch.log(dt0)
    return _DualAvg(log_eps=log_eps, log_eps_avg=log_eps,
                    h_avg=torch.zeros_like(log_eps), t=torch.zeros_like(log_eps),
                    mu=math.log(10.0) + log_eps)


def _da_update(da: _DualAvg, alpha_mean, w: WarmupOptions) -> _DualAvg:
    t = da.t + 1.0
    eta = 1.0 / (t + w.t0)
    h_avg = (1.0 - eta) * da.h_avg + eta * (w.target_accept - alpha_mean)
    log_eps = da.mu - torch.sqrt(t) / w.gamma * h_avg
    wk = t ** (-w.kappa)
    log_eps_avg = wk * log_eps + (1.0 - wk) * da.log_eps_avg
    return _DualAvg(log_eps=log_eps, log_eps_avg=log_eps_avg, h_avg=h_avg,
                    t=t, mu=da.mu)


class WarmupInfo(NamedTuple):
    dt: torch.Tensor          # adapted step size (dual-averaged)
    inv_m: torch.Tensor       # (P,) adapted diagonal inverse mass
    alpha_mean: torch.Tensor  # running mean acceptance probability


class WarmupCarry(NamedTuple):
    """Full adapter state carried across warmup segments."""

    state: ChainState
    da: _DualAvg
    inv_m: torch.Tensor
    acc: tuple          # (n, sum m, sum m^2) of the open window
    alpha_acc: tuple    # (iterations, sum of pooled alphas)


def carry_from_state(state: ChainState, dt: float) -> WarmupCarry:
    """A fresh adapter at ``state``: dual averaging started at ``dt``, unit
    diagonal mass, no window or acceptance sums yet."""
    P = state.m.shape[-1]
    kw = dict(dtype=state.m.dtype, device=state.m.device)
    da0 = _da_init(torch.tensor(dt, **kw))
    acc0 = (torch.zeros((), **kw), torch.zeros(P, **kw), torch.zeros(P, **kw))
    alpha_acc0 = (torch.zeros((), **kw), torch.zeros((), **kw))
    return WarmupCarry(state, da0, torch.ones(P, **kw), acc0, alpha_acc0)


def warmup_carry_init(potential_vg, opts: HMCOptions, m0, m_ref) -> WarmupCarry:
    return carry_from_state(sample_chain_init(potential_vg, m0, m_ref), opts.dt)


def warmup_keys(seed: int, it_offset: int, n: int, device,
                stream: int = STREAM_WARMUP) -> list[torch.Generator]:
    """Generators of warmup iterations [it_offset, it_offset + n) of
    ``stream``, a pure function of the global iteration index
    (segmentation-invariant)."""
    return [generator(seed, stream, it_offset + i, device) for i in range(n)]


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median over axis 0: the mean of the two middle values when
    the count is even (``torch.median`` takes the lower one)."""
    v = torch.sort(x, dim=0).values
    n = v.shape[0]
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def warmup_scan(potential_vg: Callable, opts: HMCOptions, m_ref,
                carry: WarmupCarry, keys: Sequence, ends, w: WarmupOptions,
                sample_dtype=torch.float32, factor_fn: Callable | None = None,
                fixed_mass: MassMatrix | None = None, draws: Sequence | None = None,
                pool=None):
    """One warmup segment: ``len(keys)`` adaptation iterations, iteration i
    drawing from the generator ``keys[i]`` and closing a mass window where
    ``ends[i]``.

    With ``fixed_mass`` the kernel samples under that (possibly dense) mass
    and only the step size adapts: the re-adaptation phase of the
    Gauss-Newton / Wm schedule (pass ``ends`` all False).  ``draws[i] =
    (L, p0, u)`` replaces iteration i's random draws (the tests' seam).

    ``pool`` (a process group whose ranks hold consecutive chain shards of
    equal size, in rank order) pools the statistics over every chain of the
    group: each pooled mean or median is taken over the rows gathered from
    every rank, the same operation on the same (C, ...) batch as the
    single-process warmup, so the two agree bit for bit (a sum of per-rank
    sums rounds otherwise, and in float32 the adapted step size then drifts
    by ~1e-3); the window shrinkage counts the global chains, and each rank
    draws the global batch's numbers and keeps its rows.

    Returns the advanced :class:`WarmupCarry` and the per-iteration outputs
    stacked: (models, stats, accepts, pred, lf_steps)."""
    C = m_ref.shape[0]
    rows, n_global = chain_rows(pool, C)
    step = make_sample_step(potential_vg, opts, factor_fn=factor_fn, rows=rows,
                            n_global=n_global)

    def pooled(x):
        return x if pool is None else all_gather_cat(x, pool)

    def pool_mean(x):
        return pooled(x).mean(dim=0)

    def pool_alpha(alpha):
        return _median(pooled(alpha)) if w.alpha_pool == "median" else pool_mean(alpha)

    state, da, inv_m, (n, s1, s2), (an, asum) = carry
    rdt = da.log_eps.dtype
    outs = []
    for i, (gen, is_end) in enumerate(zip(keys, ends)):
        mass = fixed_mass if fixed_mass is not None else MassMatrix(
            sqrt_m=torch.rsqrt(inv_m), inv_m=inv_m, diagonal=True)
        new, accept, stats, alpha, L = step(
            state, gen, m_ref, torch.exp(da.log_eps), mass,
            draws=None if draws is None else draws[i])
        state = new
        with span("adapt.update"):
            # a diverged trajectory (non-finite dH) is a rejection with
            # acceptance probability 0: one NaN would poison dual averaging
            alpha = torch.where(torch.isfinite(alpha), alpha, torch.zeros_like(alpha))
            alpha_mean = pool_alpha(alpha).to(rdt)
            da = _da_update(da, alpha_mean, w)

            n = n + 1.0
            s1 = s1 + pool_mean(new.m)
            s2 = s2 + pool_mean(new.m * new.m)
            if bool(is_end):
                # pooled variance over the window's draws of all chains, shrunk
                # toward unit mass; dual averaging restarts at the current step
                mean = s1 / n
                var = torch.clamp(s2 / n - mean * mean, min=1e-12)
                cnt = n * n_global
                inv_m = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
                da = _da_init(torch.exp(da.log_eps))
                n, s1, s2 = torch.zeros_like(n), torch.zeros_like(s1), torch.zeros_like(s2)

            an, asum = an + 1.0, asum + alpha_mean
            outs.append((new.m.to(sample_dtype), stats, accept, _pred_cast(new.pred),
                         torch.full((C,), L, dtype=torch.int32, device=new.m.device)))
    carry = WarmupCarry(state, da, inv_m, (n, s1, s2), (an, asum))
    return carry, tuple(torch.stack(o) for o in zip(*outs))


def warmup_finalize(carry: WarmupCarry) -> tuple[MassMatrix, WarmupInfo]:
    """Adapted mass matrix and step-size/acceptance info from a carry."""
    da, inv_m = carry.da, carry.inv_m
    an, asum = carry.alpha_acc
    mass = MassMatrix(sqrt_m=torch.rsqrt(inv_m), inv_m=inv_m, diagonal=True)
    info = WarmupInfo(dt=torch.exp(da.log_eps_avg), inv_m=inv_m,
                      alpha_mean=asum / torch.clamp(an, min=1.0))
    return mass, info


def start_row(state0: ChainState, seed: int, shape, dtype=torch.float32):
    """The reference's "Starting status" row: the pre-warmup state with the
    kinetic energy drawn under the initial identity mass
    (HMCSampler.jl:113-115,810-827), from stream ``STREAM_WARMUP_ROW``."""
    dev = state0.m.device
    inv_m0 = torch.ones(shape[-1:], dtype=dtype, device=dev)
    mass0 = MassMatrix(sqrt_m=torch.rsqrt(inv_m0), inv_m=inv_m0, diagonal=True)
    ke = mass0.kinetic(mass0.draw(generator(seed, STREAM_WARMUP_ROW, 0, dev), shape))
    h = state0.misfit + state0.mnorm + ke
    start_stats = torch.stack([state0.misfit.to(h.dtype), state0.mnorm.to(h.dtype),
                               ke.to(h.dtype), h], dim=-1)
    return start_stats, _pred_cast(state0.pred)


def warmup(potential_vg: Callable, opts: HMCOptions, m0, m_ref, n_warmup: int,
           seed: int, w: WarmupOptions | None = None, sample_dtype=torch.float32,
           init_state: ChainState | None = None, factor_fn: Callable | None = None,
           fixed_mass: MassMatrix | None = None):
    """Adaptive warmup phase in one segment (see ``warmup_scan`` for the
    segmented building blocks that run_inversion uses).

    Returns ``(result, state, mass, info)``: per-iteration records (an
    :class:`HMCResult`, so warmup draws appear in the output files like the
    reference's burn-in), the final chain state, the adapted
    :class:`MassMatrix` and a :class:`WarmupInfo` with the adapted step size.
    """
    w = w or WarmupOptions()
    carry0 = warmup_carry_init(potential_vg, opts, m0, m_ref)
    if init_state is not None:
        carry0 = carry0._replace(state=init_state)
    state0 = carry0.state
    ends = window_schedule(n_warmup, w) if (w.adapt_mass and fixed_mass is None) \
        else np.zeros(n_warmup, bool)
    keys = warmup_keys(seed, 0, n_warmup, m0.device)
    carry, (models, stats, accepts, pred, lf) = warmup_scan(
        potential_vg, opts, m_ref, carry0, keys, ends, w,
        sample_dtype=sample_dtype, factor_fn=factor_fn, fixed_mass=fixed_mass)
    mass, info = warmup_finalize(carry)
    if fixed_mass is not None:
        mass = fixed_mass
    start_stats, start_pred = start_row(state0, seed, m0.shape, m0.dtype)
    result = HMCResult(models=models, stats=stats, accepts=accepts, pred=pred,
                       final=carry.state, start_stats=start_stats,
                       start_pred=start_pred, lf_steps=lf)
    return result, carry.state, mass, info
