"""Plain reference of one HMC iteration and of the warmup's adaptation.

Written for the benchmark in plain PyTorch from the semantics of the
HMCMT2D reference sampler (HMCSampler.jl: leapfrog with a step clip of 3
and reflective bounds, the Metropolis test) and of Stan's warmup (Hoffman &
Gelman 2014, Algorithm 5: dual averaging of log dt; windowed diagonal mass
shrunk toward 1e-3).  It imports nothing of the program under test.

The draws of an iteration are inputs that the benchmark makes from the
run's seed by the counter-based recipe the program documents for its
sampler: a torch generator on the device seeded from numpy's
``SeedSequence([seed, stream, index])``, drawing L, then the clipped
normals of the momenta, then the uniforms of the Metropolis test.
"""

from __future__ import annotations

import numpy as np
import torch

STREAM_MAIN = 1       # a main-phase iteration, by its global index
STREAM_WARMUP = 2     # a warmup iteration, by its global index


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, stream, index]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def draws(seed: int, stream: int, index: int, shape, steps, device,
          dtype=torch.float32):
    """(L, raw, u) of one iteration: L ~ U{lo..hi}, raw normals clipped to
    +-2.5 in the mass's ``dtype`` (the momenta before the mass; float32
    where the program solves in complex64), u float64 uniforms."""
    gen = generator(seed, stream, index, device)
    L = int(torch.randint(steps[0], steps[1] + 1, (), generator=gen, device=device))
    raw = torch.randn(shape, generator=gen, dtype=dtype, device=device).clamp(-2.5, 2.5)
    u = torch.rand(shape[:1], generator=gen, dtype=torch.float64, device=device)
    return L, raw, u


def reflect(m, p, lo, hi):
    """Fold m into [lo, hi] as a triangle wave; p flips where it descends."""
    width = hi - lo
    t = torch.remainder(m - lo, 2.0 * width)
    return lo + width - torch.abs(t - width), torch.where(t > width, -p, p)


def trajectory(vg, m0, g0, p0, n_steps, dt, inv_mass, bounds, max_step=3.0):
    """Leapfrog from (m0, p0) with the gradient g0 at m0: ``vg(m) -> (U,
    aux, g)``; ``inv_mass(p)`` applies M^-1.  Returns (m, p, U, aux, g) at
    the end."""
    p = p0 - 0.5 * dt * g0
    m = m0
    for k in range(n_steps):
        dm = dt * inv_mass(p)
        m = m + dm * torch.clamp(max_step / dm.abs().amax(-1, keepdim=True), max=1.0)
        m, p = reflect(m, p, *bounds)
        U, aux, g = vg(m)
        p = p - (0.5 * dt if k == n_steps - 1 else dt) * g
    return m, p, U, aux, g


def kinetic(p, inv_mass):
    return 0.5 * (p * inv_mass(p)).sum(-1)


def mh(h0, h1, finite, u):
    """(accept, alpha, margin): accept iff finite and log u < dH; alpha =
    exp(min(dH, 0)), 0 where not finite; margin = |dH - log u|."""
    dh = h0 - h1
    accept = finite & ((dh > 0) | (u < torch.exp(dh)))
    alpha = torch.where(finite, torch.exp(torch.clamp(dh, max=0.0)), torch.zeros_like(dh))
    return accept, alpha, (dh - torch.log(u)).abs()


def median(x):
    """numpy's median over the chains: the mean of the middle two."""
    v = torch.sort(x).values
    n = v.shape[0]
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def adapt(da, window, inv_m, a, new_m, is_end, n_chains, w):
    """One warmup iteration's adaptation.  ``da`` = (log_eps, log_eps_avg,
    h_avg, t, mu), ``window`` = (n, sum m, sum m^2), ``a`` the pooled
    acceptance probability, ``new_m`` the chains' new states, ``w`` the
    warmup options (target_accept, gamma, t0, kappa).  At the end of a mass
    window the pooled variance, shrunk toward 1e-3, becomes the inverse
    mass and dual averaging restarts at the current step.  Returns (da,
    window, inv_m)."""
    log_eps, log_eps_avg, h_avg, t, mu = da
    t = t + 1.0
    eta = 1.0 / (t + w["t0"])
    h_avg = (1 - eta) * h_avg + eta * (w["target_accept"] - a)
    log_eps = mu - torch.sqrt(t) / w["gamma"] * h_avg
    wk = t ** (-w["kappa"])
    log_eps_avg = wk * log_eps + (1 - wk) * log_eps_avg
    n, s1, s2 = window
    n, s1, s2 = n + 1.0, s1 + new_m.mean(0), s2 + (new_m * new_m).mean(0)
    if is_end:
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=1e-12)
        cnt = n * n_chains
        inv_m = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
        log_eps = torch.log(torch.exp(log_eps))
        log_eps_avg, h_avg, t = log_eps, torch.zeros_like(h_avg), torch.zeros_like(t)
        mu = np.log(10.0) + log_eps
        n, s1, s2 = torch.zeros_like(n), torch.zeros_like(s1), torch.zeros_like(s2)
    return (log_eps, log_eps_avg, h_avg, t, mu), (n, s1, s2), inv_m


def implied_acceptance(da0, log_eps1, w):
    """The pooled acceptance probability that moved dual averaging from
    ``da0`` to the step ``log_eps1`` (the update above, solved for a)."""
    log_eps, log_eps_avg, h_avg, t, mu = da0
    t = t + 1.0
    eta = 1.0 / (t + w["t0"])
    h1 = (mu - log_eps1) * w["gamma"] / torch.sqrt(t)
    return w["target_accept"] - (h1 - (1 - eta) * h_avg) / eta
