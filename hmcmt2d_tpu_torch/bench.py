"""Benchmark: HMC sampling throughput on the dprism-scale flagship workload.

Counterpart of the JAX package's ``bench.py`` (repo root), on the port's
fused CUDA kernels:

    python3 -m hmcmt2d_tpu_torch.bench [--smoke] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a GPU; ``--smoke``
runs the whole pipeline on the tiny flagship (``--smoke --device cpu`` on
a machine without one).  Prints ONE JSON line with the keys of
``bench.py``'s line, plus ``device`` (the card's ``nvidia-smi`` name and
power limit, or ``cpu``):

value               = HMC samples/s/chip at the best measured chain count
                      (each sample = L ~ U[6,10] leapfrog steps; each step
                      one batched forward + adjoint solve of 11 freqs x 2
                      modes x C chains).  Measured on the production kernel:
                      a dual-averaging warmup (dt + diagonal mass), the
                      Gauss-Newton dense mass, a dt re-adaptation under it,
                      then a timed window of >= 1000 samples.
ess_per_sec_per_chip= effective samples/s (rank-normalized bulk ESS,
                      Vehtari et al. 2021, median over params) over the
                      timed window.
solves_per_sec      = (freq x mode) forward + adjoint system pairs per
                      second, over chain-evals.
nfevals             = gradient evaluations of all chains in the window (the
                      reference's counter, HMCStruct.jl:34), + 1 a chain.
flops_per_sec_est   = the JAX bench's analytic estimate, kept unchanged so
                      the lines compare: ceil(L/4) + 1 factorisations an
                      iteration, each nzi complex q x q inverses; not a
                      count of what the port runs.
vs_baseline         = value over a measured CPU rate of the same solves:
                      the threaded native band LDL^T engine, or where it
                      cannot be built, single-threaded scipy splu.

The window runs in one ``run_hmc`` call: ``seg`` is only the unit of the
sample accounting (the window is a multiple of it, the priming run two of
it).  Every draw is a pure function of (seed, stream, index), so one call
equals any segmentation.  Any failure exits non-zero: there is no fallback
to a cheaper kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .device import to_numpy
from .entry import flagship_problem
from .models.forward import make_forward
from .ops import fused_factor as FF
from .sampler import adapt as A
from .sampler import diagnostics as D
from .sampler import hmc as H
from .sampler.driver import gauss_newton_mass, make_factor_fn, make_potential_vg
from .sampler.graphed import GraphedPotential
from .tools import add_device_arg, device_of

WARMUP_SEED = 7     # the warmup and re-adaptation draws (JAX: PRNGKey(7))
PRIME_SEED = 0      # the priming run (PRNGKey(0))
WINDOW_SEED = 1     # the timed window (PRNGKey(1))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def realistic(problem, m0):
    """``problem`` with observations generated from its own prediction at
    the start model ``m0`` (as float32) plus 3% noise (numpy seed 0;
    complex noise for complex data), errors 3% of |obs|, so the sampler has
    a sane posterior (the flagship's placeholder obs make acceptance
    statistics meaningless).  ``bench.py``'s ``_realistic``, which covers
    complex data only."""
    m0_t = torch.as_tensor(m0, dtype=torch.float32, device=problem.device)
    with torch.no_grad():
        obs = to_numpy(problem.predict(m0_t))
    rng = np.random.default_rng(0)
    if np.iscomplexobj(obs):
        obs = obs.astype(np.complex128)
        noise = rng.standard_normal(len(obs)) + 1j * rng.standard_normal(len(obs))
        obs = obs * (1 + 0.03 * noise / np.sqrt(2))
    else:       # rho / phase: real data
        obs = obs.astype(np.float64) * (1 + 0.03 * rng.standard_normal(len(obs)))
    return dataclasses.replace(problem, obs=obs, weights=1.0 / (0.03 * np.abs(obs)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(problem_factory, n_chains, seg=8, n_warm=0, gn_mass=False, n_readapt=56):
    """The problem (realistic observations), a runner ``run(n_samples,
    seed) -> HMCResult`` of the adapted kernel, and its options;
    ``run.graphed`` says whether CUDA graphs serve its evals (every engine
    on the card, :mod:`.sampler.graphed`).

    With ``n_warm`` > 0, the production adaptation runs first: a
    dual-averaging dt + diagonal mass warmup (``sampler/adapt.py``); with
    ``gn_mass`` then the Gauss-Newton dense mass at the chains' mean model
    (J under the thomas engine, as the JAX bench takes it) and ``n_readapt``
    iterations of dt re-adaptation under that fixed mass, from dt 0.2.  The
    runner starts every run from the adapted state.  The engine is the
    factory's problem's (``bench.py``'s ``method`` is the factory's choice
    here)."""
    problem, m0 = problem_factory()
    problem = realistic(problem, m0)
    # amortisation pays for slow factorisations, not for the fused engine,
    # where a fresh factor beats the stale factor's refinement solves
    amortize = problem.fwd.cfg.solver_method != "fused"
    dev = problem.device
    vg = make_potential_vg(problem, 1.0)
    graphed = isinstance(vg, GraphedPotential)
    factor_fn = make_factor_fn(problem, vg) if amortize else None
    opts = H.HMCOptions(dt=0.03, steps_lo=6, steps_hi=10,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(1.0)), reg_param=1.0)
    rdt = problem.fwd.cfg.real_dtype
    mass = H.identity_mass(len(m0), rdt, dev)
    m_start = torch.as_tensor(m0, dtype=rdt, device=dev).expand(n_chains, -1).contiguous()
    init_state = None

    if n_warm > 0:
        t0 = time.perf_counter()
        wopts = A.WarmupOptions()
        carry = A.warmup_carry_init(vg, opts, m_start, m_start)
        carry, _ = A.warmup_scan(vg, opts, m_start, carry,
                                 A.warmup_keys(WARMUP_SEED, 0, n_warm, dev),
                                 A.window_schedule(n_warm, wopts), wopts,
                                 factor_fn=factor_fn)
        mass, info = A.warmup_finalize(carry)
        opts = dataclasses.replace(opts, dt=float(info.dt))
        init_state = carry.state
        _sync(dev)
        log(f"warmup {n_warm} iterations ({eval_kind(graphed)}): "
            f"{time.perf_counter() - t0:.3f} s, dt {opts.dt:.6g}")

        if gn_mass:
            t0 = time.perf_counter()
            jac_cfg = dataclasses.replace(problem.fwd.cfg, solver_method="thomas")
            jac_problem = dataclasses.replace(
                problem, fwd=make_forward(problem.mesh, problem.fwd.data, jac_cfg))
            # J from its slab graph on the card, as the evals (graphed=None)
            mass = gauss_newton_mass(problem, carry.state.m.mean(dim=0), 1.0,
                                     jac_problem=jac_problem, chunk=128, log=log)
            _sync(dev)
            log(f"Gauss-Newton mass: {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            opts2 = dataclasses.replace(opts, dt=0.2)
            carry, _ = A.warmup_scan(
                vg, opts2, m_start, A.carry_from_state(carry.state, opts2.dt),
                A.warmup_keys(WARMUP_SEED, n_warm, n_readapt, dev),
                np.zeros(n_readapt, bool), dataclasses.replace(wopts, adapt_mass=False),
                factor_fn=factor_fn, fixed_mass=mass)
            _, info2 = A.warmup_finalize(carry)
            opts = dataclasses.replace(opts, dt=float(info2.dt))
            init_state = carry.state
            _sync(dev)
            log(f"re-adaptation {n_readapt} iterations ({eval_kind(graphed)}): "
                f"{time.perf_counter() - t0:.3f} s, dt {opts.dt:.6g}")

    def run(n_samples, seed):
        # exact accounting: the window is whole units of seg, no sample is
        # computed and discarded
        if n_samples % seg:
            raise ValueError(f"n_samples {n_samples} is not a multiple of seg {seg}")
        m = m_start if init_state is None else init_state.m
        return H.run_hmc(vg, opts, mass, m, m_start, n_samples, seed,
                         init_state=init_state, factor_fn=factor_fn)

    run.graphed = graphed
    return problem, run, opts


def eval_kind(graphed: bool) -> str:
    return "graphed" if graphed else "eager"


class Window(NamedTuple):
    """The timed window of :func:`_measure`."""

    problem: object
    result: H.HMCResult
    seconds: float               # host clock, between two synchronisations
    opts: H.HMCOptions
    launches: dict               # fused-kernel launches inside the window
    graphed: bool                # whether a CUDA graph served the evals


def _measure(problem_factory, n_chains, n_samples, seg=8, n_warm=0, gn_mass=False,
             n_readapt=56) -> Window:
    """Build the kernel, prime it with ``2 seg`` samples outside the timed
    window (kernel builds, cuBLAS warm-up), then time ``n_samples``."""
    seg = min(seg, n_samples)
    problem, run, opts = _build(problem_factory, n_chains, seg=seg, n_warm=n_warm,
                                gn_mass=gn_mass, n_readapt=n_readapt)
    graphed = run.graphed
    dev = problem.device
    run(2 * seg, PRIME_SEED)
    _sync(dev)
    before = FF.launches()
    t0 = time.perf_counter()
    res = run(n_samples, WINDOW_SEED)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = FF.launch_delta(before, FF.launches())
    if not bool(torch.isfinite(res.stats).all()):
        raise FloatingPointError("non-finite sampler stats")
    evals = int(res.lf_steps[:, 0].sum()) + (n_warm == 0)   # + the start model's
    log(f"window C={n_chains} x {n_samples} samples: {seconds:.3f} s, {evals} "
        f"batched evals ({eval_kind(graphed)}), {seconds * 1e3 / evals:.2f} ms each; "
        f"launches {launches}")
    return Window(problem, res, seconds, opts, launches, graphed)


def summarize(problem, models, accepts, lf_steps, seconds: float, kernel_dt: float,
              n_warm: int, gn_mass: bool) -> dict:
    """The bench's accounting of a timed window: ``models`` (S, C, P),
    ``accepts`` (S, C) and ``lf_steps`` (S, C) of the window, its wall
    ``seconds`` and the kernel's step size; ``bench.py``'s
    ``measure_ess`` dict, key for key.  Without warmup the ESS reads the
    window's second half."""
    models, accepts, lf = (to_numpy(x) for x in (models, accepts, lf_steps))
    n_samples, n_chains = lf.shape
    nfev = int(lf.sum()) + n_chains          # + the initial evaluation a chain
    n_freq = problem.fwd.data.n_freq
    # each gradient eval: one forward + one adjoint solve per (freq, mode)
    solves = nfev * n_freq * 2
    window = models if n_warm else models[n_samples // 2:]
    ess = float(np.median(D.ess(window)))
    ess_200 = (float(np.median(D.ess(window[:200]))) if window.shape[0] >= 400
               else None)
    # JAX's analytic factorisation FLOPs: ceil(L/4) + init factors an
    # iteration, nzi batched complex inverses (~4 (8/3) q^3 real mult-adds)
    q, nzi = problem.mesh.ny - 1, problem.mesh.nz - 1
    n_fac = int(np.ceil(lf / 4.0).sum()) + n_chains
    flops = n_fac * n_freq * 2 * nzi * (8.0 / 3.0) * 4 * q ** 3
    return {
        "samples_per_sec": round(n_chains * n_samples / seconds, 4),
        "ess_per_sec_per_chip": round(ess / seconds, 4),
        "ess_median": round(ess, 2),
        "ess_median_first200": round(ess_200, 2) if ess_200 is not None else None,
        "ess_window_samples": int(window.shape[0]),
        "kernel_mass": "gauss-newton" if gn_mass else "adapted-diagonal",
        "solves_per_sec": round(solves / seconds, 1),
        "nfevals": nfev,
        "accept_rate": round(float(accepts.mean()), 3),
        "kernel_dt": round(float(kernel_dt), 5),
        "kernel_adapted": bool(n_warm),
        "flops_per_sec_est": round(flops / seconds / 1e9, 1),
    }


def measure_ess(problem_factory, n_chains, n_samples=40, n_warm=0, gn_mass=False,
                n_readapt=56) -> dict:
    """Throughput, effective sample size and solve rate of the kernel that
    ``_build`` adapts (see :func:`summarize`).  With ``gn_mass`` the window
    should hold >= 1000 samples so that the integrated autocorrelation time
    is resolved rather than truncated."""
    w = _measure(problem_factory, n_chains, n_samples, n_warm=n_warm,
                 gn_mass=gn_mass, n_readapt=n_readapt)
    r = w.result
    return summarize(w.problem, r.models, r.accepts, r.lf_steps, w.seconds,
                     w.opts.dt, n_warm, gn_mass)


def _baseline_inputs(problem, n_freq: int):
    """(dy, dz, flat sigma at 0.01 S/m on the active cells, the first
    ``n_freq`` frequencies, a random right-hand side (numpy seed 0)) of the
    CPU baselines."""
    from .utils import cpu_reference as R

    mesh = problem.mesh
    dy = to_numpy(mesh.y_len).astype(float)
    dz = to_numpy(mesh.z_len).astype(float)
    sigma = np.zeros(mesh.n_cell)
    sigma[problem.active_idx] = 0.01
    sigma += problem.bg_flat
    n = len(R.boundary_index(len(dy), len(dz))[0])
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return dy, dz, sigma, np.asarray(problem.fwd.data.freqs)[:n_freq], b


def measure_cpu_baseline(problem, n_freq=11, leapfrog_avg=8.0):
    """Samples/s of the reference-equivalent CPU linear algebra: (L + 1)
    sweeps a sample, each a sparse LU of every (freq, mode) system with a
    forward and an adjoint solve on it (HMCSampler.jl:136-141, 216-263,
    MT2DFwdSolver.jl:140-171).  Single-threaded scipy splu."""
    import scipy.sparse.linalg as spla

    from .utils import cpu_reference as R

    dy, dz, sigma, freqs, b = _baseline_inputs(problem, n_freq)
    ii, _ = R.boundary_index(len(dy), len(dz))
    t0 = time.perf_counter()
    for mode in ("TE", "TM"):
        for f in freqs:
            A_ = R.dense_operator(dy, dz, sigma, mode, 2 * np.pi * f)
            lu = spla.splu(A_[np.ix_(ii, ii)].tocsc())
            lu.solve(b)           # forward solve
            lu.solve(b)           # adjoint solve (factor reuse)
    t_sweep = time.perf_counter() - t0   # one sweep, assembly included
    return 1.0 / ((leapfrog_avg + 1.0) * t_sweep)


def measure_cpu_baseline_native(problem, n_freq=11, leapfrog_avg=8.0, threads=None):
    """Samples/s of the threaded CPU baseline: the native band LDL^T engine
    (``native/band_solver.cc``, the repo's MUMPS equivalent) over the (freq
    x mode) sweep in a thread pool (ctypes releases the GIL), as the
    reference runs MUMPS with many threads (runHMCscript.jl:17-18); the
    frequency-independent matrices assembled once (MT2DFwdSolver.jl:124-135).
    None when the native library cannot be built or loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from . import native as N
    from .utils import cpu_reference as R

    if not N.available():
        return None
    dy, dz, sigma, freqs, b = _baseline_inputs(problem, n_freq)
    nyi = len(dy) - 1
    ii, _ = R.boundary_index(len(dy), len(dz))
    parts = {mode: R.assemble_mode_matrices(dy, dz, sigma, mode) for mode in ("TE", "TM")}

    def one_system(args):
        mode, f = args
        dgrad, mnode = parts[mode]
        A_ = (dgrad + 1j * (2 * np.pi * f) * mnode).tocsr()[np.ix_(ii, ii)]
        n = A_.shape[0]
        band = np.zeros((n, nyi + 1), np.complex128)
        band[:, 0] = A_.diagonal(0)
        band[: n - 1, 1] = A_.diagonal(-1)
        band[: n - nyi, nyi] = A_.diagonal(-nyi)
        with N.BandFactorization(band) as fac:
            fac.solve(b)   # forward
            fac.solve(b)   # adjoint (factor reuse)

    tasks = [(mode, f) for mode in ("TE", "TM") for f in freqs]
    threads = threads or min(len(tasks), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one_system, tasks))  # warm (thread spin-up, page-in)
        t0 = time.perf_counter()
        list(pool.map(one_system, tasks))
        t_sweep = time.perf_counter() - t0
    return 1.0 / ((leapfrog_avg + 1.0) * t_sweep)


def device_name(device: torch.device) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def unit_of(problem, smoke: bool) -> str:
    """The line's ``unit``: what a sample was measured on."""
    cfg, dev = problem.fwd.cfg, problem.device.type
    if smoke:
        return f"samples/s (smoke: tiny problem, {dev})"
    engine = ("fused CUDA kernels (schur_factor, bt_sweep_fwd, bt_sweep_bwd)"
              if cfg.solver_method == "fused"
              else f"{cfg.solver_method} engine, {str(cfg.solve_dtype).split('.')[-1]}")
    return (f"samples/s (dprism-scale: 96x56 mesh, 11 freqs, TE+TM merged solve; "
            f"{engine} on {dev})")


def report(stats: dict, sweep: dict, cpu_sps: float, cpu_native_sps: float | None,
           unit: str, device: str) -> dict:
    """The bench's JSON line from the primary run's ``stats``, the chain
    sweep's samples/s and the CPU baselines."""
    best = max([v for v in sweep.values() if v] + [stats["samples_per_sec"]])
    base = cpu_native_sps or cpu_sps
    out = {
        "metric": "hmc_samples_per_sec_per_chip",
        "value": best,
        "unit": unit,
        "vs_baseline": round(best / base, 2),
        "baseline_note": ("threaded native band-LDLT CPU pipeline (this repo's "
                          "MUMPS-equivalent engine; ref runs MUMPS with 48 MKL "
                          "threads)" if cpu_native_sps else
                          "single-threaded scipy splu"),
        "cpu_samples_per_sec_scipy_1t": round(cpu_sps, 4),
        "cpu_samples_per_sec_native_mt": (round(cpu_native_sps, 4)
                                          if cpu_native_sps else None),
        "chains_sweep": sweep,
        "device": device,
    }
    out.update(stats)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hmcmt2d_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the whole pipeline on the tiny flagship")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    FF.reset_launches()
    # complex64 solves are held to float32 accuracy: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def factory():
        return flagship_problem(tiny=args.smoke, device=dev)

    full = dev.type == "cuda" and not args.smoke
    base_chains = 8 if full else 1
    # the production kernel: warmup, the Gauss-Newton mass and a >= 1000
    # sample window on the card; a short adapted-diagonal run elsewhere
    if full:
        stats = measure_ess(factory, base_chains, n_samples=1008, n_warm=104,
                            gn_mass=True)
    else:
        stats = measure_ess(factory, base_chains, n_samples=4 if args.smoke else 8,
                            n_warm=4)
    sweep = {str(base_chains): stats["samples_per_sec"]}

    problem, _ = factory()
    nf = problem.fwd.data.n_freq if args.smoke else 11
    cpu_sps = measure_cpu_baseline(problem, n_freq=nf)
    cpu_native_sps = measure_cpu_baseline_native(problem, n_freq=nf)

    if full:
        for c in (12, 16):
            w = _measure(factory, c, 16)
            sweep[str(c)] = round(c * 16 / w.seconds, 4)

    log(f"launches over the run: {FF.launches()}")
    print(json.dumps(report(stats, sweep, cpu_sps, cpu_native_sps,
                            unit_of(problem, args.smoke), device_name(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
