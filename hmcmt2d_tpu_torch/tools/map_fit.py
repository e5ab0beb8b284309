"""MAP / misfit-floor diagnosis: what chi^2 per datum can a workload reach?

Minimises the potential (data misfit + reg x smoothness prior) with Adam
over the active-cell log-conductivity, for one or more reg values, and
reports the misfit floor and a per-datum residual breakdown.  It tells a
mixing problem (floor ~ 1: the chains have not got there yet) from a floor
of the model or of the error treatment (floor >> 1: no 2-D conductivity
within the bounds fits the data to their quoted errors).

Counterpart of ``scripts/map_fit.py`` with the same report keys: C =
max(2, chains) Adam runs from the sampler's randomised homogeneous starts,
``torch.optim.Adam`` under ``CosineAnnealingLR(T_max=iters,
eta_min=0.05 lr)`` (optax's ``cosine_decay_schedule(lr, iters,
alpha=0.05)``), non-finite gradient entries zeroed, the models clipped to
the log-conductivity bounds after each step.  ``--seg`` only sets how often
a progress line is printed.  Usage::

    python -m hmcmt2d_tpu_torch.tools.map_fit <startupfile> [--iters N]
        [--regs 1.0,0.01] [--lr 0.03] [--chains 4]
        [--solver thomas|thomas_blocked|bcr|fused]
        [--out out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..device import to_numpy
from ..io.startup import read_startup
from ..models.forward import default_config
from ..models.posterior import build_inverse_problem
from ..sampler import hmc as H
from ..sampler.driver import make_potential_vg
from . import add_device_arg, device_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hmcmt2d_tpu_torch.tools.map_fit",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("startupfile")
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--seg", type=int, default=25,
                    help="iterations between progress lines (x4)")
    ap.add_argument("--regs", default="1.0,0.01")
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "thomas", "thomas_blocked", "bcr", "fused"])
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--out", default="")
    add_device_arg(ap)
    return ap


def adam_fit(vg, m_start: torch.Tensor, m_ref: torch.Tensor, iters: int, lr: float,
             lo: float, hi: float, on_iter=None) -> torch.Tensor:
    """``iters`` steps of cosine-decayed Adam on the potential of ``vg``
    (``vg(m, m_ref) -> ((U, (misfit, mnorm, pred)), grad)``) from
    ``m_start``, clipped to [lo, hi]; ``on_iter(i, misfit)`` follows each
    step.  Returns the final models."""
    m = m_start.detach().clone()
    opt = torch.optim.Adam([m], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=iters,
                                                       eta_min=0.05 * lr)
    for i in range(iters):
        (_U, (mis, _mn, _pred)), g = vg(m, m_ref)
        m.grad = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        opt.step()
        sched.step()
        with torch.no_grad():
            m.clamp_(lo, hi)
        if on_iter is not None:
            on_iter(i, mis)
    return m.detach()


def reg_report(problem, vg, m, m_ref, iters: int) -> dict:
    """The report of one reg value at the final models ``m``: each chain's
    chi^2 per datum (misfit / N) and the best chain's residual breakdown."""
    data = problem.fwd.data
    n_data = len(problem.obs)
    (_U, (mis, _mn, pred)), _g = vg(m, m_ref)
    chain_chi2 = to_numpy(mis) / n_data
    b = int(np.argmin(chain_chi2))
    pred_b = to_numpy(pred)[b]
    r = np.asarray(problem.weights) * (pred_b - np.asarray(problem.obs))
    r2 = np.abs(r) ** 2                      # per-datum chi^2 contribution
    fid = np.asarray(data.freq_id)
    by_freq = {float(np.asarray(data.freqs)[f]): float(r2[fid == f].mean())
               for f in np.unique(fid)}
    return {
        "chi2_per_datum_per_chain": [round(float(c), 4) for c in chain_chi2],
        "chi2_best": round(float(chain_chi2[b]), 4),
        # the artifact summaries use sum|r|^2/N = 2 misfit/N ("chi2 per
        # complex datum"); the chi2_* fields above are misfit/N
        "chi2_artifact_convention_best": round(2 * float(chain_chi2[b]), 4),
        "chi2_quantiles_per_datum": {q: round(float(np.quantile(r2, float(q))), 3)
                                     for q in ("0.5", "0.9", "0.99", "1.0")},
        "chi2_by_freq_mean": {f"{k:.4g}": round(v, 3) for k, v in sorted(by_freq.items())},
        "iters": iters,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = device_of(args)
    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile, device=dev)
    scfg = default_config(dev)
    if args.solver != "auto":
        scfg = dataclasses.replace(scfg, solver_method=args.solver)
    if scfg.solver_method == "fused":
        scfg = dataclasses.replace(scfg, refine_iters=max(args.refine, 1))
    problem, m0 = build_inverse_problem(mesh, data, obs, err, to_numpy(sigma2d).ravel(),
                                        sigma_fixed=cfg.sig_fix, cfg=scfg, device=dev)
    n_data = len(problem.obs)
    # complex data count re and im as 2 residuals in the misfit 0.5 |r|^2,
    # so chi^2 per datum = 2 misfit / (2 ndata) = misfit / ndata
    print(f"[map_fit] {args.startupfile}: {n_data} data, {problem.n_param} params, "
          f"engine={scfg.solver_method}", flush=True)

    C = max(2, args.chains)   # as the JAX tool, so that the reports compare
    rdt = scfg.real_dtype
    m_start = H.random_homogeneous_start(cfg.seed, m0, C, rdt, dev)
    lo, hi = float(np.log(cfg.sig_bounds[0])), float(np.log(cfg.sig_bounds[1]))
    every = max(args.seg, 1) * 4

    report = {"startupfile": args.startupfile, "n_data": n_data,
              "engine": scfg.solver_method, "regs": {}}
    for reg in [float(r) for r in args.regs.split(",")]:
        vg = make_potential_vg(problem, reg if reg > 0 else 1e-6)
        t0 = time.time()

        def progress(i, mis, reg=reg, t0=t0):
            done = i + 1
            if done % every == 0 or done == args.iters:
                print(f"[map_fit] reg={reg}: iter {done}/{args.iters} "
                      f"chi2/datum={float(mis.mean()) / n_data:.3f} "
                      f"({done / (time.time() - t0):.1f} it/s)", flush=True)

        m = adam_fit(vg, m_start, m_start, args.iters, args.lr, lo, hi, progress)
        report["regs"][str(reg)] = rep = reg_report(problem, vg, m, m_start, args.iters)
        print(f"[map_fit] reg={reg}: floor chi2/datum per chain = "
              f"{rep['chi2_per_datum_per_chain']}", flush=True)

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
