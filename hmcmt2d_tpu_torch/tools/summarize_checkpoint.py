"""Posterior artifacts from a checkpoint of the port: ``summary.json``, the
mean and std models and the chain statistics logs, so a long checkpointed
run can be snapshotted at any segment boundary.

Counterpart of ``scripts/summarize_checkpoint.py``: the same files and
``summary.json`` keys, from a checkpoint that ``hmcmt2d-torch run`` (single
or sharded) or :mod:`.refresh_extend` wrote.  The posterior-mean prediction
behind ``posterior_mean_nrms`` runs on ``--device`` under its default
engine; a failure there is an error.  Usage::

    python -m hmcmt2d_tpu_torch.tools.summarize_checkpoint \\
        run/checkpoint.npz run/startupfile artifacts/run [--burn N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..device import to_numpy
from ..io.startup import read_startup
from ..models.posterior import build_inverse_problem
from ..sampler import checkpoint as CK
from ..sampler import diagnostics as D
from ..sampler import outputs as O
from . import add_device_arg, device_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hmcmt2d_tpu_torch.tools.summarize_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint")
    ap.add_argument("startupfile")
    ap.add_argument("outdir")
    ap.add_argument("--status", default="")
    ap.add_argument("--burn", type=int, default=0,
                    help="diagnostics burn-in cut (samples incl. warmup); "
                         "overrides the checkpoint's n_warm when larger")
    ap.add_argument("--notes", default="")
    add_device_arg(ap)
    return ap


def summarize(ck: dict, problem, n_cut: int, workload: str, status: str = "",
              notes: str = "") -> dict:
    """The ``summary.json`` of a loaded checkpoint ``ck``: acceptance,
    misfits, R-hat and ESS after ``n_cut`` rows, and the posterior mean's
    fit and anomaly statistics."""
    models, stats, accepts = ck["models"], ck["stats"], ck["accepts"]
    S, Cn, P = models.shape
    n_warm = ck["n_warm"]
    post = models[n_cut:]
    ndata = len(np.asarray(problem.obs))
    misfit = stats[..., 0]
    rhat = np.asarray(D.split_rhat(post)) if S - n_cut >= 4 else None
    ess = np.asarray(D.ess(post)) if S - n_cut >= 4 else None
    etail = np.asarray(D.ess_tail(post)) if S - n_cut >= 8 else None

    # posterior-mean fit, in the solve's real dtype
    mean_m = post.reshape(-1, P).mean(axis=0)
    with torch.no_grad():
        pred = to_numpy(problem.predict(torch.as_tensor(
            mean_m, dtype=problem.fwd.cfg.real_dtype, device=problem.device)))

    # anomaly recovery: per-cell z-score of the posterior mean against the
    # homogeneous start model, in posterior-std units
    mean_full, std_full = O.posterior_mean_std(models, n_cut)
    m_start_log = float(np.median(to_numpy(ck["m_ref"])))
    z = (mean_full - m_start_log) / np.maximum(std_full, 1e-12)
    rho_mean = 1.0 / np.exp(mean_full)

    summary = {
        "samples": int(S),
        "warmup": int(n_warm),
        "diagnostics_burn": int(n_cut),
        "chains": int(Cn),
        "accept_rate": round(float(accepts[n_cut:].mean()), 3),
        "misfit_per_datum_start": round(float(np.asarray(ck["start_stats"])[:, 0].mean())
                                        / ndata * 2, 3),
        "misfit_per_datum_end_per_chain": [
            round(float(misfit[-1, c]) / ndata * 2, 3) for c in range(Cn)],
        "chi2_per_datum_end": round(float(misfit[-1].mean()) / ndata * 2, 3),
        "split_rhat_max": round(float(rhat.max()), 3) if rhat is not None else None,
        "split_rhat_median": round(float(np.median(rhat)), 3) if rhat is not None else None,
        "ess_median": round(float(np.median(ess)), 1) if ess is not None else None,
        "ess_total": round(float(np.sum(ess)), 1) if ess is not None else None,
        "ess_tail_median": (round(float(np.median(etail)), 1)
                            if etail is not None else None),
        "accept_rate_last_quarter": round(
            float(accepts[n_cut + 3 * (S - n_cut) // 4:].mean()), 3),
        "diagnostics": "rank-normalized split-R-hat (bulk+folded max) and "
                       "bulk/tail ESS, Vehtari et al. 2021 "
                       "(sampler/diagnostics.py)",
        "wall_time_s": round(float(ck["wall_time"]), 1),
        "samples_per_sec_total": round(S * Cn / float(ck["wall_time"]), 3),
        "anomaly_zscore_max": round(float(np.abs(z).max()), 2),
        "anomaly_cells_z_gt_2": int(np.sum(np.abs(z) > 2.0)),
        "rho_range_posterior_mean": [round(float(rho_mean.min()), 1),
                                     round(float(rho_mean.max()), 1)],
        "adapted_dt": round(float(ck["dt"]), 5),
        "workload": workload,
        "status": status or ("VALID multi-chain posterior run" if Cn >= 2
                             else "VALID single-chain run"),
        "notes": notes,
    }
    res = (pred - np.asarray(problem.obs)) * np.asarray(problem.weights)
    summary["posterior_mean_nrms"] = round(float(np.sqrt(np.mean(np.abs(res) ** 2))), 3)
    if ck["pred"].size == 0:
        summary["chain_pred"] = "none: the checkpoint holds no predicted data"
    return summary


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = device_of(args)
    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile, device=dev)
    problem, _ = build_inverse_problem(mesh, data, obs, err, to_numpy(sigma2d).ravel(),
                                       sigma_fixed=cfg.sig_fix, device=dev)
    ck = CK.load_checkpoint(args.checkpoint, dev)
    models = ck["models"]          # (S, C, P), warmup rows included
    Cn = models.shape[1]
    os.makedirs(args.outdir, exist_ok=True)

    n_cut = max(ck["n_warm"], args.burn)
    has_pred = ck["pred"].size > 0
    O.write_posterior_models(problem, models, n_cut, args.outdir)
    for c in range(Cn):
        O.write_chain_outputs(models, ck["stats"], ck["accepts"], ck["pred"],
                              ck["start_stats"], chain=c, ichain=c + 1,
                              cputime=ck["wall_time"], outdir=args.outdir,
                              start_pred=ck["start_pred"] if has_pred else None)
        # the checkpoint keeps the per-sample dumps; the artifact keeps the
        # statistics logs only
        for n in (f"hmcsamples_id{c + 1}.model", f"hmcsamples_id{c + 1}.data"):
            p = os.path.join(args.outdir, n)
            if os.path.exists(p):
                os.remove(p)

    summary = summarize(ck, problem, n_cut, args.startupfile, args.status, args.notes)
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
