"""Posterior summaries and chain output files.

Copy of ``hmcmt2d_tpu/sampler/outputs.py``, byte for byte in its formats:
posterior mean/std models via writeEMModel2D (getPosteriorModel,
HMCSampler.jl:605-642), and per-chain ``hmcsamples_id$i.model`` /
``hmcsamples_id$i.data`` / ``hmcstatistics_id$i.log`` dumps
(outputHMCSamples, HMCSampler.jl:785-828).  Arrays may be tensors on any
device or numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import to_numpy
from ..io.model_io import write_model
from ..models.posterior import InverseProblem


def posterior_mean_std(models, burnin: int):
    """Post-burn-in mean and standard deviation of the log-sigma samples
    (getPosteriorModel, HMCSampler.jl:609-627).  ``models`` is (S, P) or
    (S, C, P); chains are pooled."""
    s = to_numpy(models).astype(np.float64)[burnin:]
    s = s.reshape(-1, s.shape[-1])
    mean = s.mean(axis=0)
    var = np.maximum(s.var(axis=0), np.finfo(float).eps)
    return mean, np.sqrt(var)


def write_posterior_models(problem: InverseProblem, models, burnin: int,
                           outdir: str = "."):
    """meanModel.model holds sigma = exp(mean log-sigma) + background;
    stdModel.model holds the std of log-sigma scattered onto active cells
    (HMCSampler.jl:629-641)."""
    mean, std = posterior_mean_std(models, burnin)
    msh = problem.mesh
    nz, ny = msh.nz, msh.ny

    sig = np.zeros(msh.n_cell)
    sig[problem.active_idx] = np.exp(mean)
    sig += problem.bg_flat
    write_model(os.path.join(outdir, "meanModel.model"), msh, sig.reshape(nz, ny))

    sd = np.zeros(msh.n_cell)
    sd[problem.active_idx] = std
    sd += problem.bg_flat
    write_model(os.path.join(outdir, "stdModel.model"), msh, sd.reshape(nz, ny))
    return mean, std


def write_chain_outputs(models, stats, accepts, pred, start_stats,
                        chain: int = 0, ichain: int = 1, cputime: float = 0.0,
                        outdir: str = ".", start_pred=None, thin: int = 1):
    """Per-chain sample/data/statistics files (outputHMCSamples).

    ``models`` (S, C, P), ``stats`` (S, C, 4), ``accepts`` (S, C),
    ``pred`` (S, C, D), ``start_stats`` (C, 4), ``start_pred`` (C, D);
    ``chain`` selects the batch column, ``ichain`` the 1-based file id.
    ``thin`` > 1 writes every ``thin``-th sample row of the model and
    predicted-data dumps; the statistics log is always written in full.
    """
    models = to_numpy(models)[:, chain]
    stats = to_numpy(stats)[:, chain]
    accepts = to_numpy(accepts)[:, chain]
    pred = to_numpy(pred)[:, chain]
    start = to_numpy(start_stats)[chain]
    S = models.shape[0]

    with open(os.path.join(outdir, f"hmcsamples_id{ichain}.model"), "w") as f:
        for k in range(0, S, thin):
            f.write("".join("%8.4e " % v for v in models[k]) + "\n")

    # S+1 rows: the start-model predicted data first, as the reference writes
    # (outputHMCSamples, HMCSampler.jl:801-808)
    rows = pred[::thin] if start_pred is None else np.concatenate(
        [to_numpy(start_pred)[None, chain], pred[::thin]])
    with open(os.path.join(outdir, f"hmcsamples_id{ichain}.data"), "w") as f:
        for row in rows:
            if np.iscomplexobj(rows):
                f.write("".join("%12.4e %12.4e" % (v.real, v.imag) for v in row) + "\n")
            else:
                f.write("".join("%12.4e" % v for v in row) + "\n")

    n_accept = int(accepts.sum())
    with open(os.path.join(outdir, f"hmcstatistics_id{ichain}.log"), "w") as f:
        f.write("Total elapsed time (s): %8.2f\n" % cputime)
        f.write("Totalsamples: %6d, nAccept: %6d, nReject: %6d\n"
                % (S, n_accept, S - n_accept))
        f.write("Starting status: dtMisfit=%8.1f,mNorm=%8.1f,KEnergy=%8.1f,HEnergy=%8.1f\n"
                % tuple(start))
        f.write("iterNo   dtMisfit  mNorm   KEnergy  HEnergy  Accept \n")
        for k in range(S):
            f.write("%6d %8.4e %8.4e %8.4e %8.4e %2d\n"
                    % (k + 1, stats[k, 0], stats[k, 1], stats[k, 2], stats[k, 3],
                       int(accepts[k])))


def write_thinned_models(problem: InverseProblem, models, chain: int = 0,
                         start: int = 0, step: int = 10, outdir: str = "."):
    """Thinned full conductivity model dumps (outputHMCmodel,
    HMCSampler.jl:760-777)."""
    models = to_numpy(models)[:, chain]
    msh = problem.mesh
    for k in range(start, models.shape[0], step):
        sig = np.zeros(msh.n_cell)
        sig[problem.active_idx] = np.exp(models[k])
        sig += problem.bg_flat
        write_model(os.path.join(outdir, f"hmcmodel_iter{k + 1}.model"),
                    msh, sig.reshape(msh.nz, msh.ny))
