"""Startup (configuration) file reader.

Copy of ``hmcmt2d_tpu/io/startup.py``: the key-value format of
readstartupFile.jl (``datafile:``, ``modelfile:``, ``burninsamples:``,
``totalsamples:``, ``resistivity: lo hi std``, ``fixedresistivity:``,
``timeinterval:``, ``timestep: lo hi``, ``linearsolver:``, ``masstype:``,
``smoothparameter:``) with the same extensions (``chains:``, ``seed:``,
``targetaccept:``, ``adapt:``, ``amortize:``, ``warmuppool:``,
``masswarmup:``, ``massdt0:``) and defaults.  Air conductivity 1e-8 is always
in the fixed set (readstartupFile.jl:17).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..constants import SIGMA_AIR
from .data_io import read_data
from .model_io import read_model


@dataclasses.dataclass
class HMCConfig:
    """HMC prior/configuration — the reference's ``HMCPrior``
    (HMCStruct.jl:18-36) with defaults from initHMCPrior (:129-140)."""

    burnin: int = 100
    total_samples: int = 500
    sig_bounds: tuple = (0.01, 10.0)   # conductivity (lo, hi) [S/m]
    sigma_std: float = 0.05
    dt: float = 0.01                   # leapfrog time interval
    timestep: tuple = (10, 15)         # (lo, hi) leapfrog step counts
    linear_solver: str = ""            # accepted for compatibility; unused
    mass_type: str = "diagonal"
    reg_param: float = 1.0
    sig_fix: tuple = (SIGMA_AIR,)
    # extensions (defaults preserve reference behaviour)
    n_chains: int = 1
    seed: int = 0
    adapt: bool = False            # dual-averaging + mass warmup over burnin
    target_accept: float = 0.8
    # trajectory-amortised PDE factorisation: refactor every few leapfrog
    # steps, refine in between.  "amortize: off" forces a fresh
    # factorisation every leapfrog step (the reference's behaviour).
    amortize: bool = True
    # cross-chain pooling of the warmup acceptance statistic: "mean" (Stan)
    # or "median" (robust to a stuck-chain minority; see WarmupOptions)
    warmup_pool: str = "mean"
    # dense-mass schedule (masstype: gaussnewton): after the diagonal
    # warmup, run_inversion builds M = J'W^2J + reg*Wm at the pooled
    # warmed-up model and re-adapts the step size under that fixed metric
    # for `masswarmup:` iterations starting from `massdt0:`
    mass_warmup: int = 100
    mass_dt0: float = 0.2

    @property
    def max_steps(self) -> int:
        return int(self.timestep[1])


def parse_startup(path) -> tuple[HMCConfig, str, str]:
    """Parse the key/value file only; returns (config, datafile, modelfile)."""
    cfg = HMCConfig()
    datafile = modelfile = None
    sig_fix = [SIGMA_AIR]
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            if "datafile:" in line:
                datafile = toks[-1]
            elif "modelfile:" in line:
                modelfile = toks[-1]
            elif "burninsamples:" in line:
                cfg.burnin = int(toks[-1])
            elif "totalsamples:" in line:
                cfg.total_samples = int(toks[-1])
            elif "fixedresistivity:" in line:
                sig_fix.append(1.0 / float(toks[-1]))
            elif "resistivity:" in line:
                rho_min, rho_max = float(toks[-3]), float(toks[-2])
                cfg.sig_bounds = (1.0 / rho_max, 1.0 / rho_min)
                # parsed for parity; the reference computes sigmastd the same
                # way and then never uses it (HMCSampler.jl:82)
                cfg.sigma_std = (np.log(cfg.sig_bounds[1]) - np.log(cfg.sig_bounds[0])) * 0.05
            elif "timeinterval:" in line:
                cfg.dt = float(toks[-1])
            elif "timestep:" in line:
                cfg.timestep = (int(toks[-2]), int(toks[-1]))
            elif "linearsolver:" in line:
                cfg.linear_solver = toks[-1]
            elif "masstype:" in line:
                cfg.mass_type = toks[-1].lower()
            elif "masswarmup:" in line:  # extension: dense-mass dt re-adapt iters
                cfg.mass_warmup = int(toks[-1])
            elif "massdt0:" in line:     # extension: dense-mass da restart dt
                cfg.mass_dt0 = float(toks[-1])
            elif "smoothparameter:" in line:
                cfg.reg_param = float(toks[-1])
            elif "chains:" in line:      # extension: multi-chain count
                cfg.n_chains = int(toks[-1])
            elif "seed:" in line:        # extension: random seed
                cfg.seed = int(toks[-1])
            elif "targetaccept:" in line:  # extension: warmup target accept
                cfg.target_accept = float(toks[-1])
            elif "adapt:" in line:       # extension: warmup adaptation on/off
                cfg.adapt = toks[-1].lower() in ("1", "true", "yes", "on")
            elif "amortize:" in line:    # extension: trajectory-amortised factor
                cfg.amortize = toks[-1].lower() in ("1", "true", "yes", "on")
            elif "warmuppool:" in line:  # extension: warmup alpha pooling
                cfg.warmup_pool = toks[-1].lower()
                if cfg.warmup_pool not in ("mean", "median"):
                    raise ValueError(
                        f"warmuppool must be 'mean' or 'median', got "
                        f"{cfg.warmup_pool!r} ({path})")
    cfg.sig_fix = tuple(sig_fix)
    if datafile is None or modelfile is None:
        raise ValueError(f"startup file {path} must name datafile: and modelfile:")
    return cfg, datafile, modelfile


def read_startup(path, device=None):
    """Parse the config and load data and model (paths relative to the
    startup file's directory), as readstartupFile.jl:4-103.  The mesh goes
    to ``device`` (None: the GPU, and raises without one).

    Returns (config, mesh, sigma2d, data, obs, err).
    """
    cfg, datafile, modelfile = parse_startup(path)
    base = os.path.dirname(os.path.abspath(path))
    data, obs, err = read_data(os.path.join(base, datafile))
    mesh, sigma2d = read_model(os.path.join(base, modelfile), device=device)
    return cfg, mesh, sigma2d, data, obs, err
