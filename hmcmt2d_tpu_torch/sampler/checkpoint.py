"""Periodic checkpoint / resume of a running HMC inversion.

PyTorch counterpart of ``hmcmt2d_tpu/sampler/checkpoint.py``: the same npz
keys and ``FORMAT_VERSION`` layout (the sampler state, the random stream's
position, the adapted step size, the mass matrix and every output so far),
written atomically after each checkpointed segment.  Two differences:

* ``key`` holds the port's generator seed (an int64 array), not a JAX key;
* a ``framework = "torch"`` entry marks the file as the port's.
  :func:`load_checkpoint` refuses a file without it: a JAX run's random
  stream cannot be continued by the port, so its checkpoint cannot resume
  here;
* a ``path`` entry, ``"single"`` or ``"sharded"``, says which kind of run
  wrote it: the sharded run carries the whole response cube as the state's
  predicted data, the single-process one the observed data only, so a
  checkpoint resumes only on the kind of path that wrote it (on any mesh,
  for a sharded one: its state is the gathered, global one).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import to_numpy
from . import hmc as H

FORMAT_VERSION = 3
FRAMEWORK = "torch"
PATHS = ("single", "sharded")


def save_checkpoint(path: str, *, n_done: int, state: H.ChainState, key: int,
                    dt: float, mass: H.MassMatrix, m_ref,
                    models, stats, accepts, pred, lf_steps, start_stats,
                    start_pred, n_warm: int, wall_time: float,
                    path_kind: str = "single") -> None:
    """Atomic (write-then-rename) checkpoint dump; ``key`` is the seed and
    ``path_kind`` one of :data:`PATHS`."""
    if path_kind not in PATHS:
        raise ValueError(f"path_kind {path_kind!r} is not one of {PATHS}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            version=FORMAT_VERSION,
            framework=FRAMEWORK,
            path=path_kind,
            n_done=n_done,
            n_warm=n_warm,
            wall_time=wall_time,
            dt=dt,
            key=np.asarray(key, np.int64),
            state_m=to_numpy(state.m),
            state_grad=to_numpy(state.grad),
            state_misfit=to_numpy(state.misfit),
            state_mnorm=to_numpy(state.mnorm),
            state_pred=to_numpy(state.pred),
            mass_sqrt=to_numpy(mass.sqrt_m),
            mass_inv=to_numpy(mass.inv_m),
            mass_diagonal=bool(mass.diagonal),
            m_ref=to_numpy(m_ref),
            models=to_numpy(models),
            stats=to_numpy(stats),
            accepts=to_numpy(accepts),
            pred=to_numpy(pred),
            lf_steps=to_numpy(lf_steps),
            start_stats=to_numpy(start_stats),
            start_pred=to_numpy(start_pred),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, device, path_kind: str | None = None) -> dict:
    """Load a checkpoint the port wrote: the chain state, mass matrix and
    reference models as tensors on ``device``, the outputs as numpy.  With
    ``path_kind`` it refuses a file that another kind of run wrote."""
    with np.load(path) as z:
        if "framework" not in z.files or str(z["framework"]) != FRAMEWORK:
            raise ValueError(
                f"{path} was not written by hmcmt2d_tpu_torch (no framework="
                f"'{FRAMEWORK}' entry; the JAX package writes none): the "
                "port's random stream differs from jax.random's, so it cannot "
                "continue that run. Resume it with the package that wrote it.")
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        wrote = str(z["path"]) if "path" in z.files else "single"
        if path_kind is not None and wrote != path_kind:
            raise ValueError(
                f"{path} was written by a {wrote} run and cannot resume a "
                f"{path_kind} one (their states carry the predicted data in "
                "different layouts); resume it on the kind of run that wrote it")

        def t(name):
            return torch.as_tensor(z[name], device=device)

        state = H.ChainState(m=t("state_m"), grad=t("state_grad"),
                             misfit=t("state_misfit"), mnorm=t("state_mnorm"),
                             pred=t("state_pred"))
        mass = H.MassMatrix(sqrt_m=t("mass_sqrt"), inv_m=t("mass_inv"),
                            diagonal=bool(z["mass_diagonal"]))
        return dict(
            path=wrote,
            n_done=int(z["n_done"]),
            n_warm=int(z["n_warm"]),
            wall_time=float(z["wall_time"]),
            dt=float(z["dt"]),
            key=int(z["key"]),
            state=state,
            mass=mass,
            m_ref=t("m_ref"),
            models=np.asarray(z["models"]),
            stats=np.asarray(z["stats"]),
            accepts=np.asarray(z["accepts"]),
            pred=np.asarray(z["pred"]),
            lf_steps=np.asarray(z["lf_steps"]),
            start_stats=np.asarray(z["start_stats"]),
            start_pred=np.asarray(z["start_pred"]),
        )
