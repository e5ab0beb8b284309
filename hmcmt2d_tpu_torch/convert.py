"""Carry state across from the JAX package, as numpy arrays.

A problem or a chain state of ``hmcmt2d_tpu`` is described by plain numpy
arrays (pulled out by the caller; this module imports no JAX) and rebuilt
here as the port's objects on a chosen device.

Problem arrays: the mesh (``y_len``, ``z_len``, ``air_layer``, ``origin``),
the ``MTData`` fields (``rx_loc``, ``freqs``, ``data_type``, ``data_comp``,
``freq_id``, ``rx_id``, ``dt_id``), ``obs``, ``weights``, ``active_idx`` and
``bg_flat``.  Chain-state arrays: ``m``, ``grad``, ``misfit``, ``mnorm``,
``pred``.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import make_mesh
from .models.data import MTData
from .models.forward import SolveConfig, make_forward, resolve_device
from .models.posterior import InverseProblem
from .sampler.hmc import ChainState

MESH_KEYS = ("y_len", "z_len", "air_layer", "origin")
DATA_KEYS = ("rx_loc", "freqs", "data_type", "data_comp", "freq_id", "rx_id",
             "dt_id")
PROBLEM_KEYS = MESH_KEYS + DATA_KEYS + ("obs", "weights", "active_idx", "bg_flat")
STATE_KEYS = ("m", "grad", "misfit", "mnorm", "pred")


def problem_from_arrays(arrays: dict, cfg: SolveConfig | None = None,
                        device=None) -> InverseProblem:
    """The port's :class:`InverseProblem` from numpy arrays; ``device`` None
    means the GPU, ``cfg`` None the device's default config."""
    missing = [k for k in PROBLEM_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"problem arrays lack {missing}")
    a = {k: np.asarray(arrays[k]) for k in PROBLEM_KEYS}
    mesh = make_mesh(a["y_len"], a["z_len"], air_layer=a["air_layer"],
                     origin=a["origin"], device=resolve_device(device))
    data = MTData(rx_loc=a["rx_loc"].astype(float), freqs=a["freqs"].astype(float),
                  data_type=str(a["data_type"]),
                  data_comp=tuple(str(c) for c in np.atleast_1d(a["data_comp"])),
                  freq_id=a["freq_id"].astype(np.int64),
                  rx_id=a["rx_id"].astype(np.int64),
                  dt_id=a["dt_id"].astype(np.int64)).validate()
    return InverseProblem(fwd=make_forward(mesh, data, cfg), obs=a["obs"],
                          weights=a["weights"].astype(float),
                          active_idx=a["active_idx"].astype(np.int64),
                          bg_flat=a["bg_flat"].astype(float))


def problem_to_arrays(problem: InverseProblem) -> dict:
    """The inverse of :func:`problem_from_arrays`."""
    mesh, data = problem.mesh, problem.fwd.data
    out = {k: getattr(mesh, k).cpu().numpy() for k in MESH_KEYS}
    out.update(rx_loc=data.rx_loc, freqs=data.freqs,
               data_type=np.asarray(data.data_type),
               data_comp=np.asarray(data.data_comp), freq_id=data.freq_id,
               rx_id=data.rx_id, dt_id=data.dt_id, obs=problem.obs,
               weights=problem.weights, active_idx=problem.active_idx,
               bg_flat=problem.bg_flat)
    return out


def chain_state_from_arrays(arrays: dict, device=None) -> ChainState:
    """A :class:`ChainState` on ``device`` (None: the GPU), dtypes kept."""
    dev = resolve_device(device)
    return ChainState(*(torch.as_tensor(np.asarray(arrays[k]), device=dev)
                        for k in STATE_KEYS))


def chain_state_to_arrays(state: ChainState) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_KEYS}
