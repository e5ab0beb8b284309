"""Shared helpers of the parity tests between the PyTorch port
(``hmcmt2d_tpu_torch``) and the JAX package (``hmcmt2d_tpu``).

Inputs are made with numpy from a seed and handed to both sides; data
crosses between the frameworks only as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def relerr(a, b) -> float:
    """max |a - b| / max |b| over numpy-convertible arrays."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def problem_arrays(problem) -> dict:
    """The numpy arrays that describe a JAX ``InverseProblem``, in the form
    ``hmcmt2d_tpu_torch.convert.problem_from_arrays`` takes."""
    mesh, d = problem.mesh, problem.fwd.data
    return dict(y_len=np.asarray(mesh.y_len), z_len=np.asarray(mesh.z_len),
                air_layer=np.asarray(mesh.air_layer),
                origin=np.asarray(mesh.origin), rx_loc=d.rx_loc,
                freqs=d.freqs, data_type=np.asarray(d.data_type),
                data_comp=np.asarray(d.data_comp), freq_id=d.freq_id,
                rx_id=d.rx_id, dt_id=d.dt_id, obs=np.asarray(problem.obs),
                weights=np.asarray(problem.weights),
                active_idx=np.asarray(problem.active_idx),
                bg_flat=np.asarray(problem.bg_flat))


def port_setup(mesh, data):
    """A JAX mesh and ``MTData`` (as ``tests/test_e2e.py::tiny_setup`` makes
    them) rebuilt as the port's, on the CPU."""
    from hmcmt2d_tpu_torch import make_mesh
    from hmcmt2d_tpu_torch.models.data import MTData

    tmesh = make_mesh(np.asarray(mesh.y_len), np.asarray(mesh.z_len),
                      air_layer=np.asarray(mesh.air_layer),
                      origin=np.asarray(mesh.origin), device="cpu")
    tdata = MTData(rx_loc=data.rx_loc, freqs=data.freqs, data_type=data.data_type,
                   data_comp=data.data_comp, freq_id=data.freq_id,
                   rx_id=data.rx_id, dt_id=data.dt_id)
    return tmesh, tdata


def tiny_problems(cfg=None):
    """``tests/test_mass.py``'s tiny problem on both sides: (JAX problem
    under exact complex128 thomas, the port's problem on the CPU under
    ``cfg`` (default the same engine), start model m0)."""
    import jax.numpy as jnp

    from hmcmt2d_tpu.models import forward as F
    from hmcmt2d_tpu.models.posterior import build_inverse_problem
    from hmcmt2d_tpu_torch import convert
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from tests.test_e2e import tiny_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    jprob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                      cfg=F.SolveConfig(jnp.complex128, 0, "thomas"))
    tprob = convert.problem_from_arrays(
        problem_arrays(jprob), cfg or SolveConfig(torch.complex128, 0, "thomas"),
        device="cpu")
    return jprob, tprob, np.asarray(m0)


def jax_problem_with(problem, cfg):
    """The JAX problem rebuilt under another ``SolveConfig``."""
    from hmcmt2d_tpu.models.forward import make_forward
    from hmcmt2d_tpu.models.posterior import InverseProblem

    return InverseProblem(fwd=make_forward(problem.mesh, problem.fwd.data, cfg),
                          obs=problem.obs, weights=problem.weights,
                          active_idx=problem.active_idx, bg_flat=problem.bg_flat)


def realistic(problem, m0: np.ndarray):
    """The JAX problem with observations = its own prediction at m0 plus 3%
    complex noise (numpy seed 0) and errors of 3% of |obs|, as bench.py's
    ``_realistic`` builds them: a posterior whose potential is O(n_data)."""
    import jax
    import jax.numpy as jnp

    obs = np.asarray(jax.jit(problem.predict)(jnp.asarray(m0)))
    rng = np.random.default_rng(0)
    obs = obs * (1 + 0.03 * (rng.standard_normal(len(obs))
                             + 1j * rng.standard_normal(len(obs))) / np.sqrt(2))
    return problem.__class__(fwd=problem.fwd, obs=obs,
                             weights=1.0 / (0.03 * np.abs(obs)),
                             active_idx=problem.active_idx,
                             bg_flat=problem.bg_flat)


def chain_models(m0: np.ndarray, n_chains: int, scale: float = 0.1,
                 seed: int = 0) -> np.ndarray:
    """(C, P) models around m0; chain 0 is m0 itself."""
    rng = np.random.default_rng(seed)
    m = m0 + scale * rng.standard_normal((n_chains, len(m0)))
    m[0] = m0
    return m
