"""The production fused config on the CPU against JAX's, on the tiny flagship.

Port: complex64 factors, refine_iters = 6, float32 ``m``, the kernels'
plain versions.  JAX: the same ``SolveConfig`` with the Pallas kernels in
interpret mode (Q = 32, PANEL = 8, as tests/test_pallas_factor.py runs them).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.models.forward import SolveConfig as JaxConfig  # noqa: E402
from hmcmt2d_tpu.ops import pallas_factor as PF  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import chain_models, jax_problem_with, problem_arrays  # noqa: E402

U_TOL = 1e-4
GRAD_TOL = 1e-3
COS_MIN = 0.9999
FUSED = SolveConfig(torch.complex64, 6, "fused")


@pytest.fixture(scope="module")
def case():
    mp = pytest.MonkeyPatch()
    mp.setattr(PF, "Q", 32)
    mp.setattr(PF, "PANEL", 8)
    mp.setattr(PF, "INTERPRET", True)
    try:
        jprob, m0 = _flagship_problem(tiny=True)
        jfused = jax_problem_with(jprob, JaxConfig(jnp.complex64, 6, "fused"))
        m = chain_models(m0, 2).astype(np.float32)
        (U, aux), g = jax.jit(jax_vg(jfused, 1.0))(jnp.asarray(m), jnp.asarray(m))
        U, g = np.asarray(U), np.asarray(g)
    finally:
        mp.undo()
    tprob = convert.problem_from_arrays(problem_arrays(jprob), cfg=FUSED,
                                        device="cpu")
    m_t = torch.as_tensor(m)
    FF.reset_launches()
    (tU, taux), tg = make_potential_vg(tprob, 1.0)(m_t, m_t)
    return dict(U=U, g=g, aux=aux, tU=tU, tg=tg, taux=taux,
                launches=FF.launches(), tprob=tprob, m=m)


def test_fused_potential_matches_jax(case):
    assert case["tU"].dtype == torch.float64
    rel = np.abs(case["tU"].numpy() - case["U"]) / np.abs(case["U"])
    assert rel.max() < U_TOL
    # the receiver interpolation promotes to complex128 on both sides
    assert case["taux"][2].numpy().dtype == np.asarray(case["aux"][2]).dtype


def test_fused_gradient_matches_jax(case):
    g, tg = case["g"].astype(np.float64), case["tg"].double().numpy()
    assert case["tg"].dtype == torch.float32
    assert np.isfinite(tg).all()
    assert np.linalg.norm(tg - g) / np.linalg.norm(g) < GRAD_TOL
    for a, b in zip(tg, g):
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > COS_MIN


def test_fused_cpu_path_takes_plain_versions(case):
    """On CPU tensors the wrappers run the plain versions: no launch."""
    assert case["launches"] == {"schur_factor": 0, "bt_sweep_fwd": 0,
                                "bt_sweep_bwd": 0}
    assert case["tprob"].fwd.cfg == FUSED
