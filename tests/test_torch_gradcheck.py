"""The port's adjoint gradient against finite differences.

``solve_dirichlet``'s autograd Function (forward factor + refined solve,
backward lambda = conj(solve(conj(g))) on the same factor) is checked with
``torch.autograd.gradcheck`` on a small interior system, and the whole
potential gradient with central differences on the small 2-D problem of
tests/test_gradient.py, with and without the tipper (TZY).  The tipper
gradient is also FD-checked on the JAX side and compared across.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.models import forward as TF  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from tests.test_gradient import tiny_problem  # noqa: E402
from tests.torch_parity import problem_arrays  # noqa: E402

EPS = 1e-4        # central-difference step (see tests/test_gradient.py)
FD_RTOL = 2e-4


def _small_system(seed=0):
    rng = np.random.default_rng(seed)
    B, nzi, q = 2, 3, 4
    diag = (4.0 + rng.uniform(0, 1, (B, nzi, q))
            + 1j * rng.uniform(0.1, 1, (B, nzi, q)))
    offy = 1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))
    offz = 1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))
    rhs = rng.standard_normal((B, nzi, q)) + 1j * rng.standard_normal((B, nzi, q))
    return [torch.tensor(a, requires_grad=True) for a in (diag, offy, offz, rhs)]


@pytest.mark.parametrize("refine", [0, 2])
def test_dirichlet_solve_function_gradcheck(refine):
    cfg = TF.SolveConfig(torch.complex128, refine, "thomas")
    inputs = _small_system(refine)
    assert torch.autograd.gradcheck(
        lambda d, oy, oz, b: TF.interior_solve(d, oy, oz, b, cfg),
        inputs, eps=1e-6, atol=1e-8, rtol=1e-6)
    # the forward really solves the system
    d, oy, oz, b = (t.detach() for t in inputs)
    x = TF.interior_solve(d, oy, oz, b, cfg)
    res = TS.apply_interior(TS.InteriorSystem(d, oy, oz), x) - b
    assert float(res.abs().max()) < 1e-12


_PROBLEMS = {}


def _port_problem(comps):
    """(JAX problem, port problem, m0), built once per component set."""
    if comps not in _PROBLEMS:
        jprob, m0 = tiny_problem(comps=comps, data_type="Impedance", nfreq=2)
        _PROBLEMS[comps] = (jprob, convert.problem_from_arrays(
            problem_arrays(jprob), device="cpu"), m0)
    return _PROBLEMS[comps]


@pytest.mark.parametrize("comps", [("ZXY", "ZYX"), ("ZXY", "ZYX", "TZY")])
def test_potential_gradient_vs_fd(comps):
    _, prob, m0 = _port_problem(comps)
    reg = 0.7
    m_ref = torch.as_tensor(m0)
    m = m_ref + 0.05 * torch.as_tensor(np.random.default_rng(1).standard_normal(len(m0)))
    (_, _), g = prob.potential_value_and_grad(m, m_ref, reg)
    assert torch.isfinite(g).all()

    def pot(mm):
        with torch.no_grad():
            return float(prob.potential(mm, m_ref, reg)[0])

    for i in np.random.default_rng(2).choice(len(m0), size=6, replace=False):
        dm = torch.zeros(len(m0), dtype=torch.float64)
        dm[i] = EPS
        fd = (pot(m + dm) - pot(m - dm)) / (2 * EPS)
        np.testing.assert_allclose(float(g[i]), fd, rtol=FD_RTOL, atol=1e-7)


def test_tipper_gradient_vs_fd_on_both_sides():
    """TZY: the directional derivative of each side's potential against its
    own central difference, and the two gradients against each other."""
    comps = ("ZXY", "ZYX", "TZY")
    jprob, prob, m0 = _port_problem(comps)
    v = np.random.default_rng(3).standard_normal(len(m0))
    v /= np.linalg.norm(v)
    eps = 2e-4

    m = torch.as_tensor(m0)
    (_, _), g = prob.potential_value_and_grad(m, m, 0.0)
    with torch.no_grad():
        up = float(prob.potential(m + eps * torch.as_tensor(v), m, 0.0)[0])
        um = float(prob.potential(m - eps * torch.as_tensor(v), m, 0.0)[0])
    np.testing.assert_allclose(float(g.numpy() @ v), (up - um) / (2 * eps), rtol=1e-5)

    jm = jnp.asarray(m0)
    (_, _), jg = jax.jit(lambda a: jprob.potential_value_and_grad(a, jm, 0.0))(jm)
    pot = jax.jit(lambda mm: jprob.potential(mm, jm, 0.0)[0])
    jfd = (float(pot(jm + eps * jnp.asarray(v))) - float(pot(jm - eps * jnp.asarray(v)))) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(jg) @ v), jfd, rtol=1e-5)

    jg = np.asarray(jg)
    assert np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg) < 1e-8
