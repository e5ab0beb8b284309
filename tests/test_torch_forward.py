"""Port parity on the tiny flagship: forward responses, potential, gradient.

The JAX problem is ``__graft_entry__._flagship_problem(tiny=True)`` (CPU
complex128); the port's is carried across with ``convert.problem_from_arrays``
and runs the exact complex128 thomas engine.  C = 2 chains.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.models import forward as JF  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.models import forward as TF  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import chain_models, problem_arrays, relerr  # noqa: E402

TOL = 1e-10
GRAD_TOL = 1e-8


@pytest.fixture(scope="module")
def case():
    jprob, m0 = _flagship_problem(tiny=True)
    tprob = convert.problem_from_arrays(problem_arrays(jprob), device="cpu")
    m = chain_models(m0, 2)
    (U, aux), g = jax.jit(jax_vg(jprob, 1.0))(jnp.asarray(m), jnp.asarray(m))
    return dict(jprob=jprob, tprob=tprob, m=m, m0=m0, U=np.asarray(U),
                aux=[np.asarray(a) for a in aux], g=np.asarray(g))


def test_port_config_is_exact_on_cpu(case):
    cfg = case["tprob"].fwd.cfg
    assert cfg == TF.SolveConfig(torch.complex128, 0, "thomas")
    assert cfg == TF.default_config("cpu")


def test_predict_matches_jax(case):
    pred = case["tprob"].predict(torch.as_tensor(case["m"]))
    assert pred.shape == case["aux"][2].shape
    assert relerr(pred, case["aux"][2]) < TOL


def test_response_cube_and_sigma_match_jax(case):
    jprob, tprob, m = case["jprob"], case["tprob"], case["m"]
    sig_j = jprob.sigma2d(jnp.asarray(m))
    sig_t = tprob.sigma2d(torch.as_tensor(m))
    assert relerr(sig_t, sig_j) < TOL
    cube_j = jax.jit(jprob.fwd.response_cube)(sig_j)
    cube_t = tprob.fwd.response_cube(sig_t)
    assert cube_t.shape == cube_j.shape
    assert relerr(cube_t, cube_j) < TOL


def test_potential_matches_jax(case):
    m = torch.as_tensor(case["m"])
    U, (misfit, mnorm, _) = case["tprob"].potential(m, m.flip(0), 0.7)
    jU, (jmis, jmn, _) = jax.jit(lambda a, b: case["jprob"].potential(a, b, 0.7))(
        jnp.asarray(case["m"]), jnp.asarray(case["m"][::-1].copy()))
    assert relerr(U, jU) < TOL
    assert relerr(misfit, jmis) < TOL
    assert relerr(mnorm, jmn) < TOL


def test_batched_gradient_matches_jax(case):
    m = torch.as_tensor(case["m"])
    (U, aux), g = make_potential_vg(case["tprob"], 1.0)(m, m)
    assert relerr(U, case["U"]) < TOL
    assert g.shape == case["g"].shape
    rel = np.linalg.norm(g.numpy() - case["g"]) / np.linalg.norm(case["g"])
    assert rel < GRAD_TOL


def test_rx_helpers_match_jax(case):
    jprob, tprob = case["jprob"], case["tprob"]
    rx_j = JF.make_rx_interp(jprob.mesh, jprob.fwd.data.rx_loc)
    rx_t = tprob.fwd.rx
    assert rx_t.zid == rx_j.zid
    for name in ("idx", "w0", "w1", "cidx", "c0", "c1"):
        np.testing.assert_allclose(getattr(rx_t, name).numpy(),
                                   getattr(rx_j, name), rtol=0, atol=1e-14)
    rng = np.random.default_rng(3)
    Z = rng.standard_normal((4, 2, 5)) + 1j * rng.standard_normal((4, 2, 5))
    om = 2 * np.pi * np.logspace(1, -1, 4)
    for a, b in zip(TF.impedance_to_rho_phase(torch.as_tensor(om), torch.as_tensor(Z)),
                    JF.impedance_to_rho_phase(jnp.asarray(om), jnp.asarray(Z))):
        assert relerr(a, b) < TOL


def test_response_cube_on_a_frequency_subset(case):
    """``freqs=`` solves only those frequencies: the rows of the full cube,
    also through a factor taken over the same subset."""
    tprob = case["tprob"]
    sig = tprob.sigma2d(torch.as_tensor(case["m"]))
    full = tprob.fwd.response_cube(sig)
    pick = [3, 1]
    freqs = np.asarray(tprob.fwd.data.freqs)[pick]
    sub = tprob.fwd.response_cube(sig, freqs=freqs)
    assert sub.shape == full[..., pick, :, :].shape
    assert relerr(sub, full[..., pick, :, :]) < 1e-12
    fac = tprob.fwd.factor_at(sig, freqs=freqs)
    assert relerr(tprob.fwd.response_cube(sig, freqs=freqs, fac=fac), sub) < 1e-12
