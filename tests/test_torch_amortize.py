"""Trajectory amortisation in the port: a stale factor with refinement
(``SolveConfig.stale_refine_iters``), ``factor_state`` and ``factor_fn``.

Tolerances: 1e-8 relative between a stale and a fresh factor (10
refinement steps at a 2% model drift contract far below that in
complex128); the leapfrog against JAX's takes ``tests/test_torch_hmc.py``'s
(1e-10, gradients 1e-8).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.sampler import hmc as JH  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_factor_fn as jax_factor_fn  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch.sampler import hmc as TH  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import (make_factor_fn,  # noqa: E402
                                              make_potential_vg)
from tests.torch_parity import relerr, tiny_problems  # noqa: E402

STALE_TOL = 1e-8
TOL, GRAD_TOL = 1e-10, 1e-8
OPTS = dict(dt=0.02, steps_lo=5, steps_hi=5, log_sig_lo=float(np.log(1e-4)),
            log_sig_hi=float(np.log(10.0)), reg_param=1.0, refactor_every=2)
L = 5


@pytest.fixture(scope="module")
def case():
    jprob, tprob, m0 = tiny_problems()
    rng = np.random.default_rng(4)
    m = m0 + 0.05 * rng.standard_normal((2, len(m0)))
    p0 = np.clip(rng.standard_normal(m.shape), -2.5, 2.5)
    jv = jax_vg(jprob, 1.0)
    jm = jnp.asarray(m)
    jstate = JH.sample_chain_init(jv, jm, jm)
    jopts = JH.HMCOptions(**OPTS)
    prop, p1 = jax.jit(lambda st, p: JH._leapfrog(
        jv, jopts, JH.identity_mass(m.shape[1]), st, p, jm, L, jopts.dt,
        factor_fn=jax_factor_fn(jprob)))(jstate, jnp.asarray(p0))
    # JAX's potential with a factor built at m + 0.02
    stale_U, _ = jax.jit(lambda mm, mf: jprob.potential(
        mm, mm, 1.0, fac=jprob.factor_state(mf)))(jm, jm + 0.02)
    return dict(tprob=tprob, m=m, p0=p0, prop=prop, p1=np.asarray(p1),
                stale_U=np.asarray(stale_U))


def test_stale_factor_matches_fresh(case):
    prob = case["tprob"]
    m = torch.as_tensor(case["m"])
    stale = prob.factor_state(m + 0.02 * torch.sin(torch.arange(m.shape[1])))
    (U, (_, _, pred)), g = prob.potential_value_and_grad(m, m, 1.0)
    (Us, (_, _, preds)), gs = prob.potential_value_and_grad(m, m, 1.0, fac=stale)
    assert relerr(Us, U) < STALE_TOL
    assert relerr(preds, pred) < STALE_TOL
    assert relerr(gs, g) < STALE_TOL
    # the stale path really refines: a fresh factor at m gives the same
    (Uf, _), gf = prob.potential_value_and_grad(m, m, 1.0, fac=prob.factor_state(m))
    assert relerr(Uf, U) < 1e-12 and relerr(gf, g) < 1e-10


def test_stale_potential_matches_jax(case):
    """The same stale factor model on both sides: JAX's potential with its
    factor_state and the port's agree."""
    m = torch.as_tensor(case["m"])
    tU, _ = case["tprob"].potential(m, m, 1.0,
                                    fac=case["tprob"].factor_state(m + 0.02))
    assert relerr(tU, case["stale_U"]) < TOL


def test_leapfrog_with_factor_fn_matches_jax(case):
    prob = case["tprob"]
    factor_calls = []

    def factor_fn(mm):
        factor_calls.append(mm)
        return make_factor_fn(prob)(mm)

    m = torch.as_tensor(case["m"])
    tv = make_potential_vg(prob, 1.0)
    state = TH.sample_chain_init(tv, m, m)
    prop, p1 = TH._leapfrog(tv, TH.HMCOptions(**OPTS),
                            TH.identity_mass(m.shape[1], device="cpu"), state,
                            torch.as_tensor(case["p0"]), m, L, OPTS["dt"],
                            factor_fn=factor_fn)
    assert len(factor_calls) == 3          # at the start, then k = 2 and 4
    jp = case["prop"]
    assert relerr(prop.m, jp.m) < TOL
    assert relerr(p1, case["p1"]) < TOL
    assert relerr(prop.grad, jp.grad) < GRAD_TOL
    assert relerr(prop.misfit, jp.misfit) < TOL
    assert relerr(prop.pred, jp.pred) < TOL


def test_run_hmc_with_factor_fn_is_segmentation_exact(case):
    prob = case["tprob"]
    tv = make_potential_vg(prob, 1.0)
    opts = TH.HMCOptions(**dict(OPTS, steps_lo=2, steps_hi=4))
    m = torch.as_tensor(case["m"])
    mass = TH.identity_mass(m.shape[1], device="cpu")
    ff = make_factor_fn(prob)
    one = TH.run_hmc(tv, opts, mass, m, m, 3, seed=2, factor_fn=ff,
                     sample_dtype=torch.float64)
    a = TH.run_hmc(tv, opts, mass, m, m, 1, seed=2, factor_fn=ff,
                   sample_dtype=torch.float64)
    b = TH.run_hmc(tv, opts, mass, m, m, 2, seed=2, factor_fn=ff, init_state=a.final,
                   key_offset=1, sample_dtype=torch.float64)
    assert torch.equal(torch.cat([a.models, b.models]), one.models)
    assert torch.isfinite(one.stats).all()
