"""Port parity of the HMC sampler.

torch and JAX random streams cannot match, so the deterministic parts are
compared given the same draws (made with numpy): one leapfrog trajectory on
the tiny flagship posterior, and one MH-corrected sample step with injected
(L, p0, u).  The counter-based stream of the port is checked on its own:
two run segments reproduce one unbroken run bit for bit.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.sampler import hmc as JH  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.sampler import hmc as TH  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import (chain_models, problem_arrays, realistic,  # noqa: E402
                                relerr)

TOL = 1e-10
GRAD_TOL = 1e-8   # gradients at the posterior sum residuals of 3% of |pred|
OPTS = dict(dt=2e-3, steps_lo=3, steps_hi=3, log_sig_lo=float(np.log(1e-4)),
            log_sig_hi=float(np.log(10.0)), reg_param=1.0)
L = 3


@pytest.fixture(scope="module")
def case():
    jprob, m0 = _flagship_problem(tiny=True)
    jprob = realistic(jprob, m0)
    tprob = convert.problem_from_arrays(problem_arrays(jprob), device="cpu")
    m = chain_models(m0, 2, scale=0.02, seed=1)
    rng = np.random.default_rng(2)
    p0 = np.clip(rng.standard_normal(m.shape), -2.5, 2.5)
    jv = jax.jit(jax_vg(jprob, 1.0))
    jstate = JH.sample_chain_init(jv, jnp.asarray(m), jnp.asarray(m0)[None])
    jmass = JH.identity_mass(m.shape[1])
    jopts = JH.HMCOptions(**OPTS)
    prop, p1 = jax.jit(lambda st, p: JH._leapfrog(
        jv, jopts, jmass, st, p, jnp.asarray(m0)[None], L, jopts.dt))(
            jstate, jnp.asarray(p0))
    tvg = make_potential_vg(tprob, 1.0)
    m_ref = torch.as_tensor(m0)[None]
    tstate = TH.sample_chain_init(tvg, torch.as_tensor(m), m_ref)
    return dict(jstate=jstate, prop=prop, p1=np.asarray(p1), p0=p0, m=m,
                tvg=tvg, tstate=tstate, m_ref=m_ref,
                tmass=TH.identity_mass(m.shape[1], device="cpu"), topts=TH.HMCOptions(**OPTS))


def test_chain_init_matches_jax(case):
    js, ts = case["jstate"], case["tstate"]
    for name in ("misfit", "mnorm", "pred"):
        assert relerr(getattr(ts, name), getattr(js, name)) < TOL
    assert relerr(ts.grad, js.grad) < GRAD_TOL


def test_leapfrog_matches_jax(case):
    prop, p1 = TH._leapfrog(case["tvg"], case["topts"], case["tmass"],
                            case["tstate"], torch.as_tensor(case["p0"]),
                            case["m_ref"], L, case["topts"].dt)
    jp = case["prop"]
    assert relerr(prop.m, jp.m) < TOL
    assert relerr(p1, case["p1"]) < TOL
    assert relerr(prop.grad, jp.grad) < GRAD_TOL
    assert relerr(prop.misfit, jp.misfit) < TOL
    assert relerr(prop.pred, jp.pred) < TOL


def test_sample_step_with_injected_draws_matches_jax_mh(case):
    """The port's sample_step against JAX's _leapfrog output followed by the
    MH rule of hmc.py:218-250 recomputed in numpy."""
    u = np.array([1e-12, 1.0 - 1e-12])
    step = TH.make_sample_step(case["tvg"], case["topts"])
    new, accept, stats, alpha, L_used = step(
        case["tstate"], None, case["m_ref"], case["topts"].dt, case["tmass"],
        draws=(L, torch.as_tensor(case["p0"]), torch.as_tensor(u)))
    js, jp = case["jstate"], case["prop"]
    ke0 = 0.5 * np.sum(case["p0"] ** 2, axis=-1)
    h0 = np.asarray(js.misfit) + np.asarray(js.mnorm) + ke0
    h1 = (np.asarray(jp.misfit) + np.asarray(jp.mnorm)
          + 0.5 * np.sum(case["p1"] ** 2, axis=-1))
    dh = h0 - h1
    finite = np.isfinite(h1) & np.isfinite(np.asarray(jp.grad)).all(-1)
    want_acc = finite & ((dh > 0) | (u < np.exp(dh)))
    np.testing.assert_array_equal(accept.numpy(), want_acc)
    assert L_used == L
    want_m = np.where(want_acc[:, None], np.asarray(jp.m), case["m"])
    assert relerr(new.m, want_m) < TOL
    mis = np.where(want_acc, np.asarray(jp.misfit), np.asarray(js.misfit))
    mn = np.where(want_acc, np.asarray(jp.mnorm), np.asarray(js.mnorm))
    want_stats = np.stack([mis, mn, ke0, mis + mn + ke0], axis=-1)
    assert relerr(stats, want_stats) < TOL
    assert relerr(alpha, np.where(finite, np.exp(np.minimum(dh, 0.0)), 0.0)) < 1e-8


def test_reflect_bounds_matches_jax_and_loop():
    rng = np.random.default_rng(0)
    lo, hi = -2.0, 1.0
    m = rng.uniform(-12, 12, size=200)
    p = rng.standard_normal(200)

    def iterative(mk, pk):
        while not (lo <= mk <= hi):
            if mk < lo:
                mk, pk = 2 * lo - mk, -pk
            if mk > hi:
                mk, pk = 2 * hi - mk, -pk
        return mk, pk

    want = np.array([iterative(mk, pk) for mk, pk in zip(m, p)])
    got_m, got_p = TH.reflect_bounds(torch.as_tensor(m), torch.as_tensor(p), lo, hi)
    np.testing.assert_allclose(got_m.numpy(), want[:, 0], atol=1e-12)
    np.testing.assert_allclose(got_p.numpy(), want[:, 1], atol=1e-12)
    jm, jp = JH.reflect_bounds(jnp.asarray(m), jnp.asarray(p), lo, hi)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(jm), atol=1e-12)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))


def test_mass_matrices_match_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 4))
    Wm = A @ A.T + 4 * np.eye(4)
    p = rng.standard_normal((3, 4))
    for jmass, tmass in ((JH.dense_mass(Wm), TH.dense_mass(Wm, device="cpu")),
                         (JH.identity_mass(4), TH.identity_mass(4, device="cpu"))):
        assert relerr(tmass.apply_inv(torch.as_tensor(p)),
                      jmass.apply_inv(jnp.asarray(p))) < 1e-12
        assert relerr(tmass.kinetic(torch.as_tensor(p)),
                      jmass.kinetic(jnp.asarray(p))) < 1e-12
    draws = TH.dense_mass(Wm, device="cpu").draw(TH.generator(0, 1, 0, "cpu"), (20000, 4))
    assert draws.abs().max() <= 2.5 * np.abs(np.linalg.cholesky(Wm)).sum(1).max()
    np.testing.assert_allclose(np.cov(draws.numpy().T), Wm, rtol=0.15,
                               atol=0.1 * np.abs(Wm).max())


def _gaussian_vg(mu, var):
    mu, var = torch.as_tensor(mu), torch.as_tensor(var)

    def vg(m, m_ref):
        U = 0.5 * ((m - mu) ** 2 / var).sum(-1)
        return (U, (U, torch.zeros_like(U), m[..., :1].clone())), (m - mu) / var

    return vg


def test_segmented_run_is_bit_exact():
    vg = _gaussian_vg([1.0, -2.0, 0.5], [0.25, 1.0, 4.0])
    opts = TH.HMCOptions(dt=0.3, steps_lo=2, steps_hi=5, log_sig_lo=-50.0,
                         log_sig_hi=50.0, reg_param=0.0)
    mass = TH.identity_mass(3, device="cpu")
    m0 = torch.zeros(4, 3, dtype=torch.float64)
    one = TH.run_hmc(vg, opts, mass, m0, m0, 6, seed=7, sample_dtype=torch.float64)
    a = TH.run_hmc(vg, opts, mass, m0, m0, 2, seed=7, sample_dtype=torch.float64)
    b = TH.run_hmc(vg, opts, mass, a.final.m, m0, 4, seed=7,
                   sample_dtype=torch.float64, init_state=a.final, key_offset=2)
    for name in ("models", "stats", "accepts", "lf_steps"):
        got = torch.cat([getattr(a, name), getattr(b, name)])
        assert torch.equal(got, getattr(one, name)), name
    assert torch.equal(b.final.m, one.final.m)
    assert 0.0 < float(one.accepts.double().mean()) <= 1.0
    assert one.models.shape == (6, 4, 3) and one.start_stats.shape == (4, 4)


def test_nonfinite_gradient_proposal_never_accepted():
    """A finite-energy proposal with a non-finite gradient is rejected and
    reports alpha = 0 (hmc.py:224-242)."""

    def vg(m, m_ref):
        U = 0.5 * (m * m).sum(-1)
        g = torch.where(m[..., :1] > 0.3, torch.full_like(m, float("nan")), m)
        return (U, (U, torch.zeros_like(U), m[..., :1].clone())), g

    opts = TH.HMCOptions(dt=0.4, steps_lo=2, steps_hi=3, log_sig_lo=-50.0,
                         log_sig_hi=50.0, reg_param=1.0)
    m0 = torch.full((3, 4), -1.0, dtype=torch.float64)
    res = TH.run_hmc(vg, opts, TH.identity_mass(4, device="cpu"), m0, m0, 40, seed=0,
                     sample_dtype=torch.float64)
    assert torch.isfinite(res.final.m).all() and torch.isfinite(res.final.grad).all()
    assert torch.isfinite(res.models).all()
    assert float(res.accepts.double().mean()) > 0.2
    assert float(res.models[..., 0].max()) <= 0.3 + 2 * 0.4 * 3
