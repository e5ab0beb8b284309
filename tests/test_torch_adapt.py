"""Port parity of the warmup adapter (``sampler/adapt.py``).

The window schedule and dual averaging are compared directly.  For
``warmup_scan`` both sides get the same random draws, made with numpy: the
port through ``make_sample_step``'s ``draws=`` seam, JAX by monkeypatching
``hmcmt2d_tpu.sampler.adapt.warmup_keys`` to hand out iteration indices and
``make_sample_step`` to look the draws up by index, run JAX's ``_leapfrog``
and apply the MH rule of ``hmc.py:218-250``.  JAX's own ``warmup_scan`` does
the adaptation arithmetic; nothing in ``hmcmt2d_tpu`` changes.

Tolerances: 1e-12 for dual averaging fed the same alphas (float64, same
formulas); 1e-8 for the warmup on the tiny problem (complex128 solves over
12 iterations of 2-3 leapfrog steps each).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.sampler import adapt as JA  # noqa: E402
from hmcmt2d_tpu.sampler import hmc as JH  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch.sampler import adapt as TA  # noqa: E402
from hmcmt2d_tpu_torch.sampler import hmc as TH  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import relerr, tiny_problems  # noqa: E402

DA_TOL = 1e-12
SCAN_TOL = 1e-8
N_IT, C = 12, 2
OPTS = dict(dt=0.05, steps_lo=2, steps_hi=3, log_sig_lo=float(np.log(1e-4)),
            log_sig_hi=float(np.log(10.0)), reg_param=1.0)
OPTIONS = [dict(), dict(init_buffer=10, term_buffer=5, base_window=3),
           dict(init_buffer=40, term_buffer=20, base_window=10, target_accept=0.65)]


@pytest.mark.parametrize("kw", OPTIONS, ids=["default", "short", "medium"])
def test_window_schedule_matches_jax(kw):
    jw, tw = JA.WarmupOptions(**kw), TA.WarmupOptions(**kw)
    for n in range(1, 401):
        np.testing.assert_array_equal(TA.window_schedule(n, tw),
                                      JA.window_schedule(n, jw), err_msg=str(n))


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(3)
    alphas = rng.uniform(size=60)
    w_j, w_t = JA.WarmupOptions(), TA.WarmupOptions()
    jda = JA._da_init(jnp.asarray(0.05, jnp.float64))
    tda = TA._da_init(torch.tensor(0.05, dtype=torch.float64))
    for k, a in enumerate(alphas):
        jda = JA._da_update(jda, jnp.asarray(a), w_j)
        tda = TA._da_update(tda, torch.tensor(a, dtype=torch.float64), w_t)
        if k == 30:      # a window restart, as close_window does
            jda = JA._da_init(jnp.exp(jda.log_eps))
            tda = TA._da_init(torch.exp(tda.log_eps))
        for name in jda._fields:
            assert abs(float(getattr(tda, name)) - float(getattr(jda, name))) \
                <= DA_TOL * max(1.0, abs(float(getattr(jda, name)))), (k, name)


def _draws(n, shape, seed):
    rng = np.random.default_rng(seed)
    Ls = rng.integers(OPTS["steps_lo"], OPTS["steps_hi"] + 1, size=n)
    p0 = np.clip(rng.standard_normal((n,) + shape), -2.5, 2.5)
    u = rng.uniform(size=(n, shape[0]))
    return Ls, p0, u


def _jax_step_with_draws(Ls, p0s, us):
    """A stand-in for JAX's make_sample_step whose iteration 'key' is an
    index into the given draws; then JAX's _leapfrog and the MH rule."""
    Ls, p0s, us = jnp.asarray(Ls), jnp.asarray(p0s), jnp.asarray(us)

    def make(potential_vg, opts, factor_fn=None):
        def sample_step(state, i, m_ref, dt, mass):
            c = state.m.shape[0]
            p0, u, L = p0s[i], us[i], Ls[i]
            ke0 = mass.kinetic(p0)
            h0 = state.misfit + state.mnorm + ke0
            prop, p1 = JH._leapfrog(potential_vg, opts, mass, state, p0, m_ref,
                                    L, dt, factor_fn=factor_fn)
            h1 = prop.misfit + prop.mnorm + mass.kinetic(p1)
            dh = h0 - h1
            finite = (jnp.isfinite(h1) & jnp.isfinite(prop.grad).all(axis=-1)
                      & jnp.isfinite(prop.m).all(axis=-1))
            accept = finite & ((dh > 0) | (u < jnp.exp(dh)))
            alpha = jnp.where(finite, jnp.minimum(1.0, jnp.exp(jnp.minimum(dh, 0.0))),
                              0.0)

            def pick(a, b):
                return jnp.where(accept.reshape((c,) + (1,) * (a.ndim - 1)), a, b)

            new = JH.ChainState(*(pick(a, b) for a, b in zip(prop, state)))
            stats = jnp.stack([new.misfit, new.mnorm, ke0,
                               new.misfit + new.mnorm + ke0], axis=-1)
            return new, accept, stats, alpha, L
        return sample_step

    return make


@pytest.fixture(scope="module")
def scan_case():
    jprob, tprob, m0 = tiny_problems()
    rng = np.random.default_rng(5)
    m = m0 + 0.05 * rng.standard_normal((C, len(m0)))
    draws = _draws(N_IT, m.shape, 6)
    w = dict(alpha_pool="mean")
    ends = JA.window_schedule(N_IT, JA.WarmupOptions(**w))
    assert ends.sum() == 1 and not ends[-1]      # a window closes mid-way

    mp = pytest.MonkeyPatch()
    mp.setattr(JA, "warmup_keys", lambda key, off, n: jnp.arange(n) + off)
    mp.setattr(JA, "make_sample_step", _jax_step_with_draws(*draws))
    try:
        jv = jax_vg(jprob, 1.0)
        jopts = JH.HMCOptions(**OPTS)
        carry0 = JA.warmup_carry_init(jv, jopts, jnp.asarray(m), jnp.asarray(m))
        jcarry, jout = jax.jit(lambda c: JA.warmup_scan(
            jv, jopts, jnp.asarray(m), c, JA.warmup_keys(None, 0, N_IT),
            jnp.asarray(ends), JA.WarmupOptions(**w),
            sample_dtype=jnp.float64))(carry0)
    finally:
        mp.undo()
    _, jinfo = JA.warmup_finalize(jcarry)
    return dict(tprob=tprob, m=m, draws=draws, ends=ends, w=w, jcarry=jcarry,
                jout=[np.asarray(x) for x in jout], jinfo=jinfo)


def test_warmup_scan_matches_jax(scan_case):
    c = scan_case
    Ls, p0, u = c["draws"]
    tv = make_potential_vg(c["tprob"], 1.0)
    topts = TH.HMCOptions(**OPTS)
    m = torch.as_tensor(c["m"])
    carry0 = TA.warmup_carry_init(tv, topts, m, m)
    draws = [(int(Ls[i]), torch.as_tensor(p0[i]), torch.as_tensor(u[i]))
             for i in range(N_IT)]
    carry, out = TA.warmup_scan(tv, topts, m, carry0, [None] * N_IT, c["ends"],
                                TA.WarmupOptions(**c["w"]),
                                sample_dtype=torch.float64, draws=draws)
    _, info = TA.warmup_finalize(carry)
    models, stats, accepts, pred, lf = out
    jm, js, ja, jp, jl = c["jout"]
    np.testing.assert_array_equal(accepts.numpy(), ja)
    assert 0 < ja.sum() < ja.size                 # both outcomes occur
    np.testing.assert_array_equal(lf.numpy(), jl)
    assert relerr(models, jm) < SCAN_TOL
    assert relerr(stats, js) < SCAN_TOL
    assert relerr(pred, jp) < 1e-6                # complex64 outputs
    assert abs(float(info.dt) / float(c["jinfo"].dt) - 1) < SCAN_TOL
    assert abs(float(torch.exp(carry.da.log_eps))
               / float(jnp.exp(c["jcarry"].da.log_eps)) - 1) < SCAN_TOL
    assert relerr(carry.inv_m, c["jcarry"].inv_m) < SCAN_TOL
    assert not np.allclose(np.asarray(c["jcarry"].inv_m), 1.0)   # the window closed
    assert abs(float(info.alpha_mean) - float(c["jinfo"].alpha_mean)) < SCAN_TOL


def _gaussian_vg(mu, var):
    mu, var = torch.as_tensor(mu), torch.as_tensor(var)

    def vg(m, m_ref, fac=None):
        U = 0.5 * ((m - mu) ** 2 / var).sum(-1)
        return (U, (U, torch.zeros_like(U), m[..., :1].clone())), (m - mu) / var

    return vg


def test_median_pooling_matches_jax_on_a_gaussian():
    """Three chains, alpha pooled by the median (the mean of the middle two
    for an even count is numpy's rule; with three, the middle one)."""
    var = np.array([0.04, 1.0, 9.0])
    rng = np.random.default_rng(11)
    n, Cg = 20, 3
    m0 = rng.standard_normal((Cg, 3))
    Ls = rng.integers(2, 5, size=n)
    p0 = np.clip(rng.standard_normal((n, Cg, 3)), -2.5, 2.5)
    u = rng.uniform(size=(n, Cg))
    opts = dict(dt=0.8, steps_lo=2, steps_hi=4, log_sig_lo=-50.0, log_sig_hi=50.0,
                reg_param=0.0)
    w = dict(alpha_pool="median", init_buffer=5, term_buffer=4, base_window=3)
    ends = JA.window_schedule(n, JA.WarmupOptions(**w))

    def jvg(m, m_ref, fac=None):
        U = 0.5 * jnp.sum(m ** 2 / jnp.asarray(var), -1)
        return (U, (U, jnp.zeros_like(U), m[..., :1])), m / jnp.asarray(var)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "make_sample_step", _jax_step_with_draws(Ls, p0, u))
        jopts = JH.HMCOptions(**opts)
        jm0 = jnp.asarray(m0)
        jcarry, jout = JA.warmup_scan(
            jvg, jopts, jm0, JA.warmup_carry_init(jvg, jopts, jm0, jm0),
            jnp.arange(n), jnp.asarray(ends), JA.WarmupOptions(**w),
            sample_dtype=jnp.float64)
    tvg = _gaussian_vg(np.zeros(3), var)
    tm0 = torch.as_tensor(m0)
    topts = TH.HMCOptions(**opts)
    carry, out = TA.warmup_scan(
        tvg, topts, tm0, TA.warmup_carry_init(tvg, topts, tm0, tm0), [None] * n,
        ends, TA.WarmupOptions(**w), sample_dtype=torch.float64,
        draws=[(int(Ls[i]), torch.as_tensor(p0[i]), torch.as_tensor(u[i]))
               for i in range(n)])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    assert relerr(out[0], jout[0]) < 1e-10
    assert relerr(carry.inv_m, jcarry.inv_m) < 1e-10
    assert abs(float(carry.da.log_eps) - float(jcarry.da.log_eps)) < 1e-10


def test_warmup_adapts_on_a_gaussian():
    """Dual averaging reaches the target acceptance and the mass learns the
    per-dimension scales of an anisotropic Gaussian, as
    tests/test_hmc.py::test_warmup_adaptation_gaussian checks JAX."""
    sd = np.array([0.1, 1.0, 10.0, 0.5])
    vg = _gaussian_vg(np.zeros(4), sd ** 2)
    opts = TH.HMCOptions(dt=1.5, steps_lo=4, steps_hi=8, log_sig_lo=-1e6,
                         log_sig_hi=1e6, reg_param=0.0)
    m0 = torch.zeros(8, 4, dtype=torch.float64)
    _, state, mass, info = TA.warmup(vg, opts, m0, m0, 400, seed=0,
                                     w=TA.WarmupOptions(target_accept=0.8))
    np.testing.assert_allclose(info.inv_m.numpy(), sd ** 2, rtol=0.6)
    opts2 = TH.HMCOptions(dt=float(info.dt), steps_lo=4, steps_hi=8,
                          log_sig_lo=-1e6, log_sig_hi=1e6, reg_param=0.0)
    res = TH.run_hmc(vg, opts2, mass, state.m, m0, 300, seed=1, init_state=state,
                     sample_dtype=torch.float64)
    rate = float(res.accepts.double().mean())
    assert 0.6 < rate <= 1.0, rate
    np.testing.assert_allclose(res.models.reshape(-1, 4).std(0).numpy(), sd, rtol=0.35)


def test_segmented_warmup_is_bit_exact():
    vg = _gaussian_vg([1.0, -2.0, 0.5], [0.25, 1.0, 4.0])
    opts = TH.HMCOptions(dt=0.3, steps_lo=2, steps_hi=5, log_sig_lo=-50.0,
                         log_sig_hi=50.0, reg_param=0.0)
    w = TA.WarmupOptions(init_buffer=4, term_buffer=3, base_window=3)
    m0 = torch.zeros(4, 3, dtype=torch.float64)
    n = 17
    ends = TA.window_schedule(n, w)
    assert ends.sum() >= 2
    carry0 = TA.warmup_carry_init(vg, opts, m0, m0)
    one, out_one = TA.warmup_scan(vg, opts, m0, carry0, TA.warmup_keys(3, 0, n, "cpu"),
                                  ends, w, sample_dtype=torch.float64)
    carry, outs = carry0, []
    for a, b in ((0, 5), (5, 6), (6, 17)):
        carry, o = TA.warmup_scan(vg, opts, m0, carry, TA.warmup_keys(3, a, b - a, "cpu"),
                                  ends[a:b], w, sample_dtype=torch.float64)
        outs.append(o)
    for k in range(5):
        assert torch.equal(torch.cat([o[k] for o in outs]), out_one[k]), k
    assert torch.equal(carry.inv_m, one.inv_m)
    assert all(torch.equal(x, y) for x, y in zip(carry.da, one.da))
    assert torch.equal(carry.state.m, one.state.m)


def test_start_row_is_the_pre_warmup_state():
    mu = np.array([3.0, -4.0])
    vg = _gaussian_vg(mu, np.ones(2))
    opts = TH.HMCOptions(dt=0.2, steps_lo=4, steps_hi=6, log_sig_lo=-1e6,
                         log_sig_hi=1e6, reg_param=0.0)
    m0 = torch.zeros(3, 2, dtype=torch.float64)
    res, _, _, _ = TA.warmup(vg, opts, m0, m0, 150, seed=0)
    (_, (mis0, _, _)), _ = vg(m0, m0)
    np.testing.assert_allclose(res.start_stats[:, 0].numpy(), mis0.numpy(), rtol=1e-6)
    assert float(res.stats[-1, :, 0].mean()) < 0.5 * float(mis0.mean())
