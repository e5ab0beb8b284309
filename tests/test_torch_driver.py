"""The port's ``run_inversion`` end to end on the tiny problem, on the CPU.

The port's random stream differs from ``jax.random``'s, so whole runs are
held to the properties the JAX package's tests hold its own runs to
(tests/test_e2e.py, test_mass.py, test_checkpoint.py, test_hybrid.py):
shapes, a falling misfit, the sample ledger, and bit-exact segmentation and
resume.  The hybrid schedule here warms up under complex64 thomas with 3
refinement steps and runs the rest under complex128 thomas.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.sampler import checkpoint as JCK  # noqa: E402
from hmcmt2d_tpu.sampler import driver as JD  # noqa: E402
from hmcmt2d_tpu.sampler import hmc as JH  # noqa: E402
from hmcmt2d_tpu_torch.io import HMCConfig  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.sampler import checkpoint as CK  # noqa: E402
from hmcmt2d_tpu_torch.sampler import driver as D  # noqa: E402
from tests.test_e2e import tiny_setup  # noqa: E402
from tests.torch_parity import port_setup  # noqa: E402

EXACT = SolveConfig(torch.complex128, 0, "thomas")
WARM = SolveConfig(torch.complex64, 3, "thomas")


@pytest.fixture(scope="module")
def setup():
    mesh, start_sig, data, obs, err = tiny_setup()
    tmesh, tdata = port_setup(mesh, data)
    return tmesh, start_sig, tdata, obs, err


def _cfg(**kw):
    base = dict(burnin=6, total_samples=14, sig_bounds=(1e-4, 10.0), dt=0.05,
                timestep=(2, 3), reg_param=1.0, seed=0, adapt=True)
    base.update(kw)
    return HMCConfig(**base)


def _run(setup, cfg, **kw):
    kw.setdefault("solve_cfg", EXACT)
    return D.run_inversion(cfg, *setup, n_chains=2, device="cpu", **kw)


def test_adapt_off_run(setup):
    cfg = _cfg(adapt=False, burnin=5, total_samples=25)
    run = _run(setup, cfg)
    res = run.result
    S, C, P = res.models.shape
    assert (S, C, P) == (25, 2, run.problem.n_param) and run.n_warm == 0
    stats = res.stats.numpy()
    assert np.isfinite(stats).all()
    assert stats[-5:, :, 0].mean() < float(res.start_stats[:, 0].mean())
    assert float(res.accepts.double().mean()) > 0.1
    models = res.models.numpy()
    assert models.min() >= np.log(1e-4) - 1e-5 and models.max() <= np.log(10.0) + 1e-5
    lf = res.lf_steps.numpy()
    assert lf.shape == (S, C) and lf.min() >= 2 and lf.max() <= 3
    assert run.nfevals == int(lf.sum()) + C
    # start models: homogeneous integer resistivities around the file's
    rho = 1.0 / np.exp(run.m_ref[:, 0])
    np.testing.assert_allclose(rho, np.round(rho), atol=1e-9)
    assert np.all(run.m_ref == run.m_ref[:, :1]) and 50 <= rho.min() <= rho.max() <= 150


def test_gauss_newton_schedule(setup):
    cfg = _cfg(total_samples=24, mass_type="gaussnewton", mass_warmup=6, mass_dt0=0.2)
    run = _run(setup, cfg)
    res = run.result
    assert res.models.shape[:2] == (24, 2)
    assert run.n_warm == 12                       # burnin + mass_warmup
    assert torch.isfinite(res.stats).all()
    assert float(res.accepts[run.n_warm:].double().mean()) > 0.1
    assert res.models.dtype == torch.float32 and res.final.m.dtype == torch.float64


def test_resume_is_bit_exact(setup, tmp_path):
    cfg = _cfg(adapt=False, burnin=3, total_samples=15)
    ck = str(tmp_path / "run.ckpt.npz")
    full = _run(setup, cfg, checkpoint_path=ck, checkpoint_every=4)
    ck2 = str(tmp_path / "partial.ckpt.npz")
    _run(setup, cfg, n_samples=11, checkpoint_path=ck2, checkpoint_every=4)
    resumed = _run(setup, cfg, checkpoint_path=ck2, checkpoint_every=4, resume=True)
    for name in ("models", "accepts", "stats", "lf_steps", "pred"):
        assert torch.equal(getattr(full.result, name), getattr(resumed.result, name)), name
    assert full.result.models.shape == (15, 2, full.problem.n_param)
    z = np.load(ck)
    assert str(z["framework"]) == "torch" and z["key"].dtype == np.int64


def test_hybrid_equals_manual_two_phase(setup, tmp_path):
    """The hybrid main phase is what the main engine gives from the warmed-up
    state: a hybrid checkpoint resumed and extended equals one full run."""
    ck = str(tmp_path / "hyb.ckpt.npz")
    short = _run(setup, _cfg(total_samples=10), warmup_solve_cfg=WARM,
                 checkpoint_path=ck, checkpoint_every=2)
    full = _run(setup, _cfg(), warmup_solve_cfg=WARM)
    resumed = _run(setup, _cfg(), warmup_solve_cfg=WARM, checkpoint_path=ck,
                   checkpoint_every=2, resume=True)
    assert torch.equal(full.result.models, resumed.result.models)
    assert short.result.models.shape[0] == 10
    # warmup ran under the warmup engine: not the exact engine's stream
    pure = _run(setup, _cfg())
    assert not torch.equal(full.result.models[:6], pure.result.models[:6])
    assert float(full.result.accepts[6:].double().mean()) > 0.2


def test_hybrid_gauss_newton_schedule(setup):
    run = _run(setup, _cfg(total_samples=20, mass_type="gaussnewton", mass_warmup=4),
               warmup_solve_cfg=WARM)
    assert run.n_warm == 10 and run.result.models.shape[0] == 20
    assert torch.isfinite(run.result.stats).all()


def test_segmented_warmup_is_bit_exact(setup):
    one = _run(setup, _cfg())
    seg = _run(setup, _cfg(), progress_every=2)
    for name in ("models", "accepts", "stats"):
        assert torch.equal(getattr(one.result, name), getattr(seg.result, name)), name


def test_load_checkpoint_refuses_a_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    C, P, S, Dn = 2, 3, 4, 5
    state = JH.ChainState(m=jnp.asarray(rng.standard_normal((C, P))),
                          grad=jnp.zeros((C, P)), misfit=jnp.ones(C),
                          mnorm=jnp.ones(C), pred=np.ones((C, Dn), complex))
    path = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(path, n_done=1, state=state, key=jax.random.PRNGKey(0),
                        dt=0.1, mass=JH.identity_mass(P), m_ref=np.zeros((C, P)),
                        models=np.zeros((S, C, P)), stats=np.zeros((S, C, 4)),
                        accepts=np.zeros((S, C), bool),
                        pred=np.zeros((S, C, Dn), complex),
                        lf_steps=np.zeros((S, C), np.int32),
                        start_stats=np.zeros((C, 4)),
                        start_pred=np.zeros((C, Dn), complex), n_warm=0,
                        wall_time=1.0)
    with pytest.raises(ValueError, match="JAX"):
        CK.load_checkpoint(path, "cpu")


def test_segment_plan_and_mass_kind_match_jax():
    for n, every in ((10, 0), (10, 4), (8, 4), (3, 10), (0, 4), (7, 7)):
        assert D._segment_plan(n, every) == JD._segment_plan(n, every)
    for mt in ("diagonal", "gaussnewton", "GN", "nondiagonal", "wm"):
        assert D.mass_kind(HMCConfig(mass_type=mt)) == JD.mass_kind(
            JD.HMCConfig(mass_type=mt))


def test_make_mass(setup):
    problem, _ = D.build_inverse_problem(setup[0], setup[2], setup[3], setup[4],
                                         setup[1].ravel(), device="cpu")
    assert not D.make_mass(problem, HMCConfig(mass_type="wm")).diagonal
    assert D.make_mass(problem, HMCConfig()).diagonal
    with pytest.raises(ValueError, match="gaussnewton"):
        D.make_mass(problem, HMCConfig(mass_type="gaussnewton"))


def test_run_inversion_without_gpu_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.run_inversion(_cfg(), *setup, n_chains=2)
