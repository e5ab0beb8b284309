"""The port's checkpoint tools (``hmcmt2d_tpu_torch.tools``) on the CPU.

One numpy checkpoint of the tiny flagship written to files (its chain
state evaluated by the port in complex128) is written through both
frameworks' ``save_checkpoint``.  ``summarize_checkpoint`` is held to the JAX
script's output (run in a subprocess on the CPU); ``refresh_extend``'s
refreshed Gauss-Newton mass to JAX's ``gauss_newton_mass`` at the same
pooled model; ``map_fit``'s Adam loop to an optax loop written here.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hmcmt2d_tpu.io.startup import read_startup as jax_read_startup  # noqa: E402
from hmcmt2d_tpu.models.forward import SolveConfig as JSolveConfig  # noqa: E402
from hmcmt2d_tpu.models.posterior import build_inverse_problem as jax_build  # noqa: E402
from hmcmt2d_tpu.sampler import checkpoint as JCK  # noqa: E402
from hmcmt2d_tpu.sampler import hmc as JH  # noqa: E402
from hmcmt2d_tpu.sampler.driver import gauss_newton_mass as jax_gn_mass  # noqa: E402
from hmcmt2d_tpu_torch import entry  # noqa: E402
from hmcmt2d_tpu_torch.io import read_startup, write_data, write_model  # noqa: E402
from hmcmt2d_tpu_torch.models.posterior import build_inverse_problem  # noqa: E402
from hmcmt2d_tpu_torch.sampler import checkpoint as CK  # noqa: E402
from hmcmt2d_tpu_torch.sampler import hmc as H  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from hmcmt2d_tpu_torch.tools import map_fit, refresh_extend, summarize_checkpoint  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GN_TOL = 1e-9
ADAM_TOL = 1e-8
STARTUP = """datafile:      obs.dat
modelfile:     start.mod
burninsamples: 4
totalsamples:  10
resistivity:   0.1 1e4 0.05
timeinterval:  0.05
timestep:      2 3
chains:        2
seed:          3
adapt:         on
masstype:      gaussnewton
"""
S_ROWS, N_WARM, C = 8, 3, 2


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """The startup files and one checkpoint, written by both frameworks."""
    d = tmp_path_factory.mktemp("tools")
    flag, m_file = entry.flagship_problem(tiny=True, device="cpu")
    with torch.no_grad():
        obs = flag.predict(torch.as_tensor(m_file)).numpy()
    obs = obs * (1 + 0.03 * np.random.default_rng(0).standard_normal(len(obs)))
    write_model(d / "start.mod", flag.mesh, flag.sigma2d(torch.as_tensor(m_file)))
    write_data(d / "obs.dat", flag.fwd.data, obs, 0.03 * np.abs(obs))
    (d / "startup").write_text(STARTUP)
    cfg, tmesh, sig, tdata, tobs, terr = read_startup(d / "startup", device="cpu")
    prob, m0 = build_inverse_problem(tmesh, tdata, tobs, terr, sig.ravel(),
                                     sigma_fixed=cfg.sig_fix, device="cpu")
    rng = np.random.default_rng(21)
    P, D = prob.n_param, len(prob.obs)
    models = m0 + 0.05 * rng.standard_normal((S_ROWS, C, P))
    m_ref = np.tile(np.log(np.full(P, 0.012)), (C, 1))
    m = torch.as_tensor(models[-1])
    (U, (mis, mn, pred)), g = make_potential_vg(prob, cfg.reg_param)(m, torch.as_tensor(m_ref))
    arr = dict(
        n_done=S_ROWS - N_WARM, n_warm=N_WARM, wall_time=12.5, dt=0.02,
        m=models[-1], grad=g.numpy(), misfit=mis.numpy(), mnorm=mn.numpy(),
        pred=pred.numpy(), m_ref=m_ref, models=models.astype(np.float32),
        stats=np.abs(rng.standard_normal((S_ROWS, C, 4))) * 50,
        accepts=rng.random((S_ROWS, C)) < 0.7,
        preds=(rng.standard_normal((S_ROWS, C, D))
               + 1j * rng.standard_normal((S_ROWS, C, D))).astype(np.complex64),
        lf_steps=rng.integers(2, 4, (S_ROWS, C)).astype(np.int32),
        start_stats=np.abs(rng.standard_normal((C, 4))) * 80,
        start_pred=(rng.standard_normal((C, D)) + 0j).astype(np.complex64))
    outs = dict(models=arr["models"], stats=arr["stats"], accepts=arr["accepts"],
                pred=arr["preds"], lf_steps=arr["lf_steps"],
                start_stats=arr["start_stats"], start_pred=arr["start_pred"],
                n_warm=N_WARM, wall_time=arr["wall_time"], dt=arr["dt"],
                n_done=arr["n_done"], m_ref=m_ref)
    CK.save_checkpoint(
        str(d / "torch.npz"), key=3,
        state=H.ChainState(*(torch.as_tensor(arr[k]) for k in
                             ("m", "grad", "misfit", "mnorm", "pred"))),
        mass=H.MassMatrix(torch.ones(P, dtype=torch.float64),
                          torch.ones(P, dtype=torch.float64)), **outs)
    JCK.save_checkpoint(
        str(d / "jax.npz"), key=np.zeros(2, np.uint32),
        state=JH.ChainState(*(jnp.asarray(arr[k]) for k in ("m", "grad", "misfit", "mnorm",
                                                              "pred"))),
        mass=JH.MassMatrix(np.ones(P), np.ones(P), True), **outs)
    with np.load(d / "torch.npz") as z:
        np.savez(d / "sharded.npz", **{k: (np.asarray("sharded") if k == "path" else z[k])
                                      for k in z.files})
    return dict(dir=d, arr=arr, prob=prob, m0=m0)


def _untimed(path: Path) -> list[str]:
    """A text file's lines but the model header's time stamp."""
    return [ln for ln in path.read_text().splitlines() if not re.search(r"\d\d:\d\d:\d\d", ln)]


def test_summarize_matches_the_jax_script(run_dir, tmp_path):
    d = run_dir["dir"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "summarize_checkpoint.py"),
                          str(d / "jax.npz"), str(d / "startup"), str(tmp_path / "jax")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert summarize_checkpoint.main([str(d / "torch.npz"), str(d / "startup"),
                                      str(tmp_path / "torch"), "--device", "cpu"]) == 0
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert "summary.json" in files and "meanModel.model" in files
    assert "hmcstatistics_id2.log" in files and "hmcsamples_id1.model" not in files
    for name in files:
        if name != "summary.json":
            assert _untimed(tmp_path / "torch" / name) == _untimed(tmp_path / "jax" / name), name
    got, want = (json.loads((tmp_path / k / "summary.json").read_text())
                 for k in ("torch", "jax"))
    assert got.keys() == want.keys()
    nrms = got.pop("posterior_mean_nrms"), want.pop("posterior_mean_nrms")
    assert abs(nrms[0] - nrms[1]) <= 1e-8 * abs(nrms[1])
    assert got == want


def test_summarize_says_when_the_checkpoint_has_no_pred(run_dir, tmp_path):
    d = run_dir["dir"]
    with np.load(d / "torch.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["pred"] = arrays["pred"][..., :0]
    np.savez(tmp_path / "nopred.npz", **arrays)
    assert summarize_checkpoint.main([str(tmp_path / "nopred.npz"), str(d / "startup"),
                                      str(tmp_path / "out"), "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert summary["chain_pred"].startswith("none")
    assert np.isfinite(summary["posterior_mean_nrms"])


def test_summarize_refuses_a_jax_checkpoint(run_dir, tmp_path):
    d = run_dir["dir"]
    with pytest.raises(ValueError, match="hmcmt2d_tpu_torch"):
        summarize_checkpoint.main([str(d / "jax.npz"), str(d / "startup"), str(tmp_path),
                                   "--device", "cpu"])


def _refresh(d, out):
    return refresh_extend.main([str(d / "startup"), str(d / "torch.npz"), str(out),
                                "--readapt", "2", "--samples", "3", "--seg", "2",
                                "--stride", "1", "--jac-chunk", "16", "--device", "cpu"])


def test_refresh_extend(run_dir, tmp_path):
    d, arr = run_dir["dir"], run_dir["arr"]
    assert _refresh(d, tmp_path / "a.npz") == 0
    assert _refresh(d, tmp_path / "b.npz") == 0
    ck = CK.load_checkpoint(str(tmp_path / "a.npz"), "cpu")
    assert ck["models"].shape == (5, C, arr["m"].shape[1]) and ck["n_warm"] == 2
    assert ck["n_done"] == 3 and ck["path"] == "single"
    np.testing.assert_array_equal(ck["start_stats"], arr["start_stats"])
    with pytest.raises(ValueError, match="sharded"):
        refresh_extend.main([str(d / "startup"), str(d / "sharded.npz"), str(tmp_path / "c"),
                             "--device", "cpu"])
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        for k in a.files:
            if k != "wall_time":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # the refreshed metric is JAX's Gauss-Newton mass at the pooled model
    cfg, mesh, sig, data, obs, err = jax_read_startup(str(d / "startup"))
    jprob, _ = jax_build(mesh, data, obs, err, np.asarray(sig).ravel(),
                         sigma_fixed=cfg.sig_fix, cfg=JSolveConfig(jnp.complex128, 0, "thomas"))
    want = jax_gn_mass(jprob, jnp.asarray(arr["m"].mean(axis=0)), cfg.reg_param, chunk=16)
    assert not ck["mass"].diagonal
    assert relerr(ck["mass"].sqrt_m, want.sqrt_m) < GN_TOL
    assert relerr(ck["mass"].inv_m, want.inv_m) < GN_TOL


def test_adam_loop_matches_optax(run_dir):
    """5 iterations in float64 from one numpy start, the port's loop against
    an optax loop, both on the port's potential with one gradient entry made
    NaN (zeroed by both)."""
    prob, m0 = run_dir["prob"], run_dir["m0"]
    rng = np.random.default_rng(5)
    lo, hi, lr, iters = float(np.log(0.1)), float(np.log(1e4)), 0.05, 5
    m_start = np.clip(m0 + 0.3 * rng.standard_normal((C, len(m0))), lo, hi)
    vg_port = make_potential_vg(prob, 1.0)

    def vg(m, m_ref):
        out, g = vg_port(m, m_ref)
        g = g.clone()
        g[0, 3] = float("nan")
        return out, g

    got = map_fit.adam_fit(vg, torch.as_tensor(m_start), torch.as_tensor(m_start),
                           iters, lr, lo, hi)

    opt = optax.adam(optax.cosine_decay_schedule(lr, iters, alpha=0.05))
    m = jnp.asarray(m_start)
    state = opt.init(m)
    for _ in range(iters):
        _, g = vg(torch.as_tensor(np.array(m)), torch.as_tensor(m_start))
        g = jnp.asarray(g.numpy())
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        upd, state = opt.update(g, state, m)
        m = jnp.clip(m + upd, lo, hi)
    assert got.dtype == torch.float64
    assert float(np.abs(got.numpy() - m_start).max()) > 0.05
    assert float(got[0, 3]) == m_start[0, 3]
    assert relerr(got, m) < ADAM_TOL


def test_map_fit_report(run_dir, tmp_path):
    d = run_dir["dir"]
    out = tmp_path / "report.json"
    assert map_fit.main([str(d / "startup"), "--iters", "3", "--seg", "1", "--regs",
                         "1.0,0", "--chains", "1", "--device", "cpu", "--out",
                         str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["engine"] == "thomas" and rep["n_data"] == len(run_dir["prob"].obs)
    assert sorted(rep["regs"]) == ["0.0", "1.0"]
    for r in rep["regs"].values():
        assert sorted(r) == ["chi2_artifact_convention_best", "chi2_best",
                             "chi2_by_freq_mean", "chi2_per_datum_per_chain",
                             "chi2_quantiles_per_datum", "iters"]
        assert len(r["chi2_per_datum_per_chain"]) == 2   # C = max(2, chains)
        assert np.isfinite(r["chi2_per_datum_per_chain"]).all()


def test_map_fit_under_thomas_blocked(run_dir, tmp_path):
    """``--solver thomas_blocked`` (JAX's script takes any engine name) runs
    the same Adam fit as exact thomas: the same chi^2 to 1e-8."""
    d = run_dir["dir"]
    reps = {}
    for solver in ("thomas", "thomas_blocked"):
        out = tmp_path / f"{solver}.json"
        assert map_fit.main([str(d / "startup"), "--iters", "3", "--seg", "1", "--regs",
                             "1.0", "--chains", "1", "--device", "cpu", "--solver", solver,
                             "--out", str(out)]) == 0
        reps[solver] = json.loads(out.read_text())
    assert reps["thomas_blocked"]["engine"] == "thomas_blocked"
    assert relerr(reps["thomas_blocked"]["regs"]["1.0"]["chi2_per_datum_per_chain"],
                  reps["thomas"]["regs"]["1.0"]["chi2_per_datum_per_chain"]) < 1e-8


@pytest.mark.parametrize("tool", [summarize_checkpoint, refresh_extend, map_fit])
def test_tools_default_to_the_gpu(run_dir, tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = run_dir["dir"]
    argv = {summarize_checkpoint: [str(d / "torch.npz"), str(d / "startup"), str(tmp_path)],
            refresh_extend: [str(d / "startup"), str(d / "torch.npz"), str(tmp_path / "o")],
            map_fit: [str(d / "startup")]}[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
