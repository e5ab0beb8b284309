"""The port's bench (``hmcmt2d_tpu_torch.bench``) against the JAX one
(``bench.py`` at the repo root, loaded with importlib) on the CPU.

``realistic`` is held to ``bench._realistic`` on the tiny flagship in
complex128 (REALISTIC_TOL relative); ``summarize`` to the dict that JAX's
``measure_ess`` returns for the same window arrays (its ``_measure``
patched to return them), key for key and exactly; the CPU baselines to a
finite positive rate; and the slice as a whole runs as
``python -m hmcmt2d_tpu_torch.bench --smoke --device cpu`` in a
subprocess.
"""

import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hmcmt2d_tpu_torch import bench as B  # noqa: E402
from hmcmt2d_tpu_torch import native  # noqa: E402
from hmcmt2d_tpu_torch.entry import flagship_problem  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REALISTIC_TOL = 1e-10
SMOKE_TIMEOUT_S = 600


def _load(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / filename)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return _load("jax_bench", "bench.py")


@pytest.fixture(scope="module")
def tiny():
    return flagship_problem(tiny=True, device="cpu")


def _jax_line_keys() -> set:
    """The string keys of the dict literals in ``bench.py``'s ``main`` and
    ``measure_ess``: every key of its JSON line."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main", "measure_ess"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
    return keys


def test_realistic_matches_jax(jax_bench, tiny):
    import jax

    assert jax.config.jax_enable_x64
    g = _load("jax_graft", "__graft_entry__.py")
    jprob, jm0 = jax_bench._realistic(lambda: g._flagship_problem(tiny=True))
    problem, m0 = tiny
    tprob = B.realistic(problem, m0)
    np.testing.assert_array_equal(m0, np.asarray(jm0))
    jobs = np.asarray(jprob.obs)
    assert jobs.dtype == np.complex128 and tprob.obs.dtype == np.complex128
    rel = np.abs(tprob.obs - jobs).max() / np.abs(jobs).max()
    assert rel < REALISTIC_TOL, rel
    w_rel = np.abs(tprob.weights - np.asarray(jprob.weights)).max() / np.abs(
        np.asarray(jprob.weights)).max()
    assert w_rel < REALISTIC_TOL, w_rel
    # the placeholder observations are gone, the rest of the problem stays
    assert not np.allclose(tprob.obs, problem.obs)
    np.testing.assert_array_equal(tprob.active_idx, problem.active_idx)


def _window(n_samples, n_chains=3, n_param=5, seed=0):
    """Window arrays: random-walk models (S, C, P) float32, accepts, and
    leapfrog steps in 6..10 shared by the chains of an iteration."""
    rng = np.random.default_rng(seed)
    models = np.cumsum(rng.standard_normal((n_samples, n_chains, n_param)),
                       axis=0).astype(np.float32)
    accepts = rng.random((n_samples, n_chains)) < 0.8
    lf = np.repeat(rng.integers(6, 11, (n_samples, 1)), n_chains, axis=1).astype(np.int32)
    return models, accepts, lf


# a stand-in for the flagship: what the accounting reads of the problem
FLAGSHIP = SimpleNamespace(fwd=SimpleNamespace(data=SimpleNamespace(n_freq=11)),
                           mesh=SimpleNamespace(ny=96, nz=56))


def _jax_measure_ess(jax_bench, monkeypatch, models, accepts, lf, seconds, dt,
                     n_warm, gn_mass):
    res = SimpleNamespace(models=models, accepts=accepts, lf_steps=lf,
                          stats=np.zeros(models.shape[:2] + (4,)))
    monkeypatch.setattr(jax_bench, "_measure", lambda *a, **k: (
        FLAGSHIP, res, seconds, SimpleNamespace(dt=dt)))
    return jax_bench.measure_ess(None, models.shape[1], n_samples=models.shape[0],
                                 n_warm=n_warm, gn_mass=gn_mass)


@pytest.mark.parametrize("n_samples,n_warm,gn_mass", [
    (8, 0, False), (8, 4, False), (8, 104, True), (400, 0, False), (400, 104, True)])
def test_summarize_matches_jax_measure_ess(jax_bench, monkeypatch, n_samples,
                                           n_warm, gn_mass):
    models, accepts, lf = _window(n_samples, seed=n_samples + n_warm)
    seconds, dt = 12.345678, np.float32(0.0123456789)
    want = _jax_measure_ess(jax_bench, monkeypatch, models, accepts, lf, seconds,
                            float(dt), n_warm, gn_mass)
    got = B.summarize(FLAGSHIP, torch.as_tensor(models), torch.as_tensor(accepts),
                      torch.as_tensor(lf), seconds, float(dt), n_warm, gn_mass)
    assert got == want
    assert list(got) == list(want)
    assert (got["ess_median_first200"] is None) == (n_samples - (0 if n_warm else
                                                                 n_samples // 2) < 400)


def test_summarize_keeps_an_ess_of_zero(jax_bench, monkeypatch):
    """An ESS of 0.0 reads 0.0 in ``ess_median_first200``, where
    ``bench.py:275`` (``if ess_200``) turns it into None."""
    models, accepts, lf = _window(400)
    monkeypatch.setattr(B, "D", SimpleNamespace(ess=lambda w: np.zeros(w.shape[-1])))
    got = B.summarize(FLAGSHIP, models, accepts, lf, 2.0, 0.01, 104, True)
    assert got["ess_median"] == 0.0 and got["ess_per_sec_per_chip"] == 0.0
    assert got["ess_median_first200"] == 0.0
    from hmcmt2d_tpu.sampler import diagnostics as JD

    monkeypatch.setattr(JD, "ess", lambda w: np.zeros(np.shape(w)[-1]))
    want = _jax_measure_ess(jax_bench, monkeypatch, models, accepts, lf, 2.0, 0.01,
                            104, True)
    assert want["ess_median_first200"] is None
    assert {k: v for k, v in got.items() if k != "ess_median_first200"} == \
        {k: v for k, v in want.items() if k != "ess_median_first200"}


def test_cpu_baselines(tiny, monkeypatch):
    problem, _ = tiny
    n_freq = problem.fwd.data.n_freq
    sps = B.measure_cpu_baseline(problem, n_freq=n_freq)
    assert math.isfinite(sps) and sps > 0
    nat = B.measure_cpu_baseline_native(problem, n_freq=n_freq, threads=2)
    if native.available():
        assert math.isfinite(nat) and nat > 0
    else:
        assert nat is None
    monkeypatch.setattr(native, "available", lambda: False)
    assert B.measure_cpu_baseline_native(problem, n_freq=n_freq) is None


def test_window_is_whole_segments(tiny):
    """The runner computes exactly the samples asked for, in units of seg."""
    problem, m0 = tiny
    _, run, opts = B._build(lambda: (problem, m0), 1, seg=2)
    assert opts.dt == 0.03
    res = run(2, 0)
    assert tuple(res.models.shape) == (2, 1, len(m0))
    with pytest.raises(ValueError, match="multiple of seg"):
        run(3, 0)


def _bench(args, **env):
    e = dict(os.environ, OMP_NUM_THREADS="2", **env)
    return subprocess.run([sys.executable, "-m", "hmcmt2d_tpu_torch.bench", *args],
                          cwd=ROOT, env=e, capture_output=True, text=True,
                          timeout=SMOKE_TIMEOUT_S)


def test_bench_smoke_runs_clean_on_cpu():
    """The whole pipeline on the tiny flagship; the line as
    tests/test_bench_smoke.py checks JAX's, plus every key of bench.py's
    line and ``device``."""
    p = _bench(["--smoke", "--device", "cpu"])
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-4000:])
    out = json.loads(p.stdout.strip().splitlines()[-1])
    for k in ("metric", "value", "unit", "vs_baseline",
              "ess_per_sec_per_chip", "solves_per_sec", "nfevals"):
        assert k in out, k
    assert out["value"] > 0
    assert out["nfevals"] > 0
    keys = _jax_line_keys()
    assert len(keys) >= 20 and not keys - set(out), keys - set(out)
    assert set(out) - keys == {"device"}
    assert out["device"] == "cpu"
    assert out["kernel_adapted"] is True and 0.0 <= out["accept_rate"] <= 1.0
    assert out["chains_sweep"] == {"1": out["value"]}
    assert "CUDA" not in out["unit"] and "Pallas" not in out["unit"]


def test_bench_without_gpu_raises():
    p = _bench(["--smoke"], CUDA_VISIBLE_DEVICES="")
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr
    assert '"metric"' not in p.stdout
