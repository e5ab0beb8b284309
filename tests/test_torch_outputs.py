"""Port parity of the output files and diagnostics (``sampler/outputs.py``,
``sampler/diagnostics.py``).

The same arrays, made with numpy from a seed, go through both packages'
writers; the files must agree byte for byte, apart from the model files'
``file generated in ...`` timestamp line.  The diagnostics are a numpy copy
and must agree exactly (tolerance 0).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hmcmt2d_tpu.sampler import diagnostics as JDg  # noqa: E402
from hmcmt2d_tpu.sampler import outputs as JO  # noqa: E402
from hmcmt2d_tpu_torch.sampler import diagnostics as TDg  # noqa: E402
from hmcmt2d_tpu_torch.sampler import outputs as TO  # noqa: E402
from tests.torch_parity import tiny_problems  # noqa: E402


def _no_stamp(path):
    return [ln for ln in path.read_text().splitlines() if "file generated in" not in ln]


def _chains(S=11, C=3, P=6, D=4, complex_pred=True, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((S, C, D))
    start_pred = rng.standard_normal((C, D))
    if complex_pred:
        pred = pred + 1j * rng.standard_normal((S, C, D))
        start_pred = start_pred + 1j * rng.standard_normal((C, D))
    return dict(models=rng.standard_normal((S, C, P)).astype(np.float32),
                stats=np.abs(rng.standard_normal((S, C, 4))) * 100,
                accepts=rng.random((S, C)) > 0.5,
                pred=pred.astype(np.complex64 if complex_pred else np.float32),
                start_stats=np.abs(rng.standard_normal((C, 4))) * 1000,
                start_pred=start_pred)


@pytest.fixture(scope="module")
def problems():
    jprob, tprob, _ = tiny_problems()
    return jprob, tprob


@pytest.mark.parametrize("complex_pred,thin,as_tensor", [
    (True, 3, False), (False, 3, True), (True, 1, True)],
    ids=["complex-thin3", "real-thin3-tensors", "complex-thin1-tensors"])
def test_chain_outputs_are_jax_bytes(tmp_path, complex_pred, thin, as_tensor):
    a = _chains(complex_pred=complex_pred)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for c in range(3):
        JO.write_chain_outputs(**a, chain=c, ichain=c + 1, cputime=12.5,
                               outdir=str(tmp_path / "j"), thin=thin)
        ta = {k: torch.as_tensor(v) for k, v in a.items()} if as_tensor else a
        TO.write_chain_outputs(**ta, chain=c, ichain=c + 1, cputime=12.5,
                               outdir=str(tmp_path / "t"), thin=thin)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 9
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    lines = (tmp_path / "t" / "hmcsamples_id2.model").read_text().splitlines()
    assert len(lines) == len(range(0, 11, thin))


def test_posterior_and_thinned_models_are_jax_bytes(tmp_path, problems):
    jprob, tprob = problems
    rng = np.random.default_rng(1)
    models = (np.log(0.01) + 0.3 * rng.standard_normal((9, 2, tprob.n_param))
              ).astype(np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jm, js = JO.write_posterior_models(jprob, models, 3, str(tmp_path / "j"))
    tm, ts = TO.write_posterior_models(tprob, torch.as_tensor(models), 3,
                                       str(tmp_path / "t"))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    JO.write_thinned_models(jprob, models, chain=1, start=1, step=4,
                            outdir=str(tmp_path / "j"))
    TO.write_thinned_models(tprob, models, chain=1, start=1, step=4,
                            outdir=str(tmp_path / "t"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert "meanModel.model" in names and "hmcmodel_iter6.model" in names
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert _no_stamp(tmp_path / "t" / n) == _no_stamp(tmp_path / "j" / n), n


@pytest.mark.parametrize("fn", ["split_rhat", "ess", "ess_tail"])
def test_diagnostics_match_jax(fn):
    rng = np.random.default_rng(2)
    S, C, P = 40, 4, 7
    walk = np.cumsum(rng.standard_normal((S, C, P)), axis=0) * 0.1
    samples = walk + rng.standard_normal((S, C, P))
    samples[:, 1] += 0.5                      # one chain off-centre
    samples[::3, :, 0] = samples[0, :, 0]     # ties, as MH rejections make
    want = getattr(JDg, fn)(samples)
    np.testing.assert_array_equal(getattr(TDg, fn)(samples), want)
    np.testing.assert_array_equal(getattr(TDg, fn)(torch.as_tensor(samples)), want)


def test_misfit_summary_and_mean_std_match_jax():
    a = _chains()
    assert TDg.misfit_summary(torch.as_tensor(a["stats"])) == JDg.misfit_summary(a["stats"])
    for got, want in zip(TO.posterior_mean_std(a["models"], 4),
                         JO.posterior_mean_std(a["models"], 4)):
        np.testing.assert_array_equal(got, want)
