"""The port as a package: carrying state across, entry points, device
defaults, and independence from JAX and from ``hmcmt2d_tpu``."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hmcmt2d_tpu_torch  # noqa: E402
from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu_torch import convert, entry, make_mesh  # noqa: E402
from hmcmt2d_tpu_torch.models import forward as TF  # noqa: E402
from hmcmt2d_tpu_torch.models import posterior as TP  # noqa: E402
from hmcmt2d_tpu_torch.parallel import multichain  # noqa: E402
from hmcmt2d_tpu_torch.sampler.hmc import (ChainState, dense_mass,  # noqa: E402
                                           identity_mass)
from tests.torch_parity import problem_arrays  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(hmcmt2d_tpu_torch.__file__).resolve().parent


@pytest.fixture(scope="module")
def jax_tiny():
    return _flagship_problem(tiny=True)


def _assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if g.dtype.kind in "US":
            assert g.tolist() == w.tolist(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_flagship_arrays_match_jax_flagship_problem(jax_tiny):
    jprob, jm0 = jax_tiny
    tprob, tm0 = entry.flagship_problem(tiny=True, device="cpu")
    _assert_same_arrays(convert.problem_to_arrays(tprob), problem_arrays(jprob))
    np.testing.assert_array_equal(tm0, np.asarray(jm0))
    assert tprob.fwd.cfg == TF.default_config("cpu")


def test_problem_round_trip(jax_tiny):
    arrays = problem_arrays(jax_tiny[0])
    prob = convert.problem_from_arrays(arrays, device="cpu")
    _assert_same_arrays(convert.problem_to_arrays(prob), arrays)
    with pytest.raises(KeyError):
        convert.problem_from_arrays({k: v for k, v in arrays.items() if k != "obs"},
                                    device="cpu")


def test_chain_state_round_trip():
    rng = np.random.default_rng(0)
    arrays = dict(m=rng.standard_normal((2, 5)).astype(np.float32),
                  grad=rng.standard_normal((2, 5)).astype(np.float32),
                  misfit=rng.uniform(size=2), mnorm=rng.uniform(size=2),
                  pred=rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3)))
    state = convert.chain_state_from_arrays(arrays, device="cpu")
    assert isinstance(state, ChainState) and state.m.dtype == torch.float32
    _assert_same_arrays(convert.chain_state_to_arrays(state), arrays)


def test_entry_step_runs_on_cpu():
    step, (m0,) = entry.entry(device="cpu")
    assert m0.dtype == torch.float32 and m0.shape == (4704,)
    U, misfit, grad = step(m0.double())
    assert grad.shape == (4704,) and torch.isfinite(grad).all()
    assert float(U) == pytest.approx(float(misfit))     # m = m_ref: no prior


def test_entry_points_without_gpu_raise(monkeypatch, jax_tiny):
    """device=None means the GPU; without one every entry point raises and
    none carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = problem_arrays(jax_tiny[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.default_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.flagship_problem(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        multichain.rank_device()
    # under torchrun's variables the rank's device is its GPU, or an error
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        multichain.distributed_init()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.problem_from_arrays(arrays)
    tprob, _ = entry.flagship_problem(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.build_inverse_problem(tprob.mesh, tprob.fwd.data, tprob.obs,
                                 1.0 / tprob.weights, np.ones(tprob.mesh.n_cell))
    assert TF.default_config("cpu") == TF.SolveConfig(torch.complex128, 0, "thomas")


@pytest.mark.parametrize("make", [
    lambda dev: make_mesh([1.0, 2.0], [1.0, 1.0], device=dev),
    lambda dev: identity_mass(3, device=dev),
    lambda dev: dense_mass(np.eye(3), device=dev),
], ids=["make_mesh", "identity_mass", "dense_mass"])
def test_constructors_without_gpu_raise(monkeypatch, make):
    """The public constructors default to the GPU too: without one and
    without a device they raise; device='cpu' still builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make(None)
    built = make("cpu")
    tensors = (built.y_len,) if hasattr(built, "y_len") else built[:2]
    assert all(t.device.type == "cpu" for t in tensors)


def test_gpu_default_config_is_fused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TF.default_config() == TF.SolveConfig(torch.complex64, 6, "fused")
    assert TF.default_config("cuda") == TF.SolveConfig(torch.complex64, 6, "fused")


def test_import_pulls_in_no_jax():
    """Importing the package and every submodule leaves jax and
    hmcmt2d_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hmcmt2d_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'jaxlib' or n == 'hmcmt2d_tpu' or n.startswith('hmcmt2d_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('hmcmt2d_tpu_torch')]))\n"
        "print(bad)\n"
        "print(all(n in sys.modules for n in ('hmcmt2d_tpu_torch.parallel.multichain',\n"
        "                                     'hmcmt2d_tpu_torch.utils.collectives',\n"
        "                                     'hmcmt2d_tpu_torch.native',\n"
        "                                     'hmcmt2d_tpu_torch.utils.cpu_reference',\n"
        "                                     'hmcmt2d_tpu_torch.tools.summarize_checkpoint',\n"
        "                                     'hmcmt2d_tpu_torch.tools.refresh_extend',\n"
        "                                     'hmcmt2d_tpu_torch.tools.map_fit')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_loaded, bad, sharded_loaded = out.stdout.strip().splitlines()
    assert int(n_loaded) >= 18 and sharded_loaded == "True"
    assert bad == "[]"


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 18 and PKG / "parallel" / "multichain.py" in files
    for new in (PKG / "native.py", PKG / "utils" / "cpu_reference.py",
                PKG / "tools" / "summarize_checkpoint.py",
                PKG / "tools" / "refresh_extend.py", PKG / "tools" / "map_fit.py"):
        assert new in files, new
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "hmcmt2d_tpu"), (path, name)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a GPU,
    and also when it stands alone, without the package beside it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
