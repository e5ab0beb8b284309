"""The port's command line (``hmcmt2d_tpu_torch/cli.py``) on the CPU.

``run`` on the tiny problem written to a temporary directory, checkpointed
and resumed; ``forward`` against JAX's ``cmd_forward`` (both in complex128;
the files print 7 significant digits, so 1e-10 relative means the same
digits); the engine rules of ``_solve_cfg`` and ``_warmup_cfg`` against
JAX's; and the GPU default.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hmcmt2d_tpu import cli as JC  # noqa: E402
from hmcmt2d_tpu_torch import cli  # noqa: E402
from hmcmt2d_tpu_torch.io import read_data, read_model, write_data, write_model  # noqa: E402
from tests.test_e2e import tiny_setup  # noqa: E402
from tests.torch_parity import port_setup  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
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
warmuppool:    median
masstype:      gaussnewton
masswarmup:    2
massdt0:       0.2
"""


@pytest.fixture(scope="module")
def startup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    mesh, start_sig, data, obs, err = tiny_setup()
    tmesh, tdata = port_setup(mesh, data)
    write_model(d / "start.mod", tmesh, start_sig)
    write_data(d / "obs.dat", tdata, obs, err)
    (d / "startup").write_text(STARTUP)
    return d / "startup"


@pytest.fixture(scope="module")
def jax_forward(startup, tmp_path_factory):
    """JAX's ``hmcmt2d forward`` of the startup file, read back."""
    path = tmp_path_factory.mktemp("jaxfwd") / "jax.dat"
    assert JC.main(["--precision", "f64", "forward", str(startup), "-o", str(path)]) == 0
    return read_data(path)


def _files(d, C):
    names = ["meanModel.model", "stdModel.model"]
    for i in range(1, C + 1):
        names += [f"hmcsamples_id{i}.model", f"hmcsamples_id{i}.data",
                  f"hmcstatistics_id{i}.log"]
    return [d / n for n in names]


def test_run_writes_every_file_and_resumes(startup, tmp_path, capsys):
    out, ck = tmp_path / "out", str(tmp_path / "run.ckpt.npz")
    out.mkdir()
    rc = cli.main(["--device", "cpu", "run", str(startup), "--outdir", str(out),
                   "--checkpoint", ck, "--checkpoint-every", "2"])
    assert rc == 0
    log = capsys.readouterr().out
    assert "[hmcmt2d] warmup 4/4" in log and "dense mass (gn)" in log
    assert "samples 1..2/4" in log and "split-R-hat" in log
    assert all(p.exists() for p in _files(out, 2))
    lines = (out / "hmcstatistics_id2.log").read_text().splitlines()
    assert lines[1].startswith("Totalsamples:     10") and len(lines) == 4 + 10
    assert len((out / "hmcsamples_id1.data").read_text().splitlines()) == 11

    rc = cli.main(["--device", "cpu", "run", str(startup), "--outdir", str(out),
                   "--checkpoint", ck, "--checkpoint-every", "2", "--samples", "14",
                   "--resume", "--out-thin", "2"])
    assert rc == 0
    assert "resumed" in capsys.readouterr().out
    with np.load(ck) as z:
        assert z["models"].shape[:2] == (14, 2) and int(z["n_warm"]) == 6
        assert np.isfinite(z["stats"]).all()
    assert len((out / "hmcsamples_id1.model").read_text().splitlines()) == 7


def test_forward_matches_jax(startup, jax_forward, tmp_path):
    tp = tmp_path / "port.dat"
    assert cli.main(["--device", "cpu", "--precision", "f64", "forward",
                     str(startup), "-o", str(tp)]) == 0
    _, jv, je = jax_forward
    _, tv, te = read_data(tp)
    np.testing.assert_allclose(tv, jv, rtol=1e-10, atol=0)
    np.testing.assert_allclose(te, je, rtol=1e-10, atol=0)


def test_default_device_needs_a_gpu(startup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", str(startup)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["forward", str(startup)])


def _args(**kw):
    base = dict(precision="f32", refine=1, solver="thomas", inv="auto",
                warmup_solver="auto")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("precision,solver,refine", [
    ("f32", "thomas", 2), ("f32", "fused", 0), ("f32", "fused", 4),
    ("f64", "thomas", 1)])
@pytest.mark.parametrize("warmup", ["auto", "same", "thomas", "fused"])
def test_engine_rules_match_jax(precision, solver, refine, warmup):
    a = _args(precision=precision, solver=solver, refine=refine, warmup_solver=warmup)
    t, j = cli._solve_cfg(a, torch.device("cpu")), JC._solve_cfg(a)
    assert (t.solver_method, t.refine_iters, t.real_dtype.itemsize) == (
        j.solver_method, j.refine_iters, np.dtype(j.real_dtype).itemsize)
    tw, jw = cli._warmup_cfg(a, t), JC._warmup_cfg(a, j)
    assert (tw is None) == (jw is None)
    if tw is not None:
        # under a fused main engine 'auto' warms up on bcr in the port, on
        # thomas in JAX (a deliberate difference, measured on the card)
        port_auto = warmup == "auto" and t.solver_method == "fused"
        want = "bcr" if port_auto else jw.solver_method
        assert (tw.solver_method, tw.refine_iters) == (want, jw.refine_iters)


def test_fused_f64_is_refused():
    a = _args(precision="f64", solver="fused")
    with pytest.raises(SystemExit):
        cli._solve_cfg(a, torch.device("cpu"))
    with pytest.raises(SystemExit):
        JC._solve_cfg(a)


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "hmcmt2d_tpu_torch.cli", "run", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--warmup-solver" in out.stdout


def test_multi_process_flags_parse():
    a = cli.build_parser().parse_args([
        "run", "s", "--freq-devices", "2", "--no-shard", "--coordinator", "h:29500",
        "--num-processes", "4", "--process-id", "3", "--backend", "gloo",
        "--profile", "prof"])
    assert (a.freq_devices, a.no_shard, a.coordinator, a.num_processes, a.process_id,
            a.backend, a.profile) == (2, True, "h:29500", 4, 3, "gloo", "prof")
    d = cli.build_parser().parse_args(["run", "s"])
    assert (d.freq_devices, d.no_shard, d.coordinator, d.backend, d.profile) == (
        1, False, "", "auto", "")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["run", "s", "--backend", "mpi"])


@pytest.mark.parametrize("flags,warns", [
    (["--freq-devices", "2"], True),
    (["--freq-devices", "2", "--no-shard"], False)], ids=["unshardable", "no-shard"])
def test_single_process_run_with_shard_flags(startup, tmp_path, capsys, flags, warns):
    """One process cannot shard 2 frequency ranks: the run warns and goes
    on single-process; --no-shard asks for that and does not warn.  The
    second also writes a torch.profiler trace."""
    prof = tmp_path / "prof"
    rc = cli.main(["--device", "cpu", "run", str(startup), "--outdir", str(tmp_path),
                   "--samples", "8", "--quiet", "--profile", str(prof), *flags])
    log = capsys.readouterr().out
    assert rc == 0 and ("WARNING: cannot shard" in log) == warns
    assert "device mesh" not in log
    assert all(p.exists() for p in _files(tmp_path, 2))
    assert (prof / "trace_rank0.json").stat().st_size > 0
    # the plain versions the CPU runs count no launch
    assert "[hmcmt2d] kernel launches: {}" in log


def test_profile_prints_each_modes_line_axis(startup, tmp_path, capsys):
    """Under the fused engine --profile prints, beside the launch counts,
    the axis along which each solved mode's lines lie: line_axis of the
    mesh's interior shape (the tiny mesh's 10 x 9 interiors: z)."""
    from hmcmt2d_tpu_torch.ops.fused_factor import line_axis

    rc = cli.main(["--device", "cpu", "--precision", "f32", "--refine", "6", "--solver",
                   "fused", "run", str(startup), "--outdir", str(tmp_path), "--samples", "4",
                   "--quiet", "--profile", str(tmp_path / "prof")])
    log = capsys.readouterr().out
    mesh = read_model(startup.parent / "start.mod", device="cpu")[0]
    nzi, nyi = mesh.nz - 1, mesh.ny - 1
    axis = line_axis(nzi, nyi)
    assert rc == 0 and "[hmcmt2d] kernel launches: {}" in log
    assert (f"[hmcmt2d] fused lines: TE along {axis}, TM along {axis} "
            f"(interiors of {nzi} x {nyi})") in log


def _two_ranks(startup, out, chains):
    """``hmcmt2d-torch run`` in two processes joined with --coordinator."""
    import os

    from hmcmt2d_tpu_torch.parallel.multichain import free_port

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hmcmt2d_tpu_torch.cli", "--device", "cpu", "run",
         str(startup), "--outdir", str(out), "--samples", "8", "--chains", str(chains),
         "--backend", "gloo", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


@pytest.mark.parametrize("chains,sharded", [(2, True), (3, False)],
                         ids=["sharded", "chains-do-not-divide"])
def test_two_rank_run_writes_each_file_once(startup, tmp_path, chains, sharded):
    """Two gloo ranks on the CPU: 2 chains shard over them; 3 do not, and
    rank 0 runs alone after the warning.  Rank 0 alone prints and writes
    the output files."""
    out0, out1 = _two_ranks(startup, tmp_path, chains)
    assert "[hmcmt2d]" not in out1
    assert ("device mesh: chains=2 x freq=1" in out0) == sharded
    assert ("WARNING: cannot shard chains=3" in out0) != sharded
    assert "done in" in out0 and "split-R-hat" in out0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in _files(tmp_path, chains))
    lines = (tmp_path / "hmcstatistics_id1.log").read_text().splitlines()
    assert lines[1].split()[:2] == ["Totalsamples:", "8,"] and len(lines) == 4 + 8
