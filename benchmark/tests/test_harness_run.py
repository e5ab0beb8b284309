"""The harness end to end on the tiny configuration with the kernels'
plain versions (the CPU), and the shape of its result line."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, workload, trace=False, seconds=1.0, seed=2**31 + 12345):
    return harness.run_cell(root, workload, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda msg: None)


@pytest.mark.parametrize("phase", ["sample", "warmup"])
def test_tiny_cell_is_correct(tiny_root, phase):
    out = run(tiny_root, f"tiny.{phase}")
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["attempted"] % 2 == 0
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"} | (
        {"iter_ms_p90"} if phase == "sample" else set())
    assert all(v["value"] > 0 for v in out["metrics"].values())
    want = {"u_gap", "grad_gap", "pred_gap", "traj_gap", "steps_wrong"} | ({"mass_gap"} if phase == "sample" else {"adapt_gap"})
    assert set(out["checks"]) == want
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    json.dumps(out)


def test_traced_line_has_device_window(tiny_root):
    out = run(tiny_root, "tiny.sample", trace=True)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(dev)
    assert dev["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no CUDA events and no kernels here: every reader finds nothing to read
    assert out["metrics"] == {}


def test_same_seed_same_inputs(tiny_root):
    cfg = harness.load(tiny_root, "configs", "tiny")
    a = harness.make_inputs(tiny_root, cfg, 2**33 + 7, torch.device("cpu"))
    b = harness.make_inputs(tiny_root, cfg, 2**33 + 7, torch.device("cpu"))
    c = harness.make_inputs(tiny_root, cfg, 2**33 + 8, torch.device("cpu"))
    assert (a.obs == b.obs).all() and torch.equal(a.m_start, b.m_start)
    assert not (a.obs == c.obs).all()


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output (decided here only when this machine has no card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dprism2d.sample",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "hmcmt2d_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN for n in harness.forbidden_modules())
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "hmcmt2d_tpu.ops", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert set(harness.forbidden_modules()) - before == {"hmcmt2d_tpu.ops", "jaxlib"}
