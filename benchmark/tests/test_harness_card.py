"""On the card (marked ``cuda``; each test decides whether a card is
present and skips without one): one short run of a cell through the
command, and the control of a cell at its own size, which has to read
past the cell's limits.

    python -m pytest -m cuda benchmark/tests -q
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

CELLS = ["dprism2d.sample", "dprism2d.warmup"]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct(workload):
    need_card()
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                        "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    need_card()
    from benchmark import check as CK
    from benchmark import harness

    got = {}

    def control(kept, cfg, mix, inp, limits, dev, seed):
        got.update(CK.control_readings(kept, cfg, mix, inp, seed, limits, dev))
        return limits

    out = harness.run_cell(ROOT, workload, 2**31 + 77, 3.0, False, torch.device("cuda"),
                           time.perf_counter(), log=lambda m: None, also=control)
    limits = out["also"]
    assert any(v > limits[k] for k, v in got.items()), got
