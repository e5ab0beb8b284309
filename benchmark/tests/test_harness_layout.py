"""A configuration, a traffic mix, a metric reader and limits added under
new names are found by those names, with no file of the benchmark edited:
only BENCHMARK.json gains the cell and the metric."""

import hashlib
import json
import time

import torch

from benchmark import harness


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tiny_root):
    bm = tiny_root / "benchmark"
    before = digests(tiny_root)
    cfg = json.loads((bm / "configs/tiny.json").read_text())
    cfg.update(name="tiny_wide", chains=4)
    (bm / "configs/tiny_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bm / "traffic/sample.json").read_text())
    mix.update(check_iterations=1, mass_probes=1)
    (bm / "traffic/brief.json").write_text(json.dumps(mix))
    (bm / "metrics/iterations_seen.py").write_text(
        "def read(rec):\n    return float(rec['iterations'])\n")
    (bm / "limits/tiny_wide.brief.json").write_text(
        (bm / "limits/tiny.sample.json").read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny_wide",
                                file="benchmark/configs/tiny_wide.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="tiny_wide.brief",
                                  config="tiny_wide", traffic="brief"))
    spec["per_layer"].append(dict(spec["per_layer"][0], name="iterations_seen", unit="1",
                                  workloads=["tiny_wide.brief"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = harness.run_cell(tiny_root, "tiny_wide.brief", 77, 1.0, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"] is True
    assert out["attempted"] % 4 == 0
    assert out["metrics"]["iterations_seen"]["value"] == out["attempted"] / 4
    after = digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
