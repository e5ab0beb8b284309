"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory holding a tiny configuration (12 x 8 cells under 3 air layers,
4 receivers, 3 frequencies, 2 chains) and a tiny cell of each phase, with
the repository's traffic mixes and metric readers."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)

NY, NZ, AIR = 12, 8, (100.0, 1000.0, 10000.0)


def write_tiny_model(path: Path, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    dy = np.array([1600.0, 800, 400] + [200.0] * (NY - 6) + [400, 800, 1600])
    dz = np.array([100.0] * 5 + [200.0, 400, 800])
    sig = 0.01 * np.exp(0.5 * rng.standard_normal((NZ, NY)))
    lines = ["#Format: EMModel2DFile", f"NY: {NY}", " ".join(f"{v:.2f}" for v in dy),
             f"NAIR: {len(AIR)}", " ".join(f"{v:.2f}" for v in AIR), f"NZ: {NZ}",
             " ".join(f"{v:.2f}" for v in dz), "Resistivity Type: Conductivity",
             "Model Type: Linear"]
    lines += [" ".join(f"{v:.4e}" for v in row) for row in sig]
    lines.append(f"Origin (m): {dy.sum() / 2:.2e} 0.00e+00")
    path.write_text("\n".join(lines) + "\n")


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/dprism2d.json").read_text())
    dy = np.array([1600.0, 800, 400] + [200.0] * (NY - 6) + [400, 800, 1600])
    y0 = np.cumsum(dy)[2] - dy.sum() / 2
    cfg.update(name="tiny", model_file="benchmark/data/tiny.model",
               receivers={"count": 4, "first_y_m": y0 + 100, "last_y_m": y0 + 1100},
               freqs_hz=[10.0, 1.0, 0.1], chains=2, main_dt=0.02)
    cfg["gn_mass"]["chunk"] = 16
    return cfg


def make_root(tmp: Path) -> Path:
    """A checkout root: the repository's benchmark files and a tiny config
    with a cell of each phase."""
    root = tmp / "checkout"
    bm = root / "benchmark"
    for sub in ("traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bm / sub)
    (bm / "configs").mkdir(parents=True)
    (bm / "data").mkdir()
    (bm / "limits").mkdir()
    write_tiny_model(bm / "data/tiny.model")
    (bm / "configs/tiny.json").write_text(json.dumps(tiny_config()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(spec["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    spec["workloads"] = [dict(spec["workloads"][0], name=f"tiny.{t}", config="tiny", traffic=t)
                         for t in ("sample", "warmup")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("dprism2d", "tiny") for w in m["workloads"]
                              if w.startswith("dprism2d")]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for t in ("sample", "warmup"):
        (bm / f"limits/tiny.{t}.json").write_text(json.dumps(TINY_LIMITS[t]))
    return root


# limits of the tiny cells, over the readings of the tiny configuration's
# program on the CPU (seeds 1-3: u 2e-4 - 8e-4, grad 2e-3 - 1e-2, pred
# 3e-5 - 6e-5, traj <= 3e-4, mass <= 2e-4, alpha <= 1e-2, adapt <= 2e-7)
COMMON = {"u_gap": 5e-3, "grad_gap": 5e-2, "pred_gap": 1e-3, "traj_gap": 5e-3,
          "steps_wrong": 0, "mh_margin": 0.5}
TINY_LIMITS = {"sample": dict(COMMON, mass_gap=5e-3),
               "warmup": dict(COMMON, adapt_gap=0.1)}


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
