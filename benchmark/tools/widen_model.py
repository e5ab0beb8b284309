"""The model file of the full COPROD2 profile, made from the example's:

    python3 benchmark/tools/widen_model.py [--out benchmark/data/coprod2_full.model]

HMCMT2D's ``examples/coprod2`` mesh has 7 padding columns each side (512
km down to 8 km) around 62 core columns of 4 km, under 7 air layers, with
45 earth rows.  The full profile keeps the padding, the rows and the air
layers and halves the core's cells: 212 core columns of 2 km, 424 km.  Each
core column takes the conductivity column of the example's model
(``benchmark/data/coprod2_meanModel.model``) at the same relative position
along the core (the nearest column centre); each padding column copies the
example's.  The origin puts y = 0 12 km inside the core's west end, so the
central 400 km of the core run from y = 0 to y = 400 km.  The values are
written as the example's file writes them (three significant digits), so
every core value is one of the example's, digit for digit.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "benchmark" / "data" / "coprod2_meanModel.model"
OUT = ROOT / "benchmark" / "data" / "coprod2_full.model"
PAD = 7             # padding columns each side, as the example's
CORE_DY = 2000.0    # the full profile's core cells (the example's halved)
CORE_N = 212        # 424 km of core
CORE_MARGIN = 12000.0   # from each end of the core to the central 400 km


def read_blocks(path: Path) -> dict:
    """The example's file: the NY, NAIR and NZ blocks and the conductivity
    rows (nz, ny) of the earth, top down, as numbers."""
    lines = [ln.strip() for ln in path.read_text().splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    out, rows, i = {}, [], 0
    while i < len(lines):
        key = lines[i].split(":")[0].strip()
        if key in ("NY", "NAIR", "NZ"):
            n, vals = int(lines[i].split()[-1]), []
            i += 1
            while len(vals) < n:
                vals += [float(t) for t in lines[i].split()]
                i += 1
            out[key] = np.asarray(vals)
            continue
        if key == "Model Type":
            i += 1
            while i < len(lines) and not lines[i].startswith("Origin"):
                rows.append([float(t) for t in lines[i].split()])
                i += 1
            continue
        i += 1
    out["sigma"] = np.asarray(rows)
    return out


def core_columns(n_src: int, n_out: int) -> np.ndarray:
    """For each of ``n_out`` equal core columns, the index of the nearest of
    ``n_src`` equal source columns by relative position of the centres."""
    centre = (np.arange(n_out) + 0.5) / n_out
    return np.minimum((centre * n_src).astype(int), n_src - 1)


def widen(src: dict) -> dict:
    """The full profile's blocks from the example's."""
    dy = src["NY"]
    left, right = dy[:PAD], dy[-PAD:]
    core_src = src["sigma"][:, PAD:-PAD]
    cols = core_columns(core_src.shape[1], CORE_N)
    sigma = np.concatenate([src["sigma"][:, :PAD], core_src[:, cols],
                            src["sigma"][:, -PAD:]], axis=1)
    ny = np.concatenate([left, np.full(CORE_N, CORE_DY), right])
    return {"NY": ny, "NAIR": src["NAIR"], "NZ": src["NZ"], "sigma": sigma,
            "origin_y": float(left.sum() + CORE_MARGIN), "core_columns": cols}


def _block(name: str, vals: np.ndarray) -> list[str]:
    out = [f"{name + ':':<9}{len(vals):>4}"]
    for k in range(0, len(vals), 8):
        out.append("".join(f"{v:10.2f}" for v in vals[k:k + 8]))
    return out


def render(w: dict) -> str:
    lines = ["#Source: benchmark/tools/widen_model.py from benchmark/data/"
             "coprod2_meanModel.model: its padding, rows and air layers, 212 core "
             "columns of 2 km, each the example's nearest core column",
             "#Format:           EMModel2DFile"]
    lines += _block("NY", w["NY"]) + _block("NAIR", w["NAIR"]) + _block("NZ", w["NZ"])
    lines += ["Resistivity Type:  Conductivity", "Model Type:        Linear"]
    lines += [" ".join(f"{v:.2e}" for v in row) + " " for row in w["sigma"]]
    lines.append(f"Origin (m):     {w['origin_y']:.2f} 0.00")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    args.out.write_text(render(widen(read_blocks(SOURCE))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
