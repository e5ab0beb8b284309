"""The readings the limits of a cell are set from, in one process:

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--seconds 10] [--out FILE]

For each seed, one run of the cell as ``benchmark/run.py`` makes it (set-up,
a window of ``--seconds``, the check), its compared numbers; for each of
``--control-seeds``, also those of the control: the plain reference in
complex64 with TF32 on in the program's place, on the same drawn states and
draws.  One JSON line a seed on standard output, appended to ``--out`` too
when given.  Needs the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check as CK  # noqa: E402
from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    _, cell = harness.find_cell(ROOT, args.workload)
    harness.check_device(cell["chips"])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in args.seeds:
        also = None
        if seed in args.control_seeds:
            def also(kept, cfg, mix, inp, limits, dev, s):
                t = time.perf_counter()
                got = CK.control_readings(kept, cfg, mix, inp, s, limits, dev)
                log(f"[calibrate] control {time.perf_counter() - t:.1f} s")
                return got
        t = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               torch.device("cuda"), t, log, also=also)
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t,
                "correct": res["correct"], "failed": res["failed"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "control": res.get("also"), "metrics": res["metrics"]}
        print(json.dumps(line), flush=True)
        if args.out is not None:
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
