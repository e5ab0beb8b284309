"""How a configuration's fixed main-phase step size (``main_dt``) was
found, once, on the card:

    python3 benchmark/tools/adapt_dt.py --config <name> [--seed 0] [--iterations 56]

The sample cell's set-up (inputs from the seed, the fused engine, the
Gauss-Newton mass at the model file), then dual averaging of dt alone from
0.2 under that mass for ``--iterations`` iterations, as the port's bench
re-adapts it; prints the adapted dt and the mean acceptance.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import sampler as RS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=56)
    ap.add_argument("--dt0", type=float, default=0.2)
    args = ap.parse_args()
    harness.check_device(1)
    from hmcmt2d_tpu_torch.sampler import adapt as A

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = harness.load(ROOT, "configs", args.config)
    mix = harness.load(ROOT, "traffic", "sample")
    inp = harness.make_inputs(ROOT, cfg, args.seed, dev)
    t = time.perf_counter()
    phase = harness.SamplePhase(ROOT, cfg, mix, inp, dev, harness.Spans(False, dev))
    setup = time.perf_counter() - t
    opts = harness.hmc_options(cfg, args.dt0)
    w = A.WarmupOptions(adapt_mass=False, alpha_pool=cfg["warmuppool"])
    carry = A.carry_from_state(phase.state, args.dt0)
    keys = [RS.generator(args.seed, RS.STREAM_WARMUP, i, dev) for i in range(args.iterations)]
    t = time.perf_counter()
    carry, outs = A.warmup_scan(phase.vg, opts, phase.m_ref, carry, keys,
                                np.zeros(args.iterations, bool), w, fixed_mass=phase.mass)
    _, info = A.warmup_finalize(carry)
    torch.cuda.synchronize()
    line = {"config": args.config, "seed": args.seed, "iterations": args.iterations,
            "dt0": args.dt0, "dt": float(info.dt), "alpha_mean": float(info.alpha_mean),
            "accept": float(outs[2].double().mean()), "setup_s": setup,
            "seconds": time.perf_counter() - t}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
