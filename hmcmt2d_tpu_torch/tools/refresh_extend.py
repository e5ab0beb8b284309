"""Continue a checkpointed run with a refreshed Gauss-Newton mass matrix.

The GN metric of a run is built at the warmed-up model.  Where a long
descent follows the warmup, the curvature at the plateau is much larger, the
stale metric under-estimates it and the adapted step size stays tiny.  This
tool loads the checkpoint, rebuilds M = J'W^2J + reg Wm at the current
pooled model (J under the thomas engine with 3 refinement steps when the
main engine is the fused kernels), re-adapts the step size under the fixed
new metric from the checkpoint's state, and samples an extension with it.
It writes a self-contained checkpoint: its rows are the re-adaptation's and
the extension's, its ``n_warm`` the re-adaptation count, so
:mod:`.summarize_checkpoint` reads the refreshed kernel's window alone.

Counterpart of ``scripts/refresh_extend.py``, on a single-process run's
checkpoint (it refuses a sharded one).  Its draws come from their own
streams (``STREAM_REFRESH_WARMUP``, ``STREAM_REFRESH_MAIN`` of
``sampler/hmc.py``), so an extension never replays the run's own.  Usage::

    python -m hmcmt2d_tpu_torch.tools.refresh_extend <startupfile> <checkpoint.npz>
        <out_checkpoint.npz> [--samples 3000] [--readapt 104] [--seg 8]
        [--dt0 0.05] [--stride 25] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..device import to_numpy
from ..io.startup import read_startup
from ..models.forward import default_config, make_forward
from ..models.posterior import build_inverse_problem
from ..sampler import adapt as A
from ..sampler import checkpoint as CK
from ..sampler import hmc as H
from ..sampler.driver import (BatchedSampler, _Outputs, _segment_plan,
                              gauss_newton_mass, hmc_options, warmup_segments)
from . import add_device_arg, device_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hmcmt2d_tpu_torch.tools.refresh_extend",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("startupfile")
    ap.add_argument("checkpoint")
    ap.add_argument("out_checkpoint")
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--readapt", type=int, default=104)
    ap.add_argument("--seg", type=int, default=8)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("--dt0", type=float, default=0.05)
    ap.add_argument("--jac-chunk", type=int, default=128)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = device_of(args)
    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile, device=dev)
    scfg = default_config(dev)
    problem, _ = build_inverse_problem(mesh, data, obs, err, to_numpy(sigma2d).ravel(),
                                       sigma_fixed=cfg.sig_fix, cfg=scfg, device=dev)
    # the exact engine for the Jacobian, as the run's GN build takes it
    cfg_j = (dataclasses.replace(scfg, solver_method="thomas", refine_iters=3)
             if scfg.solver_method == "fused" else scfg)
    problem_j = dataclasses.replace(problem, fwd=make_forward(problem.mesh, data, cfg_j))

    # single-process: a sharded run's state carries the whole response cube
    ck = CK.load_checkpoint(args.checkpoint, dev, path_kind="single")
    state, m_ref, seed = ck["state"], ck["m_ref"], ck["key"]
    print(f"[refresh] loaded {args.checkpoint}: {ck['n_done']} samples done, "
          f"old dt={ck['dt']:.4g}", flush=True)

    amortize = cfg.amortize and scfg.solver_method != "fused"
    eng = BatchedSampler(problem, cfg.reg_param, amortize)
    opts = dataclasses.replace(hmc_options(cfg), dt=args.dt0)

    t0 = time.time()
    mass = gauss_newton_mass(problem, state.m.mean(dim=0), cfg.reg_param,
                             jac_problem=problem_j, chunk=args.jac_chunk,
                             log=lambda msg: print(f"[refresh] {msg}", flush=True))
    print(f"[refresh] GN mass rebuilt at the current model in "
          f"{time.time() - t0:.1f}s", flush=True)

    # step-size re-adaptation under the fixed new metric, from the state
    wopts = A.WarmupOptions(adapt_mass=False, target_accept=cfg.target_accept,
                            alpha_pool=cfg.warmup_pool)
    out = _Outputs()

    def on_segment(done, n, carry, wout, secs):
        out.add(*wout)
        print(f"[refresh] readapt {done}/{args.readapt}: "
              f"misfit={float(wout[1][-1, :, 0].mean()):.4g} "
              f"dt={float(torch.exp(carry.da.log_eps)):.4g} "
              f"({n * state.m.shape[0] / secs:.2f} samples/s)", flush=True)

    carry = warmup_segments(eng, opts, m_ref, A.carry_from_state(state, args.dt0), seed,
                            0, np.zeros(args.readapt, bool), wopts, args.seg,
                            fixed_mass=mass, on_segment=on_segment,
                            stream=H.STREAM_REFRESH_WARMUP)
    _, info = A.warmup_finalize(carry)
    state = carry.state
    opts = dataclasses.replace(opts, dt=float(info.dt))
    print(f"[refresh] refreshed kernel: dt={opts.dt:.4g} "
          f"accept~{float(info.alpha_mean):.2f}", flush=True)

    # the extension, sampled with the refreshed kernel
    n_done = 0
    segs = _segment_plan(args.samples, args.seg)
    for i_seg, n_seg in enumerate(segs):
        t_seg = time.time()
        res = H.run_hmc(eng.potential_vg, opts, mass, state.m, m_ref, n_seg, seed,
                        init_state=state, key_offset=n_done, factor_fn=eng.factor_fn,
                        stream=H.STREAM_REFRESH_MAIN)
        state = res.final
        n_done += n_seg
        out.add(res.models, res.stats, res.accepts, res.pred, res.lf_steps)
        if (i_seg + 1) % max(args.stride, 1) == 0 or i_seg == len(segs) - 1:
            models, stats, accepts, pred, lf = out.arrays()
            CK.save_checkpoint(
                args.out_checkpoint, n_done=n_done, state=state, key=seed, dt=opts.dt,
                mass=mass, m_ref=m_ref, models=models, stats=stats, accepts=accepts,
                pred=pred, lf_steps=lf, start_stats=ck["start_stats"],
                start_pred=ck["start_pred"], n_warm=args.readapt,
                wall_time=ck["wall_time"] + time.time() - t0)
        if (i_seg + 1) % 5 == 0 or i_seg == len(segs) - 1:
            print(f"[refresh] samples {n_done}/{args.samples}: "
                  f"misfit={float(res.stats[-1, :, 0].mean()):.4g} "
                  f"accept={float(res.accepts.double().mean()):.2f} "
                  f"({n_seg * res.models.shape[1] / (time.time() - t_seg):.2f} "
                  f"samples/s)", flush=True)
    print(f"[refresh] done: {n_done} extension samples in "
          f"{time.time() - t0:.1f}s -> {args.out_checkpoint}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
