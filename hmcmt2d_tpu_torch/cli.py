"""Command-line driver: run inversions / forward models from a startup file.

PyTorch counterpart of ``hmcmt2d_tpu/cli.py``:

    hmcmt2d-torch run startupfile [--chains N] [--samples S] [--outdir D]
    hmcmt2d-torch forward startupfile -o pred.dat
    python -m hmcmt2d_tpu_torch.cli ...

Runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs on the CPU.  Nothing falls back to the CPU or to a
kernel's plain version on its own.

Several processes shard a run over a (chains, freq) mesh, one rank a GPU:

    torchrun --nproc-per-node 4 -m hmcmt2d_tpu_torch.cli run startup --freq-devices 2
    hmcmt2d-torch run startup --coordinator host:port --num-processes N --process-id i

Rank 0 alone prints the progress and writes the output files.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def _solve_cfg(args, device: torch.device):
    from .models.forward import SolveConfig, default_config

    if args.precision == "auto":
        cfg = default_config(device)
    elif args.precision == "f64":
        cfg = SolveConfig(torch.complex128, 0)
    else:
        cfg = SolveConfig(torch.complex64, args.refine)
    if args.solver != "auto":
        cfg = dataclasses.replace(cfg, solver_method=args.solver)
    if args.inv != "auto":
        cfg = dataclasses.replace(cfg, inv_method=args.inv)
    if cfg.solver_method == "fused":
        # the kernels factor in complex64, so an f64 request cannot be
        # honoured, and refine_iters = 0 would return raw complex64 factor
        # solves with no refinement against the operator
        if cfg.solve_dtype == torch.complex128:
            raise SystemExit("--solver fused is complex64-only; drop "
                             "--precision f64 or pick --solver thomas")
        if cfg.refine_iters < 1:
            cfg = dataclasses.replace(cfg, refine_iters=1)
    return cfg


def _warmup_cfg(args, solve_cfg):
    """Resolve --warmup-solver into a hybrid warmup SolveConfig (or None).

    'auto' warms up with an exact engine whenever the main engine is the
    fused one: at a high-misfit random start the fused engine's residual
    noise can collapse dual averaging.  The engine is bcr, where the JAX
    package takes thomas: over the flagship's 300 production warmup
    iterations on an H100, bcr took 0.71x thomas's seconds with the same
    accept rate and an adapted dt 6% apart (PERF.md, "warmup engines").
    """
    ws = args.warmup_solver
    if ws == "auto":
        ws = "bcr" if solve_cfg.solver_method == "fused" else "same"
    if ws == "same" or ws == solve_cfg.solver_method:
        return None
    # refine_iters = 3 for the exact warmup engine: at extreme high-misfit
    # states the refine-1 potential has cliffs that inexact HMC seeks out
    return dataclasses.replace(
        solve_cfg, solver_method=ws,
        refine_iters=max(solve_cfg.refine_iters, 1) if ws == "fused" else 3)


def _device_mesh(args, cfg, data, dev):
    """The (chains, freq) mesh of this run's ranks, or None: single-process
    on request (--no-shard), and with a warning when the ranks, chains and
    frequencies do not divide."""
    import torch.distributed as dist

    from .parallel.multichain import make_device_mesh

    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if args.no_shard or (n_proc == 1 and args.freq_devices == 1):
        return None
    kf = args.freq_devices
    if n_proc % kf or data.n_freq % kf or cfg.n_chains % (n_proc // kf):
        _say(f"WARNING: cannot shard chains={cfg.n_chains} freqs={data.n_freq} "
             f"over {n_proc} processes (freq_devices={kf}); running "
             f"single-process batched on rank 0. Adjust --chains/--freq-devices "
             f"or pass --no-shard.")
        return None
    _say(f"device mesh: chains={n_proc // kf} x freq={kf} (warmup + "
         f"checkpointing run sharded)")
    return make_device_mesh(n_proc // kf, kf, device=dev)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _say(msg: str) -> None:
    if _rank() == 0:
        print(f"[hmcmt2d] {msg}", flush=True)


def cmd_run(args):
    import contextlib
    import os

    import torch.distributed as dist

    from .io.startup import read_startup
    from .parallel.multichain import distributed_init
    from .sampler.driver import run_inversion

    # several processes (torchrun, or --coordinator): join their group
    joined = distributed_init(
        args.coordinator or None, args.num_processes, args.process_id,
        backend=None if args.backend == "auto" else args.backend,
        device=None if args.device == "cuda" else args.device)
    try:
        dev = joined if joined is not None else _device(args)
        cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile, device=dev)
        if args.chains:
            cfg.n_chains = args.chains
        if args.samples:
            cfg.total_samples = args.samples
        if args.seed is not None:
            cfg.seed = args.seed
        solve_cfg = _solve_cfg(args, dev)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        _say(f"device={dev} ({name}) chains={cfg.n_chains} "
             f"samples={cfg.total_samples} solve={solve_cfg.solver_method} "
             f"inv={solve_cfg.inv_method} "
             f"{str(solve_cfg.solve_dtype).removeprefix('torch.')}")
        dev_mesh = _device_mesh(args, cfg, data, dev)
        if joined is not None and dev_mesh is None:
            # the run is single-process, on rank 0: every rank leaves the
            # group first, so that nothing rank 0 runs alone waits on a peer
            rank = _rank()
            dist.destroy_process_group()
            joined = None
            if rank != 0:
                return 0

        profiler = contextlib.nullcontext()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            from .ops import fused_factor as FF

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if dev.type == "cuda" else [])
            profiler = profile(activities=acts)
            FF.reset_launches()
        with profiler as prof:
            run = run_inversion(cfg, mesh, sigma2d, data, obs, err,
                                solve_cfg=solve_cfg, device=dev, device_mesh=dev_mesh,
                                checkpoint_path=args.checkpoint or None,
                                checkpoint_every=args.checkpoint_every,
                                checkpoint_stride=args.checkpoint_stride,
                                resume=args.resume, verbose=not args.quiet,
                                progress_every=args.progress_every,
                                warmup_solve_cfg=_warmup_cfg(args, solve_cfg))
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, f"trace_rank{_rank()}.json")
            prof.export_chrome_trace(trace)
            print(f"[hmcmt2d] profiler trace written to {trace}", flush=True)
            # the kernels inside a CUDA graph show in the trace under the
            # graph's launch; their counts, and the axis along which the fused
            # engine lays each solved mode's lines, from the mesh's shape
            counts = {k: n for k, n in FF.launches().items() if n}
            print(f"[hmcmt2d] kernel launches: {counts}", flush=True)
            if solve_cfg.solver_method == "fused":
                nzi, nyi = mesh.nz - 1, mesh.ny - 1
                axis = FF.line_axis(nzi, nyi)
                modes = [m for m, on in (("TE", data.comp_te), ("TM", data.comp_tm)) if on]
                print(f"[hmcmt2d] fused lines: {', '.join(f'{m} along {axis}' for m in modes)}"
                      f" (interiors of {nzi} x {nyi})", flush=True)
        if _rank() == 0:
            _write_outputs(args, cfg, run)
        return 0
    finally:
        if joined is not None:
            dist.destroy_process_group()


def _write_outputs(args, cfg, run):
    """The summary lines and the output files of a finished run."""
    from .sampler import diagnostics as D
    from .sampler import outputs as O

    problem, result, wall = run.problem, run.result, run.wall_time

    S, C, P = result.models.shape
    rate = float(result.accepts.double().mean())
    print(f"[hmcmt2d] done in {wall:.1f}s  ({S * C / wall:.2f} samples/s total, "
          f"accept rate {rate:.2f}, nfevals {run.nfevals})")

    O.write_posterior_models(problem, result.models, run.n_warm or cfg.burnin,
                             args.outdir)
    for c in range(C):
        O.write_chain_outputs(result.models, result.stats, result.accepts,
                              result.pred, result.start_stats, chain=c,
                              ichain=c + 1, cputime=wall, outdir=args.outdir,
                              start_pred=result.start_pred,
                              thin=max(args.out_thin, 1))
    if C >= 2:
        rhat = D.split_rhat(result.models)
        print(f"[hmcmt2d] split-R-hat: max={rhat.max():.3f} "
              f"median={np.median(rhat):.3f}")
    print(D.misfit_summary(result.stats))


def cmd_forward(args):
    from .io.data_io import write_data
    from .io.startup import read_startup
    from .models.forward import make_forward

    dev = _device(args)
    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile, device=dev)
    fwd = make_forward(mesh, data, _solve_cfg(args, dev))
    t0 = time.time()
    with torch.no_grad():
        pred = fwd.predict(torch.as_tensor(np.asarray(sigma2d), device=dev)).cpu().numpy()
    wall = time.time() - t0
    res = pred - obs
    nrms = float(np.sqrt(np.mean(np.abs(res / np.maximum(np.abs(err), 1e-300)) ** 2)))
    print(f"[hmcmt2d] forward: {len(pred)} data in {wall:.2f}s, "
          f"normalised RMS vs observed = {nrms:.3f}")
    write_data(args.output, data, pred, err)
    print(f"[hmcmt2d] wrote {args.output}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hmcmt2d-torch",
                                 description="2D MT Bayesian inversion, PyTorch/CUDA")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises without a "
                         "GPU; cpu runs on the CPU)")
    ap.add_argument("--precision", choices=["auto", "f32", "f64"], default="auto")
    ap.add_argument("--refine", type=int, default=1,
                    help="iterative-refinement steps for f32 solves")
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "thomas", "thomas_blocked", "bcr", "fused"],
                    help="factorisation engine (fused = the CUDA kernels)")
    ap.add_argument("--inv", default="auto", choices=["auto", "lu", "gj"],
                    help="batched inverse of thomas, thomas_blocked and bcr: "
                         "lu (partial-pivoting LU; auto) or gj (unpivoted "
                         "Gauss-Jordan, the gj_inverse kernel on the GPU)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run the HMC inversion")
    runp.add_argument("startupfile")
    runp.add_argument("--chains", type=int, default=0)
    runp.add_argument("--samples", type=int, default=0)
    runp.add_argument("--seed", type=int, default=None)
    runp.add_argument("--freq-devices", type=int, default=1,
                      help="ranks on the frequency axis of the process mesh")
    runp.add_argument("--no-shard", action="store_true",
                      help="force single-process batched sampling")
    runp.add_argument("--outdir", default=".")
    runp.add_argument("--checkpoint", default="",
                      help="checkpoint file path (enables periodic dumps)")
    runp.add_argument("--checkpoint-every", type=int, default=0,
                      help="samples per segment")
    runp.add_argument("--checkpoint-stride", type=int, default=1,
                      help="write the checkpoint every this many segments")
    runp.add_argument("--resume", action="store_true",
                      help="resume from --checkpoint (bit-exact)")
    runp.add_argument("--quiet", action="store_true",
                      help="suppress per-segment progress lines")
    runp.add_argument("--progress-every", type=int, default=0,
                      help="segment length for progress lines (no checkpoint)")
    runp.add_argument("--out-thin", type=int, default=1,
                      help="write every Nth sample row of the per-chain "
                           "model/data dumps (stats log stays full)")
    runp.add_argument("--warmup-solver", default="auto",
                      choices=["auto", "same", "thomas", "bcr", "fused"],
                      help="hybrid schedule: engine for the warmup phase "
                           "(auto = bcr when the main engine is fused; "
                           "same = no hybrid)")
    runp.add_argument("--profile", default="",
                      help="write a torch.profiler trace of the run to this "
                           "directory (trace_rank<r>.json)")
    # several processes: torchrun sets RANK/WORLD_SIZE/LOCAL_RANK, or these
    runp.add_argument("--coordinator", default="",
                      help="host:port of rank 0 for a multi-process run")
    runp.add_argument("--num-processes", type=int, default=None)
    runp.add_argument("--process-id", type=int, default=None)
    runp.add_argument("--backend", default="auto", choices=["auto", "nccl", "gloo"],
                      help="collectives backend (auto: nccl when each rank of "
                           "the host has a GPU of its own, else gloo; ranks "
                           "sharing one card need gloo)")
    runp.set_defaults(func=cmd_run)

    fwdp = sub.add_parser("forward", help="forward-model the startup model")
    fwdp.add_argument("startupfile")
    fwdp.add_argument("-o", "--output", default="predicted.dat")
    fwdp.set_defaults(func=cmd_forward)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    # complex64 solves are held to float32 accuracy: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
