"""The benchmark of ``hmcmt2d_tpu_torch``: one cell, one run.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell that ``BENCHMARK.json`` names: its
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<mix>.json``), its limits (``benchmark/limits/
<cell>.json``) and, with ``--trace 1``, the readers of its per-layer
metrics (``benchmark/metrics/<metric>.py``), each found by its name.

A run builds the inputs from the seed (the observations from the plain
reference's complex128 prediction at the model file, the chain starts),
sets the program up (engine, graphs, the dense mass or the adapter, the
first iteration), then drives one HMC iteration a call for ``--seconds``
and times each; with ``--trace 1`` CUDA events frame every call into the
eval and the factor, and the profiler records a few iterations after the
window.  Then the program's memory peak is read, its state freed, and the
plain reference (``benchmark/reference``) judges iterations drawn from the
seed (:mod:`benchmark.check`).  The last line of standard output is the
result, and the compared numbers close standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check as CK
from .check import SEED_NOISE, SEED_STARTS, sub_seed
from .reference import forward as RF
from .reference import sampler as RS

FORBIDDEN = ("jax", "jaxlib", "flax", "hmcmt2d_tpu")


class NoDevice(RuntimeError):
    """The run cannot start: fewer cards than the cell asks for."""


def load(root: Path, kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json`` under the checkout ``root``."""
    return json.loads((root / "benchmark" / kind / f"{name}.json").read_text())


def find_cell(root: Path, workload: str) -> tuple[dict, dict]:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return spec, cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metric_readers(root: Path, spec: dict, workload: str) -> dict:
    """name -> read(records) of the per-layer metrics this cell reports."""
    import importlib.util

    out = {}
    for m in spec["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        path = root / "benchmark" / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(f"metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        out[m["name"]] = (mod.read, m["unit"])
    return out


def check_device(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands both sides."""

    model: RF.Model
    rx_y: np.ndarray
    freqs: np.ndarray
    obs: np.ndarray            # (ndata,) complex128
    err: np.ndarray            # (ndata,)
    m_start: torch.Tensor      # (C, P) float32 chain starts, also the prior's reference


def make_inputs(root: Path, cfg: dict, seed: int, dev: torch.device) -> Inputs:
    model = RF.read_model(root / cfg["model_file"])
    rx = cfg["receivers"]
    rx_y = np.linspace(rx["first_y_m"], rx["last_y_m"], rx["count"])
    freqs = np.asarray(cfg["freqs_hz"], np.float64)
    ref = RF.Reference(model, rx_y, freqs, dev)
    with torch.no_grad():
        pred = ref.predict(ref.true_m()[None])[0]
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, SEED_NOISE))
    n = torch.randn((2,) + pred.shape, generator=gen, dtype=torch.float64, device=dev)
    obs = pred * (1 + cfg["noise"] * torch.complex(n[0], n[1]) / math.sqrt(2))
    err = cfg["noise"] * obs.abs()
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, SEED_STARTS))
    P = ref.n_param
    m_true = ref.true_m()
    z = torch.randn((cfg["chains"], P), generator=gen, dtype=torch.float64, device=dev)
    m_start = (m_true + cfg["start_spread"] * z).to(torch.float32)
    return Inputs(model, rx_y, freqs, obs.cpu().numpy(), err.cpu().numpy(), m_start)


def solve_config(d: dict):
    from hmcmt2d_tpu_torch.models.forward import SolveConfig

    return SolveConfig(getattr(torch, d["dtype"]), d["refine"], d["method"], d["inv"],
                       stale_refine_iters=d.get("stale_refine", 10))


def build_problem(root: Path, cfg: dict, inp: Inputs, solve: dict, dev):
    """The program's inverse problem over the model file and the inputs."""
    from hmcmt2d_tpu_torch.io.model_io import read_model
    from hmcmt2d_tpu_torch.models.data import MTData
    from hmcmt2d_tpu_torch.models.posterior import build_inverse_problem

    mesh, sigma2d = read_model(root / cfg["model_file"], device=dev)
    nf, nr, nc = len(inp.freqs), len(inp.rx_y), len(cfg["components"])
    f, r, c = np.meshgrid(np.arange(nf), np.arange(nr), np.arange(nc), indexing="ij")
    data = MTData(rx_loc=np.stack([inp.rx_y, np.zeros(nr)], axis=1), freqs=inp.freqs,
                  data_type="Impedance", data_comp=tuple(cfg["components"]),
                  freq_id=f.ravel(), rx_id=r.ravel(), dt_id=c.ravel()).validate()
    problem, m0 = build_inverse_problem(mesh, data, inp.obs, inp.err, sigma2d.ravel(),
                                        cfg=solve_config(solve), device=dev)
    return problem, m0


def hmc_options(cfg: dict, dt: float, refactor_every: int = 4):
    from hmcmt2d_tpu_torch.sampler.hmc import HMCOptions

    rho_lo, rho_hi = cfg["resistivity"]
    return HMCOptions(dt=dt, steps_lo=cfg["timestep"][0], steps_hi=cfg["timestep"][1],
                      log_sig_lo=math.log(1.0 / rho_hi), log_sig_hi=math.log(1.0 / rho_lo),
                      reg_param=cfg["smoothparameter"], refactor_every=refactor_every)


class Spans:
    """CUDA-event spans around the benchmark's calls into one layer, and a
    profiler range of the same name; off unless ``on``."""

    def __init__(self, on: bool, dev: torch.device):
        self.on = on and dev.type == "cuda"
        self.pairs: dict[str, list] = {"eval": [], "factor": []}

    def wrap(self, kind: str, fn):
        if not self.on:
            return fn
        pairs = self.pairs[kind]

        def timed(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"bench.{kind}"):
                a.record()
                out = fn(*args)
                b.record()
            pairs.append((a, b))
            return out

        return timed

    def ms(self) -> dict[str, list[float]]:
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.pairs.items()}


@dataclasses.dataclass
class Iteration:
    """One iteration of the program, kept for the check."""

    index: int
    before: object        # the program's state (ChainState or WarmupCarry) before it
    after: object
    accepts: torch.Tensor
    steps: torch.Tensor   # (C,) leapfrog steps the program took


class SamplePhase:
    """The main phase: ``run_hmc`` one iteration a call under the dense
    Gauss-Newton mass at the configuration's fixed step size."""

    stream = RS.STREAM_MAIN

    def __init__(self, root, cfg, mix, inp, dev, spans):
        from hmcmt2d_tpu_torch.models.forward import make_forward
        from hmcmt2d_tpu_torch.sampler import driver as D
        from hmcmt2d_tpu_torch.sampler import hmc as H

        self.H, self.cfg, self.mix = H, cfg, mix
        self.problem, m0 = build_problem(root, cfg, inp, cfg["solve"], dev)
        gn = cfg["gn_mass"]
        jac = dataclasses.replace(self.problem, fwd=make_forward(
            self.problem.mesh, self.problem.fwd.data, solve_config(gn)))
        self.m_true = torch.as_tensor(m0, dtype=torch.float32, device=dev)
        self.mass = D.gauss_newton_mass(self.problem, self.m_true, cfg["smoothparameter"],
                                        jac_problem=jac, chunk=gn["chunk"], jitter=gn["jitter"])
        self.opts = hmc_options(cfg, cfg["main_dt"])
        self.vg_raw = D.make_potential_vg(self.problem, cfg["smoothparameter"])
        self.vg = spans.wrap("eval", self.vg_raw)
        self.m_ref = inp.m_start
        self.state = H.sample_chain_init(self.vg, inp.m_start, self.m_ref)

    def step(self, index: int) -> Iteration:
        res = self.H.run_hmc(self.vg, self.opts, self.mass, self.state.m, self.m_ref, 1,
                             self.mix["sampler_seed"], init_state=self.state,
                             key_offset=index)
        it = Iteration(index, self.state, res.final, res.accepts[0], res.lf_steps[0])
        self.state = res.final
        return it

    def release(self) -> None:
        rel = getattr(self.vg_raw, "release", None)
        if rel is not None:
            rel()
        self.problem = self.vg = self.vg_raw = None


class WarmupPhase:
    """The hybrid warmup: ``warmup_scan`` one iteration a call on the exact
    engine with its amortised factor, dual averaging and diagonal mass
    windows on a schedule that restarts every ``schedule_length``."""

    stream = RS.STREAM_WARMUP

    def __init__(self, root, cfg, mix, inp, dev, spans):
        from hmcmt2d_tpu_torch.sampler import adapt as A
        from hmcmt2d_tpu_torch.sampler import driver as D

        self.A, self.cfg, self.mix, self.dev = A, cfg, mix, dev
        eng = dict(mix["engine"], stale_refine=mix["stale_refine"])
        self.problem, _ = build_problem(root, cfg, inp, eng, dev)
        self.vg_raw = D.make_potential_vg(self.problem, cfg["smoothparameter"])
        self.vg = spans.wrap("eval", self.vg_raw)
        self.factor_fn = (spans.wrap("factor", D.make_factor_fn(self.problem, self.vg_raw))
                          if mix["amortize"] else None)
        self.opts = hmc_options(cfg, cfg["timeinterval"], mix["refactor_every"])
        self.wopts = A.WarmupOptions(target_accept=mix["target_accept"],
                                     alpha_pool=cfg["warmuppool"])
        self.ends = A.window_schedule(mix["schedule_length"], self.wopts)
        self.m_ref = inp.m_start
        self.carry = A.warmup_carry_init(self.vg, self.opts, inp.m_start, self.m_ref)

    def step(self, index: int) -> Iteration:
        gen = RS.generator(self.mix["sampler_seed"], self.stream, index, self.dev)
        end = self.ends[index % len(self.ends)]
        carry, outs = self.A.warmup_scan(self.vg, self.opts, self.m_ref, self.carry, [gen],
                                         np.array([end]), self.wopts, factor_fn=self.factor_fn)
        it = Iteration(index, self.carry, carry, outs[2][0], outs[4][0])
        self.carry = carry
        return it

    def release(self) -> None:
        rel = getattr(self.vg_raw, "release", None)
        if rel is not None:
            rel()
        self.problem = self.vg = self.vg_raw = self.factor_fn = None


PHASES = {"sample": SamplePhase, "warmup": WarmupPhase}


def percentile(xs, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation, numpy's rule."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def device_record(dev: torch.device, count: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def profile_records(prof) -> dict:
    """Device kernels and copies (name, start ns, end ns) and host ranges of
    a profile, in the profiler's one clock.  The profiler mirrors each host
    range of ``record_function`` on the device's timeline; those mirrors
    bear a host range's name and are not device work."""
    dev_events, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (e.name(), start, start + e.duration_ns())
        (dev_events if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(rec)
    host_names = {name for name, _, _ in host}
    return {"kernels": [k for k in dev_events if k[0] not in host_names], "host": host}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float, log=print, also=None) -> dict:
    """One run of ``workload``; returns the result line's object.  ``also``
    (kept, cfg, mix, inputs, limits, device, seed) -> dict runs after the
    verdict, on what the check kept, and lands under the key ``also``."""
    spec, cell = find_cell(root, workload)
    cfg = load(root, "configs", cell["config"])
    mix = load(root, "traffic", cell["traffic"])
    limits = load(root, "limits", workload)
    readers = metric_readers(root, spec, workload) if trace else {}
    tf32 = cfg["solve"].get("tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    inp = make_inputs(root, cfg, seed, dev)
    spans = Spans(trace, dev)
    phase = PHASES[mix["phase"]](root, cfg, mix, inp, dev, spans)
    kept: list[Iteration] = []
    index = 0
    for _ in range(mix["setup_iterations"]):
        kept.append(phase.step(index))
        index += 1
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {workload}: set-up {setup_s:.3f} s")
    for pairs in spans.pairs.values():
        pairs.clear()

    # the window: one iteration a call, each timed to its synchronisation
    first = index
    iter_s = []
    t0 = time.perf_counter()
    t_prev = t0
    while t_prev - t0 < seconds:
        kept.append(phase.step(index))
        index += 1
        sync(dev)
        t = time.perf_counter()
        iter_s.append(t - t_prev)
        t_prev = t
    window_s = t_prev - t0
    n_iter = index - first
    C = cfg["chains"]
    log(f"[bench] window: {n_iter} iterations in {window_s:.3f} s")

    records = None
    if trace:
        span_ms = spans.ms()
        for pairs in spans.pairs.values():
            pairs.clear()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                for _ in range(mix["profile_iterations"]):
                    kept.append(phase.step(index))
                    index += 1
                sync(dev)
        prof_span = spans.ms()
        records = dict(
            phase=mix["phase"], window_s=window_s, eval_ms=span_ms["eval"],
            factor_ms=span_ms["factor"], iterations=n_iter,
            profile=dict(profile_records(prof), evals=len(prof_span["eval"]),
                         factors=len(prof_span["factor"])),
            shapes=CK.shapes(inp.model, cfg, mix), peaks=CK.peak_rates(dev))
        del prof

    steps = torch.stack([it.steps for it in kept[first:first + n_iter]])
    device = device_record(dev, cell["chips"])
    phase_state = CK.keep_for_check(phase, kept, first, n_iter, mix, seed)
    phase.release()
    del kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    verdict = CK.judge(phase_state, cfg, mix, inp, limits, dev, seed)
    failed = int(verdict.pop("failed"))
    out = {"correct": bool(verdict["correct"]), "attempted": C * n_iter, "failed": failed}
    if also is not None:
        out["also"] = also(phase_state, cfg, mix, inp, limits, dev, seed)
    if trace:
        metrics = {}
        for name, (read, unit) in readers.items():
            v = read(records)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        out["metrics"] = metrics
        device["busy_s"], device["window_s"] = CK.busy(records)
        out["device"] = device
        out["breakdown"] = CK.breakdown(records)
    else:
        it_ms = [1e3 * s for s in iter_s]
        metrics = {"samples_per_s": {"value": C * n_iter / window_s, "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        if any(m["name"] == "iter_ms_p90" and workload in m.get("workloads", [workload])
               for m in spec["end_to_end"]):
            metrics["iter_ms_p90"] = {"value": percentile(it_ms, 90), "unit": "ms"}
        out["metrics"] = metrics
        out["device"] = device
        log(f"[bench] iteration ms: median {statistics.median(it_ms):.2f}, "
            f"p90 {percentile(it_ms, 90):.2f}, max {max(it_ms):.2f}; leapfrog steps "
            f"{int(steps.sum()) // C} in {n_iter} iterations")
    lim = power_limit()
    if lim:
        log(f"[bench] card: {lim}")
    out["checks"] = verdict["checks"]
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    _, cell = find_cell(root, args.workload)
    try:
        check_device(cell["chips"])
    except NoDevice as e:
        log(f"[bench] {e}: no result")
        return 2
    out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t_start, log)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] loaded in this process, and forbidden: {', '.join(bad)}: no result")
        return 3
    for name, c in out["checks"].items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
