"""High-level inversion driver: config + files -> chains -> posterior.

PyTorch counterpart of ``hmcmt2d_tpu/sampler/driver.py`` (the reference's
runHMCscript.jl / runHMCSampler wiring): all chains advance together as one
batch through the PDE solves, in one process or, with a ``device_mesh``,
sharded over the ranks of a (chains, freq) mesh
(:class:`hmcmt2d_tpu_torch.parallel.multichain.ShardedSampler`).  The run is

1. warmup over the burn-in iterations: dual-averaged step size and windowed
   diagonal mass (:mod:`.adapt`), in segments;
2. for a dense masstype, the Gauss-Newton (or Wm) mass at the pooled
   warmed-up model and a step-size re-adaptation under it;
3. the main phase, in segments, with a checkpoint after every
   ``checkpoint_stride`` of them.

Every draw is a pure function of (seed, stream, global index), so segmented
and resumed runs reproduce an unbroken one exactly (``sampler/hmc.py``
``generator``), and a sharded run the single-process one.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import to_numpy
from ..io.startup import HMCConfig
from ..models import jacobian as JJ
from ..models.forward import SolveConfig
from ..models.posterior import InverseProblem, build_inverse_problem
from ..utils.trace import span
from . import adapt as A
from . import checkpoint as CK
from . import graphed as G
from . import hmc as H


@dataclasses.dataclass
class InversionRun:
    problem: InverseProblem
    result: H.HMCResult   # outputs on the host; ``final`` on the device
    config: HMCConfig
    m_ref: np.ndarray       # (C, P) per-chain reference/start models
    wall_time: float
    n_warm: int = 0         # warmup iterations included at the head of result

    @property
    def nfevals(self) -> int:
        """Gradient (forward + adjoint) evaluations over all chains: the
        reference's nfevals counter (HMCStruct.jl:34), plus one initial
        evaluation per chain."""
        lf = to_numpy(self.result.lf_steps)
        return int(lf.sum()) + lf.shape[1]


def make_potential_vg(problem: InverseProblem, reg: float,
                      graphed: bool | None = None):
    """Batched (chains-leading) potential value-and-grad.

    Chains are an ordinary batch axis of the forward model (one merged
    chains x freq x mode factor and solve), and the per-chain gradients are
    the gradient of the chain-summed potential: chains are independent.
    ``vg(m, m_ref, fac=None) -> ((U, (misfit, mnorm, pred)), grad)``, all
    detached; ``fac`` is a stale factor from :func:`make_factor_fn`.

    ``graphed``: None serves every CUDA problem, whatever its engine and
    inverse, from CUDA graphs (:class:`.graphed.GraphedPotential`: the
    fresh eval, and the stale eval of a factor from its own factor graph)
    and a CPU problem eagerly; True asks for the graphs and raises where
    they cannot serve; False returns the eager closure (the counterpart of
    ``jax.disable_jit``).
    """
    if graphed is None:
        graphed = G.unservable(problem) is None
    if graphed:
        return G.GraphedPotential(problem, reg)

    def vg(m, m_ref, fac=None):
        return problem.potential_value_and_grad(m, m_ref, reg, fac=fac)

    return vg


def no_stale_factor(m):
    """The trajectory-amortisation hook that makes no factor: the leapfrog
    hands ``potential_vg`` None, so every eval factors afresh."""
    return None


def make_factor_fn(problem: InverseProblem, potential_vg=None):
    """Batched model -> merged-mode factorisation (trajectory amortisation)
    for ``potential_vg``'s stale evals: its factor graph when it is graphed
    (whose stale eval takes only that factor), else the eager
    ``problem.factor_state``.

    On a CUDA device, :func:`no_stale_factor`: every eval factors afresh.
    There a stale eval and its share of the factors cost what a fresh eval
    costs (bcr + LU on an H100, the dprism2d warmup: 34.7 ms and a 28.5 ms
    factor every ~3.3 steps, against 42.8 ms), and once dual averaging
    restarts the step the stale eval's refinement leaves errors that flip
    Metropolis decisions a fresh eval gets right against the complex128
    reference (PERF.md, the warmup check)."""
    if problem.device.type == "cuda":
        return no_stale_factor
    if isinstance(potential_vg, G.GraphedPotential):
        return potential_vg.factor
    return problem.factor_state


class BatchedSampler:
    """The single-process sampler behind the calls of
    :class:`~hmcmt2d_tpu_torch.parallel.multichain.ShardedSampler`, so that
    :func:`run_inversion` drives either one.  ``graphed`` as in
    :func:`make_potential_vg`."""

    def __init__(self, problem: InverseProblem, reg: float, amortize: bool = True,
                 graphed: bool | None = None):
        self.potential_vg = make_potential_vg(problem, reg, graphed)
        self.factor_fn = make_factor_fn(problem, self.potential_vg) if amortize else None

    def release(self) -> list[dict]:
        """Free the graphs and pools of a graphed potential; returns each
        capture's summary (none for the eager one)."""
        vg = self.potential_vg
        return vg.release() if isinstance(vg, G.GraphedPotential) else []

    def carry_init(self, opts, m0, m_ref) -> A.WarmupCarry:
        return A.warmup_carry_init(self.potential_vg, opts, m0, m_ref)

    def warmup_scan(self, opts, m_ref, carry, keys, ends, w, fixed_mass=None):
        return A.warmup_scan(self.potential_vg, opts, m_ref, carry, keys, ends, w,
                             factor_fn=self.factor_fn, fixed_mass=fixed_mass)

    def run(self, opts, mass, m_start, m_ref, n_samples, seed, init_state=None,
            key_offset=0) -> H.HMCResult:
        return H.run_hmc(self.potential_vg, opts, mass, m_start, m_ref, n_samples,
                         seed, init_state=init_state, key_offset=key_offset,
                         factor_fn=self.factor_fn)

    def shared_mass(self, build) -> H.MassMatrix:
        return build()

    def mask_pred(self, pred):
        return pred


def make_sampler(problem: InverseProblem, reg: float, amortize: bool,
                 device_mesh=None, graphed: bool | None = None):
    """A :class:`BatchedSampler`, or over ``device_mesh`` a ShardedSampler;
    either serves a CUDA problem's evals (and its amortised factor) from
    CUDA graphs by default, ``graphed`` as in :func:`make_potential_vg`."""
    if device_mesh is None:
        return BatchedSampler(problem, reg, amortize, graphed)
    from ..parallel.multichain import ShardedSampler

    return ShardedSampler(problem, reg, device_mesh, amortize=amortize, graphed=graphed)


def mass_kind(cfg: HMCConfig) -> str:
    """'diagonal' | 'gn' | 'wm': the reference treats any non-"diagonal"
    masstype as M = Wm (setMassMatrix, HMCSampler.jl:478-489); 'gaussnewton'
    is an extension."""
    mt = cfg.mass_type.lower()
    if mt == "diagonal":
        return "diagonal"
    if mt in ("gaussnewton", "gn"):
        return "gn"
    return "wm"


def make_mass(problem: InverseProblem, cfg: HMCConfig,
              dtype=torch.float64) -> H.MassMatrix:
    kind = mass_kind(cfg)
    if kind == "diagonal":
        # the reference uses identity scaling 1.0 (HMCSampler.jl:81-84)
        return H.identity_mass(problem.n_param, dtype, problem.device)
    if kind == "gn":
        raise ValueError("masstype gaussnewton requires adapt: on (the "
                         "Jacobian is evaluated at the warmed-up model)")
    return H.dense_mass(problem.wm_dense() + 1e-8 * np.eye(problem.n_param),
                        dtype, problem.device)


def gauss_newton_mass(problem: InverseProblem, m_repr: torch.Tensor, reg: float,
                      jac_problem: InverseProblem | None = None,
                      chunk: int = 128, jitter: float = 1e-6,
                      graphed: bool | None = None, log=None) -> H.MassMatrix:
    """Dense HMC mass M = J'W^2J + reg*Wm + jitter*mu*I, the Gauss-Newton
    approximation of the posterior precision at ``m_repr`` (P,), in
    ``m_repr``'s dtype on the problem's device.

    J comes from one factorisation and ``chunk``-row multi-right-hand-side
    adjoint solves (models/jacobian.full_jacobian_chunked), served from a
    CUDA graph as ``graphed`` says (None: on the card); M and its Cholesky
    are float64 on the host.  ``jac_problem`` evaluates J under another
    engine (the hybrid run's exact warmup engine).  ``log`` (a callable of
    one string) gets a line for the Jacobian's graph, freed before M is
    built."""
    pj = jac_problem if jac_problem is not None else problem
    caps = []
    with span("gn.jacobian"):
        J = JJ.full_jacobian_chunked(pj, m_repr, chunk=chunk, graphed=graphed,
                                     captures=caps)
    for cap in caps:
        if log is not None:
            log(f"released the GN build's {cap['kind']} graph ({cap['slabs']} slabs "
                f"of {cap['rows']} rows, {cap['replays']} replayed): pool "
                f"{cap['pool_bytes']} bytes, captured in {cap['capture_s']:.3f} s")
    with span("gn.host"):
        w = np.asarray(problem.weights, np.float64)
        if np.iscomplexobj(problem.obs):
            w = np.concatenate([w, w])      # re/im rows share the datum weight
        Jw = J * w[:, None]
        M = Jw.T @ Jw + reg * problem.wm_dense()
        mu = np.trace(M) / M.shape[0]
        M += jitter * mu * np.eye(M.shape[0])
        return H.dense_mass(M, m_repr.dtype, problem.device)


def hmc_options(cfg: HMCConfig) -> H.HMCOptions:
    return H.HMCOptions(
        dt=cfg.dt,
        steps_lo=int(cfg.timestep[0]),
        steps_hi=int(cfg.timestep[1]),
        log_sig_lo=float(np.log(cfg.sig_bounds[0])),
        log_sig_hi=float(np.log(cfg.sig_bounds[1])),
        reg_param=cfg.reg_param,
    )


def _segment_plan(n_main: int, every: int) -> list[int]:
    """Segment lengths: full ``every``-sized segments plus a tail."""
    if every <= 0 or every >= n_main:
        return [n_main] if n_main > 0 else []
    segs = [every] * (n_main // every)
    if n_main % every:
        segs.append(n_main % every)
    return segs


def warmup_segments(eng, opts: H.HMCOptions, m_ref, carry: A.WarmupCarry, seed: int,
                    it_offset: int, ends, w: A.WarmupOptions, seg: int,
                    fixed_mass: H.MassMatrix | None = None, on_segment=None,
                    stream: int = H.STREAM_WARMUP):
    """The warmup iterations ``it_offset + [0, len(ends))`` through
    ``eng.warmup_scan`` (a :class:`BatchedSampler` or a ShardedSampler) in
    segments of ``seg`` (0: one), each drawing from ``stream`` at its
    global iteration index, so any segmentation gives the same carry.
    ``on_segment(done, n, carry, outs, seconds)`` follows each segment;
    returns the advanced carry."""
    done = 0
    for n in _segment_plan(len(ends), seg):
        t_seg = time.time()
        carry, outs = eng.warmup_scan(
            opts, m_ref, carry,
            A.warmup_keys(seed, it_offset + done, n, m_ref.device, stream),
            ends[done:done + n], w, fixed_mass=fixed_mass)
        done += n
        if on_segment is not None:
            on_segment(done, n, carry, outs, time.time() - t_seg)
    return carry


class _Outputs:
    """Per-iteration records of a run, gathered on the host."""

    def __init__(self):
        self.parts = ([], [], [], [], [])   # models, stats, accepts, pred, lf

    def add(self, models, stats, accepts, pred, lf):
        for part, x in zip(self.parts, (models, stats, accepts, pred, lf)):
            part.append(to_numpy(x))

    def arrays(self):
        return [np.concatenate(p) for p in self.parts]


def run_inversion(cfg: HMCConfig, mesh, sigma2d, data, obs, err,
                  n_chains: int | None = None, seed: int | None = None,
                  solve_cfg: SolveConfig | None = None,
                  n_samples: int | None = None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 0,
                  checkpoint_stride: int = 1,
                  resume: bool = False,
                  verbose: bool = False,
                  progress_every: int = 0,
                  warmup_solve_cfg: SolveConfig | None = None,
                  device=None, device_mesh=None,
                  graphed: bool | None = None) -> InversionRun:
    """End-to-end inversion on ``device`` (None: the GPU, and raises
    without one); ``solve_cfg`` None is the device's default engine.

    With ``device_mesh`` (a (chains, freq) DeviceMesh over every rank, from
    ``parallel.multichain.make_device_mesh``; ``device`` is then this rank's)
    each phase runs sharded, in the same order and with the same draws as
    the single-process run, which it equals up to the order of reduction.
    Every rank returns the gathered run; rank 0 alone prints and writes the
    checkpoint.  A checkpoint resumes only on the kind of path that wrote it.

    With ``checkpoint_path`` the main phase runs in ``checkpoint_every``-
    sample segments and dumps the sampler state after every
    ``checkpoint_stride`` of them (and after the last); ``resume=True``
    continues from that file bit-exactly.  ``verbose`` prints one
    ``[hmcmt2d]`` line per segment; ``progress_every`` shortens segments
    for more lines.

    ``warmup_solve_cfg`` turns on the hybrid engine schedule: warmup runs
    under that engine (an exact one: bcr from the CLI by default, or
    thomas), and the run switches to the ``solve_cfg`` engine (typically
    the fused kernels) before the dense-mass phase, starting fresh there
    at the warmed-up models.  The Gauss-Newton Jacobian is taken under the
    warmup engine.

    ``graphed`` (as in :func:`make_potential_vg`; None: CUDA graphs on the
    card) serves both engines' evals and the Gauss-Newton Jacobian.
    """
    n_chains = n_chains or cfg.n_chains
    seed = cfg.seed if seed is None else seed
    n_samples = n_samples or cfg.total_samples

    problem, m0_file = build_inverse_problem(
        mesh, data, obs, err, to_numpy(sigma2d).ravel(),
        sigma_fixed=cfg.sig_fix, cfg=solve_cfg, device=device)
    dev = problem.device
    rdt = problem.fwd.cfg.real_dtype

    opts = hmc_options(cfg)
    # trajectory amortisation is off under the fused engine, the JAX
    # package's rule (its fused factor is cheap next to the 10 extra
    # refinement solves of a stale one); on the card make_factor_fn turns it
    # off for every engine
    amortize = cfg.amortize and problem.fwd.cfg.solver_method != "fused"
    eng = make_sampler(problem, cfg.reg_param, amortize, device_mesh, graphed)

    hybrid = (warmup_solve_cfg is not None and cfg.adapt and not resume
              and warmup_solve_cfg != problem.fwd.cfg)
    if hybrid:
        problem_w = dataclasses.replace(
            problem, fwd=dataclasses.replace(problem.fwd, cfg=warmup_solve_cfg))
        amortize_w = cfg.amortize and warmup_solve_cfg.solver_method != "fused"
        eng_w = make_sampler(problem_w, cfg.reg_param, amortize_w, device_mesh, graphed)
    else:
        problem_w, eng_w = problem, eng
    path_kind = "single" if device_mesh is None else "sharded"
    rank0 = device_mesh is None or dist.get_rank() == 0

    def log(msg):
        if verbose and rank0:
            print(f"[hmcmt2d] {msg}", flush=True)

    def rate(n_it, secs):
        return f"{n_it * n_chains / secs:.2f} samples/s, {secs:.3f} s"

    def logged(phase, total):
        """A warmup_segments callback: the outputs kept, one line logged."""
        def on_segment(done, n, carry, wout, secs):
            out.add(*wout)
            log(f"{phase} {done}/{total}: "
                f"misfit={float(wout[1][-1, :, 0].mean()):.4g} "
                f"dt={float(torch.exp(carry.da.log_eps)):.4g} ({rate(n, secs)})")
        return on_segment

    t0 = time.time()
    wall_prev = 0.0
    out = _Outputs()
    start_stats = start_pred = None

    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(f"no checkpoint to resume: {checkpoint_path}")
        ck = CK.load_checkpoint(checkpoint_path, dev, path_kind)
        n_warm, n_done = ck["n_warm"], ck["n_done"]
        state, mass = ck["state"], ck["mass"]
        seed = ck["key"]
        opts = dataclasses.replace(opts, dt=ck["dt"])
        m_ref = ck["m_ref"]
        m_start = m_ref
        start_stats, start_pred = ck["start_stats"], ck["start_pred"]
        wall_prev = ck["wall_time"]
        out.add(*(ck[k] for k in ("models", "stats", "accepts", "pred", "lf_steps")))
        log(f"resumed {checkpoint_path}: {n_done}/{n_samples - n_warm} main "
            f"samples done, dt={opts.dt:.4g}")
    else:
        n_done = 0
        m_start = H.random_homogeneous_start(seed, m0_file, n_chains, rdt, dev)
        m_ref = m_start   # refModel = strModel (HMCSampler.jl:108-109)
        # with adaptation on, the warmup (and the dense phase) replace this
        if cfg.adapt:
            mass = H.identity_mass(problem.n_param, rdt, dev)
        elif mass_kind(cfg) == "wm":
            mass = eng.shared_mass(lambda: make_mass(problem, cfg, rdt))
        else:       # the identity, or on every rank the gaussnewton error
            mass = make_mass(problem, cfg, rdt)
        if cfg.adapt:
            n_warm = min(cfg.burnin, n_samples)
            wopts = A.WarmupOptions(target_accept=cfg.target_accept,
                                    alpha_pool=cfg.warmup_pool)
            seg_w = checkpoint_every or progress_every or n_warm
            ends = (A.window_schedule(n_warm, wopts) if wopts.adapt_mass
                    else np.zeros(n_warm, bool))
            carry = eng_w.carry_init(opts, m_start, m_ref)
            state0 = carry.state
            carry = warmup_segments(eng_w, opts, m_ref, carry, seed, 0, ends, wopts,
                                    seg_w, on_segment=logged("warmup", n_warm))
            mass, info = A.warmup_finalize(carry)
            state = carry.state
            start_stats, start_pred = A.start_row(state0, seed, m_start.shape)
            start_pred = eng_w.mask_pred(start_pred)
            opts = dataclasses.replace(opts, dt=float(info.dt))
            # dense-metric phase: M (Gauss-Newton or Wm) at the pooled
            # warmed-up model, then the step size re-adapted under it
            mkind = mass_kind(cfg)
            if hybrid:
                # switch engines before the dense phase: its step size is
                # then tuned against the main engine near the posterior, and
                # its final state carries straight into the main phase
                m_start = state.m
                state = None
                log(f"hybrid: warmup engine {warmup_solve_cfg.solver_method} "
                    f"-> main engine {problem.fwd.cfg.solver_method}")
                # the warmup engine's graphs go before the main engine's
                # capture theirs
                for cap in eng_w.release():
                    on = f" on rank {cap['rank']}" if "rank" in cap else ""
                    log(f"released the warmup engine's {cap['kind']} graph{on} "
                        f"(C={cap['chains']}): pool {cap['pool_bytes']} bytes, "
                        f"captured in {cap['capture_s']:.3f} s")
            if mkind != "diagonal":
                t_m = time.time()
                m_repr = (m_start if state is None else state.m).mean(dim=0)
                if mkind == "gn":
                    mass = eng.shared_mass(lambda: gauss_newton_mass(
                        problem, m_repr, cfg.reg_param, jac_problem=problem_w,
                        graphed=graphed, log=log))
                else:
                    mass = eng.shared_mass(lambda: H.dense_mass(
                        problem.wm_dense() + 1e-8 * np.eye(problem.n_param), rdt, dev))
                log(f"dense mass ({mkind}) built in {time.time() - t_m:.3f}s")
                n_c = min(int(cfg.mass_warmup), max(0, n_samples - n_warm))
                if n_c > 0:
                    opts_c = dataclasses.replace(opts, dt=float(cfg.mass_dt0))
                    wopts_c = dataclasses.replace(wopts, adapt_mass=False)
                    t_i = time.time()
                    if state is None:
                        # a fresh main-engine evaluation at the warmed-up models
                        carry = eng.carry_init(opts_c, m_start, m_ref)
                        log(f"mass-warmup init: main-engine gradient in "
                            f"{time.time() - t_i:.3f} s")
                    else:
                        carry = A.carry_from_state(state, opts_c.dt)
                    carry = warmup_segments(
                        eng, opts_c, m_ref, carry, seed, n_warm, np.zeros(n_c, bool),
                        wopts_c, checkpoint_every or progress_every or n_c,
                        fixed_mass=mass, on_segment=logged("mass-warmup", n_c))
                    _, info_c = A.warmup_finalize(carry)
                    state = carry.state     # main-engine state: flows on
                    opts = dataclasses.replace(opts, dt=float(info_c.dt))
                    n_warm += n_c
                    log(f"mass-warmup done: dt={opts.dt:.4g}, "
                        f"accept~{float(info_c.alpha_mean):.2f}")
            log(f"warmup {n_warm} iters in {time.time() - t0:.1f}s: adapted "
                f"dt={opts.dt:.4g}, accept~{float(info.alpha_mean):.2f}, "
                f"misfit {float(start_stats[:, 0].mean()):.4g} -> "
                f"{float(out.parts[1][-1][-1, :, 0].mean()):.4g}")
        else:
            n_warm = 0
            state = None   # the first segment initialises itself

    n_main = n_samples - n_warm
    # per-sample draws are a pure function of the global sample index
    # (run_hmc's key_offset), so any segmentation, a resume included,
    # gives the same stream
    every = checkpoint_every if checkpoint_every else progress_every
    segs = _segment_plan(n_main - n_done, every)
    for i_seg, n_seg in enumerate(segs):
        t_seg = time.time()
        res = eng.run(opts, mass, state.m if state is not None else m_start,
                      m_ref, n_seg, seed, init_state=state, key_offset=n_done)
        state = res.final
        n_done += n_seg
        if start_stats is None:
            start_stats, start_pred = res.start_stats, res.start_pred
        out.add(res.models, res.stats, res.accepts, res.pred, res.lf_steps)
        log(f"samples {n_done - n_seg + 1}..{n_done}/{n_main}: "
            f"misfit={float(res.stats[-1, :, 0].mean()):.4g} "
            f"accept={float(res.accepts.double().mean()):.2f} "
            f"dt={opts.dt:.4g} ({rate(n_seg, time.time() - t_seg)})")
        # checkpoint every `checkpoint_stride` segments and after the last
        if checkpoint_path and ((i_seg + 1) % max(checkpoint_stride, 1) == 0
                                or i_seg == len(segs) - 1):
            if rank0:
                models, stats, accepts, pred, lf = out.arrays()
                CK.save_checkpoint(
                    checkpoint_path, n_done=n_done, state=state, key=seed,
                    dt=opts.dt, mass=mass, m_ref=m_ref, models=models, stats=stats,
                    accepts=accepts, pred=pred, lf_steps=lf,
                    start_stats=start_stats, start_pred=start_pred, n_warm=n_warm,
                    wall_time=wall_prev + time.time() - t0, path_kind=path_kind)
            if device_mesh is not None:
                dist.barrier()      # the file is whole before any rank reads it

    models, stats, accepts, pred, lf = out.arrays()
    result = H.HMCResult(
        models=torch.from_numpy(models), stats=torch.from_numpy(stats),
        accepts=torch.from_numpy(accepts), pred=torch.from_numpy(pred),
        final=state, start_stats=torch.as_tensor(to_numpy(start_stats)),
        start_pred=torch.as_tensor(to_numpy(start_pred)),
        lf_steps=torch.from_numpy(lf))
    return InversionRun(problem=problem, result=result, config=cfg,
                        m_ref=to_numpy(m_ref), wall_time=wall_prev + time.time() - t0,
                        n_warm=n_warm)
