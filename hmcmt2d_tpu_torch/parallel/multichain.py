"""Sharded sampling over a (chains, freq) process mesh with torch.distributed.

PyTorch counterpart of ``hmcmt2d_tpu/parallel/multichain.py``.  One process
per device, the idiom of ``torchrun``, in place of JAX's one process over
many devices:

* the **chains** axis is data parallelism: each rank advances its shard of
  the chains, and draws the random numbers of the whole batch and keeps its
  own rows (``hmc.make_sample_step(rows=...)``), so a sharded run equals the
  single-process run of the same chains up to the order of reduction;
* the **freq** axis splits the PDE solves: each rank solves its block of
  frequencies (``InverseProblem.potential_cube``), and the value, misfit,
  model norm and gradient are summed over the freq group;
* warmup pools its statistics over the chains group
  (``adapt.warmup_scan(pool=...)``).

Everything that crosses :class:`ShardedSampler`'s methods is global and the
same on every rank: the models in, and the gathered results out, with the
predicted data masked onto the observed triples as ``run_hmc`` returns
them.  A carried :class:`ChainState` holds the whole response cube,
flattened, as its ``pred``.  Every rank makes the same collectives in the
same order, since each branches only on values that every rank shares.

On a CUDA problem each rank's local work is served from CUDA graphs
(:class:`~hmcmt2d_tpu_torch.sampler.graphed.GraphedPotential`, as the JAX
package jits its ``shard_map`` programs): its frequency block's
value-and-grad with the float64 packing of its four terms, the
trajectory-amortised cube factor and the eval against that factor.  The freq-group ``all_reduce`` runs on
the replay's output, outside the graph: a graphed eval equals the eager
one bit for bit, and the graph holds no collective, so it serves gloo
(which ranks sharing a card run, and which cannot be captured) and NCCL
alike.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..models.posterior import InverseProblem
from ..ops import solver
from ..sampler import adapt as A
from ..sampler import graphed as G
from ..sampler import hmc as H
from ..utils.collectives import all_gather_cat, all_reduce_sum

DEFAULT_TIMEOUT_S = 900.0


def rank_device(device=None, local_rank: int | None = None) -> torch.device:
    """This rank's device: ``device`` when given, else the GPU
    ``local_rank % device_count`` (default ``LOCAL_RANK``, else the rank;
    raises without a GPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pick_backend(device: torch.device, ranks_per_host: int) -> str:
    """``nccl`` when each rank of the host has a GPU of its own, else
    ``gloo`` (the CPU, or ranks sharing a card: NCCL refuses two ranks on
    one device)."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def host_layout(store, rank: int, world: int) -> tuple[int, int]:
    """(local rank, ranks on this host) of ``rank``, from every rank's host
    name posted to ``store``: the local rank is its place among the ranks of
    its host in rank order, whatever order the hosts' ranks come in."""
    host = socket.gethostname()
    store.set(f"hmcmt2d/host/{rank}", host)
    keys = [f"hmcmt2d/host/{r}" for r in range(world)]
    store.wait(keys)
    same = [r for r, k in enumerate(keys) if store.get(k).decode() == host]
    return same.index(rank), len(same)


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group and return this rank's device, or None when
    there is nothing to join.

    With ``coordinator`` ("host:port") it joins ``num_processes`` ranks as
    rank ``process_id``, and the ranks learn how many of them share each
    host through the coordinator's store (:func:`host_layout`); under
    torchrun it reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; otherwise it does nothing.  The rank's device is
    the GPU ``local rank % device_count``.  ``backend`` None picks one
    (:func:`pick_backend`); the group's timeout makes a rank that waits on a
    lost peer fail instead of hanging."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        world, rank = int(num_processes), int(process_id)
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timeout)
        local_rank, local_world = host_layout(store, rank, world)
        join = dict(store=store)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        join = dict(init_method="env://")
    else:
        return None
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or pick_backend(dev, local_world)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a GPU for each rank")
    dist.init_process_group(backend, world_size=world, rank=rank, timeout=timeout, **join)
    return dev


def _group_options(backend: str, timeout_s: float):
    """(backend, options) of a mesh dimension's group, with the timeout."""
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    return backend, opts


def make_device_mesh(n_chain_dev: int | None = None, n_freq_dev: int = 1,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The (chains, freq) ``DeviceMesh`` over every rank of the process
    group; ``n_chain_dev`` defaults to the world size over ``n_freq_dev``.
    Rank r sits at (r // n_freq_dev, r % n_freq_dev): the frequency ranks
    of a chain shard are neighbours (one host, the fast links)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n_chain_dev = n_chain_dev or world // n_freq_dev
    if n_chain_dev * n_freq_dev != world:
        raise ValueError(f"a {n_chain_dev} x {n_freq_dev} mesh must divide the "
                         f"{world} ranks exactly")
    backend = dist.get_backend()
    over = _group_options(backend, timeout_s)
    return init_device_mesh(rank_device(device).type, (n_chain_dev, n_freq_dev),
                            mesh_dim_names=("chains", "freq"),
                            backend_override={"chains": over, "freq": over})


class ShardedSampler:
    """Warmup and sampling over a (chains, freq) ``DeviceMesh``, with the
    calls and results of the single-process sampler (``run`` as
    ``hmc.run_hmc``, ``warmup`` as ``adapt.warmup``, ``warmup_scan`` as
    ``adapt.warmup_scan``).  ``problem`` lives on this rank's device.

    ``graphed`` as in
    :class:`~hmcmt2d_tpu_torch.sampler.driver.BatchedSampler`: None serves
    a CUDA problem's local eval, cube factor and stale eval from CUDA
    graphs and a CPU problem eagerly; True raises where the graphs cannot
    serve; False is the eager path."""

    def __init__(self, problem: InverseProblem, reg: float, mesh,
                 amortize: bool = True, graphed: bool | None = None):
        self.problem, self.reg = problem, reg
        data = problem.fwd.data
        self.n_chain_dev, self.n_freq_dev = mesh.size(0), mesh.size(1)
        if data.n_freq % self.n_freq_dev:
            raise ValueError(f"frequencies ({data.n_freq}) must divide the freq "
                             f"mesh axis ({self.n_freq_dev})")
        self.chains, self.freq = mesh.get_group("chains"), mesh.get_group("freq")
        self.chain_rank = mesh.get_local_rank("chains")
        nf_l = data.n_freq // self.n_freq_dev
        f0 = mesh.get_local_rank("freq") * nf_l
        self.fsl = slice(f0, f0 + nf_l)
        obs_cube, w_cube = problem.cube_arrays()
        self.freqs = np.asarray(data.freqs)[self.fsl]
        self.obs_l, self.w_l = (torch.as_tensor(a[self.fsl], device=problem.device)
                                for a in (obs_cube, w_cube))
        self.cube_shape = (data.n_freq, data.n_rx * data.n_comp)
        self.flat_index = torch.as_tensor(data.flat_index, device=problem.device)
        if graphed is None:
            graphed = G.unservable(problem) is None
        if graphed:
            self.local_vg = G.GraphedPotential(problem, reg, eval_fn=self._local_vg,
                                               factor_fn=self._factor)
            factor = self.local_vg.factor
        else:
            self.local_vg, factor = self._local_vg, self._factor
        self.factor_fn = factor if amortize else None
        cfg = problem.fwd.cfg
        if (solver.uses_kernels(cfg.solver_method, cfg.inv_method)
                and problem.device.type == "cuda"):
            from ..ops import kernel_build

            # rank 0 runs nvcc while the others wait, then every rank loads
            # the one library (the construction is collective: every rank
            # of the mesh makes the same samplers in the same order)
            if dist.get_rank() == 0:
                kernel_build.build()
            dist.barrier()
            kernel_build.library()

    # -- potential ---------------------------------------------------------
    def _factor(self, m):
        """The merged-mode factor of this rank's frequencies (trajectory
        amortisation)."""
        return self.problem.factor_state_cube(m, self.freqs)

    def _local_vg(self, m, m_ref, fac=None):
        """This rank's share of the potential and its gradient, before the
        freq-group sum (what the graphs capture): with one frequency rank
        ``((U, (misfit, mnorm, cube)), grad)``, else ``(flat, cube,
        dtypes)``, the four terms packed as float64 columns of ``flat``
        beside their own dtypes."""
        m = m.detach().requires_grad_(True)
        with torch.enable_grad():
            U, (mis, mn, cube) = self.problem.potential_cube(
                m, m_ref, self.reg, self.freqs, self.obs_l, self.w_l,
                prior_scale=1.0 / self.n_freq_dev, fac=fac)
            (g,) = torch.autograd.grad(U.sum(), m)
        if self.n_freq_dev == 1:
            return (U.detach(), (mis.detach(), mn.detach(), cube.detach())), g
        parts = (U.detach(), mis.detach(), mn.detach(), g)
        flat = torch.cat([p.reshape(m.shape[0], -1).double() for p in parts], dim=1)
        return flat, cube.detach(), tuple(p.dtype for p in parts)

    def potential_vg(self, m, m_ref, fac=None):
        """Value and gradient of the local chains' potential, summed over
        the freq group: this rank's frequencies plus 1/k of the prior, whose
        sum over the k frequency ranks is the global potential.  The four
        terms travel in one float64 all_reduce, after the local eval (a
        graph replay on the card), and come back in their own dtypes (with
        one frequency rank there is nothing to sum); ``pred`` stays this
        rank's block of the cube."""
        out = self.local_vg(m, m_ref, fac)
        if self.n_freq_dev == 1:
            return out
        flat, cube, dtypes = out
        flat = all_reduce_sum(flat, self.freq)
        U, mis, mn = (flat[:, i].to(dt) for i, dt in enumerate(dtypes[:3]))
        return (U, (mis, mn, cube)), flat[:, 3:].to(dtypes[3])

    # -- between global and local -----------------------------------------
    def _rows(self, n_global: int) -> tuple[int, int]:
        if n_global % self.n_chain_dev:
            raise ValueError(f"chains ({n_global}) must divide the chains mesh "
                             f"axis ({self.n_chain_dev})")
        n = n_global // self.n_chain_dev
        return self.chain_rank * n, (self.chain_rank + 1) * n

    def _local(self, x, rows):
        return x[rows[0]:rows[1]]

    def _cube_block(self, pred):
        """(..., nfreq * rest) global cube -> this rank's frequency block."""
        nf, rest = self.cube_shape
        return pred.reshape(pred.shape[:-1] + (nf, rest))[..., self.fsl, :].flatten(-2)

    def _gather_cube(self, pred, chain_dim):
        """(..., C_l, nf_l * rest) local blocks -> (..., C, nfreq * rest)."""
        p = pred.reshape(pred.shape[:-1] + (-1, self.cube_shape[1]))
        p = all_gather_cat(p, self.freq, dim=-2).flatten(-2)
        return all_gather_cat(p, self.chains, dim=chain_dim)

    def mask_pred(self, cube_flat):
        """A carried state's (..., nfreq * nrx * ncomp) cube -> the observed
        data, as the single-process sampler carries them."""
        return cube_flat[..., self.flat_index]

    def release(self) -> list[dict]:
        """Free this rank's graphs and pools (none when eager), as
        ``BatchedSampler.release`` does, and return every rank's capture
        summaries, each with its ``rank``.  Collective: every rank calls it
        at the same point (the hybrid run's engine switch)."""
        vg = self.local_vg
        rank = dist.get_rank()
        mine = [dict(c, rank=rank)
                for c in (vg.release() if isinstance(vg, G.GraphedPotential) else [])]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return [c for part in every for c in part]

    def local_state(self, state: H.ChainState, rows) -> H.ChainState:
        return H.ChainState(m=self._local(state.m, rows), grad=self._local(state.grad, rows),
                            misfit=self._local(state.misfit, rows),
                            mnorm=self._local(state.mnorm, rows),
                            pred=self._cube_block(self._local(state.pred, rows)))

    def global_state(self, state: H.ChainState) -> H.ChainState:
        def g(x):
            return all_gather_cat(x, self.chains, dim=0)

        return H.ChainState(m=g(state.m), grad=g(state.grad), misfit=g(state.misfit),
                            mnorm=g(state.mnorm), pred=self._gather_cube(state.pred, 0))

    def _gather_outs(self, outs):
        """(models, stats, accepts, pred, lf_steps) of the local chains ->
        the global ones, pred masked."""
        models, stats, accepts, pred, lf = outs

        def g(x):
            return all_gather_cat(x, self.chains, dim=1)

        return (g(models), g(stats), g(accepts), self.mask_pred(self._gather_cube(pred, 1)),
                g(lf))

    # -- sampling ----------------------------------------------------------
    def run(self, opts: H.HMCOptions, mass: H.MassMatrix, m_start, m_ref,
            n_samples: int, seed: int, init_state: H.ChainState | None = None,
            key_offset: int = 0) -> H.HMCResult:
        """Sharded :func:`hmc.run_hmc` of the global chains ``m_start``."""
        C = m_start.shape[0]
        rows = self._rows(C)
        st = None if init_state is None else self.local_state(init_state, rows)
        res = H.run_hmc(self.potential_vg, opts, mass, self._local(m_start, rows),
                        self._local(m_ref, rows), n_samples, seed, init_state=st,
                        key_offset=key_offset, factor_fn=self.factor_fn, rows=rows,
                        n_global=C)
        models, stats, accepts, pred, lf = self._gather_outs(
            (res.models, res.stats, res.accepts, res.pred, res.lf_steps))
        return H.HMCResult(
            models=models, stats=stats, accepts=accepts, pred=pred,
            final=self.global_state(res.final),
            start_stats=all_gather_cat(res.start_stats, self.chains, dim=0),
            start_pred=self.mask_pred(self._gather_cube(res.start_pred, 0)),
            lf_steps=lf)

    # -- warmup ------------------------------------------------------------
    def carry_init(self, opts: H.HMCOptions, m0, m_ref) -> A.WarmupCarry:
        """Sharded :func:`adapt.warmup_carry_init` (the state global)."""
        rows = self._rows(m0.shape[0])
        c = A.warmup_carry_init(self.potential_vg, opts, self._local(m0, rows),
                                self._local(m_ref, rows))
        return c._replace(state=self.global_state(c.state))

    def warmup_scan(self, opts: H.HMCOptions, m_ref, carry: A.WarmupCarry, keys,
                    ends, w: A.WarmupOptions, fixed_mass: H.MassMatrix | None = None):
        """Sharded :func:`adapt.warmup_scan`, its statistics pooled over the
        chains group: the carry and the outputs in and out are global."""
        rows = self._rows(m_ref.shape[0])
        c = carry._replace(state=self.local_state(carry.state, rows))
        c, outs = A.warmup_scan(self.potential_vg, opts, self._local(m_ref, rows), c,
                                keys, ends, w, factor_fn=self.factor_fn,
                                fixed_mass=fixed_mass, pool=self.chains)
        return c._replace(state=self.global_state(c.state)), self._gather_outs(outs)

    def _segments(self, opts, m_ref, carry, seed, it_offset, ends, w, seg,
                  fixed_mass=None):
        """The driver's segment loop (:func:`driver.warmup_segments`) over
        this sampler: the advanced carry and the outputs joined."""
        from ..sampler.driver import warmup_segments

        parts = []
        carry = warmup_segments(self, opts, m_ref, carry, seed, it_offset, ends, w, seg,
                                fixed_mass=fixed_mass,
                                on_segment=lambda done, n, c, outs, secs: parts.append(outs))
        return carry, [torch.cat(p) for p in zip(*parts)]

    def warmup(self, opts: H.HMCOptions, m0, m_ref, n_warm: int, seed: int,
               wopts: A.WarmupOptions | None = None, seg: int = 0):
        """Sharded :func:`adapt.warmup`, in one scan or in ``seg``-iteration
        segments (bit-exact with each other), through the segment loop that
        :func:`driver.run_inversion` drives: ``(result, state, mass, info)``,
        all global."""
        wopts = wopts or A.WarmupOptions()
        carry = self.carry_init(opts, m0, m_ref)
        state0 = carry.state
        ends = (A.window_schedule(n_warm, wopts) if wopts.adapt_mass
                else np.zeros(n_warm, bool))
        carry, (models, stats, accepts, pred, lf) = self._segments(
            opts, m_ref, carry, seed, 0, ends, wopts, seg)
        mass, info = A.warmup_finalize(carry)
        start_stats, start_pred = A.start_row(state0, seed, m0.shape, m0.dtype)
        result = H.HMCResult(models=models, stats=stats, accepts=accepts, pred=pred,
                             final=carry.state, start_stats=start_stats,
                             start_pred=self.mask_pred(start_pred), lf_steps=lf)
        return result, carry.state, mass, info

    def readapt(self, opts: H.HMCOptions, state: H.ChainState, m_ref, n_iters: int,
                seed: int, wopts: A.WarmupOptions, mass: H.MassMatrix, seg: int = 0,
                it_offset: int = 0):
        """Step-size-only dual averaging under the fixed (dense) ``mass``
        from ``state``, restarting at ``opts.dt`` and continuing the warmup
        stream at ``it_offset``, as the dense phase of
        :func:`driver.run_inversion` does: ``(result, state, info)``."""
        carry = A.carry_from_state(state, opts.dt)
        wopts = dataclasses.replace(wopts, adapt_mass=False)
        carry, (models, stats, accepts, pred, lf) = self._segments(
            opts, m_ref, carry, seed, it_offset, np.zeros(n_iters, bool), wopts, seg,
            fixed_mass=mass)
        _, info = A.warmup_finalize(carry)
        result = H.HMCResult(models=models, stats=stats, accepts=accepts, pred=pred,
                             final=carry.state, start_stats=torch.zeros_like(stats[0]),
                             start_pred=pred[0], lf_steps=lf)
        return result, carry.state, info

    def shared_mass(self, build) -> H.MassMatrix:
        """``build()``'s dense mass, made on rank 0 and sent to every rank,
        so that the ranks of a chain shard sample under one matrix."""
        P, rdt = self.problem.n_param, self.problem.fwd.cfg.real_dtype
        if dist.get_rank() == 0:
            mass = build()
            sq, im = mass.sqrt_m.contiguous(), mass.inv_m.contiguous()
        else:
            sq, im = (torch.empty((P, P), dtype=rdt, device=self.problem.device)
                      for _ in range(2))
        dist.broadcast(sq, 0)
        dist.broadcast(im, 0)
        return H.MassMatrix(sqrt_m=sq, inv_m=im, diagonal=False)


def run_sharded_hmc(problem: InverseProblem, opts: H.HMCOptions, mass: H.MassMatrix,
                    m_start, m_ref, n_samples: int, seed: int, mesh) -> H.HMCResult:
    """One sharded run with no warmup and no segments."""
    return ShardedSampler(problem, opts.reg_param, mesh).run(
        opts, mass, m_start, m_ref, n_samples, seed)


# -- spawning ranks on this host -------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, backend, device, timeout_s, out_dir, args):
    dev = distributed_init(f"localhost:{port}", n, rank, backend=backend,
                           device=device, timeout_s=timeout_s)
    try:
        out = fn(dev, *args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, args=(), backend: str | None = None, device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(device, *args)`` in ``n`` ranks of a new process group on
    this host (the spawn start method) and return their results in rank
    order.  A rank that raises fails the call with its traceback; ranks
    still running after ``timeout_s`` seconds are killed and the call
    raises ``TimeoutError``.  ``fn`` must be importable by name."""
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, free_port(), backend, device, timeout_s, out_dir,
                              tuple(args)),
            nprocs=n, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
