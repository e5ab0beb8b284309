"""The batched potential value-and-grad, and its trajectory-amortised
factor, captured once as CUDA graphs: the single-process sampler's
(``sampler/driver.py``, every engine) and a sharded rank's local work
(``parallel/multichain.py``: its frequency block's value-and-grad, cube
factor and stale eval; the freq-group reduction runs after the replay).

The port's counterpart of the JAX package's jitted sampler and warmup
(``hmcmt2d_tpu/sampler/hmc.py``, ``sampler/driver.py``): XLA traces an
evaluation once and dispatches it as one program, where the eager port
issues every op of every evaluation from Python (about 11,900 kernels a
fused flagship eval at C = 8, 14,000-24,000 on the other engines, the host
setting its pace).  Here every engine's eval, fused, thomas,
thomas_blocked or bcr with either inverse
(``problem.potential_value_and_grad`` with its ``torch.autograd.grad``:
the forward factor, the forward solve and the adjoint solve of
``_DirichletSolve.backward``, ``models/forward.py``), is captured into one
``torch.cuda.CUDAGraph`` for each shape and dtype of (m, m_ref) and
replayed in every later call.  :class:`GraphedPotential` captures any
such pair of functions: the problem's own by default, a sharded rank's
when it passes them (``eval_fn``, ``factor_fn``).  The Gauss-Newton
build's slab pullback (``models/jacobian.py``) takes the same recipe
(:func:`capture`, :func:`replay`) for one graph a build.

Trajectory amortisation (``sampler/hmc.py`` ``_leapfrog``: a factor at the
trajectory's start and every ``refactor_every`` steps, the steps between
solving against it) takes two more graphs a shape, as JAX compiles the
factor and the stale evals into its scan:

* the factor graph, :meth:`GraphedPotential.factor`: m ->
  ``problem.factor_state(m)`` (or ``factor_fn(m)``).  Its replay rewrites
  the factor in the graph's static outputs and returns that same
  ``Factorization``;
* the stale eval graph, ``vg(m, m_ref, fac)`` with ``fac`` that static
  output: it reads the factor graph's outputs where they lie.

Rewriting the factor in place is sound because the sampler holds one
factor at a time: ``_leapfrog`` drops the old factor when it refactors,
and a factor never outlives its trajectory.  A caller that kept two
factors would find both rewritten by the later one, so ``vg`` refuses any
factor that is not its own factor graph's output: a foreign factor is
never read silently from stale buffers.

Capture follows PyTorch's recipe for whole-network capture:
:data:`WARMUP_CALLS` eager calls on a side stream, then the capture on
that stream into the graph's own memory pool (one pool a graph: the bench
interleaves C = 8, 12 and 16, and a factor must survive the stale evals'
replays that read it).  A call copies its inputs into the graph's static
inputs and replays it; an eval returns clones of its output tensors,
since the next replay overwrites them and the sampler carries the gradient
and pred across steps.  A capture or replay error raises; nothing falls
back to the eager eval.  :meth:`GraphedPotential.release` frees every
graph and pool (the hybrid run's warmup engine, at the switch to the main
one).

Launch counts: the kernel wrappers count while they are captured, not when
the graph runs them.  A capture records what :func:`.fused_factor.launches`
moved across it, and each replay adds that (:func:`.fused_factor.
add_launches`), so the counts read as eagerly: (1, 14, 14) a fused eval,
and ``gj_inverse`` once a line (thomas, thomas_blocked) or a level (bcr)
of each factor under ``inv_method="gj"``.  The capture's own warm-up calls
and its recording are taken back out of the counts (they serve no caller)
and kept in its :class:`Capture`.
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple

import torch

from ..ops import fused_factor as FF
from ..utils.trace import span

WARMUP_CALLS = 3   # eager calls on the side stream before a capture
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}


def unservable(problem) -> str | None:
    """Why the graphs cannot serve ``problem``, or None: they serve every
    engine and inverse on a CUDA device."""
    if problem.device.type != "cuda":
        return f"the graphed eval needs a CUDA problem, not one on {problem.device}"
    return None


class Capture(NamedTuple):
    """One captured call: the graph, its static inputs and outputs, and
    what its capture cost."""

    kind: str                       # "eval" (fresh factor), "factor", "stale"
    #                                 or "jacobian" (models/jacobian.py)
    graph: torch.cuda.CUDAGraph
    inputs: tuple                   # static (m,) or (m, m_ref), copied into
    out: object                     # static outputs, rewritten by each replay
    launches: dict[str, int]        # counted once a replay
    warmup_launches: dict[str, int]  # the WARMUP_CALLS eager calls' launches
    seconds: float                  # warm-ups and capture, host clock
    pool_bytes: int                 # device memory the graph's pool reserved

    def summary(self) -> dict:
        x = self.inputs[0]        # (C, P) models, or a 0-d slab start
        return {"kind": self.kind, "chains": x.shape[0] if x.dim() else None,
                "capture_s": self.seconds, "pool_bytes": self.pool_bytes,
                "launches_per_replay": self.launches}


def _signature(*ts: torch.Tensor) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in ts)


def _clone(out):
    """A fresh copy of every tensor of a (nested) tuple; anything else (a
    dtype) as it is."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        return tuple(_clone(x) for x in out)
    return out


def _load(static: tuple, inputs: tuple) -> None:
    with torch.no_grad():
        for s, x in zip(static, inputs):
            s.copy_(x)


def _side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` that every capture takes: PyTorch
    keeps cuBLAS workspaces for each stream that runs a product, so a new
    stream a capture would keep another set allocated each time."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def capture(kind: str, fn, inputs: tuple, device, warmups=None) -> Capture:
    """``fn``'s call on static copies of ``inputs``, captured as a CUDA
    graph by PyTorch's recipe for whole-network capture:
    :data:`WARMUP_CALLS` eager calls on a side stream, then the capture on
    that stream into the graph's own memory pool.

    ``warmups`` holds one tuple of inputs for each warm-up call, loaded
    into the static inputs before it (by default ``inputs`` itself,
    :data:`WARMUP_CALLS` times), so that the warm-ups can do a caller's
    work; the capture records the call on ``inputs``.  The warm-ups' and
    the capture's launches are taken back out of the counts and kept in
    the :class:`Capture`.  Autograd runs each backward op on the stream its
    forward op ran on, so a function that captures only a backward pass
    makes its forward in its first warm-up call, on the side stream."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                   for x in inputs)
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    before = FF.launches()
    with torch.cuda.stream(side):
        for args in warmups or (inputs,) * WARMUP_CALLS:
            _load(static, args)
            fn(*static)
        _load(static, inputs)
    torch.cuda.current_stream(device).wait_stream(side)
    warmed = FF.launches()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection while recording: a graph that the collector
    # frees (one held in a reference cycle, as every GraphedPotential is)
    # destroys its executable, which a capture does not permit
    collecting = gc.isenabled()
    gc.disable()
    try:
        # the graph's pool is new and takes only fresh segments, so what
        # the capture reserves is the pool's size
        with torch.cuda.graph(graph, stream=side):
            reserved = torch.cuda.memory_reserved(device)
            out = fn(*static)
    finally:
        if collecting:
            gc.enable()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    after = FF.launches()
    FF.add_launches(FF.launch_delta(after, before))
    torch.cuda.synchronize(device)
    return Capture(kind, graph, static, out, FF.launch_delta(warmed, after),
                   FF.launch_delta(before, warmed), time.perf_counter() - t0,
                   pool_bytes)


def replay(cap: Capture, inputs: tuple):
    """Load ``inputs`` into the capture's static inputs, replay its graph
    and count its launches; returns its static outputs."""
    with span("graphed.load"):
        _load(cap.inputs, inputs)
    with span("graphed.launch"):
        cap.graph.replay()
        FF.add_launches(cap.launches)
    return cap.out


class GraphedPotential:
    """``vg(m, m_ref, fac=None)``, the call of the eager ``eval_fn``, and
    :meth:`factor`, the eager ``factor_fn``'s, served by CUDA graphs on
    ``problem``'s device, one for each kind and each shape and dtype of the
    inputs (``captures``).  By default ``eval_fn`` is
    ``problem.potential_value_and_grad`` at ``reg`` (the eager
    ``make_potential_vg`` closure's ``((U, (misfit, mnorm, pred)), grad)``)
    and ``factor_fn`` is ``problem.factor_state`` (the eager
    ``make_factor_fn``'s); any other pair must make no host round trip
    after its first call, and ``eval_fn`` returns tensors in (nested)
    tuples."""

    def __init__(self, problem, reg: float, eval_fn=None, factor_fn=None):
        why = unservable(problem)
        if why:
            raise ValueError(why)
        self.problem, self.reg = problem, reg
        self.eval_fn = eval_fn or self._problem_eval
        self.factor_fn = factor_fn or self._problem_factor
        self.captures: dict[tuple, Capture] = {}

    def _problem_eval(self, m, m_ref, fac=None):
        return self.problem.potential_value_and_grad(m, m_ref, self.reg, fac=fac)

    def _problem_factor(self, m):
        return self.problem.factor_state(m)

    def _capture(self, kind: str, fn, inputs: tuple) -> Capture:
        return capture(kind, fn, inputs, self.problem.device)

    def _replay(self, key: tuple, kind: str, fn, inputs: tuple):
        dev = self.problem.device
        if any(x.device != dev for x in inputs):
            raise ValueError(f"inputs on {[str(x.device) for x in inputs]}; the "
                             f"problem is on {dev}")
        cap = self.captures.get(key)
        if cap is None:
            with span("graphed.capture"):
                cap = self.captures[key] = self._capture(kind, fn, inputs)
        return replay(cap, inputs)

    def factor(self, m: torch.Tensor):
        """``factor_fn(m)`` from the factor graph: the graph's static
        ``Factorization``, rewritten in place by every call (see the module
        docstring); the stale eval takes only this."""
        with span("graphed.factor"):
            return self._replay(("factor",) + _signature(m), "factor", self.factor_fn,
                                (m,))

    def _factor_key(self, fac) -> tuple:
        for key, cap in self.captures.items():
            if cap.kind == "factor" and cap.out is fac:
                return key
        raise ValueError("a stale factor that this graphed eval's factor graph "
                         "did not make: it could be read only from stale "
                         "buffers; take factors from its factor()")

    def __call__(self, m: torch.Tensor, m_ref: torch.Tensor, fac=None):
        kind = "eval" if fac is None else "stale"
        with span("graphed." + kind):
            if fac is None:
                key, fn = ("eval",) + _signature(m, m_ref), self.eval_fn
            else:
                key = ("stale", self._factor_key(fac)) + _signature(m, m_ref)

                def fn(m_s, r_s):
                    return self.eval_fn(m_s, r_s, fac)

            out = self._replay(key, kind, fn, (m, m_ref))
            with span("graphed.clone"):
                return _clone(out)

    def release(self) -> list[dict]:
        """Drop every capture, its graph and its pool, and return the
        device's freed memory; returns each capture's summary.  A later
        call captures afresh."""
        done = [cap.summary() for cap in self.captures.values()]
        self.captures.clear()
        torch.cuda.empty_cache()
        return done
