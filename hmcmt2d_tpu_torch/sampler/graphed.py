"""The batched potential value-and-grad, captured once as a CUDA graph.

The port's counterpart of the JAX package's jitted sampler
(``hmcmt2d_tpu/sampler/hmc.py``, ``sampler/driver.py``): XLA traces an
evaluation once and dispatches it as one program, where the eager port
issues every op of every evaluation from Python (about 11,900 kernels a
flagship eval at C = 8, the host setting its pace).  Here the fused
engine's eval, ``problem.potential_value_and_grad`` with its
``torch.autograd.grad`` (the forward factor, the forward sweeps and the
adjoint solve of ``_DirichletSolve.backward``, ``models/forward.py``), is
captured into one ``torch.cuda.CUDAGraph`` for each shape and dtype of
(m, m_ref) and replayed in every later call.

Capture follows PyTorch's recipe for whole-network capture:
:data:`WARMUP_CALLS` eager calls on a side stream, then the capture on
that stream into the graph's own memory pool (one pool a shape: the bench
interleaves C = 8, 12 and 16).  A call copies m and m_ref into the graph's
static inputs, replays it, and returns clones of its outputs, since the
next replay overwrites them and the sampler carries the gradient and pred
across steps.  A capture or replay error raises; nothing falls back to
the eager eval.

Launch counts: the kernel wrappers count while they are captured, not when
the graph runs them.  A capture records what :func:`.fused_factor.launches`
moved across it, and each replay adds that (:func:`.fused_factor.
add_launches`), so the counts read (1, 14, 14) an eval served, as eagerly.
The capture's own warm-up evals and its recording are taken back out of
the counts (they serve no caller) and kept in its :class:`Capture`.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops import fused_factor as FF

WARMUP_CALLS = 3   # eager calls on the side stream before a capture


def unservable(problem) -> str | None:
    """Why the graphed eval cannot serve ``problem``, or None: it serves the
    fused engine on a CUDA device only."""
    if problem.device.type != "cuda":
        return f"the graphed eval needs a CUDA problem, not one on {problem.device}"
    method = problem.fwd.cfg.solver_method
    if method != "fused":
        return f"the graphed eval serves the fused engine, not {method!r}"
    return None


class Capture(NamedTuple):
    """One captured eval: the graph, its static inputs and outputs, and what
    its capture cost."""

    graph: torch.cuda.CUDAGraph
    m: torch.Tensor                 # static input, copied into at each call
    m_ref: torch.Tensor
    out: tuple                      # ((U, (misfit, mnorm, pred)), grad), static
    launches: dict[str, int]        # counted once a replay
    warmup_launches: dict[str, int]  # the WARMUP_CALLS eager evals' launches
    seconds: float                  # warm-ups and capture, host clock
    pool_bytes: int                 # device memory the graph's pool reserved


class GraphedPotential:
    """``vg(m, m_ref) -> ((U, (misfit, mnorm, pred)), grad)``, the call of
    the eager ``make_potential_vg`` closure, served by a CUDA graph of the
    fused engine's eval, one for each shape and dtype of (m, m_ref)
    (``captures``).  A stale factor (``fac``) raises: the fused engine runs
    without trajectory amortisation."""

    def __init__(self, problem, reg: float):
        why = unservable(problem)
        if why:
            raise ValueError(why)
        self.problem, self.reg = problem, reg
        self.captures: dict[tuple, Capture] = {}

    def _eval(self, m, m_ref):
        return self.problem.potential_value_and_grad(m, m_ref, self.reg)

    def _capture(self, m: torch.Tensor, m_ref: torch.Tensor) -> Capture:
        dev = self.problem.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m_s = torch.empty(m.shape, dtype=m.dtype, device=dev).copy_(m)
        r_s = torch.empty(m_ref.shape, dtype=m_ref.dtype, device=dev).copy_(m_ref)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = FF.launches()
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self._eval(m_s, r_s)
        torch.cuda.current_stream(dev).wait_stream(side)
        warmed = FF.launches()
        graph = torch.cuda.CUDAGraph()
        # the graph's pool is new and takes only fresh segments, so what
        # the capture reserves is the pool's size
        with torch.cuda.graph(graph, stream=side):
            reserved = torch.cuda.memory_reserved(dev)
            out = self._eval(m_s, r_s)
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = FF.launches()
        FF.add_launches(FF.launch_delta(after, before))
        torch.cuda.synchronize(dev)
        return Capture(graph, m_s, r_s, out, FF.launch_delta(warmed, after),
                       FF.launch_delta(before, warmed), time.perf_counter() - t0,
                       pool_bytes)

    def __call__(self, m: torch.Tensor, m_ref: torch.Tensor, fac=None):
        if fac is not None:
            raise ValueError("the graphed eval takes no stale factor: the fused "
                             "engine runs without trajectory amortisation")
        dev = self.problem.device
        if m.device != dev or m_ref.device != dev:
            raise ValueError(f"m on {m.device} and m_ref on {m_ref.device}; the "
                             f"problem is on {dev}")
        key = (tuple(m.shape), m.dtype, tuple(m_ref.shape), m_ref.dtype)
        cap = self.captures.get(key)
        if cap is None:
            cap = self.captures[key] = self._capture(m, m_ref)
        cap.m.copy_(m)
        cap.m_ref.copy_(m_ref)
        cap.graph.replay()
        FF.add_launches(cap.launches)
        (U, aux), g = cap.out
        return (U.clone(), tuple(a.clone() for a in aux)), g.clone()
