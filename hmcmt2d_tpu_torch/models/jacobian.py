"""Jacobian products and full Jacobians of the predicted data.

PyTorch counterpart of ``hmcmt2d_tpu/models/jacobian.py`` (the reference's
compJacTMatVec / compJacMat): autograd through the differentiable forward
model, reverse mode for ``jtv`` and the Jacobians, forward mode for
``jv``.  Complex data are stacked as real parts then imaginary parts, the
reference's real view of the misfit: J is (2 ndata, n_param) for impedance
data and (ndata, n_param) for rho/phase data.

The full Jacobian takes one factorisation and one forward pass for all its
rows: the model is repeated over ``chunk`` rows that share the factor
(``factor_state`` at the model, handed to the solve as a stale factor whose
batch is 1 on the row axis), and each backward pass with a ``chunk``-row
slab of the identity as ``grad_outputs`` gives ``chunk`` rows of J from one
multi-right-hand-side adjoint solve.  ``torch.vmap`` cannot pass through
the solve's kernels, so this is how the rows share the factor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused_factor as FF
from ..sampler import graphed as G


def _real_stack(pred: torch.Tensor) -> torch.Tensor:
    if pred.is_complex():
        return torch.cat([pred.real, pred.imag], dim=-1)
    return pred


def real_predict(problem, m: torch.Tensor, fac=None) -> torch.Tensor:
    """Predicted data as a real vector (re parts then im parts), batched
    over m's leading axes."""
    return _real_stack(problem.predict(m, fac=fac))


def jv(problem, m: torch.Tensor, v: torch.Tensor, fac=None) -> torch.Tensor:
    """J @ v: the directional derivative of :func:`real_predict` at m along
    v, in forward mode (``torch.func.jvp``; one extra solve per (freq, mode)
    on the forward solve's factor, the solve's ``jvp``)."""
    _, out = torch.func.jvp(lambda mm: real_predict(problem, mm, fac),
                            (m.detach(),), (v.to(m.dtype),))
    return out


def jtv(problem, m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """J' @ w: the adjoint product (one extra solve per (freq, mode) on the
    forward solve's factor, as compJacTMatVec.jl:224,295)."""
    m = m.detach().requires_grad_(True)
    with torch.enable_grad():
        y = real_predict(problem, m)
        (g,) = torch.autograd.grad(y, m, grad_outputs=w.to(y.dtype))
    return g


def n_rows(problem) -> int:
    """Rows of J: the data's real view (re and im parts of complex data)."""
    data = problem.fwd.data
    return data.n_data * (2 if data.is_complex else 1)


class SlabPullback:
    """The Gauss-Newton build's work at model m (P,).  Each call with a
    slab's first row index ``i0`` (a 0-d int64 tensor on m's device) pulls
    that ``chunk``-row slab of the identity back through one forward pass
    over ``chunk`` equal rows that share the factor at m (see the module
    docstring), and writes rows i0 .. i0 + chunk - 1 of J into ``out``
    (``n_slabs * chunk`` rows).  A tail slab's rows past the last repeat its
    basis vector (one fixed-size slab for every call, as JAX's
    ``jac_slab``) and land in rows of ``out`` that :meth:`jacobian` drops.

    The first call makes the factor and the forward pass, once, on the
    stream it runs on: under a capture that is the capture's side stream,
    where autograd then runs their backward ops.  A later call reads
    nothing back to the host, so a CUDA graph captures it
    (``full_jacobian_chunked``)."""

    def __init__(self, problem, m: torch.Tensor, chunk: int):
        self.problem, self.m, self.chunk = problem, m.detach(), chunk
        self.n = n_rows(problem)
        self.n_slabs = -(-self.n // chunk)
        self.starts = torch.arange(0, self.n_slabs * chunk, chunk, device=m.device)
        self.y = None

    def _forward(self) -> None:
        m, dev = self.m, self.m.device
        self._offsets = torch.arange(self.chunk, device=dev)
        self._cols = torch.arange(self.n, device=dev)
        fac = self.problem.factor_state(m[None])
        self.rows = m.expand(self.chunk, -1).clone().requires_grad_(True)
        with torch.enable_grad():
            self.y = real_predict(self.problem, self.rows, fac)   # (chunk, n)
        self.out = torch.empty((self.n_slabs * self.chunk, m.shape[-1]), dtype=m.dtype,
                               device=dev)

    def __call__(self, i0: torch.Tensor) -> torch.Tensor:
        if self.y is None:
            self._forward()
        rows = i0 + self._offsets
        idx = torch.clamp(rows, max=self.n - 1)
        slab = (idx[:, None] == self._cols).to(self.y.dtype)
        (g,) = torch.autograd.grad(self.y, self.rows, grad_outputs=slab,
                                   retain_graph=True)
        return self.out.index_copy_(0, rows, g)

    def jacobian(self) -> np.ndarray:
        """J (n x P) as float64 on the host: one copy, after the last slab."""
        return self.out[:self.n].cpu().to(torch.float64).numpy()


def unservable(problem, n_slabs: int) -> str | None:
    """Why a graph cannot serve a build of ``n_slabs`` slabs, or None."""
    why = G.unservable(problem)
    if why is None and n_slabs <= G.WARMUP_CALLS:
        why = (f"a build of {n_slabs} slabs has none left to replay after the "
               f"capture's {G.WARMUP_CALLS} warm-up slabs")
    return why


def full_jacobian_chunked(problem, m: torch.Tensor, chunk: int = 128,
                          graphed: bool | None = None,
                          captures: list | None = None) -> np.ndarray:
    """Dense J (n_real_data x n_param) as a float64 numpy array, ``chunk``
    rows per backward pass (:class:`SlabPullback`); used by the
    Gauss-Newton mass matrix.  The rows stay on the device until the last
    slab, and J crosses to the host once.

    ``graphed``, as in ``sampler.driver.make_potential_vg``: None builds a
    CUDA problem's J from a CUDA graph of the slab pullback wherever a
    replay is left after the warm-ups (more than
    ``sampler.graphed.WARMUP_CALLS`` slabs), on every engine and survey,
    and eagerly otherwise; True asks for the graph and raises where it
    cannot serve; False is the eager build.  The graph is the port's
    counterpart of JAX's jitted ``jac_slab``, though the factor and the
    forward pass stay outside it, eager and once a build: the capture's
    warm-up calls make them and compute slabs 0 .. WARMUP_CALLS - 1 on its
    side stream (autograd runs each backward op on its forward op's
    stream), the capture records the next slab, and one replay a slab
    computes it and the rest.  The launch counts read as an eager build's.
    The graph and its pool are freed before this returns; with
    ``captures`` (a list) the capture's summary (kind "jacobian", with its
    ``rows``, ``slabs`` and ``replays``) is appended to it."""
    pull = SlabPullback(problem, m, chunk)
    why = unservable(problem, pull.n_slabs)
    if graphed is None:
        graphed = why is None
    elif graphed and why:
        raise ValueError(why)
    if not graphed:
        for i0 in pull.starts:
            pull(i0)
        return pull.jacobian()
    w = G.WARMUP_CALLS
    cap = G.capture("jacobian", pull, (pull.starts[w],), problem.device,
                    warmups=[(i0,) for i0 in pull.starts[:w]])
    # the warm-ups made the forward pass and slabs 0 .. w-1
    FF.add_launches(cap.warmup_launches)
    for i0 in pull.starts[w:]:
        G.replay(cap, (i0,))
    J = pull.jacobian()
    if captures is not None:
        captures.append(dict(cap.summary(), rows=chunk, slabs=pull.n_slabs,
                             replays=pull.n_slabs - w))
    del cap, pull
    torch.cuda.empty_cache()
    return J


def full_jacobian(problem, m: torch.Tensor) -> torch.Tensor:
    """Dense J (n_real_data x n_param) on m's device, all rows in one
    backward pass (compJacMat.jl)."""
    return torch.as_tensor(full_jacobian_chunked(problem, m, chunk=n_rows(problem)),
                           dtype=m.dtype, device=m.device)
