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


def full_jacobian_chunked(problem, m: torch.Tensor, chunk: int = 128) -> np.ndarray:
    """Dense J (n_real_data x n_param) as a float64 numpy array, ``chunk``
    rows per backward pass (see the module docstring); used by the
    Gauss-Newton mass matrix."""
    m = m.detach()
    fac = problem.factor_state(m[None])
    rows = m.expand(chunk, -1).clone().requires_grad_(True)
    with torch.enable_grad():
        y = real_predict(problem, rows, fac)          # (chunk, n), equal rows
        n = y.shape[-1]
        out = []
        for i in range(0, n, chunk):
            k = min(chunk, n - i)
            # fixed-size slab: tail rows repeat the last basis vector
            idx = torch.clamp(torch.arange(i, i + chunk, device=m.device), max=n - 1)
            slab = torch.zeros_like(y)
            slab[torch.arange(chunk, device=m.device), idx] = 1.0
            (g,) = torch.autograd.grad(y, rows, grad_outputs=slab,
                                       retain_graph=i + chunk < n)
            out.append(g[:k].to(torch.float64).cpu())
    return torch.cat(out).numpy()


def full_jacobian(problem, m: torch.Tensor) -> torch.Tensor:
    """Dense J (n_real_data x n_param) on m's device, all rows in one
    backward pass (compJacMat.jl)."""
    data = problem.fwd.data
    n = data.n_data * (2 if data.is_complex else 1)
    return torch.as_tensor(full_jacobian_chunked(problem, m, chunk=n),
                           dtype=m.dtype, device=m.device)
