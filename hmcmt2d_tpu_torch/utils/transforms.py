"""Model parameterisation: log-conductivity transform and active cells.

PyTorch counterpart of ``hmcmt2d_tpu/utils/transforms.py`` (the reference's
HMCUtility layer: modelTransform, the bounded sigmoid of Kim & Kim 2011 and
its inverse, and setActiveElement).  Autograd supplies the transforms'
Jacobians.
"""

from __future__ import annotations

import numpy as np
import torch


def model_transform(m: torch.Tensor) -> torch.Tensor:
    """log-conductivity -> linear conductivity."""
    return torch.exp(m)


def model_transform_bounded(m: torch.Tensor, sig_lb, sig_ub,
                            cp: float = 2.0) -> torch.Tensor:
    """Bounded sigmoid sigma = (a + b exp(cp m)) / (1 + exp(cp m))
    (HMCUtility.jl:114-138)."""
    e = torch.exp(cp * m)
    return (sig_lb + sig_ub * e) / (1.0 + e)


def bounded_model(sigma: torch.Tensor, sig_lb, sig_ub, cp: float = 2.0) -> torch.Tensor:
    """Inverse of :func:`model_transform_bounded` (HMCUtility.jl:150-158)."""
    return torch.log((sigma - sig_lb) / (sig_ub - sigma)) / cp


def active_cells(sigma_flat: np.ndarray, sigma_fixed, fix_index=None):
    """Split cells into inversion-active and fixed-background sets.

    Cells whose conductivity exactly equals any value in ``sigma_fixed`` (air
    at 1e-8 S/m) are frozen, as are the optional explicit ``fix_index``.
    Returns numpy (active_idx, bg_flat): ``bg_flat`` holds the frozen
    conductivities and zeros on active cells.
    """
    sigma_flat = np.asarray(sigma_flat)
    inactive = np.zeros(sigma_flat.shape, bool)
    for sf in np.atleast_1d(sigma_fixed):
        inactive |= sigma_flat == sf
    if fix_index is not None and len(fix_index):
        inactive[np.asarray(fix_index, int)] = True
    bg = np.where(inactive, sigma_flat, 0.0)
    active_idx = np.nonzero(~inactive)[0]
    return active_idx, bg


def scatter_active(values: torch.Tensor, active_idx: torch.Tensor,
                   n_cell: int) -> torch.Tensor:
    """Inject active-cell values (..., n_active) into a flat cell vector
    (..., n_cell), zeros elsewhere; leading batch (chain) axes pass
    through.  ``active_idx`` is an int64 tensor on ``values``' device."""
    out = values.new_zeros(values.shape[:-1] + (n_cell,))
    return out.index_copy(-1, active_idx, values)
