"""Tensor-mesh geometry and matrix-free 5-point stencil operators.

PyTorch counterpart of ``hmcmt2d_tpu/mesh.py``.  The operator
``Grad' * M_F * Grad + i*omega*M_CN`` of the reference is a 5-point
finite-volume stencil on a tensor mesh, so only three coefficient arrays
(y-edge, z-edge, node mass) are stored and applied with shifted adds.

Layouts are z-major as in the JAX package:

* cell fields   : ``(..., nz, ny)``
* node fields   : ``(..., nz+1, ny+1)``
* y-edge fields : ``(..., nz+1, ny)``
* z-edge fields : ``(..., nz, ny+1)``
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .constants import MU0
from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class TensorMesh2D:
    """Static tensor-mesh geometry (air layers already prepended to z), as
    float64 tensors on one device.  The conductivity is not stored here: it
    is the differentiated variable and flows through function arguments."""

    y_len: torch.Tensor      # (ny,) cell widths in y [m]
    z_len: torch.Tensor      # (nz,) cell heights in z [m], air rows first
    air_layer: torch.Tensor  # (nair,) air thicknesses, bottom-up file order
    origin: torch.Tensor     # (2,) coordinates of node (z=0, y=0) offset

    @property
    def device(self) -> torch.device:
        return self.y_len.device

    def to(self, device) -> "TensorMesh2D":
        return TensorMesh2D(*(t.to(device) for t in dataclasses.astuple(self)))

    @property
    def ny(self) -> int:
        return self.y_len.shape[0]

    @property
    def nz(self) -> int:
        return self.z_len.shape[0]

    @property
    def n_air(self) -> int:
        return self.air_layer.shape[0]

    @property
    def n_node(self) -> int:
        return (self.ny + 1) * (self.nz + 1)

    @property
    def n_cell(self) -> int:
        return self.ny * self.nz

    def y_node(self) -> torch.Tensor:
        """Node y-coordinates, origin-shifted; y_len's device and dtype."""
        zero = self.y_len.new_zeros(1)
        return torch.cat([zero, torch.cumsum(self.y_len, 0)]) - self.origin[0]

    def z_node(self) -> torch.Tensor:
        """Node z-coordinates, origin-shifted; z grows down."""
        zero = self.z_len.new_zeros(1)
        return torch.cat([zero, torch.cumsum(self.z_len, 0)]) - self.origin[1]


def make_mesh(y_len, z_len, air_layer=None, origin=None,
              device: torch.device | str | None = None,
              dtype: torch.dtype = torch.float64) -> TensorMesh2D:
    """Build a mesh from plain arrays; ``z_len`` must already include air.
    ``device=None`` means the GPU, and raises without one."""
    air = np.zeros(0) if air_layer is None else np.asarray(air_layer)
    org = np.zeros(2) if origin is None else np.asarray(origin)
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.array(a, np.float64), dtype=dtype,
                            device=device)

    return TensorMesh2D(y_len=t(y_len), z_len=t(z_len), air_layer=t(air),
                        origin=t(org))


class Stencil(NamedTuple):
    """Coefficients of ``A(omega) = L + i*omega*diag(m)`` on the node grid.

    TE: faces carry ``1/mu``, mass carries ``sigma``; TM is the dual with
    ``1/sigma`` on faces and ``mu`` in the mass.
    """

    cy: torch.Tensor  # (..., nz+1, ny)   y-edge coefficient  w_y / dy^2
    cz: torch.Tensor  # (..., nz,  ny+1)  z-edge coefficient  w_z / dz^2
    m: torch.Tensor   # (..., nz+1, ny+1) node mass (multiplies i*omega)


def _ave_cn(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cell-to-node averaging along a negative ``dim``: half-weights inside,
    weight 1.0 on the two boundary nodes (length n -> n+1)."""
    n = x.shape[dim]
    lo = x.narrow(dim, 0, 1)
    hi = x.narrow(dim, n - 1, 1)
    mid = 0.5 * (x.narrow(dim, 0, n - 1) + x.narrow(dim, 1, n - 1))
    return torch.cat([lo, mid, hi], dim=dim)


def _edge_and_mass(mesh: TensorMesh2D, face_cell: torch.Tensor,
                   mass_cell: torch.Tensor) -> Stencil:
    """Shared TE/TM coefficient assembly from cell fields (..., nz, ny)."""
    dy = mesh.y_len[None, :]
    dz = mesh.z_len[:, None]
    area = dy * dz
    fa = area * face_cell
    cy = _ave_cn(fa, -2) / (dy * dy)
    cz = _ave_cn(fa, -1) / (dz * dz)
    m = _ave_cn(_ave_cn(area * mass_cell, -1), -2)
    return Stencil(cy=cy, cz=cz, m=m)


def te_stencil(mesh: TensorMesh2D, sigma2d: torch.Tensor) -> Stencil:
    """TE-mode coefficients: ``Grad'*(1/mu)_F*Grad + i*omega*(sigma)_CN``."""
    inv_mu = torch.full_like(sigma2d, 1.0 / MU0)
    return _edge_and_mass(mesh, inv_mu, sigma2d)


def tm_stencil(mesh: TensorMesh2D, sigma2d: torch.Tensor) -> Stencil:
    """TM-mode coefficients: ``Grad'*(1/sigma)_F*Grad + i*omega*(mu)_CN``."""
    mu = torch.full_like(sigma2d, MU0)
    return _edge_and_mass(mesh, 1.0 / sigma2d, mu)


def _div_adjoint_y(fy: torch.Tensor) -> torch.Tensor:
    """out[j, i] = fy[j, i-1] - fy[j, i] with zero padding."""
    z = torch.zeros_like(fy[..., :, :1])
    return torch.cat([z, fy], dim=-1) - torch.cat([fy, z], dim=-1)


def _div_adjoint_z(fz: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(fz[..., :1, :])
    return torch.cat([z, fz], dim=-2) - torch.cat([fz, z], dim=-2)


def apply_L(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """Apply the real part ``L = Grad'*W_F*Grad`` to a full node grid."""
    fy = st.cy * (u[..., :, 1:] - u[..., :, :-1])
    fz = st.cz * (u[..., 1:, :] - u[..., :-1, :])
    return _div_adjoint_y(fy) + _div_adjoint_z(fz)


def apply_A(st: Stencil, omega, u: torch.Tensor) -> torch.Tensor:
    """Apply ``A(omega) = L + i*omega*diag(m)`` to a full node grid."""
    return apply_L(st, u) + (1j * omega) * (st.m * u)


def embed_interior(u_int: torch.Tensor) -> torch.Tensor:
    """Zero-pad an interior node field (..., nz-1, ny-1) to the full grid."""
    return torch.nn.functional.pad(u_int, (1, 1, 1, 1))


def interior(u: torch.Tensor) -> torch.Tensor:
    """The interior (..., nz-1, ny-1) of a full node grid."""
    return u[..., 1:-1, 1:-1]


def boundary_rhs(st: Stencil, omega, bc_full: torch.Tensor) -> torch.Tensor:
    """Interior right-hand side ``-A_io bc`` (mt2DTE.jl:44): ``bc_full`` is
    a full node grid with the Dirichlet values on its boundary ring and
    zeros inside, so the interior rows of ``A bc_full`` are ``A_io bc``."""
    return -interior(apply_A(st, omega, bc_full))


def cell_gradient_sqnorm(v2d: torch.Tensor) -> torch.Tensor:
    """``v' Gc' Gc v`` for the unscaled cell-gradient smoothness operator
    (plain first differences between adjacent cells in y and z)."""
    dy = v2d[..., :, 1:] - v2d[..., :, :-1]
    dz = v2d[..., 1:, :] - v2d[..., :-1, :]
    return (dy * dy).sum(dim=(-2, -1)) + (dz * dz).sum(dim=(-2, -1))


def cell_gradient_normal(v2d: torch.Tensor) -> torch.Tensor:
    """``Gc' Gc v`` on the full cell grid (the smoothness matrix Wm)."""
    dy = v2d[..., :, 1:] - v2d[..., :, :-1]
    dz = v2d[..., 1:, :] - v2d[..., :-1, :]
    return _div_adjoint_y(dy) + _div_adjoint_z(dz)
