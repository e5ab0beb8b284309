"""CPU (numpy/scipy) reference assembly used as a test oracle and CPU baseline.

Copy of ``hmcmt2d_tpu/utils/cpu_reference.py`` for the port, which imports
nothing of the JAX package.  It mirrors the reference's sparse
Kronecker-product construction (HMCMT/src/MTFwdSolver/MT2DOperators.jl and
MT2DFwdSolver.jl:124-161), so the port's matrix-free stencil in
:mod:`hmcmt2d_tpu_torch.mesh` can be verified entry by entry against an
independently assembled sparse matrix.  It is not part of the GPU path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..constants import MU0


def spunit(n):
    return sp.identity(n, format="csr")


def sdiag(v):
    return sp.diags(np.asarray(v))


def ddx(n):
    """1-D node-to-center difference (MT2DOperators.jl:161-163)."""
    return sp.diags([-np.ones(n), np.ones(n)], [0, 1], shape=(n, n + 1))


def av(n):
    """1-D node-to-center averaging (MT2DOperators.jl:172-174)."""
    return sp.diags([0.5 * np.ones(n), 0.5 * np.ones(n)], [0, 1], shape=(n, n + 1))


def avcn(n):
    """1-D center-to-node averaging with unit boundary weights
    (MT2DOperators.jl:183-190)."""
    A = sp.lil_matrix((n + 1, n))
    A[0, 0] = 1.0
    A[n, n - 1] = 1.0
    for k in range(1, n):
        A[k, k - 1] = 0.5
        A[k, k] = 0.5
    return A.tocsr()


def nodal_gradient(dy, dz):
    """Length-scaled nodal gradient [G1; G2] (getNodalGradient2D,
    MT2DOperators.jl:35-48 with meshGeoEdgeInv2D :104-115)."""
    ny, nz = len(dy), len(dz)
    G1 = sp.kron(spunit(nz + 1), ddx(ny))
    G2 = sp.kron(ddx(nz), spunit(ny + 1))
    L1 = sp.kron(spunit(nz + 1), sdiag(1.0 / np.asarray(dy)))
    L2 = sp.kron(sdiag(1.0 / np.asarray(dz)), spunit(ny + 1))
    return sp.vstack([L1 @ G1, L2 @ G2]).tocsr()


def cell_gradient(dy, dz):
    """Unscaled cell gradient (getCellGradient2D, MT2DOperators.jl:52-63)."""
    ny, nz = len(dy), len(dz)
    G1 = sp.kron(spunit(nz), ddx(ny - 1))
    G2 = sp.kron(ddx(nz - 1), spunit(ny))
    return sp.vstack([G1, G2]).tocsr()


def face_area(dy, dz):
    """meshGeoFace2D (MT2DOperators.jl:84-88)."""
    return sp.kron(sdiag(dz), sdiag(dy))


def ave_cell_to_node(ny, nz):
    """aveCell2Node2D (MT2DOperators.jl:118-122)."""
    return sp.kron(avcn(nz), avcn(ny))


def ave_cell_to_face(ny, nz):
    """aveCell2Face2D (MT2DOperators.jl:126-130): [A2; A1] with A2 the
    y-edge (z-averaging) block."""
    A1 = sp.kron(spunit(nz), avcn(ny))
    A2 = sp.kron(avcn(nz), spunit(ny))
    return sp.vstack([A2, A1]).tocsr()


def assemble_mode_matrices(dy, dz, sigma, mode):
    """Real and imaginary full-grid matrices (A = dGrad + i*omega*Mcn) for one
    mode, mirroring MT2DFwdSolver.jl:124-135 (TE) / :150-161 (TM).

    ``sigma`` is the flat cell vector (y-fastest).  Returns (dGrad, Mcn) as
    sparse matrices over all (ny+1)*(nz+1) nodes.
    """
    ny, nz = len(dy), len(dz)
    F = face_area(dy, dz)
    Grad = nodal_gradient(dy, dz)
    AveCN = ave_cell_to_node(ny, nz)
    AveCF = ave_cell_to_face(ny, nz)
    mu = MU0 * np.ones(ny * nz)
    if mode == "TE":
        face_q, node_q = 1.0 / mu, sigma
    elif mode == "TM":
        face_q, node_q = 1.0 / sigma, mu
    else:
        raise ValueError(mode)
    Mface = sdiag(AveCF @ (F @ face_q))
    Mnode = sdiag(AveCN @ (F @ node_q))
    dGrad = (Grad.T @ Mface @ Grad).tocsr()
    return dGrad, Mnode.tocsr()


def boundary_index(ny, nz):
    """Inner/outer node index split (getBoundaryIndex, MT2DFwdSolver.jl:227-248),
    0-based, y-fastest node ordering."""
    idx = np.arange((ny + 1) * (nz + 1)).reshape(nz + 1, ny + 1)
    ii = idx[1:-1, 1:-1].ravel()
    it = idx[0, :]
    il = idx[1:, 0]
    ir = idx[1:, -1]
    ib = idx[-1, 1:-1]
    io = np.concatenate([it, il, ir, ib])
    return ii, io


def dense_operator(dy, dz, sigma, mode, omega):
    """Full complex operator A(omega) over all nodes as a sparse matrix."""
    dGrad, Mnode = assemble_mode_matrices(dy, dz, sigma, mode)
    return (dGrad + 1j * omega * Mnode).tocsr()


# ---------------------------------------------------------------------------
# Receiver-side surface-field corrections — line-by-line numpy ports of the
# reference's compFieldsAtRxTE/TM (mt2DTE.jl:153-210, mt2DTM.jl:152-210) used
# as the *exact* oracle for hmcmt2d_tpu_torch.models.forward.rx_fields_te/tm.
# Note the reference's receiver interpolation weights are UNNORMALISED
# (Ex0[id-1]*dy2 + Ex0[id]*dy1, mt2DTE.jl:200-207): both fields pick up the
# same (dy1+dy2) factor, which cancels in the impedance Z = E/H.
# ---------------------------------------------------------------------------

def _interp_unnormalised(y_node, ry, field):
    """field (ny+1,) -> values at receiver y-locations with the reference's
    raw dy2/dy1 weights (mt2DTE.jl:195-207)."""
    out = np.empty(len(ry), field.dtype)
    for k, y in enumerate(ry):
        i = int(np.searchsorted(y_node, y, side="right"))  # first node > y
        i = min(max(i, 1), len(y_node) - 1)
        dy1 = y - y_node[i - 1]
        dy2 = y_node[i] - y
        out[k] = field[i - 1] * dy2 + field[i] * dy1
    return out


def _interp_normalised(x_grid, xs, field):
    """Normalised linear interpolation (linearInterpMat, sensUtils.jl:63-83)."""
    out = np.empty(len(xs), field.dtype)
    for k, x in enumerate(xs):
        i = int(np.searchsorted(x_grid, x, side="right"))
        i = min(max(i, 1), len(x_grid) - 1)
        d1 = x - x_grid[i - 1]
        d2 = x_grid[i] - x
        out[k] = (field[i - 1] * d2 + field[i] * d1) / (d1 + d2)
    return out


def rx_fields_te_reference(omega, rx_y, y_node, z_len1, sigma1, E0, E1):
    """compFieldsAtRxTE (mt2DTE.jl:153-210): surface (Ex, Hy) at receivers
    from the two node rows bracketing the receiver level.

    ``E0``/``E1`` are the (ny+1,) node fields at the receiver level and one
    level below; weights unnormalised as in the reference.
    """
    y_len = np.diff(y_node)
    ny = len(y_len)

    Bz0 = np.diff(E0) / y_len / (1j * omega)
    Bz1 = np.diff(E1) / y_len / (1j * omega)
    HzQ = (0.75 * Bz0 + 0.25 * Bz1) / MU0                        # (ny,)
    HyH = -(E1[1:-1] - E0[1:-1]) / z_len1 / (1j * omega * MU0)   # (ny-1,)
    ExQ = 0.75 * E0[1:-1] + 0.25 * E1[1:-1]
    av_ylen = 0.5 * (y_len[:-1] + y_len[1:])
    sigma1v = 0.5 * (sigma1[:-1] * y_len[:-1] + sigma1[1:] * y_len[1:]) / av_ylen
    dHzQ = np.diff(HzQ) / av_ylen
    Hy0 = np.empty(ny + 1, complex)
    Hy0[1:-1] = HyH - (dHzQ - sigma1v * ExQ) * (0.5 * z_len1)
    Hy0[0] = Hy0[1]
    Hy0[-1] = Hy0[-2]

    Exr = _interp_unnormalised(y_node, rx_y, E0)
    Hyr = _interp_unnormalised(y_node, rx_y, Hy0)
    return Exr, Hyr


def rx_fields_tm_reference(omega, rx_y, y_node, z_len1, sigma1, H0, H1):
    """compFieldsAtRxTM (mt2DTM.jl:152-210): surface (Ey, Hx) at receivers."""
    y_len = np.diff(y_node)
    ny = len(y_len)

    Jz0 = -np.diff(H0) / y_len
    Jz1 = -np.diff(H1) / y_len
    EzQ = (0.75 * Jz0 + 0.25 * Jz1) / sigma1                     # (ny,)
    JyH = (H1[1:-1] - H0[1:-1]) / z_len1
    av_ylen = 0.5 * (y_len[:-1] + y_len[1:])
    rho1v = 0.5 * ((1.0 / sigma1[:-1]) * y_len[:-1]
                   + (1.0 / sigma1[1:]) * y_len[1:]) / av_ylen
    EyH = JyH * rho1v
    HxQ = 0.75 * H0[1:-1] + 0.25 * H1[1:-1]
    dEzQ = np.diff(EzQ) / av_ylen
    Ey0 = np.empty(ny + 1, complex)
    Ey0[1:-1] = EyH - (dEzQ + 1j * omega * MU0 * HxQ) * (0.5 * z_len1)
    Ey0[0] = Ey0[1]
    Ey0[-1] = Ey0[-2]

    Eyr = _interp_unnormalised(y_node, rx_y, Ey0)
    Hxr = _interp_unnormalised(y_node, rx_y, H0)
    return Eyr, Hxr


def rx_hz_te_reference(omega, rx_y, y_node, E0):
    """Tipper Hz at receivers: the reference interpolates the *surface-row*
    Bz0/mu on cell centres with normalised weights (dataFuncSens.jl:44-51,
    Hzr at :96 — NOT the quarter-point HzQ)."""
    y_len = np.diff(y_node)
    Bz0 = np.diff(E0) / y_len / (1j * omega)
    y_cen = 0.5 * (y_node[:-1] + y_node[1:])
    xs = np.clip(rx_y, y_cen[0], y_cen[-1])
    return _interp_normalised(y_cen, xs, Bz0 / MU0)
