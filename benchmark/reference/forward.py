"""Plain reference of the 2-D MT forward model and the HMC potential.

Written for the benchmark in plain PyTorch, from the semantics of the
HMCMT2D reference (MT2DOperators.jl, MT2DFwdSolver.jl, mt1DField.jl,
mt2DTE.jl, mt2DTM.jl) as this repository states them in
``hmcmt2d_tpu_torch/utils/cpu_reference.py`` (the Kronecker-product
operators and the receiver-field corrections, at commit d92175c).  It
imports nothing of the program under test and takes nothing it made: the
operator, the 1-D boundary fields, the receiver fields, the misfit, the
smoothness prior and, through autograd, the gradient are all worked out here
again from the model file, the survey and the observations.

The interior Dirichlet system of each (chain, frequency, mode) is solved
by a dense block-tridiagonal (block Thomas) elimination over the z-lines
with pivoted inverses (``torch.linalg.inv``), in ``dtype``: complex128 is
the reference, complex64 with TF32 on is the control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MU0 = 4.0e-7 * 3.141592653589793
EPS0 = 8.85e-12
SIGMA_AIR = 1.0e-8
EXP_CLAMP = 60.0    # mt1DField.jl's overflow guard: real exponents clamped
TANH_CLAMP = 20.0   # |Re| beyond which tanh is +-1


@dataclasses.dataclass(frozen=True)
class Model:
    """A model file: cell sizes (air rows first, top down), the origin of
    the node grid (shifted up by the air), conductivity (nz, ny)."""

    y_len: np.ndarray
    z_len: np.ndarray
    n_air: int
    origin: np.ndarray
    sigma: np.ndarray

    @property
    def ny(self) -> int:
        return len(self.y_len)

    @property
    def nz(self) -> int:
        return len(self.z_len)

    def y_node(self) -> np.ndarray:
        return np.concatenate([[0.0], np.cumsum(self.y_len)]) - self.origin[0]


def read_model(path) -> Model:
    """The EMModel2DFile text format: NY/NAIR/NZ blocks, conductivity rows
    of the earth top down, an origin line; '#' lines are comments."""
    with open(path) as f:
        tokens = [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    blocks, i = {}, 0
    rows = []
    origin = np.zeros(2)
    res_type, log_model = "Conductivity", False
    while i < len(tokens):
        ln = tokens[i]
        key = ln.split(":")[0].strip()
        if key in ("NY", "NZ", "NAIR"):
            n = int(ln.split()[-1])
            vals = []
            i += 1
            while len(vals) < n:
                vals += [float(t) for t in tokens[i].split()]
                i += 1
            blocks[key] = np.asarray(vals[:n])
            continue
        if key == "Resistivity Type":
            res_type = ln.split()[-1]
        elif key == "Model Type":
            log_model = ln.split()[-1].lower() == "log"
            rows = []
            i += 1
            while i < len(tokens) and not tokens[i].startswith("Origin"):
                rows += [float(t) for t in tokens[i].split()]
                i += 1
            continue
        elif key.startswith("Origin"):
            toks = ln.split()
            origin = np.array([float(toks[-2]), float(toks[-1])])
        i += 1
    ny, air = len(blocks["NY"]), blocks.get("NAIR", np.zeros(0))
    sig = np.asarray(rows).reshape(len(blocks["NZ"]), ny)
    if log_model:
        sig = np.exp(sig)
    if res_type == "Resistivity":
        sig = 1.0 / sig
    sigma = np.concatenate([np.full((len(air), ny), SIGMA_AIR), sig])
    return Model(y_len=blocks["NY"], z_len=np.concatenate([air[::-1], blocks["NZ"]]),
                 n_air=len(air), origin=origin + np.array([0.0, air.sum()]),
                 sigma=sigma)


def _avcn(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cell to node along ``dim`` (avcn, MT2DOperators.jl:183-190): the two
    end nodes take their cell, inner nodes the mean of two."""
    n = x.shape[dim]
    first, last = x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)
    mid = 0.5 * (x.narrow(dim, 0, n - 1) + x.narrow(dim, 1, n - 1))
    return torch.cat([first, mid, last], dim=dim)


def _ctanh(z: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(z.real, -TANH_CLAMP, TANH_CLAMP)
    den = torch.sinh(x) ** 2 + torch.cos(z.imag) ** 2
    return torch.complex(0.5 * torch.sinh(2 * x) / den, 0.5 * torch.sin(2 * z.imag) / den)


def _cexp(z: torch.Tensor) -> torch.Tensor:
    mag = torch.exp(torch.clamp(z.real, -EXP_CLAMP, EXP_CLAMP))
    return torch.complex(mag * torch.cos(z.imag), mag * torch.sin(z.imag))


def field_1d(omega: torch.Tensor, sigma: torch.Tensor, dz: torch.Tensor):
    """E and H at the n + 1 interfaces of layered earths (mt1DField.jl):
    ``sigma`` (..., n), ``omega`` broadcasting against sigma[..., 0]; the
    bottom layer continues as a halfspace; every interface at and below
    the first where |E| grows is zeroed."""
    om = omega[..., None]
    k = torch.sqrt(MU0 * EPS0 * om ** 2 - 1j * MU0 * sigma * om)
    zp = om * MU0 / k
    th = _ctanh(1j * k * dz)
    zp, th = torch.broadcast_tensors(zp, th)
    z = zp[..., -1]
    for j in range(zp.shape[-1] - 1, -1, -1):
        z = zp[..., j] * (z + zp[..., j] * th[..., j]) / (zp[..., j] + z * th[..., j])
    ka = torch.cat([k, k[..., -1:]], dim=-1)
    wmu = omega * MU0
    up = 0.5 * (1 - wmu / (z * ka[..., 0]))
    dn = 0.5 * (1 + wmu / (z * ka[..., 0]))
    alive = torch.ones(up.shape, dtype=torch.bool, device=up.device)
    ups, dns = [up], [dn]
    for i in range(k.shape[-1]):
        kr = ka[..., i] / ka[..., i + 1]
        u = _cexp(1j * ka[..., i] * dz[i]) * up
        d = _cexp(-1j * ka[..., i] * dz[i]) * dn
        up_n = 0.5 * ((1 + kr) * u + (1 - kr) * d)
        dn_n = 0.5 * ((1 - kr) * u + (1 + kr) * d)
        with torch.no_grad():
            grew = (up_n + dn_n).abs() - (up + dn).abs() > 0
            alive = alive & ~(grew | torch.isnan((up_n + dn_n).abs()))
        up = torch.where(alive, up_n, torch.zeros_like(up_n))
        dn = torch.where(alive, dn_n, torch.zeros_like(dn_n))
        ups.append(up)
        dns.append(dn)
    up, dn = torch.stack(ups, -1), torch.stack(dns, -1)
    return up + dn, (ka * (dn - up)) / wmu[..., None]


def block_thomas(d, oy, oz, b):
    """x = A^-1 b for block-tridiagonal A: line i's block has diagonal
    d[..., i, :] and off-diagonals oy[..., i, :]; lines i, i+1 couple by
    the diagonal oz[..., i, :]."""
    n = d.shape[-2]
    sinv, y = [], []
    for i in range(n):
        D = (torch.diag_embed(d[..., i, :]) + torch.diag_embed(oy[..., i, :], 1)
             + torch.diag_embed(oy[..., i, :], -1))
        yi = b[..., i, :]
        if i:
            c = oz[..., i - 1, :]
            D = D - c[..., :, None] * sinv[-1] * c[..., None, :]
            yi = yi - c * (sinv[-1] @ y[-1][..., None])[..., 0]
        sinv.append(torch.linalg.inv(D))
        y.append(yi)
    x = [None] * n
    x[-1] = (sinv[-1] @ y[-1][..., None])[..., 0]
    for i in range(n - 2, -1, -1):
        x[i] = (sinv[i] @ (y[i] - oz[..., i, :] * x[i + 1])[..., None])[..., 0]
    return torch.stack(x, dim=-2)


class Reference:
    """The survey over ``model``: receivers at ``rx_y`` on the surface,
    ``freqs``, components ZXY and ZYX, every (freq, rx, comp) observed in
    C order; ``obs``/``weights`` (numpy) for the misfit; ``reg`` scales the
    smoothness prior.  Models ``m`` are (C, P) log-conductivities of the
    model's non-air cells."""

    def __init__(self, model: Model, rx_y, freqs, device, dtype=torch.complex128,
                 obs=None, weights=None, reg: float = 1.0):
        self.model, self.dtype, self.device, self.reg = model, dtype, device, reg
        self.rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        r = dict(dtype=self.rdt, device=device)
        flat = model.sigma.ravel()
        self.active = torch.as_tensor(np.nonzero(flat != SIGMA_AIR)[0], device=device)
        self.bg = torch.as_tensor(np.where(flat == SIGMA_AIR, flat, 0.0), **r)
        self.dy = torch.as_tensor(model.y_len, **r)
        self.dz = torch.as_tensor(model.z_len, **r)
        self.omega = torch.as_tensor(2 * np.pi * np.asarray(freqs, np.float64), **r)
        self.zid = model.n_air               # the node row of the surface
        y_node = model.y_node()
        rx_y = np.asarray(rx_y, np.float64)
        idx = np.clip(np.searchsorted(y_node, rx_y, side="right") - 1, 0, model.ny - 1)
        d1, d2 = rx_y - y_node[idx], y_node[idx + 1] - rx_y
        self.rx_idx = torch.as_tensor(idx, device=device)
        self.rx_w = (torch.as_tensor(d2 / (d1 + d2), **r), torch.as_tensor(d1 / (d1 + d2), **r))
        self.obs = None if obs is None else torch.as_tensor(obs, dtype=dtype, device=device)
        self.weights = None if weights is None else torch.as_tensor(weights, **r)

    @property
    def n_param(self) -> int:
        return len(self.active)

    def true_m(self) -> torch.Tensor:
        return torch.log(torch.as_tensor(self.model.sigma.ravel(), dtype=self.rdt,
                                         device=self.device)[self.active])

    def sigma2d(self, m: torch.Tensor) -> torch.Tensor:
        full = self.bg.expand(m.shape[:-1] + self.bg.shape).clone()
        full[..., self.active] = torch.exp(m)
        return full.reshape(m.shape[:-1] + (self.model.nz, self.model.ny))

    def stencil(self, sig: torch.Tensor):
        """(cy, cz, mass) of TE and TM stacked on axis -3: y-edge and z-edge
        weights of Grad' diag(AveCF F q_face) Grad and the node mass AveCN F
        q_node (MT2DFwdSolver.jl:124-161)."""
        dy, dz = self.dy, self.dz[:, None]
        area = dz * dy
        inv_mu = torch.full_like(sig, 1.0 / MU0)
        face = torch.stack([inv_mu, 1.0 / sig], dim=-3) * area
        node = torch.stack([sig, torch.full_like(sig, MU0)], dim=-3) * area
        cy = _avcn(face, -2) / dy ** 2
        cz = _avcn(face, -1) / dz ** 2
        return cy, cz, _avcn(_avcn(node, -1), -2)

    def boundary(self, sig: torch.Tensor) -> torch.Tensor:
        """Dirichlet values on the grid's ring (nf, C, 2, nz+1, ny+1), zero
        inside: 1-D fields of the edge columns and of the width-weighted
        means of neighbouring columns on the bottom, E for TE and H for TM,
        each normalised to 1 at the top (mt2DTE.jl:115-131)."""
        dy = self.dy
        mid = (sig[..., :-1] * dy[:-1] + sig[..., 1:] * dy[1:]) / (dy[:-1] + dy[1:])
        prof = torch.cat([sig[..., :1], mid, sig[..., -1:]], dim=-1).transpose(-1, -2)
        e, h = field_1d(self.omega.reshape(-1, 1, 1), prof[None], self.dz)
        f = torch.stack([e, h], dim=-3)                   # (nf, C, 2, ny+1, nz+1)
        f = (f / f[..., :1]).to(self.dtype)
        nz, ny = self.model.nz, self.model.ny
        bc = torch.zeros(f.shape[:-2] + (nz + 1, ny + 1), dtype=self.dtype,
                         device=self.device)
        bc[..., 0, :] = 1.0
        bc[..., 1:, 0] = f[..., 0, 1:]
        bc[..., 1:, ny] = f[..., ny, 1:]
        bc[..., nz, 1:ny] = f[..., 1:ny, nz]
        return bc

    def fields(self, sig: torch.Tensor) -> torch.Tensor:
        """Node fields (nf, C, 2, nz+1, ny+1): TE's E and TM's H."""
        cy, cz, mass = self.stencil(sig)
        om = self.omega.reshape(-1, 1, 1, 1, 1)
        bc = self.boundary(sig)
        d = (cy[..., 1:-1, :-1] + cy[..., 1:-1, 1:] + cz[..., :-1, 1:-1]
             + cz[..., 1:, 1:-1]) + 1j * om * mass[..., 1:-1, 1:-1]
        oy = (-cy[..., 1:-1, 1:-1]).to(self.dtype).expand(d.shape[:-1] + (-1,))
        oz = (-cz[..., 1:-1, 1:-1]).to(self.dtype).expand(d.shape[:-2] + (-1, -1))
        # -A_io bc: the interior rows of A applied to the ring values
        rhs = (cy[..., 1:-1, :-1] * bc[..., 1:-1, :-2] + cy[..., 1:-1, 1:] * bc[..., 1:-1, 2:]
               + cz[..., :-1, 1:-1] * bc[..., :-2, 1:-1] + cz[..., 1:, 1:-1] * bc[..., 2:, 1:-1])
        x = block_thomas(d.to(self.dtype), oy, oz, rhs.to(self.dtype))
        return bc + torch.nn.functional.pad(x, (1, 1, 1, 1))

    def _at_rx(self, f: torch.Tensor) -> torch.Tensor:
        w0, w1 = self.rx_w
        return w0 * f[..., self.rx_idx] + w1 * f[..., self.rx_idx + 1]

    def responses(self, sig: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """(C, nf * nrx * 2) impedances ZXY, ZYX (compFieldsAtRxTE/TM,
        mt2DTE.jl:153-210, mt2DTM.jl:152-210)."""
        dy = self.dy
        dz1 = self.dz[self.zid]
        s1 = sig[..., self.zid, :]
        iw = 1j * self.omega.reshape(-1, 1, 1)
        avl = 0.5 * (dy[:-1] + dy[1:])

        def pair_mean(x):
            return (x[..., :-1] * dy[:-1] + x[..., 1:] * dy[1:]) / (dy[:-1] + dy[1:])

        def pad_ends(x):
            return torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)

        E0, E1 = u[:, :, 0, self.zid], u[:, :, 0, self.zid + 1]
        hzq = (0.75 * torch.diff(E0) + 0.25 * torch.diff(E1)) / dy / iw / MU0
        hy = (-(E1[..., 1:-1] - E0[..., 1:-1]) / dz1 / (iw * MU0)
              - (torch.diff(hzq) / avl - pair_mean(s1) * (0.75 * E0[..., 1:-1] + 0.25 * E1[..., 1:-1]))
              * (0.5 * dz1))
        zxy = self._at_rx(E0) / self._at_rx(pad_ends(hy))

        H0, H1 = u[:, :, 1, self.zid], u[:, :, 1, self.zid + 1]
        ezq = -(0.75 * torch.diff(H0) + 0.25 * torch.diff(H1)) / dy / s1
        ey = ((H1[..., 1:-1] - H0[..., 1:-1]) / dz1 * pair_mean(1.0 / s1)
              - (torch.diff(ezq) / avl + iw * MU0 * (0.75 * H0[..., 1:-1] + 0.25 * H1[..., 1:-1]))
              * (0.5 * dz1))
        zyx = self._at_rx(pad_ends(ey)) / self._at_rx(H0)
        cube = torch.stack([zxy, zyx], dim=-1).transpose(0, 1)   # (C, nf, nrx, 2)
        return cube.reshape(cube.shape[0], -1)

    def predict(self, m: torch.Tensor) -> torch.Tensor:
        sig = self.sigma2d(m)
        return self.responses(sig, self.fields(sig))

    def model_norm(self, m: torch.Tensor, m_ref: torch.Tensor) -> torch.Tensor:
        """0.5 ||Gc (m - m_ref)||^2 over the whole cell grid, air cells 0:
        first differences between neighbouring cells in y and in z."""
        v = torch.zeros(m.shape[:-1] + (self.model.nz * self.model.ny,),
                        dtype=m.dtype, device=m.device)
        v[..., self.active] = m - m_ref
        v = v.reshape(m.shape[:-1] + (self.model.nz, self.model.ny))
        return 0.5 * ((torch.diff(v, dim=-1) ** 2).sum((-2, -1))
                      + (torch.diff(v, dim=-2) ** 2).sum((-2, -1)))

    def potential(self, m: torch.Tensor, m_ref: torch.Tensor):
        """(U, misfit, mnorm, pred), U = 0.5 ||W (pred - obs)||^2 (real and
        imaginary parts) + reg * 0.5 ||Gc (m - m_ref)||^2, per chain."""
        pred = self.predict(m)
        res = self.weights * (pred - self.obs)
        misfit = 0.5 * (res.real ** 2 + res.imag ** 2).sum(-1)
        mnorm = self.reg * self.model_norm(m, m_ref)
        return misfit + mnorm, misfit, mnorm, pred

    def value_and_grad(self, m: torch.Tensor, m_ref: torch.Tensor):
        """(U, misfit, mnorm, pred, dU/dm), all detached."""
        m = m.detach().to(self.rdt).requires_grad_(True)
        with torch.enable_grad():
            U, misfit, mnorm, pred = self.potential(m, m_ref.to(self.rdt))
            (g,) = torch.autograd.grad(U.sum(), m)
        return U.detach(), misfit.detach(), mnorm.detach(), pred.detach(), g

    def gn_product(self, m: torch.Tensor, V: torch.Tensor):
        """(J'W^2J + reg Wm) V for the rows of V (K, P) at the model m (P,):
        J V by forward-mode differentiation of the prediction and J'(W^2 J
        V) by one reverse pass.  Rows of J are the real and imaginary parts
        of each datum."""
        V = V.to(self.rdt)
        x = m.detach().to(self.rdt).expand(V.shape[0], -1).contiguous()
        _, JV = torch.func.jvp(self.predict, (x,), (V,))
        c = (self.weights ** 2) * JV.detach()
        x = x.clone().requires_grad_(True)
        with torch.enable_grad():
            pred = self.predict(x)
            s = (c.real * pred.real + c.imag * pred.imag).sum()
            (jt,) = torch.autograd.grad(s, x)
            v = V.detach().clone().requires_grad_(True)
            (wm,) = torch.autograd.grad(self.model_norm(v, torch.zeros_like(v)).sum(), v)
        return jt + self.reg * wm
