"""1-D layered-earth magnetotelluric analytic fields, batched.

PyTorch counterpart of ``hmcmt2d_tpu/ops/mt1d.py`` (the reference's
mt1DField.jl): surface impedance by the bottom-up tanh recurrence, then
top-down propagation of up/down-going amplitudes with the reference's
overflow guard (zero every interface at and below the first one where |E|
grows) kept as a carried boolean mask.  Profiles are ``(..., n_layer)`` and
every function broadcasts over leading axes.  Time dependence e^{+i omega t}.
"""

from __future__ import annotations

import torch

from ..constants import EPS0, MU0
from .solver import REAL_DTYPE

# Real-exponent clamp for exp(): keeps the forward value finite so the
# overflow mask, not an Inf/NaN, zeroes the deep interfaces.
_EXP_CLAMP = 60.0

# |Re| clamp for the safe complex tanh: tanh(20) == 1 in float32.
_TANH_CLAMP = 20.0


def safe_tanh(z: torch.Tensor) -> torch.Tensor:
    """Overflow-safe complex tanh:
    tanh(x+iy) = (sinh(2x)/2 + i sin(2y)/2) / (sinh(x)^2 + cos(y)^2) with x
    clamped to +-20, where tanh is +-1 to float32 precision anyway."""
    x = torch.clamp(z.real, -_TANH_CLAMP, _TANH_CLAMP)
    y = z.imag
    den = torch.sinh(x) ** 2 + torch.cos(y) ** 2
    return torch.complex(0.5 * torch.sinh(2.0 * x) / den,
                         0.5 * torch.sin(2.0 * y) / den)


def wavenumber(omega, sigma):
    """k = sqrt(mu0 eps0 omega^2 - i mu0 sigma omega), principal root."""
    return torch.sqrt(MU0 * EPS0 * omega ** 2 - 1j * MU0 * sigma * omega)


def surface_impedance(omega, sigma, dz):
    """Surface impedance by the bottom-up recurrence (mt1DField.jl:48-56);
    ``sigma`` and ``dz`` are (..., n), the bottom layer extended as a
    halfspace."""
    k = wavenumber(omega, sigma)
    zp = omega * MU0 / k
    th = safe_tanh(1j * k * dz)
    zp, th = torch.broadcast_tensors(zp, th)
    z = zp[..., -1]
    for j in range(zp.shape[-1] - 1, -1, -1):
        zp_j, th_j = zp[..., j], th[..., j]
        z = zp_j * (z + zp_j * th_j) / (zp_j + z * th_j)
    return z


def _clamped_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a complex number with the real part clamped against Inf."""
    re = torch.clamp(x.real, -_EXP_CLAMP, _EXP_CLAMP)
    mag = torch.exp(re)
    return torch.complex(mag * torch.cos(x.imag), mag * torch.sin(x.imag))


def analytic_field(omega, sigma, dz, with_h: bool = False, dtype=None):
    """E (and optionally H) at every interface, top value E = 1
    (mt1DAnalyticField, mt1DField.jl:23-98).

    ``sigma``, ``dz``: (..., n) layer conductivities and thicknesses;
    ``omega`` broadcasts against them and may carry a trailing singleton in
    place of the layer axis.  ``dtype`` (complex) sets the working
    precision.  Returns e (..., n+1) and, with ``with_h``, h (..., n+1).
    """
    omega = torch.as_tensor(omega)
    if dtype is not None:
        rdt = REAL_DTYPE[dtype]
        omega, sigma, dz = omega.to(rdt), sigma.to(rdt), dz.to(rdt)
    omega_i = omega[..., 0] if (omega.ndim > 0 and omega.shape[-1] == 1) else omega
    omu0 = omega_i * MU0

    z0 = surface_impedance(omega, sigma, dz)
    k = wavenumber(omega, sigma)
    ka = torch.cat([k, k[..., -1:]], dim=-1)          # halfspace appended

    k_top = ka[..., 0]
    e_up = 0.5 * (1.0 - omu0 / (z0 * k_top))
    e_dn = 0.5 * (1.0 + omu0 / (z0 * k_top))
    n = k.shape[-1]
    shape = torch.broadcast_shapes(e_up.shape, k.shape[:-1], dz.shape[:-1])
    e_up, e_dn = e_up.expand(shape), e_dn.expand(shape)
    alive = torch.ones(shape, dtype=torch.bool, device=k.device)
    ups, dns = [e_up], [e_dn]
    for i in range(n):
        k_i, k_ip1, dz_i = ka[..., i], ka[..., i + 1], dz[..., i]
        kr = k_i / k_ip1
        u = _clamped_exp(1j * k_i * dz_i) * e_up
        d = _clamped_exp(-1j * k_i * dz_i) * e_dn
        e_up_n = 0.5 * ((1 + kr) * u + (1 - kr) * d)
        e_dn_n = 0.5 * ((1 - kr) * u + (1 + kr) * d)
        with torch.no_grad():
            e_prev = torch.abs(e_up + e_dn)
            e_new = torch.abs(e_up_n + e_dn_n)
            alive = alive & ~((e_new - e_prev > 0) | torch.isnan(e_new))
        zero = torch.zeros((), dtype=e_up_n.dtype, device=e_up_n.device)
        e_up = torch.where(alive, e_up_n, zero)
        e_dn = torch.where(alive, e_dn_n, zero)
        ups.append(e_up)
        dns.append(e_dn)
    e_up = torch.stack(ups, dim=-1)                   # (..., n+1)
    e_dn = torch.stack(dns, dim=-1)
    e = e_up + e_dn
    if not with_h:
        return e
    h = (-ka * e_up + ka * e_dn) / omu0[..., None]
    return e, h
