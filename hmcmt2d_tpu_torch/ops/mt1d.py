"""1-D layered-earth magnetotelluric analytic fields, batched.

PyTorch counterpart of ``hmcmt2d_tpu/ops/mt1d.py`` (the reference's
mt1DField.jl): surface impedance by the bottom-up tanh recurrence, then
top-down propagation of up/down-going amplitudes with the reference's
overflow guard (zero every interface at and below the first one where |E|
grows) kept as a carried boolean mask.  Profiles are ``(..., n_layer)`` and
every function broadcasts over leading axes.  Time dependence e^{+i omega t}.

On the CPU :func:`analytic_field` runs the layer loop below in PyTorch (the
plain version), differentiated by autograd.  On a CUDA tensor it runs the
hand-written kernels of ``csrc/mt1d_field.cu`` (built by
:mod:`.kernel_build`) inside :class:`_AnalyticField`, one thread a column (a
frequency x profile pair): one launch for the forward, one for the
reverse-mode product, one for a forward-mode tangent.  The JAX package runs
the same recursion as a ``lax.scan``; as torch ops it was ~50 elementwise
kernels a layer, forward and backward.  Beside the kernels, on columns
(omega (N,), sigma (N, n), dz (n,) or (N, n)): :func:`field_plain`,
:func:`field_tangent_plain` and :func:`field_vjp_plain`, the plain versions
of the three launches (the derivatives derived by hand, in the kernels'
steps), which the CPU tests hold against autograd and ``torch.func.jvp`` of
the plain forward and the card tests hold the kernels against.  Launches
count in ``mt1d_field.launches`` (the tangent variant included) and
``mt1d_field_vjp.launches``, registered with ``fused_factor.launches()``.
"""

from __future__ import annotations

import torch

from ..constants import EPS0, MU0
from . import fused_factor as FF
from . import kernel_build
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


def _propagate(omega, sigma, dz, with_h: bool):
    """The plain layer loop: e (..., n+1), h (or None) and the count of
    live interfaces (the kernels' ``cut``), (...,) int32."""
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
    ups, dns, alives = [e_up], [e_dn], [alive]
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
        alives.append(alive)
    e_up = torch.stack(ups, dim=-1)                   # (..., n+1)
    e_dn = torch.stack(dns, dim=-1)
    e = e_up + e_dn
    h = (-ka * e_up + ka * e_dn) / omu0[..., None] if with_h else None
    return e, h, torch.stack(alives, dim=-1).sum(-1, dtype=torch.int32)


def analytic_field(omega, sigma, dz, with_h: bool = False, dtype=None):
    """E (and optionally H) at every interface, top value E = 1
    (mt1DAnalyticField, mt1DField.jl:23-98).

    ``sigma``, ``dz``: (..., n) layer conductivities and thicknesses;
    ``omega`` broadcasts against them and may carry a trailing singleton in
    place of the layer axis.  ``dtype`` (complex) sets the working
    precision.  Returns e (..., n+1) and, with ``with_h``, h (..., n+1).
    Differentiable with respect to ``sigma``; on a CUDA tensor the kernels
    serve it (:class:`_AnalyticField`), which raise for an ``omega`` or a
    ``dz`` that requires grad.
    """
    omega = torch.as_tensor(omega, device=sigma.device)
    if dtype is not None:
        rdt = REAL_DTYPE[dtype]
        omega, sigma, dz = omega.to(rdt), sigma.to(rdt), dz.to(rdt)
    if FF._on_cpu(sigma):
        e, h, _ = _propagate(omega, sigma, dz, with_h)
    else:
        e, h = _on_card(omega, sigma, dz)
    return (e, h) if with_h else e


def _on_card(omega, sigma, dz):
    """analytic_field's e and h from the kernels: the broadcast batch
    collapsed to N columns."""
    if omega.requires_grad or dz.requires_grad:
        raise ValueError("the mt1d kernels differentiate with respect to sigma only: "
                         "omega and dz must not require grad")
    if omega.ndim > 0 and omega.shape[-1] != 1:
        raise ValueError("omega broadcasts against the layer axis with a trailing "
                         f"singleton, got shape {tuple(omega.shape)}")
    rdt = torch.promote_types(sigma.dtype, dz.dtype)
    omega_i = omega[..., 0] if omega.ndim > 0 else omega
    n = sigma.shape[-1]
    if dz.shape[-1] != n:
        raise ValueError(f"dz has {dz.shape[-1]} layers, sigma {n}")
    batch = torch.broadcast_shapes(omega_i.shape, sigma.shape[:-1], dz.shape[:-1])
    om = omega_i.to(rdt).expand(batch).reshape(-1).contiguous()
    sg = sigma.to(rdt).expand(batch + (n,)).reshape(-1, n).contiguous()
    dzc = dz.to(rdt)
    dzc = (dzc if dz.ndim == 1 else dzc.expand(batch + (n,)).reshape(-1, n)).contiguous()
    e, h, _ = _AnalyticField.apply(om, sg, dzc)
    return e.reshape(batch + (n + 1,)), h.reshape(batch + (n + 1,))


class _AnalyticField(torch.autograd.Function):
    """e, h and cut of N columns (omega (N,), sigma (N, n), dz (n,) or
    (N, n)), differentiable with respect to sigma: backward is one launch
    of the vjp kernel, forward mode (``jvp``, for ``torch.func.jvp``) one
    launch of the forward kernel's tangent variant, both under the
    forward's cut."""

    @staticmethod
    def forward(omega, sigma, dz):
        return mt1d_field(omega, sigma, dz)

    @staticmethod
    def setup_context(ctx, inputs, output):
        omega, sigma, dz = inputs
        cut = output[2]
        ctx.mark_non_differentiable(cut)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(omega, sigma, dz, cut)
        ctx.save_for_forward(omega, sigma, dz, cut)

    @staticmethod
    def backward(ctx, ge, gh, _gcut):
        if ge is None and gh is None:
            return None, None, None
        omega, sigma, dz, cut = ctx.saved_tensors
        return None, mt1d_field_vjp(omega, sigma, dz, cut, ge, gh), None

    @staticmethod
    def jvp(ctx, d_omega, d_sigma, d_dz):
        if d_omega is not None or d_dz is not None:
            raise ValueError("the mt1d kernels differentiate with respect to sigma only")
        omega, sigma, dz, cut = ctx.saved_tensors
        de, dh = mt1d_field_tangent(omega, sigma, dz, cut, d_sigma)
        return de, dh, None


# ---------------------------------------------------------------------------
# the kernels (csrc/mt1d_field.cu) and their plain versions, on columns
# ---------------------------------------------------------------------------

MT1D_THREADS = 32   # a warp a block: csrc/mt1d_field.cu THREADS
MT1D_DTYPES = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def work_rows(n: int) -> int:
    """Rows of the vjp kernel's scratch (each N complex): Z_1..Z_n,
    U_0..U_n, D_0..D_n."""
    return 3 * n + 2


def _columns(omega, sigma, dz):
    """Check columns for a launch: omega (N,), sigma (N, n) float32 or
    float64, dz (n,) or (N, n), contiguous, on one CUDA device; returns
    (N, n, complex dtype, dz_batched)."""
    if sigma.ndim != 2:
        raise ValueError(f"sigma must be (N, n), got {tuple(sigma.shape)}")
    N, n = sigma.shape
    rdt = sigma.dtype
    if rdt not in MT1D_DTYPES:
        raise ValueError(f"the mt1d kernels take float32 or float64, got {rdt}")
    if n < 1:
        raise ValueError("a profile needs at least one layer")
    dev = sigma.device
    FF._check(sigma, "sigma", rdt, (N, n), dev)
    FF._check(omega, "omega", rdt, (N,), dev)
    FF._check(dz, "dz", rdt, (n,) if dz.ndim == 1 else (N, n), dev)
    return N, n, MT1D_DTYPES[rdt], int(dz.ndim == 2)


def _operand(g: torch.Tensor | None, shape, dtype, device):
    """A cotangent as the kernel reads it (or None): contiguous, no lazy
    conjugate or negation."""
    if g is None:
        return None
    g = g.resolve_conj().resolve_neg().contiguous()
    FF._check(g, "cotangent", dtype, shape, device)
    return g


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@FF.beneath_transforms
def mt1d_field(omega, sigma, dz):
    """e (N, n+1), h (N, n+1) and cut (N,) int32 of N columns: one launch
    of the forward kernel (:func:`field_plain` is its plain version)."""
    N, n, cdt, batched = _columns(omega, sigma, dz)
    dev = sigma.device
    e = torch.empty((N, n + 1), dtype=cdt, device=dev)
    h = torch.empty((N, n + 1), dtype=cdt, device=dev)
    cut = torch.empty((N,), dtype=torch.int32, device=dev)
    lib = kernel_build.library()
    err = lib.hmc_mt1d_field(omega.data_ptr(), sigma.data_ptr(), dz.data_ptr(), None,
                             cut.data_ptr(), e.data_ptr(), h.data_ptr(), N, n, batched,
                             MT1D_THREADS, int(cdt == torch.complex128), FF._stream())
    FF._raise_on(err, "mt1d_field")
    mt1d_field.launches += 1
    return e, h, cut


@FF.beneath_transforms
def mt1d_field_tangent(omega, sigma, dz, cut, dsigma):
    """Forward-mode tangents de, dh (N, n+1) along dsigma (N, n), under the
    forward's cut: one launch of the forward kernel's tangent variant,
    counted in ``mt1d_field.launches`` (:func:`field_tangent_plain` is its
    plain version)."""
    N, n, cdt, batched = _columns(omega, sigma, dz)
    dev = sigma.device
    FF._check(cut, "cut", torch.int32, (N,), dev)
    dsigma = _operand(dsigma, (N, n), sigma.dtype, dev)
    de = torch.empty((N, n + 1), dtype=cdt, device=dev)
    dh = torch.empty((N, n + 1), dtype=cdt, device=dev)
    lib = kernel_build.library()
    err = lib.hmc_mt1d_field(omega.data_ptr(), sigma.data_ptr(), dz.data_ptr(),
                             dsigma.data_ptr(), cut.data_ptr(), de.data_ptr(), dh.data_ptr(),
                             N, n, batched, MT1D_THREADS, int(cdt == torch.complex128),
                             FF._stream())
    FF._raise_on(err, "mt1d_field (tangent)")
    mt1d_field.launches += 1
    return de, dh


@FF.beneath_transforms
def mt1d_field_vjp(omega, sigma, dz, cut, ge, gh):
    """d/dsigma of Re(<ge, e> + <gh, h>) (N, n) under the forward's cut
    (PyTorch's convention for a real input: the cotangents are the complex
    outputs' grads; either may be None): one launch of the vjp kernel
    (:func:`field_vjp_plain` is its plain version)."""
    N, n, cdt, batched = _columns(omega, sigma, dz)
    dev = sigma.device
    FF._check(cut, "cut", torch.int32, (N,), dev)
    ge = _operand(ge, (N, n + 1), cdt, dev)
    gh = _operand(gh, (N, n + 1), cdt, dev)
    work = torch.empty((work_rows(n), N), dtype=cdt, device=dev)
    gsigma = torch.empty((N, n), dtype=sigma.dtype, device=dev)
    lib = kernel_build.library()
    err = lib.hmc_mt1d_vjp(omega.data_ptr(), sigma.data_ptr(), dz.data_ptr(), cut.data_ptr(),
                           _ptr(ge), _ptr(gh), work.data_ptr(), gsigma.data_ptr(), N, n,
                           batched, MT1D_THREADS, int(cdt == torch.complex128), FF._stream())
    FF._raise_on(err, "mt1d_field_vjp")
    mt1d_field_vjp.launches += 1
    return gsigma


mt1d_field.launches = 0
mt1d_field_vjp.launches = 0
FF.register(mt1d_field)
FF.register(mt1d_field_vjp)


def field_plain(omega, sigma, dz):
    """Plain version of the forward kernel: e, h (N, n+1) and cut (N,)
    int32 of N columns, by the layer loop of :func:`analytic_field`."""
    return _propagate(omega[:, None], sigma, dz, True)


def _layers(omega, sigma, dz):
    """Each layer's k, zp = omega mu0 / k, the tanh's argument i k dz and
    the tanh, (N, n) each."""
    om = omega[:, None]
    k = wavenumber(om, sigma)
    zp = om * MU0 / k
    arg = 1j * k * dz
    return k, zp, arg, safe_tanh(arg)


def _passes(x: torch.Tensor, clamp: float) -> torch.Tensor:
    """Where torch.clamp(x, -clamp, clamp) passes a derivative."""
    return (x >= -clamp) & (x <= clamp)


def _sech2(z: torch.Tensor) -> torch.Tensor:
    """sech^2 at safe_tanh's clamped point, as (conj(cosh z) / |cosh z|^2)^2
    (|cosh z|^2 is safe_tanh's denominator): tanh's derivative without the
    cancellation of 1 - tanh^2."""
    x = torch.clamp(z.real, -_TANH_CLAMP, _TANH_CLAMP)
    y = z.imag
    den = torch.sinh(x) ** 2 + torch.cos(y) ** 2
    s = torch.complex(torch.cosh(x) * torch.cos(y) / den, -(torch.sinh(x) * torch.sin(y)) / den)
    return s * s


def _arg_tangent(t, x, clamp):
    """A tangent through a clamped function's argument: its real part
    stopped where the clamp engaged."""
    return torch.complex(torch.where(_passes(x, clamp), t.real, 0.0), t.imag)


def _arg_adjoint(c, x, clamp):
    """A clamped function's argument's adjoint from c = conj(adjoint) f':
    conj(c), with its real part stopped where the clamp engaged."""
    return torch.complex(torch.where(_passes(x, clamp), c.real, 0.0), -c.imag)


def _amplitudes(omega, sigma, dz, cut):
    """The forward under ``cut``: k, zp, the tanh's argument, th, ka (with
    the halfspace), Z_0..Z_n, and U, D at every interface (zero below the
    cut), in the kernels' steps."""
    k, zp, arg, th = _layers(omega, sigma, dz)
    n = sigma.shape[-1]
    ka = torch.cat([k, k[:, -1:]], dim=-1)
    Z = [None] * n + [zp[:, -1]]
    for j in range(n - 1, -1, -1):
        z = Z[j + 1]
        Z[j] = zp[:, j] * (z + zp[:, j] * th[:, j]) / (zp[:, j] + z * th[:, j])
    q = omega * MU0 / (Z[0] * ka[:, 0])
    U, D = [0.5 * (1.0 - q)], [0.5 * (1.0 + q)]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for i in range(n):
        dz_i = dz[..., i]
        kr = ka[:, i] / ka[:, i + 1]
        u = _clamped_exp(1j * k[:, i] * dz_i) * U[i]
        d = _clamped_exp(-1j * k[:, i] * dz_i) * D[i]
        alive = i + 1 < cut
        U.append(torch.where(alive, 0.5 * ((1 + kr) * u + (1 - kr) * d), zero))
        D.append(torch.where(alive, 0.5 * ((1 - kr) * u + (1 + kr) * d), zero))
    return k, zp, arg, th, ka, Z, U, D


def field_tangent_plain(omega, sigma, dz, cut, dsigma):
    """Plain version of the forward kernel's tangent variant: de, dh
    (N, n+1) along dsigma (N, n), dual numbers through the forward's steps
    under its cut (the mask a constant, a clamped real part passing no
    tangent)."""
    k, zp, arg, th, ka, Z, U, D = _amplitudes(omega, sigma, dz, cut)
    n = sigma.shape[-1]
    om = omega[:, None]
    omu0 = omega * MU0
    dk = torch.complex(torch.zeros_like(dsigma), -(MU0 * dsigma) * om) / (2 * k)
    dzp = -(zp * dk) / k
    dth = _sech2(arg) * _arg_tangent(1j * dk * dz, arg.real, _TANH_CLAMP)
    dZ = dzp[:, -1]
    for j in range(n - 1, -1, -1):
        z, p, t = Z[j + 1], zp[:, j], th[:, j]
        s = z + p * t
        dsum = dZ + dzp[:, j] * t + p * dth[:, j]
        dnum = dzp[:, j] * s + p * dsum
        dden = dzp[:, j] + dZ * t + z * dth[:, j]
        dZ = (dnum - Z[j] * dden) / (p + z * t)
    dka = torch.cat([dk, dk[:, -1:]], dim=-1)
    b = Z[0] * ka[:, 0]
    dq = -((omu0 / b) * (dZ * ka[:, 0] + Z[0] * dka[:, 0])) / b
    dU, dD = -0.5 * dq, 0.5 * dq
    zero = torch.zeros((), dtype=dq.dtype, device=dq.device)
    des, dhs = [], []
    for i in range(n + 1):
        des.append(dU + dD)
        dhs.append((dka[:, i] * (D[i] - U[i]) + ka[:, i] * (dD - dU)) / omu0)
        if i == n:
            break
        dz_i = dz[..., i]
        kr = ka[:, i] / ka[:, i + 1]
        dkr = (dka[:, i] - kr * dka[:, i + 1]) / ka[:, i + 1]
        wp, wm = 1j * k[:, i] * dz_i, -1j * k[:, i] * dz_i
        P, M = _clamped_exp(wp), _clamped_exp(wm)
        dP = P * _arg_tangent(1j * dk[:, i] * dz_i, wp.real, _EXP_CLAMP)
        dM = M * _arg_tangent(-1j * dk[:, i] * dz_i, wm.real, _EXP_CLAMP)
        u, d = P * U[i], M * D[i]
        du, dd = dP * U[i] + P * dU, dM * D[i] + M * dD
        skew = dkr * (u - d)
        alive = i + 1 < cut
        dU = torch.where(alive, 0.5 * ((1 + kr) * du + (1 - kr) * dd + skew), zero)
        dD = torch.where(alive, 0.5 * ((1 - kr) * du + (1 + kr) * dd - skew), zero)
    return torch.stack(des, dim=-1), torch.stack(dhs, dim=-1)


def field_vjp_plain(omega, sigma, dz, cut, ge, gh):
    """Plain version of the vjp kernel: d/dsigma of Re(<ge, e> + <gh, h>)
    (N, n), the forward's steps run backwards under its cut, each step's
    adjoint as PyTorch's autograd forms it (conjugate Wirtinger; the mask a
    constant, a clamped real part passing nothing).  ``ge`` or ``gh`` may
    be None."""
    k, zp, arg, th, ka, Z, U, D = _amplitudes(omega, sigma, dz, cut)
    n = sigma.shape[-1]
    omu0 = omega * MU0
    zero = torch.zeros((), dtype=ka.dtype, device=ka.device)

    def iface(i):
        g = ge[:, i] if ge is not None else zero
        gt = gh[:, i] / omu0 if gh is not None else zero
        t = gt * ka[:, i].conj()
        return g - t, g + t, gt * (D[i] - U[i]).conj()

    kbar = [None] * n
    Ubn, Dbn, kbn = iface(n)
    for i in range(n - 1, -1, -1):
        Ub, Db, kb = iface(i)
        dz_i = dz[..., i]
        alive = i + 1 < cut
        a = torch.where(alive, 0.5 * Ubn, zero)
        bb = torch.where(alive, 0.5 * Dbn, zero)
        kr = ka[:, i] / ka[:, i + 1]
        wp, wm = 1j * k[:, i] * dz_i, -1j * k[:, i] * dz_i
        P, M = _clamped_exp(wp), _clamped_exp(wm)
        ub = a * (1 + kr).conj() + bb * (1 - kr).conj()
        db = a * (1 - kr).conj() + bb * (1 + kr).conj()
        krb = torch.where(alive, (a - bb) * (P * U[i] - M * D[i]).conj(), zero)
        Ub = Ub + ub * P.conj()
        Db = Db + db * M.conj()
        t = krb / ka[:, i + 1].conj()
        kb = kb + t
        kbn = kbn - t * kr.conj()
        kb = kb + _arg_adjoint((ub * U[i].conj()).conj() * P, wp.real, _EXP_CLAMP) * (-1j * dz_i)
        kb = kb + _arg_adjoint((db * D[i].conj()).conj() * M, wm.real, _EXP_CLAMP) * (1j * dz_i)
        if i + 1 == n:
            kb = kb + kbn
        else:
            kbar[i + 1] = kbn
        Ubn, Dbn, kbn = Ub, Db, kb
    q = omu0 / (Z[0] * ka[:, 0])
    bbar = -(0.5 * Dbn - 0.5 * Ubn) * (q / (Z[0] * ka[:, 0])).conj()
    Zb = bbar * ka[:, 0].conj()
    kbar[0] = kbn + bbar * Z[0].conj()
    grads = []
    for j in range(n):
        A, p, t, dz_j = Z[j + 1], zp[:, j], th[:, j], dz[..., j]
        s = A + p * t
        den = p + A * t
        numb = Zb / den.conj()
        denb = -Zb * (Z[j] / den).conj()
        zpb = numb * s.conj() + numb * p.conj() * t.conj() + denb
        Ab = numb * p.conj() + denb * t.conj()
        thb = numb * p.conj() * p.conj() + denb * A.conj()
        if j == n - 1:
            zpb = zpb + Ab
        kb = _arg_adjoint(thb.conj() * _sech2(arg[:, j]), arg[:, j].real, _TANH_CLAMP) * (-1j * dz_j)
        kb = kb - zpb * (p / k[:, j]).conj() + kbar[j]
        sqb = kb / (2 * k[:, j].conj())
        grads.append(-(MU0 * omega) * sqb.imag)
        Zb = Ab
    return torch.stack(grads, dim=-1)
