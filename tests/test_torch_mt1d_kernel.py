"""The boundary fields' kernels' plain versions (``ops/mt1d.py``) on the CPU.

The hand-derived adjoint (``field_vjp_plain``) is held against
``torch.autograd.grad`` of the plain forward, and ``_AnalyticField``'s
forward mode (``field_tangent_plain`` on the CPU) against ``torch.func.jvp``
of it: at n = 56 (the flagship's 7 air + 49 earth layers) and n = 52
(coprod2's 7 + 45), in complex128 and complex64, on profiles where the deep
tail is masked and where both clamps engage.

In complex128 the three agree to rounding.  In complex64 the propagation's
up/down split is ill-conditioned below the first strong contrasts (U and D
grow while E = U + D decays), so autograd's and the plain derivatives both
stray from the complex128 truth by up to a few percent of a column's largest
entry: there the plain version is held to be no less accurate than autograd
against that truth.  Cotangents weigh the interfaces whose |E| and |H| lie
above FLOOR of the column's largest (the deep tail is rounding noise).
"""

import numpy as np
import pytest
import torch

from hmcmt2d_tpu_torch.ops import fused_factor as FF
from hmcmt2d_tpu_torch.ops import mt1d as TD

torch.set_num_threads(1)

FREQS = (1e2, 1.0, 1e-2)
AIR = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])
N_AIR = len(AIR)
FLOOR = {torch.float64: 1e-5, torch.float32: 1e-3}
EXACT = 1e-7   # complex128: the plain derivatives against autograd


def profiles(n: int, kind: str, ncol: int = 4, seed: int = 0):
    """Columns (omega (N,), sigma (N, n), dz (n,)), float64 numpy, N =
    len(FREQS) x ncol: 7 air layers over n - 7 earth layers graded as the
    flagship's (100 m, then doubling), frequencies 1e2, 1 and 1e-2 Hz.
    ``kind``: "mild" (earth 0.005..0.02 S/m, the flagship's start), "wide"
    (1e-4..10 S/m, coprod2's bounds), "clamps" (a 0.01 S/m earth with a very
    resistive 1e-4 S/m layer and a very conductive 10 S/m one, 1 km thick,
    under which the exponent's clamp engages at 1e2 Hz, and the deep
    padding layers clamp the tanh)."""
    rng = np.random.default_rng(seed)
    n_earth = n - N_AIR
    n_fine = n_earth - 9
    dz = np.concatenate([AIR[::-1], np.full(n_fine, 100.0), 100.0 * 2.0 ** np.arange(1, 10)])
    if kind == "mild":
        sig = np.exp(rng.uniform(np.log(0.005), np.log(0.02), (ncol, n)))
    elif kind == "wide":
        sig = np.exp(rng.uniform(np.log(1e-4), np.log(10.0), (ncol, n)))
    else:
        sig = np.full((ncol, n), 0.01) * np.exp(0.1 * rng.standard_normal((ncol, n)))
        sig[:, N_AIR + 3] = 1e-4
        sig[:, N_AIR + 6] = 10.0
        dz[N_AIR + 6] = 1000.0
    sig[:, :N_AIR] = 1e-8
    om = 2 * np.pi * np.asarray(FREQS)
    return np.repeat(om, ncol), np.tile(sig, (len(FREQS), 1)), dz


def _tensors(case, dtype):
    return tuple(torch.as_tensor(a, dtype=dtype) for a in case)


def cotangents(e, h, floor, seed=1):
    """Random cotangents of e and h on the interfaces above ``floor`` of the
    column's largest |e| and |h|, h's scaled by 1 / max |h|."""
    rng = np.random.default_rng(seed)
    ea, ha = e.abs(), h.abs()
    keep = (ea > floor * ea.max(1, keepdim=True).values) & \
        (ha > floor * ha.max(1, keepdim=True).values)

    def draw():
        return torch.as_tensor(rng.standard_normal(e.shape) + 1j * rng.standard_normal(e.shape))

    ge = torch.where(keep, draw(), 0.0)
    gh = torch.where(keep, draw(), 0.0) / ha.max(1, keepdim=True).values
    return ge.to(e.dtype), gh.to(e.dtype), keep


def column_err(got, want, cols=slice(None)):
    """Largest |got - want| of each column over that column's largest |want|,
    the worst column."""
    d = (got - want)[:, cols].abs().max(1).values
    return float((d / want[:, cols].abs().max(1).values).max())


def autograd_vjp(om, sg, dz, ge, gh):
    s = sg.clone().requires_grad_(True)
    e, h, _ = TD.field_plain(om, s, dz)
    loss = (torch.real(ge.conj() * e) + torch.real(gh.conj() * h)).sum()
    return torch.autograd.grad(loss, s)[0]


def _derivatives(case, dtype, floor):
    """(plain vjp, autograd vjp, plain jvp (e, h), func.jvp (e, h)) at the
    case in ``dtype``, with the complex128 cotangents' support, and the
    tangent drawn on the earth layers (air is frozen in an inversion)."""
    om, sg, dz = _tensors(case, torch.float64)
    e, h, _ = TD.field_plain(om, sg, dz)
    ge, gh, keep = cotangents(e, h, floor)
    ds = torch.as_tensor(np.random.default_rng(2).standard_normal(sg.shape)) * sg
    ds[:, :N_AIR] = 0
    om, sg, dz = _tensors(case, dtype)
    _, _, cut = TD.field_plain(om, sg, dz)
    cdt = TD.MT1D_DTYPES[dtype]
    ge, gh, ds = ge.to(cdt), gh.to(cdt), ds.to(dtype)
    vjp = TD.field_vjp_plain(om, sg, dz, cut, ge, gh)
    ref = autograd_vjp(om, sg, dz, ge, gh)
    tan = TD.field_tangent_plain(om, sg, dz, cut, ds)
    _, tref = torch.func.jvp(lambda x: TD.field_plain(om, x, dz)[:2], (sg,), (ds,))
    return vjp, ref, tan, tref, keep


CASES = [(56, "mild"), (56, "clamps"), (52, "mild"), (52, "wide"), (52, "clamps")]


@pytest.mark.parametrize("n,kind", CASES)
def test_clamps_and_mask_engage(n, kind):
    """The cases reach what they are meant to: every case masks a deep
    tail; the clamps cases clamp the tanh of the impedance recurrence (which
    no mask hides) and the exponent of a propagation step.  That step is
    always masked: an exponent past 60 grows the rounding of U past E by
    e^60, so the guard cuts there (the adjoint's clamp branch is held to
    autograd in test_clamp_derivatives_match_autograd)."""
    om, sg, dz = _tensors(profiles(n, kind), torch.float64)
    _, _, cut = TD.field_plain(om, sg, dz)
    assert bool((cut < n + 1).any())
    if kind == "clamps":
        k, _, arg, _ = TD._layers(om, sg, dz)
        assert bool((arg.real.abs() > TD._TANH_CLAMP).any())
        x = (1j * k * dz).real
        assert bool(((x.abs() > TD._EXP_CLAMP) & (torch.arange(n)[None] < cut[:, None])).any())


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64], ids=["c128", "c64"])
def test_clamp_derivatives_match_autograd(dtype):
    """The clamps' derivative rules of the adjoint and the tangent
    (``_arg_adjoint``, ``_arg_tangent``, ``_sech2``) in ``dtype`` against
    autograd and torch.func.jvp of ``_clamped_exp`` and ``safe_tanh`` in
    complex128 (autograd's own complex64 derivative of safe_tanh cancels
    near the clamp), on arguments on both sides of each clamp and at it."""
    rng = np.random.default_rng(3)
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    for fn, clamp, deriv in ((TD._clamped_exp, TD._EXP_CLAMP, TD._clamped_exp),
                             (TD.safe_tanh, TD._TANH_CLAMP, TD._sech2)):
        re = np.concatenate([rng.uniform(-1.25 * clamp, 1.25 * clamp, 40), [clamp, -clamp]])
        w = torch.as_tensor(re + 1j * rng.uniform(-4, 4, re.size))
        g, t = (torch.as_tensor(rng.standard_normal(w.shape) + 1j * rng.standard_normal(w.shape))
                for _ in range(2))
        x = w.clone().requires_grad_(True)
        (ref,) = torch.autograd.grad(torch.real(g.conj() * fn(x)).sum(), x)
        _, tref = torch.func.jvp(fn, (w,), (t,))
        w, g, t = (a.to(dtype) for a in (w, g, t))
        got = TD._arg_adjoint(g.conj() * deriv(w), w.real, clamp)
        tgot = deriv(w) * TD._arg_tangent(t, w.real, clamp)
        assert float((got - ref).abs().max() / ref.abs().max()) < tol
        assert float((tgot - tref).abs().max() / tref.abs().max()) < tol
        clamped = ~TD._passes(w.real, clamp)
        assert bool(clamped.any()) and bool((got.real[clamped] == 0).all())


@pytest.mark.parametrize("n,kind", CASES)
def test_plain_adjoint_matches_autograd_complex128(n, kind):
    """The hand-derived adjoint and tangent against autograd and
    torch.func.jvp of the plain forward, complex128, on the earth layers
    (the gradient's air entries, frozen in an inversion, span 15 more
    decades): to rounding, as the up/down split amplifies it (~1e8 at the
    wide profile's contrasts)."""
    vjp, ref, (de, dh), (te, th), keep = _derivatives(profiles(n, kind), torch.float64,
                                                     FLOOR[torch.float64])
    assert torch.isfinite(vjp).all()
    assert column_err(vjp, ref, slice(N_AIR, None)) < EXACT
    assert column_err(de * keep, te * keep) < EXACT
    assert column_err(dh * keep, th * keep) < EXACT


@pytest.mark.parametrize("n,kind", CASES)
def test_plain_adjoint_matches_autograd_complex64(n, kind):
    """complex64: the plain adjoint and tangent no less accurate than
    autograd's against the complex128 truth (within twice its error, plus
    1e-5 of the column's largest entry); on the mild profiles, where that
    error is ~1e-2 at most, also within 1e-3 of autograd itself."""
    case = profiles(n, kind)
    floor = FLOOR[torch.float32]
    vjp, ref, (de, dh), (te, th), keep = _derivatives(case, torch.float32, floor)
    tvjp, _, (tde, tdh), _, _ = _derivatives(case, torch.float64, floor)
    earth = slice(N_AIR, None)
    pairs = [(vjp.double(), ref.double(), tvjp, earth)] + [
        (a.cdouble() * keep, b.cdouble() * keep, t * keep, slice(None))
        for a, b, t in ((de, te, tde), (dh, th, tdh))]
    for got, auto, truth, cols in pairs:
        assert column_err(got, truth, cols) <= 2 * column_err(auto, truth, cols) + 1e-5
        if kind == "mild":
            assert column_err(got, auto, cols) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["c128", "c64"])
def test_function_on_cpu_is_the_plain_versions(dtype, monkeypatch):
    """_AnalyticField with the plain versions in place of the three
    launches, on CPU tensors: its outputs are the plain forward's, its
    backward the plain adjoint and its forward mode the plain tangent, bit
    for bit; with a cotangent of e alone (h's None) and a batched dz; and
    it launches nothing."""
    monkeypatch.setattr(TD, "mt1d_field", TD.field_plain)
    monkeypatch.setattr(TD, "mt1d_field_tangent", TD.field_tangent_plain)
    monkeypatch.setattr(TD, "mt1d_field_vjp", TD.field_vjp_plain)
    om, sg, dz = _tensors(profiles(56, "mild"), dtype)
    dzb = dz.expand(sg.shape).contiguous()
    e, h, cut = TD.field_plain(om, sg, dz)
    ge, gh, _ = cotangents(e, h, FLOOR[dtype])
    FF.reset_launches()
    s = sg.clone().requires_grad_(True)
    fe, fh, fcut = TD._AnalyticField.apply(om, s, dzb)
    assert torch.equal(fe, e) and torch.equal(fh, h) and torch.equal(fcut, cut)
    (g,) = torch.autograd.grad(torch.real(ge.conj() * fe).sum(), s)
    assert torch.equal(g, TD.field_vjp_plain(om, sg, dzb, cut, ge, None))
    ds = torch.ones_like(sg)
    _, (te, th) = torch.func.jvp(lambda x: TD._AnalyticField.apply(om, x, dzb)[:2], (sg,), (ds,))
    pe, ph = TD.field_tangent_plain(om, sg, dzb, cut, ds)
    assert torch.equal(te, pe) and torch.equal(th, ph)
    assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0}


def test_analytic_field_shapes_and_cpu_path():
    """analytic_field keeps its signature and broadcasting: omega with a
    trailing singleton against (1, ncol, n) profiles gives (nfreq, ncol,
    n+1), the same on the columns' plain forward."""
    om, sg, dz = profiles(52, "wide", ncol=3)
    sig = torch.as_tensor(sg[:3])
    omega = torch.as_tensor(2 * np.pi * np.asarray(FREQS)).reshape(-1, 1, 1)
    e, h = TD.analytic_field(omega, sig[None], torch.as_tensor(dz), with_h=True,
                             dtype=torch.complex128)
    assert e.shape == h.shape == (len(FREQS), 3, 53)
    ce, ch, _ = TD.field_plain(*_tensors((om, sg, dz), torch.float64))
    assert torch.equal(e.reshape(-1, 53), ce) and torch.equal(h.reshape(-1, 53), ch)
    assert torch.equal(TD.analytic_field(omega, sig[None], torch.as_tensor(dz),
                                         dtype=torch.complex128), e)


def test_launch_counters_registered():
    """The two kernels' counters appear in FF.launches() only when nonzero,
    follow add_launches (a graph replay's delta) and reset_launches."""
    FF.reset_launches()
    assert set(FF.launches()) == {"schur_factor", "bt_sweep_fwd", "bt_sweep_bwd"}
    before = FF.launches()
    TD.mt1d_field.launches += 1
    TD.mt1d_field_vjp.launches += 1
    delta = FF.launch_delta(before, FF.launches())
    assert delta == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                     "mt1d_field": 1, "mt1d_field_vjp": 1}
    FF.add_launches(delta)
    assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                             "mt1d_field": 2, "mt1d_field_vjp": 2}
    FF.reset_launches()
    assert "mt1d_field" not in FF.launches()
