"""The CUDA sources of ``gj_inverse``, ``schur_factor``, the two sweeps
(``bt_sweep``) and ``mt1d_field`` run on the CPU (``tests/csrc_emulator.py``: one OS thread a CUDA thread,
g++), held against their plain versions, and their C entry points' plan
checks held against the launch plans of ``ops/fused_factor.py`` for every
width (``ops/mt1d.py``'s block of one warp).

The emulation runs the kernels' own indexing, padding, barriers and
shuffles, so it catches an index or a missing barrier here where only the
card could otherwise; it rounds as the host does, not as nvcc contracts,
so its tolerances are the card's (``chip_smoke.py``: 1e-4 and 1e-10 for
``gj_inverse``, 1e-5 of max |G| for the factor and of max |out| for the
sweeps; read here: at most 1.3e-6, 2.3e-15 and 4.5e-7 for the first
two).  Small batches: each block is 512 threads (the sweeps' 544).
"""

import numpy as np
import pytest
import torch

from hmcmt2d_tpu_torch.ops import fused_factor as FF
from hmcmt2d_tpu_torch.ops import mt1d as TD
from tests import csrc_emulator
from tests.test_torch_mt1d_kernel import FLOOR, N_AIR, column_err, cotangents, profiles

torch.set_num_threads(1)

GJ_TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}
FACTOR_TOL = 1e-5
SWEEP_TOL = 1e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not csrc_emulator.available():
        pytest.skip("needs g++ to build the emulated sources")
    return csrc_emulator.build(tmp_path_factory.mktemp("csrc_emulated"))


def relerr(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _gj_emulated(lib, A):
    B, n, _ = A.shape
    plan = FF.gj_inverse_plan(n, A.dtype)
    X = torch.full_like(A, float("nan"))
    err = lib.hmc_gj_inverse(A.data_ptr(), X.data_ptr(), B, n, plan.qp, plan.n_threads,
                             plan.smem_bytes, plan.panel,
                             int(A.dtype == torch.complex128), None)
    assert err == 0
    return X


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("n", [1, 17, 33, 95, 128])
def test_gj_inverse_source_matches_plain(lib, n, dtype):
    """Every width template (qp = 32, 64, 96, 128), a panel cut at n and a
    panel padded past it, on diagonally dominant matrices, batch 2."""
    rng = np.random.default_rng(40 + n)
    A = (0.3 * (rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n)))
         + (4.0 + 0.5j) * np.sqrt(n) * np.eye(n))
    A = torch.as_tensor(A, dtype=dtype)
    X = _gj_emulated(lib, A)
    assert bool(torch.isfinite(torch.view_as_real(X)).all())
    assert relerr(X, FF.gj_inverse_blocked(A)) < GJ_TOL[dtype]


@pytest.mark.parametrize("q,polish", [(17, 0), (17, 2), (64, 1), (95, 1), (128, 1)])
def test_schur_factor_source_matches_plain(lib, q, polish):
    """The factor at polish 0 and its Newton-Schulz variant: two shared
    buffers up to qp = 96 (with the rebuild of S_j for a second step), one
    at qp = 128; B = 2 systems of 3 lines."""
    rng = np.random.default_rng(20 + q)
    B, nzi = 2, 3
    d = torch.as_tensor((4.0 + 0.1 * rng.standard_normal((B, nzi, q))
                         + 0.5j * rng.standard_normal((B, nzi, q))).astype(np.complex64))
    oy = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))).astype(np.float32))
    oz = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))).astype(np.float32))
    plan = FF.schur_factor_plan(q, polish)
    G = torch.full((B, nzi, q, q), float("nan"), dtype=torch.complex64)
    err = lib.hmc_schur_factor(d.data_ptr(), oy.data_ptr(), oz.data_ptr(), G.data_ptr(), B,
                               nzi, q, plan.qp, plan.n_threads, plan.smem_bytes, polish, None)
    assert err == 0
    assert relerr(G, FF.schur_factor_plain(d, oy, oz, polish)) < FACTOR_TOL


# (q, B, nzi): every width template, one-line chunks up to qp = 96 and
# half-line chunks at 128; B nzi q odd at q = 1, 51 and 95, where the
# forward sweep cuts the chunk that ends G (at q = 1 to no bulk copy at all)
SWEEP_CASES = [(1, 3, 3), (17, 2, 3), (51, 1, 3), (64, 2, 2), (95, 1, 3), (128, 1, 3)]


@pytest.mark.parametrize("name", ["bt_sweep_fwd", "bt_sweep_bwd"])
@pytest.mark.parametrize("q,B,nzi", SWEEP_CASES)
def test_bt_sweep_source_matches_plain(lib, name, q, B, nzi):
    """Each sweep given the plain factor of a diagonally dominant system,
    against its plain version in complex64.  G lies at the start of a
    buffer whose entries after it are NaN, so a span read past G would
    poison the output, and the output starts as NaN, so an unwritten entry
    shows; no bulk copy may be one a TMA copy refuses."""
    rng = np.random.default_rng(60 + q)
    d = torch.as_tensor((4.0 + 0.1 * rng.standard_normal((B, nzi, q))
                         + 0.5j * rng.standard_normal((B, nzi, q))).astype(np.complex64))
    oy = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))).astype(np.float32))
    oz = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))).astype(np.float32))
    v = torch.as_tensor((rng.standard_normal((B, nzi, q))
                         + 1j * rng.standard_normal((B, nzi, q))).astype(np.complex64))
    G = FF.schur_factor_plain(d, oy, oz)
    buf = torch.full((G.numel() + 2,), complex("nan+nanj"), dtype=G.dtype)
    G_in = buf[:G.numel()].view(G.shape).copy_(G)
    plan = getattr(FF, name + "_plan")(q)
    out = torch.full_like(v, complex("nan+nanj"))
    faults = lib.emu_faults()
    err = getattr(lib, "hmc_" + name)(G_in.data_ptr(), oz.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), B, nzi, q, plan.qp, plan.ring,
                                      plan.n_threads, plan.smem_bytes, None)
    assert err == 0 and lib.emu_faults() == faults
    assert bool(torch.isfinite(torch.view_as_real(out)).all())
    assert relerr(out, getattr(FF, name + "_plain")(G, oz, v)) < SWEEP_TOL


@pytest.mark.parametrize("name", ["bt_sweep_fwd", "bt_sweep_bwd"])
def test_bt_sweep_entries_take_exactly_the_plan(lib, name):
    """For every q, each sweep's entry point accepts the plan (B = 0: the
    check, no launch) and refuses its shared memory off by one complex and
    a ring other than three slots."""
    entry = getattr(lib, "hmc_" + name)
    for q in range(1, FF.Q_MAX + 1):
        p = getattr(FF, name + "_plan")(q)

        def call(smem, ring, p=p, q=q):
            return entry(None, None, None, None, 0, 1, q, p.qp, ring, p.n_threads, smem, None)

        assert call(p.smem_bytes, p.ring) == 0, q
        assert call(p.smem_bytes + 8, p.ring) != 0, q
        assert call(p.smem_bytes - 8, p.ring) != 0, q
        assert call(p.smem_bytes, 2) != 0 and call(p.smem_bytes, 4) != 0, q


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
def test_gj_inverse_entry_takes_exactly_the_plan(lib, dtype):
    """For every n, hmc_gj_inverse accepts the plan (B = 0: the check, no
    launch) and refuses its shared memory off by one element or another
    panel."""
    elem = dtype.itemsize
    for n in range(1, FF.Q_MAX + 1):
        p = FF.gj_inverse_plan(n, dtype)
        dbl = int(dtype == torch.complex128)

        def call(smem, panel, p=p, n=n, dbl=dbl):
            return lib.hmc_gj_inverse(None, None, 0, n, p.qp, p.n_threads, smem, panel, dbl,
                                      None)

        assert call(p.smem_bytes, p.panel) == 0, n
        assert call(p.smem_bytes + elem, p.panel) != 0, n
        assert call(p.smem_bytes - elem, p.panel) != 0, n
        assert call(p.smem_bytes, 2 * p.panel) != 0, n


@pytest.mark.parametrize("polish", [0, 1, 2])
def test_schur_factor_entry_takes_exactly_the_plan(lib, polish):
    """For every q, hmc_schur_factor accepts the plan (B = 0) and refuses
    its shared memory off by one complex."""
    for q in range(1, FF.Q_MAX + 1):
        p = FF.schur_factor_plan(q, polish)

        def call(smem, p=p, q=q):
            return lib.hmc_schur_factor(None, None, None, None, 0, 1, q, p.qp, p.n_threads,
                                        smem, polish, None)

        assert call(p.smem_bytes) == 0, q
        assert call(p.smem_bytes + 8) != 0, q
        assert call(p.smem_bytes - 8) != 0, q


def _mt1d_field(lib, om, sg, dz, ds=None, cut=None):
    """The forward (or, with ds and cut, its tangent variant) of the
    emulated source; outputs start as NaN, so an unwritten entry shows."""
    N, n = sg.shape
    cdt = TD.MT1D_DTYPES[sg.dtype]
    e = torch.full((N, n + 1), complex("nan+nanj"), dtype=cdt)
    h = e.clone()
    cut = torch.full((N,), -1, dtype=torch.int32) if cut is None else cut
    err = lib.hmc_mt1d_field(om.data_ptr(), sg.data_ptr(), dz.data_ptr(),
                             None if ds is None else ds.data_ptr(), cut.data_ptr(), e.data_ptr(),
                             h.data_ptr(), N, n, int(dz.ndim == 2), TD.MT1D_THREADS,
                             int(sg.dtype == torch.float64), None)
    assert err == 0
    return e, h, cut


def _mt1d_vjp(lib, om, sg, dz, cut, ge, gh):
    N, n = sg.shape
    cdt = TD.MT1D_DTYPES[sg.dtype]
    work = torch.full((TD.work_rows(n), N), complex("nan+nanj"), dtype=cdt)
    g = torch.full((N, n), float("nan"), dtype=sg.dtype)
    err = lib.hmc_mt1d_vjp(om.data_ptr(), sg.data_ptr(), dz.data_ptr(), cut.data_ptr(),
                           None if ge is None else ge.data_ptr(),
                           None if gh is None else gh.data_ptr(), work.data_ptr(), g.data_ptr(),
                           N, n, int(dz.ndim == 2), TD.MT1D_THREADS,
                           int(sg.dtype == torch.float64), None)
    assert err == 0
    return g


def _mt1d_all(lib, case, dtype, floor, batched):
    """The emulated source's e, h, vjp and tangent at ``case`` in ``dtype``
    beside the plain versions' (the derivatives under the plain forward's
    cut), with complex128 cotangents on the interfaces above ``floor`` and
    a tangent on the earth layers."""
    om, sg, dz = (torch.as_tensor(a) for a in case)
    e, h, _ = TD.field_plain(om, sg, dz)
    ge, gh, keep = cotangents(e, h, floor)
    ds = torch.as_tensor(np.random.default_rng(2).standard_normal(sg.shape)) * sg
    ds[:, :N_AIR] = 0
    om, sg, dz, ds = (a.to(dtype) for a in (om, sg, dz, ds))
    if batched:
        dz = dz.expand(sg.shape).contiguous()
    ge, gh = ge.to(TD.MT1D_DTYPES[dtype]), gh.to(TD.MT1D_DTYPES[dtype])
    pe, ph, cut = TD.field_plain(om, sg, dz)
    ke, kh, _ = _mt1d_field(lib, om, sg, dz)
    kde, kdh, kcut = _mt1d_field(lib, om, sg, dz, ds, cut.clone())
    assert torch.equal(kcut, cut)   # the tangent variant reads the cut
    kernel = (ke, kh, _mt1d_vjp(lib, om, sg, dz, cut, ge, gh),
              _mt1d_vjp(lib, om, sg, dz, cut, ge, None), kde, kdh)
    plain = (pe, ph, TD.field_vjp_plain(om, sg, dz, cut, ge, gh),
             TD.field_vjp_plain(om, sg, dz, cut, ge, None))
    plain += TD.field_tangent_plain(om, sg, dz, cut, ds)
    return kernel, plain, keep


MT1D_CASES = [(56, "mild", False), (56, "clamps", True), (52, "mild", True), (52, "wide", False)]


@pytest.mark.parametrize("n,kind,batched", MT1D_CASES)
def test_mt1d_source_matches_plain_complex128(lib, n, kind, batched):
    """complex128: e and h above the floor, the vjp (with and without h's
    cotangent) on the earth layers and the tangent against the plain
    versions, to rounding as the up/down split amplifies it; dz shared by
    every column or a row each."""
    floor = FLOOR[torch.float64]
    kernel, plain, keep = _mt1d_all(lib, profiles(n, kind), torch.float64, floor, batched)
    cols = [slice(None)] * 2 + [slice(N_AIR, None)] * 2 + [slice(None)] * 2
    for i, (k, p, c) in enumerate(zip(kernel, plain, cols)):
        assert bool(torch.isfinite(torch.view_as_real(k) if k.is_complex() else k).all()), i
        m = keep if i in (0, 1, 4, 5) else 1
        assert column_err(k * m, p * m, c) < 1e-7, i


@pytest.mark.parametrize("n,kind,batched", [(56, "mild", False), (52, "mild", True)])
def test_mt1d_source_matches_plain_complex64(lib, n, kind, batched):
    """complex64, on the flagship-like profiles (on the wide ones the
    complex64 derivatives of either version stray from the truth by tens
    of percent: tests/test_torch_mt1d_kernel.py): the emulated source no
    less accurate than the plain version against the plain complex128 truth
    (twice its error, plus 1e-5 of the column's largest entry), e and h
    above the floor, the vjp on the earth layers."""
    case = profiles(n, kind)
    floor = FLOOR[torch.float32]
    kernel, plain, keep = _mt1d_all(lib, case, torch.float32, floor, batched)
    _, truth, _ = _mt1d_all(lib, case, torch.float64, floor, batched)
    cols = [slice(None)] * 2 + [slice(N_AIR, None)] * 2 + [slice(None)] * 2
    for i, (k, p, t, c) in enumerate(zip(kernel, plain, truth, cols)):
        m = keep if i in (0, 1, 4, 5) else 1
        k, p = (a.to(t.dtype) * m for a in (k, p))
        t = t * m
        assert column_err(k, t, c) <= 2 * column_err(p, t, c) + 1e-5, i


def test_mt1d_entries_take_exactly_the_plan(lib):
    """hmc_mt1d_field and hmc_mt1d_vjp accept their plan (N = 0: the check,
    no launch) in both precisions and with dz shared or a row each, and
    refuse another block, no layer, a negative N, and a flag outside 0/1."""
    def field(N=0, n=56, batched=0, threads=TD.MT1D_THREADS, dbl=0):
        return lib.hmc_mt1d_field(None, None, None, None, None, None, None, N, n, batched,
                                  threads, dbl, None)

    def vjp(N=0, n=56, batched=0, threads=TD.MT1D_THREADS, dbl=0):
        return lib.hmc_mt1d_vjp(None, None, None, None, None, None, None, None, N, n, batched,
                                threads, dbl, None)

    for entry in (field, vjp):
        for dbl in (0, 1):
            for batched in (0, 1):
                assert entry(dbl=dbl, batched=batched) == 0
        assert entry(n=1) == 0
        assert entry(threads=64) != 0 and entry(threads=16) != 0
        assert entry(n=0) != 0 and entry(N=-1) != 0
        assert entry(dbl=2) != 0 and entry(batched=2) != 0


def test_mt1d_card_path_on_the_emulated_source(lib, monkeypatch):
    """ops/mt1d.py's card path (analytic_field's columns, _AnalyticField,
    the launch wrappers) with the emulated source in place of the built
    library, on the tiny flagship's CPU problem: a fused gradient eval
    launches the forward and the vjp once each, jv (torch.func.jvp) the
    forward and its tangent variant; potential, gradient, jv and jtv agree
    with the plain path's, which launches nothing."""
    import types

    from hmcmt2d_tpu_torch import entry
    from hmcmt2d_tpu_torch.models import jacobian as JJ
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

    def check(t, name, dtype, shape, device):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
                or t.is_conj() or t.is_neg():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")

    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(torch.complex64, 6, "fused"))
    rng = np.random.default_rng(0)
    m = torch.as_tensor(m0 + 0.1 * rng.standard_normal((2, len(m0))), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal(len(m0)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal(JJ.n_rows(prob)), dtype=torch.float32)
    vg = make_potential_vg(prob, 1.0, graphed=False)

    def run():
        FF.reset_launches()
        (U, _), g = vg(m, m)
        eval_counts = FF.launches()
        FF.reset_launches()
        out = (U, g, JJ.jv(prob, m[0], v), JJ.jtv(prob, m[0], w))
        return out, eval_counts, FF.launches()

    want, cpu_eval, cpu_counts = run()
    assert cpu_eval == cpu_counts == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0}
    monkeypatch.setattr(TD, "FF", types.SimpleNamespace(
        _on_cpu=lambda t: False, _check=check, _stream=lambda: None,
        _raise_on=FF._raise_on))
    monkeypatch.setattr(TD, "kernel_build", types.SimpleNamespace(library=lambda: lib))
    got, eval_counts, counts = run()
    assert eval_counts == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                           "mt1d_field": 1, "mt1d_field_vjp": 1}
    assert counts == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                      "mt1d_field": 3, "mt1d_field_vjp": 1}
    for a, b in zip(got, want):
        assert relerr(a, b) < 1e-4
