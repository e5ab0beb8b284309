"""The CUDA kernels on the card.  Every test here needs a GPU and skips
without one.  The file imports neither JAX nor other test modules, so on the
card it runs without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hmcmt2d_tpu_torch import entry
from hmcmt2d_tpu_torch.models.forward import SolveConfig
from hmcmt2d_tpu_torch.ops import fused_factor as FF
from hmcmt2d_tpu_torch.ops import mt1d as TD
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

FACTOR_TOL = 2e-5
SWEEP_TOL = 1e-5
# a gradient eval's boundary fields: one forward and one vjp launch
MT1D = {"mt1d_field": 1, "mt1d_field_vjp": 1}
FUSED = ("schur_factor", "bt_sweep_fwd", "bt_sweep_bwd")
# the fused launches of a two-mode gradient eval (refine 6: 7 solves forward, 7 adjoint)
PER_EVAL = {"schur_factor": 1, "bt_sweep_fwd": 14, "bt_sweep_bwd": 14}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The GPU, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda")


def relerr(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _system(B, nzi, q, seed):
    """Random diagonally dominant systems, as tests/test_pallas_factor.py."""
    rng = np.random.default_rng(seed)
    d = (4.0 + 0.1 * rng.standard_normal((B, nzi, q))
         + 1j * 0.5 * rng.standard_normal((B, nzi, q))).astype(np.complex64)
    oy = (1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))).astype(np.float32)
    oz = (1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))).astype(np.float32)
    b = (rng.standard_normal((B, nzi, q))
         + 1j * rng.standard_normal((B, nzi, q))).astype(np.complex64)
    return [torch.as_tensor(a) for a in (d, oy, oz, b)]


@pytest.mark.parametrize("B,nzi,q,seed", [
    (3, 5, 20, 0), (4, 1, 7, 1), (2, 6, 95, 2), (2, 3, 128, 3),
    # the edges of the width templates: the coprod2 width, Q_MAX, more
    # blocks than two waves, and the first width of each larger tile
    (4, 6, 75, 4), (3, 4, 128, 5), (300, 2, 32, 6),
    (2, 3, 33, 7), (2, 3, 65, 8), (2, 3, 97, 9),
    # odd q and odd B nzi: the last line of G starts on a 16-byte boundary,
    # so the forward sweep's aligned span around it would end past G
    (1, 1, 95, 10), (3, 5, 75, 11),
    # the wide COPROD2 profile on lines along y: 225 lines of 51, B = 192
    (192, 225, 51, 12),
    # the main path's layouts of dprism2d (95 lines of 55, B = 176) and
    # coprod2 (75 lines of 51, B = 192), lines along y
    (176, 95, 55, 13), (192, 75, 51, 14)])
def test_kernels_match_plain(cuda_device, B, nzi, q, seed):
    d, oy, oz, b = (t.to(cuda_device) for t in _system(B, nzi, q, seed))
    FF.reset_launches()
    G = FF.schur_factor(d, oy, oz)
    y = FF.bt_sweep_fwd(G, oz, b)
    x = FF.bt_sweep_bwd(G, oz, y)
    assert FF.launches() == {"schur_factor": 1, "bt_sweep_fwd": 1, "bt_sweep_bwd": 1}
    assert relerr(G, FF.schur_factor_plain(d, oy, oz)) < FACTOR_TOL
    assert relerr(y, FF.bt_sweep_fwd_plain(G, oz, b)) < SWEEP_TOL
    assert relerr(x, FF.bt_sweep_bwd_plain(G, oz, y)) < SWEEP_TOL


@pytest.mark.parametrize("q", [17, 31, 64, 95, 128])
def test_polished_factor_matches_plain(cuda_device, q):
    """The factor's Newton-Schulz variant (polish = 1) against its plain
    version, relative to max |G| (the products sum in another order); the
    polish = 0 launch beside it holds its own plain version as before."""
    d, oy, oz, _ = (t.to(cuda_device) for t in _system(3, 4, q, 20 + q))
    FF.reset_launches()
    G1 = FF.schur_factor(d, oy, oz, polish=1)
    G0 = FF.schur_factor(d, oy, oz)
    assert FF.launches() == {"schur_factor": 1, "schur_factor_polish": 1,
                             "bt_sweep_fwd": 0, "bt_sweep_bwd": 0}
    assert bool(torch.isfinite(torch.view_as_real(G1)).all())
    assert relerr(G1, FF.schur_factor_plain(d, oy, oz, polish=1)) < 1e-5
    assert relerr(G0, FF.schur_factor_plain(d, oy, oz)) < FACTOR_TOL


def test_polished_factor_two_steps_matches_plain(cuda_device):
    """polish = 2 at the flagship's width: the second step rebuilds S_j
    (its products then read both shared buffers again)."""
    d, oy, oz, _ = (t.to(cuda_device) for t in _system(3, 4, 95, 60))
    G2 = FF.schur_factor(d, oy, oz, polish=2)
    assert bool(torch.isfinite(torch.view_as_real(G2)).all())
    assert relerr(G2, FF.schur_factor_plain(d, oy, oz, polish=2)) < 1e-5


@pytest.mark.parametrize("B,nzi,q,seed", [(2, 6, 95, 2), (2, 3, 128, 3), (2, 3, 33, 7),
                                          (4, 6, 75, 4)])
def test_factor_polish0_is_bit_equal_to_plain(cuda_device, B, nzi, q, seed):
    """polish = 0 rounds every product where the plain version does, at
    the widths of the 64-, 96- and 128-wide tiles (the 32-wide tile differs
    from it in the last bits, as it did before the polish variant's
    redesign)."""
    d, oy, oz, _ = (t.to(cuda_device) for t in _system(B, nzi, q, seed))
    assert torch.equal(FF.schur_factor(d, oy, oz), FF.schur_factor_plain(d, oy, oz))


def test_single_mode_fused_eval_launches(cuda_device):
    """A TE-only survey (Z_XY and the tipper) solves its own mode alone: one
    fused gradient eval launches the factor once and each sweep 14 times,
    all on lines along y, and agrees with the plain versions on the CPU."""
    cfg = SolveConfig(torch.complex64, 6, "fused")
    kw = dict(tiny=True, cfg=cfg, data_comp=("ZXY", "TZY"),
              data_type="Impedance_Tipper")
    gpu, m0 = entry.flagship_problem(device=cuda_device, **kw)
    cpu, _ = entry.flagship_problem(device="cpu", **kw)
    m = torch.as_tensor(m0 + 0.1 * np.random.default_rng(1).standard_normal((2, len(m0))),
                        dtype=torch.float32)
    FF.reset_launches()
    (U, _), g = make_potential_vg(gpu, 1.0)(m.to(cuda_device), m.to(cuda_device))
    assert FF.launches() == {**PER_EVAL, **MT1D}
    (Uc, _), gc = make_potential_vg(cpu, 1.0)(m, m)
    assert relerr(U.cpu(), Uc) < 1e-4
    g, gc = g.cpu().double(), gc.double()
    assert float(((g * gc).sum(-1) / (g.norm(dim=-1) * gc.norm(dim=-1))).min()) > 0.9999


def _wide_system(B, nzi, nyi, seed, device):
    """Random diagonally dominant complex128 interior systems of nzi x nyi
    unknowns (the wide COPROD2 profile's is 51 x 225) and a right-hand
    side, on ``device``."""
    from hmcmt2d_tpu_torch.ops import solver as S

    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn((B,) + shape, generator=gen, dtype=torch.float64)

    sys_ = S.InteriorSystem(torch.complex(4 + 0.1 * r(nzi, nyi), 0.5 * r(nzi, nyi)),
                            1 + 0.1 * r(nzi, nyi - 1), 1 + 0.1 * r(nzi - 1, nyi))
    b = torch.complex(r(nzi, nyi), r(nzi, nyi))
    return S.InteriorSystem(*(t.to(device) for t in sys_)), b.to(device)


def test_y_line_factor_and_refined_solve_at_the_wide_profile(cuda_device):
    """B = 192 systems of 51 x 225 (the wide COPROD2 cell's): the fused
    factor takes lines along y (225 lines of 51 in the 64-wide tile) and,
    refined six times against the complex128 operator, solves them as
    complex128 thomas does (LU inverses of 225-wide z-line blocks) to
    complex128 rounding; unrefined, to complex64's.  One factor launch and
    seven sweep pairs, all counted on lines along y."""
    from hmcmt2d_tpu_torch.ops import solver as S

    sys_, b = _wide_system(192, 51, 225, 12, cuda_device)
    FF.reset_launches()
    f = S.factorize(sys_, dtype=torch.complex64, method="fused")
    x = S.refined_solve(sys_, f, b, iters=6)
    x0 = S.factor_solve(f, b)
    torch.cuda.synchronize()
    assert FF.launches() == {"schur_factor": 1, "bt_sweep_fwd": 8, "bt_sweep_bwd": 8}
    assert f.fac.lines == "y" and tuple(f.fac.G.shape) == (192, 225, 51, 51)
    exact = S.factor_solve(S.factorize(sys_), b)
    assert float((x - exact).norm() / exact.norm()) < 1e-12
    assert float((x0 - exact).norm() / exact.norm()) < 1e-5
    FF.reset_launches()


def test_least_work_lines_at_the_dprism2d_shape(cuda_device):
    """B = 176 systems of 55 x 95 (the dprism2d cells'): ``factorize`` lays
    their lines along the shorter axis, 95 lines of 55 along y in the
    64-wide tile, and, refined six times against the complex128 operator,
    solves them as complex128 thomas does (LU inverses of 95-wide z-line
    blocks) to complex128 rounding; unrefined, to complex64's."""
    from hmcmt2d_tpu_torch.ops import solver as S

    sys_, b = _wide_system(176, 55, 95, 13, cuda_device)
    FF.reset_launches()
    f = S.factorize(sys_, dtype=torch.complex64, method="fused")
    x = S.refined_solve(sys_, f, b, iters=6)
    x0 = S.factor_solve(f, b)
    torch.cuda.synchronize()
    assert FF.launches() == {"schur_factor": 1, "bt_sweep_fwd": 8, "bt_sweep_bwd": 8}
    assert f.fac.lines == "y" and tuple(f.fac.G.shape) == (176, 95, 55, 55)
    exact = S.factor_solve(S.factorize(sys_), b)
    assert float((x - exact).norm() / exact.norm()) < 1e-12
    assert float((x0 - exact).norm() / exact.norm()) < 1e-5
    FF.reset_launches()


@pytest.mark.parametrize("config", ["coprod2_full", "dprism2d", "coprod2"])
def test_graphed_y_line_eval_replays_its_capture_launches(cuda_device, config):
    """A sample cell's eval (C = 8; interiors of 51 x 225, 55 x 95 and 51 x
    75), served by the graphed potential: each replay counts the launches
    its capture recorded, one factor and 14 sweep pairs on lines along y
    (the shorter axis in all three) beside the boundary fields' two, and
    equals the eager eval."""
    from pathlib import Path

    from benchmark import harness

    root = Path(__file__).resolve().parents[1]
    cfg = harness.load(root, "configs", config)
    inp = harness.make_inputs(root, cfg, 1, cuda_device)
    problem, _ = harness.build_problem(root, cfg, inp, cfg["solve"], cuda_device)
    vg = make_potential_vg(problem, cfg["smoothparameter"])
    eager = make_potential_vg(problem, cfg["smoothparameter"], graphed=False)
    m = inp.m_start
    m_ref = m.roll(1, 0)    # another chain's start: a prior term of each chain
    FF.reset_launches()
    out = vg(m, m_ref)
    per_eval = {**PER_EVAL, **MT1D}
    assert FF.launches() == per_eval
    (cap,) = vg.captures.values()
    assert cap.launches == per_eval
    for k in (2, 3):
        vg(m, m_ref)
        assert FF.launches() == {name: k * n for name, n in per_eval.items()}
    want = _flat(eager(m, m_ref))
    for a, b in zip(_flat(out), want):
        assert relerr(a.double(), b.double()) < 1e-5
    vg.release()
    FF.reset_launches()


def test_launch_checks(cuda_device):
    d, oy, oz, b = (t.to(cuda_device) for t in _system(2, 3, 8, 1))
    with pytest.raises(ValueError):
        FF.schur_factor(d.to(torch.complex128), oy, oz)
    with pytest.raises(ValueError):
        FF.schur_factor(d.transpose(1, 2).contiguous().transpose(1, 2), oy, oz)
    with pytest.raises(ValueError):
        FF.bt_sweep_fwd(FF.schur_factor(d, oy, oz), oz.cpu(), b)
    with pytest.raises(ValueError):
        FF.schur_factor(*(t.to(cuda_device) for t in _system(1, 2, 130, 0)[:3]))
    # the sweeps' bulk copies need G 16-byte aligned
    G = FF.schur_factor(d, oy, oz)
    shifted = torch.empty(G.numel() + 1, dtype=G.dtype, device=cuda_device)[1:]
    shifted = shifted.view(G.shape).copy_(G)
    with pytest.raises(ValueError, match="aligned"):
        FF.bt_sweep_bwd(shifted, oz, b)
    with pytest.raises(ValueError, match="aligned"):
        FF.bt_sweep_fwd(shifted, oz, b)


def test_fwd_sweep_reads_nothing_past_G(cuda_device):
    """G at the start of a buffer whose two entries after G are NaN: at odd
    q and odd B nzi the 16-byte span around G's last line would reach the
    first of them, and a NaN read there poisons the last row of y."""
    d, oy, oz, b = (t.to(cuda_device) for t in _system(3, 5, 95, 12))
    G = FF.schur_factor(d, oy, oz)
    buf = torch.full((G.numel() + 2,), complex("nan+nanj"), dtype=G.dtype,
                     device=cuda_device)
    assert buf.data_ptr() % 16 == 0
    G_in = buf[:G.numel()].view(G.shape).copy_(G)
    y = FF.bt_sweep_fwd(G_in, oz, b)
    assert bool(torch.isfinite(torch.view_as_real(y)).all())
    assert relerr(y, FF.bt_sweep_fwd_plain(G, oz, b)) < SWEEP_TOL


def test_fused_gradient_on_card_matches_cpu(cuda_device):
    """The tiny flagship's fused potential and gradient on the card (the
    kernels, one factor and 14 sweep pairs on lines along y) against the
    same config on the CPU (the plain versions)."""
    cfg = SolveConfig(torch.complex64, 6, "fused")
    gpu, m0 = entry.flagship_problem(tiny=True, device=None)
    assert gpu.fwd.cfg == cfg and gpu.device.type == "cuda"
    cpu, _ = entry.flagship_problem(tiny=True, device="cpu", cfg=cfg)
    rng = np.random.default_rng(0)
    m = torch.as_tensor(m0 + 0.1 * rng.standard_normal((2, len(m0))),
                        dtype=torch.float32)
    FF.reset_launches()
    (U, _), g = make_potential_vg(gpu, 1.0)(m.to(cuda_device), m.to(cuda_device))
    assert FF.launches() == {**PER_EVAL, **MT1D}
    (Uc, _), gc = make_potential_vg(cpu, 1.0)(m, m)
    assert relerr(U.cpu(), Uc) < 1e-4
    g, gc = g.cpu().double(), gc.double()
    cos = (g * gc).sum(-1) / (g.norm(dim=-1) * gc.norm(dim=-1))
    assert float(cos.min()) > 0.9999


def _tiny_inputs():
    """The tiny flagship's mesh, start model, survey and observations (its
    own prediction at the start model plus 3% noise), for run_inversion."""
    from hmcmt2d_tpu_torch.constants import SIGMA_AIR

    prob, m0 = entry.flagship_problem(tiny=True, device="cpu")
    with torch.no_grad():
        obs = prob.predict(torch.as_tensor(m0)).numpy()
    rng = np.random.default_rng(0)
    obs = obs * (1 + 0.03 * (rng.standard_normal(len(obs))
                             + 1j * rng.standard_normal(len(obs))) / np.sqrt(2))
    sig = np.full((prob.mesh.nz, prob.mesh.ny), 0.01)
    sig[:prob.mesh.n_air] = SIGMA_AIR
    return prob.mesh, sig, prob.fwd.data, obs, 0.03 * np.abs(obs)


def test_jacobian_on_card_matches_cpu_complex128(cuda_device):
    """All rows of J from one thomas complex64 factor on the card, shared by
    each chunk's right-hand sides, against the exact CPU Jacobian."""
    from hmcmt2d_tpu_torch.models.jacobian import full_jacobian_chunked

    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device,
                                     cfg=SolveConfig(torch.complex64, 3, "thomas"))
    cpu, _ = entry.flagship_problem(tiny=True, device="cpu")
    m = m0 + 0.05 * np.sin(np.arange(len(m0)))
    FF.reset_launches()
    J = full_jacobian_chunked(gpu, torch.as_tensor(m, dtype=torch.float32,
                                                   device=cuda_device), chunk=16)
    counts = FF.launches()   # the boundary fields: one forward, a vjp a slab
    assert counts["mt1d_field"] == 1 and counts["mt1d_field_vjp"] > 1
    J_ref = full_jacobian_chunked(cpu, torch.as_tensor(m), chunk=16)
    assert np.isfinite(J).all()
    assert float(np.abs(J - J_ref).max() / np.abs(J_ref).max()) < 1e-4


def test_bcr_on_card_matches_cpu_complex128(cuda_device):
    """The tiny flagship's potential and gradient on the card under
    complex64 bcr, refined 6 times, against exact complex128 thomas on the
    CPU, with no fused kernel launch; and with no refinement to hide a bad
    factor, a complex64 bcr solve of its interior system on the card
    within 10x the complex64 thomas solve's error there."""
    from hmcmt2d_tpu_torch.ops import solver as S

    cfg = SolveConfig(torch.complex64, 6, "bcr")
    assert not torch.backends.cuda.matmul.allow_tf32
    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device, cfg=cfg)
    cpu, _ = entry.flagship_problem(tiny=True, device="cpu")
    rng = np.random.default_rng(0)
    m = m0 + 0.1 * rng.standard_normal((2, len(m0)))
    FF.reset_launches()
    mg = torch.as_tensor(m, dtype=torch.float32, device=cuda_device)
    (U, _), g = make_potential_vg(gpu, 1.0)(mg, mg)
    assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0, **MT1D}
    mc = torch.as_tensor(m)
    (Uc, _), gc = make_potential_vg(cpu, 1.0)(mc, mc)
    assert relerr(U.cpu().double(), Uc) < 1e-4
    g = g.cpu().double()
    cos = (g * gc).sum(-1) / (g.norm(dim=-1) * gc.norm(dim=-1))
    assert float(cos.min()) > 0.9999

    om = 2 * np.pi * torch.as_tensor(cpu.fwd.data.freqs).reshape((-1, 1, 1, 1, 1))
    sys_ = S.interior_system(cpu.fwd.merged_stencil(cpu.sigma2d(mc)), om)
    b = torch.as_tensor(rng.standard_normal(tuple(sys_.diag.shape))
                        + 1j * rng.standard_normal(tuple(sys_.diag.shape)))
    want = S.factor_solve(S.factorize(sys_), b)
    sys_g = S.InteriorSystem(*(t.to(cuda_device) for t in sys_))
    err = {meth: relerr(S.factor_solve(S.factorize(sys_g, torch.complex64, meth),
                                       b.to(cuda_device)).cpu().to(want.dtype), want)
           for meth in ("thomas", "bcr")}
    assert 0 < err["thomas"] < 1e-2
    assert err["bcr"] <= 10 * err["thomas"], err


GJ_TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 32, 33, 64, 95, 96, 97, 127, 128])
def test_gj_inverse_matches_plain(cuda_device, n, dtype):
    """The gj_inverse kernel at the edges of its panels and width templates
    against its plain version (the same panel order) and against LU, on
    diagonally dominant matrices with two batch axes (collapsed to one
    launch of 3 matrices)."""
    rng = np.random.default_rng(40 + n)
    A = (0.3 * (rng.standard_normal((3, 1, n, n)) + 1j * rng.standard_normal((3, 1, n, n)))
         + (4.0 + 0.5j) * np.sqrt(n) * np.eye(n))
    A = torch.as_tensor(A, dtype=dtype, device=cuda_device)
    FF.reset_launches()
    X = FF.gj_inverse(A)
    assert FF.launches()["gj_inverse"] == 1 and X.shape == A.shape
    assert relerr(X, FF.gj_inverse_blocked(A, FF.gj_inverse_plan(n, dtype).panel)) < GJ_TOL[dtype]
    lu = torch.linalg.inv(A.to(torch.complex128))
    assert relerr(X.to(torch.complex128), lu) < (1e-5 if dtype == torch.complex64 else 1e-12)


def test_gj_inverse_at_bcr_level0_batch(cuda_device):
    """bcr's level 0 on the flagship: B = 5,632 matrices of n = 95, more
    blocks than 21 waves of two an SM."""
    rng = np.random.default_rng(41)
    A = (0.3 * (rng.standard_normal((5632, 95, 95)) + 1j * rng.standard_normal((5632, 95, 95)))
         + (4.0 + 0.5j) * np.sqrt(95) * np.eye(95))
    A = torch.as_tensor(A, dtype=torch.complex64, device=cuda_device)
    X = FF.gj_inverse(A)
    assert relerr(X, FF.gj_inverse_blocked(A)) < GJ_TOL[torch.complex64]


def test_gj_inverse_launch_checks(cuda_device):
    A = torch.eye(8, dtype=torch.complex64, device=cuda_device).expand(2, 8, 8)
    with pytest.raises(ValueError):
        FF.gj_inverse(A.real.contiguous())                  # not complex
    with pytest.raises(ValueError):
        FF.gj_inverse(torch.eye(129, dtype=torch.complex64, device=cuda_device))
    with pytest.raises(ValueError):
        FF.gj_inverse(A[..., :7])                           # not square
    # a transposed view and a lazy conjugate are made contiguous first
    X = FF.gj_inverse(A.transpose(-1, -2).conj())
    assert relerr(X, A) < 1e-7


def test_gj_engines_on_card_match_cpu_complex128(cuda_device):
    """thomas, thomas_blocked and bcr with the gj_inverse kernel on the
    card, complex64 refined 6 times, against exact complex128 thomas on the
    CPU: the tiny flagship's potential and gradient, and the kernel
    launched once a line (thomas, thomas_blocked) or once a level (bcr) of
    each factor, with no fused kernel."""
    cpu, m0 = entry.flagship_problem(tiny=True, device="cpu")
    rng = np.random.default_rng(1)
    m = m0 + 0.1 * rng.standard_normal((2, len(m0)))
    mc = torch.as_tensor(m)
    (Uc, _), gc = make_potential_vg(cpu, 1.0)(mc, mc)
    nzi = cpu.mesh.nz - 1
    for method, per_factor in (("thomas", nzi), ("thomas_blocked", nzi),
                               ("bcr", nzi.bit_length())):
        cfg = SolveConfig(torch.complex64, 6, method, "gj")
        gpu, _ = entry.flagship_problem(tiny=True, device=cuda_device, cfg=cfg)
        mg = torch.as_tensor(m, dtype=torch.float32, device=cuda_device)
        FF.reset_launches()
        (U, _), g = make_potential_vg(gpu, 1.0)(mg, mg)
        assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                                 "gj_inverse": per_factor, **MT1D}, method
        assert relerr(U.cpu().double(), Uc) < 1e-4, method
        g = g.cpu().double()
        cos = (g * gc).sum(-1) / (g.norm(dim=-1) * gc.norm(dim=-1))
        assert float(cos.min()) > 0.9999, method


def test_run_inversion_main_phase_on_the_kernels(cuda_device):
    """A hybrid run (thomas warmup, fused main phase) on the card: the main
    phase launches the factor once per fused gradient eval (one at the
    switch, then one a leapfrog step) and each sweep 14 times; every
    gradient eval of both phases launches the boundary fields' forward and
    vjp kernels once."""
    from hmcmt2d_tpu_torch.io import HMCConfig
    from hmcmt2d_tpu_torch.sampler.driver import run_inversion

    cfg = HMCConfig(burnin=4, total_samples=8, sig_bounds=(1e-4, 10.0), dt=0.01,
                    timestep=(2, 3), seed=0, adapt=True, n_chains=2)
    FF.reset_launches()
    run = run_inversion(cfg, *_tiny_inputs(), device=None,
                        warmup_solve_cfg=SolveConfig(torch.complex64, 3, "thomas"))
    evals = 1 + int(run.result.lf_steps[run.n_warm:, 0].sum())
    assert run.problem.fwd.cfg.solver_method == "fused" and run.n_warm == 4
    counts = FF.launches()
    assert {k: counts[k] for k in FUSED} == {"schur_factor": evals, "bt_sweep_fwd": 14 * evals,
                                             "bt_sweep_bwd": 14 * evals}
    assert min(counts["mt1d_field"], counts["mt1d_field_vjp"]) > evals
    assert torch.isfinite(run.result.stats).all()
    assert run.result.final.m.device.type == "cuda"


def test_bench_measure_ess_launches(cuda_device, monkeypatch):
    """The bench's ``measure_ess`` on the tiny flagship on the card (warmup,
    the Gauss-Newton mass under thomas, re-adaptation, the timed window):
    every batched eval of the window launches (1, 14, 14), on lines along
    y, and the run no ``gj_inverse``."""
    from hmcmt2d_tpu_torch import bench

    windows = []
    measure = bench._measure

    def recorded(*args, **kw):
        windows.append(measure(*args, **kw))
        return windows[-1]

    monkeypatch.setattr(bench, "_measure", recorded)
    FF.reset_launches()
    stats = bench.measure_ess(lambda: entry.flagship_problem(tiny=True, device=None),
                              2, n_samples=8, n_warm=4, gn_mass=True, n_readapt=4)
    counts = FF.launches()
    (w,) = windows
    evals = int(w.result.lf_steps[:, 0].sum())
    assert w.launches == {k: evals * n for k, n in {**PER_EVAL, **MT1D}.items()}
    assert stats["nfevals"] == 2 * evals + 2
    assert "gj_inverse" not in counts and counts["schur_factor"] > evals
    assert stats["kernel_mass"] == "gauss-newton" and stats["kernel_adapted"]
    assert 0.0 <= stats["accept_rate"] <= 1.0 and stats["samples_per_sec"] > 0


def test_two_rank_sharded_run_on_card(cuda_device):
    """``dryrun_multichip(2)`` on one card: two gloo ranks sharing it on a
    (1 chain x 2 freq) mesh, the warmup, the engine switch, a continued
    segment and a dense-mass step on the fused kernels."""
    out = entry.dryrun_multichip(2, timeout_s=600)
    assert len(out) == 2 and out[0] == out[1]
    assert tuple(out[0]["mesh"]) == (1, 2) and out[0]["dt"] > 0
    assert np.isfinite(out[0]["misfit"]).all()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _tensors(part)] if isinstance(x, tuple) else []


def graphed_sharded_rank(device, n_freq: int) -> dict:
    """One rank of a (1 chain x ``n_freq`` freq) mesh on the card: the tiny
    flagship (fused kernels) through a graphed and an eager ShardedSampler,
    the fresh eval on two models in turn and the stale eval against each
    one's amortised factor; whether each graphed output equals the eager
    one bit for bit, and the released captures."""
    from hmcmt2d_tpu_torch.parallel.multichain import ShardedSampler, make_device_mesh
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    prob, m0 = entry.flagship_problem(tiny=True, device=device)
    mesh = make_device_mesh(1, n_freq, device=device)
    graphed = ShardedSampler(prob, 1.0, mesh)
    eager = ShardedSampler(prob, 1.0, mesh, graphed=False)
    rng = np.random.default_rng(9)
    ma, mb = (torch.as_tensor(m0 + 0.1 * rng.standard_normal((2, len(m0))),
                              dtype=torch.float32, device=device) for _ in range(2))
    pairs = [(graphed.potential_vg(mm, ma), eager.potential_vg(mm, ma)) for mm in (ma, mb, ma)]
    fac_g, fac_e = graphed.factor_fn(mb), eager.factor_fn(mb)
    pairs.append((graphed.potential_vg(ma, ma, fac_g), eager.potential_vg(ma, ma, fac_e)))
    equal = [all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(want)))
             for got, want in pairs]
    return {"graphed": isinstance(graphed.local_vg, GraphedPotential), "equal": equal,
            "released": sorted((c["rank"], c["kind"]) for c in graphed.release()),
            "left": len(graphed.local_vg.captures)}


@pytest.mark.parametrize("backend,n_freq", [("nccl", 1), ("gloo", 2)])
def test_graphed_sharded_eval_equals_eager_on_card(cuda_device, backend, n_freq):
    """A (1 x 1) NCCL mesh and a (1 x 2) gloo mesh of ranks sharing the
    card: each rank's graphed fresh eval (two models in turn) and stale
    eval equal its eager ones bit for bit, the freq-group sum after the
    replay included; release() frees every rank's three graphs."""
    from hmcmt2d_tpu_torch.parallel.multichain import spawn_ranks

    out = spawn_ranks(graphed_sharded_rank, n_freq, args=(n_freq,), backend=backend,
                      timeout_s=300)
    for rank in out:
        assert rank["graphed"] and rank["equal"] == [True] * 4 and rank["left"] == 0
        assert [tuple(c) for c in rank["released"]] == [
            (r, kind) for r in range(n_freq) for kind in ("eval", "factor", "stale")]


UNSHARDABLE_STARTUP = """datafile:      obs.dat
modelfile:     start.mod
totalsamples:  2
chains:        3
seed:          1
resistivity:   1.0 1e4 0.05
timeinterval:  0.01
timestep:      2 2
"""


def test_two_ranks_that_cannot_shard_run_on_rank0_on_card(cuda_device, tmp_path):
    """Three chains do not divide over two ranks: rank 0 warns, both leave
    the group, and rank 0 runs alone on the fused kernels, loading them
    without waiting on rank 1 (which has gone)."""
    import subprocess
    import sys
    from pathlib import Path

    from hmcmt2d_tpu_torch.io import write_data, write_model
    from hmcmt2d_tpu_torch.parallel.multichain import free_port

    mesh, sig, data, obs, err = _tiny_inputs()
    write_model(tmp_path / "start.mod", mesh, sig)
    write_data(tmp_path / "obs.dat", data, obs, err)
    (tmp_path / "startup").write_text(UNSHARDABLE_STARTUP)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hmcmt2d_tpu_torch.cli", "--solver", "fused", "run",
         str(tmp_path / "startup"), "--outdir", str(tmp_path), "--backend", "gloo",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(r)],
        cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err_text) in zip(procs, outs):
        assert p.returncode == 0, err_text[-3000:]
    assert "WARNING: cannot shard chains=3" in outs[0][0] and "done in" in outs[0][0]
    assert "[hmcmt2d]" not in outs[1][0]
    assert (tmp_path / "hmcstatistics_id3.log").exists()


def _graphed_pair(cuda_device, n_chains, seed):
    """The tiny flagship on the card under the fused kernels, its graphed
    and its eager eval, and two different (n_chains, P) models."""
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device)
    vg = make_potential_vg(gpu, 1.0)
    assert isinstance(vg, GraphedPotential)
    rng = np.random.default_rng(seed)
    ms = [torch.as_tensor(m0 + 0.1 * rng.standard_normal((n_chains, len(m0))),
                          dtype=torch.float32, device=cuda_device) for _ in range(2)]
    return vg, make_potential_vg(gpu, 1.0, graphed=False), ms


def _flat(out):
    (U, (misfit, mnorm, pred)), g = out
    return U, misfit, mnorm, pred, g


def test_graphed_eval_equals_eager_on_two_models(cuda_device):
    """Two models replayed in turn: each replay reads its own inputs (they
    are copied in) and returns fresh outputs, equal to the eager eval's
    (the same kernels and ops on the same inputs)."""
    vg, eager, (ma, mb) = _graphed_pair(cuda_device, 2, 3)
    outs = [(mm, _flat(vg(mm, ma))) for mm in (ma, mb, ma, mb)]
    for mm, got in outs:
        want = _flat(eager(mm, ma))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(outs[0][1][0], outs[1][1][0])
    assert len(vg.captures) == 1


def test_graphed_replay_counts_one_eval(cuda_device):
    """The capture's warm-ups and recording leave the counts as they were;
    each replay of the two-mode eval adds (1, 14, 14), on lines along y,
    and the boundary fields' forward and vjp once each."""
    vg, _, (ma, _mb) = _graphed_pair(cuda_device, 2, 4)
    FF.reset_launches()
    vg(ma, ma)
    per_eval = {**PER_EVAL, **MT1D}
    assert FF.launches() == per_eval
    for k in (2, 3):
        vg(ma, ma)
        assert FF.launches() == {name: k * n for name, n in per_eval.items()}
    (cap,) = vg.captures.values()
    assert cap.launches == per_eval
    assert cap.summary()["launches_per_replay"] == cap.launches
    assert cap.warmup_launches["schur_factor"] == 3 and cap.pool_bytes > 0


def test_graphed_second_shape_captures_its_own_graph(cuda_device):
    """C = 2, then C = 3: a graph (and pool) each, and C = 2 still replays
    right after C = 3 was captured."""
    vg, eager, (m2, _) = _graphed_pair(cuda_device, 2, 5)
    _, _, (m3, _) = _graphed_pair(cuda_device, 3, 6)
    for mm in (m2, m3, m2):
        for a, b in zip(_flat(vg(mm, mm)), _flat(eager(mm, mm))):
            assert torch.equal(a, b)
    assert sorted(tuple(c.inputs[0].shape) for c in vg.captures.values()) == [
        (2, m2.shape[1]), (3, m3.shape[1])]
    pools = [c.graph.pool() for c in vg.captures.values()]
    assert pools[0] != pools[1]


def test_graphed_eval_refuses_a_stale_factor(cuda_device):
    vg, _, (ma, _) = _graphed_pair(cuda_device, 2, 7)
    fac = vg.problem.factor_state(ma)
    with pytest.raises(ValueError, match="stale factor"):
        vg(ma, ma, fac)
    assert vg.captures == {}


def _equal_or_within_spread(got, eager_a, eager_b) -> None:
    """Each of ``got`` equals ``eager_a``'s bit for bit where two eager runs
    (a, b) agree bit for bit, else lies within their spread."""
    for g, a, b in zip(got, eager_a, eager_b):
        spread = float((a - b).abs().max())
        assert float((g - a).abs().max()) <= spread


@pytest.mark.parametrize("method,inv", [("thomas", "lu"), ("bcr", "gj")])
def test_graphed_engine_eval_and_trajectory_equal_eager(cuda_device, method, inv):
    """A warmup engine on the card (complex64, refine 6, the tiny flagship)
    served from its graphs: the fresh eval on two models in turn, then a
    trajectory-amortised leapfrog of 5 steps refactoring every 2 (the
    factor graph and the stale eval graph), each equal to the eager one;
    a factor replay launches gj_inverse once a line (thomas) or a level
    (bcr) under gj, none under LU, and the stale eval none."""
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    cfg = SolveConfig(torch.complex64, 6, method, inv)
    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device, cfg=cfg)
    vg, eager = make_potential_vg(gpu, 1.0), make_potential_vg(gpu, 1.0, graphed=False)
    assert isinstance(vg, GraphedPotential)
    rng = np.random.default_rng(8)
    ma, mb = (torch.as_tensor(m0 + 0.1 * rng.standard_normal((2, len(m0))),
                              dtype=torch.float32, device=cuda_device) for _ in range(2))
    for mm in (ma, mb, ma):
        _equal_or_within_spread(_flat(vg(mm, ma)), _flat(eager(mm, ma)), _flat(eager(mm, ma)))

    nzi = gpu.mesh.nz - 1
    per_factor = 0 if inv == "lu" else (nzi.bit_length() if method == "bcr" else nzi)
    factor = vg.factor
    FF.reset_launches()
    fac = factor(mb)
    assert FF.launches().get("gj_inverse", 0) == per_factor
    FF.reset_launches()
    vg(ma, ma, fac)
    assert FF.launches().get("gj_inverse", 0) == 0

    opts = H.HMCOptions(dt=0.02, steps_lo=5, steps_hi=5, log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0, refactor_every=2)
    mass = H.identity_mass(len(m0), torch.float32, cuda_device)
    p0 = torch.as_tensor(np.clip(rng.standard_normal((2, len(m0))), -2.5, 2.5),
                         dtype=torch.float32, device=cuda_device)
    runs = []
    for fn, fac_fn in ((vg, factor), (eager, gpu.factor_state), (eager, gpu.factor_state)):
        state = H.sample_chain_init(fn, ma, ma)
        prop, p1 = H._leapfrog(fn, opts, mass, state, p0, ma, 5, opts.dt, factor_fn=fac_fn)
        runs.append(tuple(prop) + (p1,))
    _equal_or_within_spread(*runs)
    kinds = sorted(c.kind for c in vg.captures.values())
    assert kinds == ["eval", "factor", "stale"], kinds


@pytest.mark.parametrize("method,inv", [("thomas", "lu"), ("bcr", "gj"), ("fused", "lu")])
def test_graphed_jacobian_equals_eager_on_card(cuda_device, method, inv):
    """The Gauss-Newton Jacobian from the slab pullback's CUDA graph (the
    tiny flagship, complex64 refined 6 times, chunk 7: 10 slabs, 3 warm-up
    slabs and 7 replays) against the eager build: J bit for bit where two
    eager builds agree bit for bit, else within their spread; the same
    launches; the graph released and its memory freed."""
    from hmcmt2d_tpu_torch.models import jacobian as JJ

    prob, m0 = entry.flagship_problem(tiny=True, device=cuda_device,
                                      cfg=SolveConfig(torch.complex64, 6, method, inv))
    m = torch.as_tensor(m0 + 0.05 * np.sin(np.arange(len(m0))), dtype=torch.float32,
                        device=cuda_device)
    # a first graphed build makes what a process keeps once (the capture
    # side stream's cuBLAS workspaces), so the measured one shows its own
    JJ.full_jacobian_chunked(prob, m, chunk=7, graphed=True)
    builds = []
    for graphed in (False, True, False):
        FF.reset_launches()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        caps = []
        J = JJ.full_jacobian_chunked(prob, m, chunk=7, graphed=graphed, captures=caps)
        torch.cuda.synchronize()
        builds.append((J, FF.launches(), caps, torch.cuda.memory_allocated() - allocated))
    (e0, n0, c0, _), (g, ng, cg, left), (e1, n1, _, _) = builds
    assert c0 == [] and [(c["kind"], c["slabs"], c["replays"]) for c in cg] == [
        ("jacobian", 10, 7)]
    assert cg[0]["pool_bytes"] > 0 and left == 0
    assert ng == n0 == n1
    assert np.abs(g - e0).max() <= np.abs(e1 - e0).max()
    assert np.isfinite(g).all()


def _mt1d_columns(n_freq, n_chain, n_col, n, device, seed=0):
    """The benchmark cells' boundary columns: n_freq frequencies 1e2..1e-2
    Hz x n_chain chains x n_col profiles of 7 air layers over n - 7 earth
    layers graded as the flagship's, earth 0.005..0.02 S/m (the flagship's
    start); float64 omega (N,), sigma (N, n), dz (n,) on ``device``."""
    rng = np.random.default_rng(seed)
    air = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])
    dz = np.concatenate([air[::-1], np.full(n - 16, 100.0), 100.0 * 2.0 ** np.arange(1, 10)])
    sig = np.exp(rng.uniform(np.log(0.005), np.log(0.02), (n_chain * n_col, n)))
    sig[:, :7] = 1e-8
    om = 2 * np.pi * np.logspace(2, -2, n_freq)
    cols = (np.repeat(om, len(sig)), np.tile(sig, (n_freq, 1)), dz)
    return tuple(torch.as_tensor(a, device=device) for a in cols)


def _col_err(got, want, cols=slice(None)):
    d = (got - want)[:, cols].abs().max(1).values
    return float((d / want[:, cols].abs().max(1).values).max())


@pytest.mark.parametrize("shape", [(11, 8, 97, 56), (12, 8, 77, 52)], ids=["dprism2d", "coprod2"])
def test_mt1d_kernels_match_plain_at_the_benchmark_shapes(cuda_device, shape):
    """The boundary fields' kernels at the cells' column counts (8,536
    columns of n = 56; 7,392 of n = 52): e and h (above 1e-3 of a column's
    largest), the vjp (on the earth layers) and the tangent (forward mode),
    complex64, no less accurate against the complex128 plain version than
    the complex64 plain version (twice its error plus 1e-5 of the column's
    largest entry; the derivatives under the plain forward's cut); in
    complex128, against the plain version to rounding (1e-7).  One launch
    each."""
    om64, sg64, dz64 = _mt1d_columns(*shape, cuda_device)
    e, h, _ = TD.field_plain(om64, sg64, dz64)
    keep = (e.abs() > 1e-3 * e.abs().max(1, keepdim=True).values) & \
        (h.abs() > 1e-3 * h.abs().max(1, keepdim=True).values)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def draw(like):
        return torch.randn(like.shape, dtype=like.dtype, device=cuda_device, generator=gen)

    ge = torch.where(keep, draw(e), 0)
    gh = torch.where(keep, draw(e), 0) / h.abs().max(1, keepdim=True).values
    ds = draw(sg64) * sg64
    ds[:, :7] = 0
    earth = slice(7, None)
    out = {}
    for rdt in (torch.float64, torch.float32):
        cdt = TD.MT1D_DTYPES[rdt]
        om, sg, dz, d = (t.to(rdt) for t in (om64, sg64, dz64, ds))
        g_e, g_h = ge.to(cdt), gh.to(cdt)
        pe, ph, cut = TD.field_plain(om, sg, dz)
        FF.reset_launches()
        ke, kh, _ = TD.mt1d_field(om, sg, dz)
        kv = TD.mt1d_field_vjp(om, sg, dz, cut, g_e, g_h)
        kde, kdh = TD.mt1d_field_tangent(om, sg, dz, cut, d)
        torch.cuda.synchronize()
        assert FF.launches() == {**dict.fromkeys(FUSED, 0), "mt1d_field": 2,
                                 "mt1d_field_vjp": 1}
        out[rdt] = ((ke, kh, kv, kde, kdh),
                    (pe, ph, TD.field_vjp_plain(om, sg, dz, cut, g_e, g_h))
                    + TD.field_tangent_plain(om, sg, dz, cut, d))
    kernel64, plain64 = out[torch.float64]
    kernel32, plain32 = out[torch.float32]
    cols = (slice(None), slice(None), earth, slice(None), slice(None))
    for i, c in enumerate(cols):
        m = keep if i != 2 else 1
        assert _col_err(kernel64[i] * m, plain64[i] * m, c) < 1e-7, i
        k, p = (x[i].to(plain64[i].dtype) * m for x in (kernel32, plain32))
        t = plain64[i] * m
        assert _col_err(k, t, c) <= 2 * _col_err(p, t, c) + 1e-5, i


def test_mt1d_launch_checks(cuda_device):
    """analytic_field on the card refuses an omega or a dz that requires
    grad (the kernels differentiate with respect to sigma only); the
    launches refuse a dtype, a shape or a device they do not take."""
    om, sg, dz = _mt1d_columns(2, 1, 3, 56, cuda_device)
    omega = om.reshape(-1, 1)[:2]
    with pytest.raises(ValueError, match="sigma only"):
        TD.analytic_field(omega.clone().requires_grad_(True), sg[:2], dz)
    with pytest.raises(ValueError, match="sigma only"):
        TD.analytic_field(omega, sg[:2], dz.clone().requires_grad_(True))
    with pytest.raises(ValueError):
        TD.mt1d_field(om.half(), sg.half(), dz.half())
    with pytest.raises(ValueError):
        TD.mt1d_field(om, sg[None], dz)
    with pytest.raises(ValueError):
        TD.mt1d_field(om, sg, dz.cpu())
    with pytest.raises(ValueError):
        TD.mt1d_field(om[:-1], sg, dz)


def test_jv_on_card_runs_through_the_kernels(cuda_device):
    """jv (torch.func.jvp through the forward model) on the card: the
    boundary fields' forward and its tangent variant, the fused solve's
    tangent solve on its sweeps; against the plain versions on the CPU."""
    from hmcmt2d_tpu_torch.models.jacobian import jv

    cfg = SolveConfig(torch.complex64, 6, "fused")
    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device, cfg=cfg)
    cpu, _ = entry.flagship_problem(tiny=True, device="cpu", cfg=cfg)
    rng = np.random.default_rng(5)
    m = torch.as_tensor(m0 + 0.1 * rng.standard_normal(len(m0)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal(len(m0)), dtype=torch.float32)
    FF.reset_launches()
    got = jv(gpu, m.to(cuda_device), v.to(cuda_device))
    counts = FF.launches()
    assert counts["mt1d_field"] == 2 and "mt1d_field_vjp" not in counts
    # one factor; the forward and the tangent solve, 1 + 6 refinement steps each
    assert counts["schur_factor"] == 1 and counts["bt_sweep_fwd"] == 14
    assert relerr(got.cpu(), jv(cpu, m, v)) < 1e-3
