"""The port's solver engines beyond thomas against the JAX package's, the
engine named on both sides: block cyclic reduction (``bcr``), grouped
block Thomas (``thomas_blocked``), and the unpivoted Gauss-Jordan inverse
(``inv_method="gj"``) inside thomas, thomas_blocked and bcr.

Systems are the real MT interior operator of ``tests/test_solver.py``'s
small graded meshes (air rows on top), built from the same numpy
conductivities by each package's own mesh code.  Tolerances: 1e-10
relative for solves and factors in complex128 (other summation orders),
1e-12 for the multi-right-hand-side path against one solve per row; the
problem-level checks take the other parity tests' (U 1e-10, gradients
1e-8, J v and J 1e-9), and 1e-12 for potential and gradient under the
thomas_blocked and gj engines, which repeat thomas's or bcr's arithmetic
in the same order.  An unrefined complex64 solve may be at most 10x as far
from the complex128 solve as the complex64 thomas one.
"""

import argparse
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu import cli as JC  # noqa: E402
from hmcmt2d_tpu import mesh as JM  # noqa: E402
from hmcmt2d_tpu.models import forward as JF  # noqa: E402
from hmcmt2d_tpu.models import jacobian as JJ  # noqa: E402
from hmcmt2d_tpu.ops import solver as JS  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import cli, convert  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch.io import write_data, write_model  # noqa: E402
from hmcmt2d_tpu_torch.models import jacobian as TJ  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from hmcmt2d_tpu_torch.parallel import multichain  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.test_e2e import tiny_setup  # noqa: E402
from tests.test_torch_cli import STARTUP  # noqa: E402
from tests.torch_parity import (chain_models, jax_problem_from_arrays,  # noqa: E402
                                jax_problem_with, port_setup, problem_arrays, relerr,
                                single_mode_freq_rank, survey_arrays, tiny_problems)

TOL = 1e-10
GRAD_TOL = 1e-8
JV_TOL = 1e-9
RAW_RATIO = 10.0   # unrefined complex64 bcr error over thomas's, at most


def _close(got, want, tol) -> bool:
    """max |got - want| <= tol max |want| (true for two zero arrays)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def _systems(mode, ny=12, nz=9, freq=1.0, seed=3):
    """The interior system of ``tests/test_solver.py::_problem``'s mesh and
    conductivities on both sides (JAX, port) and a right-hand side."""
    rng = np.random.default_rng(seed)
    dy, dz = small_mesh(ny, nz, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(nz, ny))
    sigma[:2] = 1e-8
    jfn = JM.te_stencil if mode == "TE" else JM.tm_stencil
    tfn = TM.te_stencil if mode == "TE" else TM.tm_stencil
    omega = 2 * np.pi * freq
    jsys = JS.interior_system(jfn(JM.make_mesh(dy, dz), jnp.asarray(sigma)), omega)
    tsys = TS.interior_system(tfn(TM.make_mesh(dy, dz, device="cpu"),
                                  torch.as_tensor(sigma)), torch.tensor(omega, dtype=torch.float64))
    b = rng.standard_normal((nz - 1, ny - 1)) + 1j * rng.standard_normal((nz - 1, ny - 1))
    return jsys, tsys, b


@functools.partial(jax.jit, static_argnames=("method", "inv_method"))
def _jax_factor_solve(jsys, b, method, inv_method="lu"):
    return JS.factor_solve(JS.factorize(jsys, method=method, inv_method=inv_method), b)


def _solve_pair(jsys, tsys, b, method, inv_method="lu"):
    jx = _jax_factor_solve(jsys, jnp.asarray(b), method=method, inv_method=inv_method)
    tx = TS.factor_solve(TS.factorize(tsys, method=method, inv_method=inv_method),
                         torch.as_tensor(b))
    return tx, jx


# -- the factor and its solves ---------------------------------------------

@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_bcr_factor_levels_match_jax(mode):
    """nzi = 16 pads to N = 31: level 0 (diagonal couplings), three dense
    levels and the last single block."""
    jsys, tsys, _ = _systems(mode, nz=17)
    jf = jax.jit(lambda s: JS.bcr_factor(JS.equilibrate(s)[0]))(jsys)
    tf = TS.bcr_factor(TS.equilibrate(tsys)[0])
    assert len(tf.levels) == len(jf.levels) == 5
    for tl, jl in zip(tf.levels, jf.levels):
        for t, j in zip(tl, jl):
            if j is None:
                assert t is None
                continue
            assert tuple(t.shape) == j.shape
            assert _close(t, j, TOL)


@pytest.mark.parametrize("freq", [0.01, 1.0, 100.0])
@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_bcr_solve_matches_jax(mode, freq):
    jsys, tsys, b = _systems(mode, freq=freq)
    tx, jx = _solve_pair(jsys, tsys, b, "bcr")
    assert relerr(tx, jx) < TOL
    assert relerr(TS.apply_interior(tsys, tx), b) < TOL


@pytest.mark.parametrize("nz", [2, 3, 4, 6, 9, 17])
def test_bcr_line_counts_match_jax(nz):
    """nzi = nz - 1 lines: the N == 1 branch (nz = 2) and paddings to
    2^m - 1."""
    jsys, tsys, b = _systems("TE", ny=7, nz=nz)
    tx, jx = _solve_pair(jsys, tsys, b, "bcr")
    assert relerr(tx, jx) < TOL


# grouped block Thomas: JAX's test_blocked_thomas_solve_matches_scipy sizes
# (ny x nz: a multiple of the group of 8 lines, and two that are not)
BLOCKED_SIZES = [(12, 9), (10, 18), (8, 6)]


@pytest.mark.parametrize("ny,nz", BLOCKED_SIZES)
@pytest.mark.parametrize("freq", [0.01, 1.0, 100.0])
@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_thomas_blocked_solve_matches_jax(mode, freq, ny, nz):
    jsys, tsys, b = _systems(mode, ny=ny, nz=nz, freq=freq)
    tx, jx = _solve_pair(jsys, tsys, b, "thomas_blocked")
    assert relerr(tx, jx) < TOL
    assert relerr(TS.apply_interior(tsys, tx), b) < TOL


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_thomas_blocked_factor_matches_jax(mode):
    """nzi = 17 lines pad to 24: G, the couplings and both groups' prefix
    products (JAX keeps the backward ones in reversed line order)."""
    jsys, tsys, _ = _systems(mode, ny=10, nz=18)
    jf = jax.jit(lambda s: JS.bt_factor_blocked(JS.equilibrate(s)[0]))(jsys)
    tf = TS.bt_factor_blocked(TS.equilibrate(tsys)[0])
    assert tf.G.shape[-3] == 24
    for name in ("G", "offz", "cf", "cb", "Qf"):
        assert _close(getattr(tf, name), getattr(jf, name), TOL), name
    assert _close(tf.Qb, np.asarray(jf.Qb)[..., ::-1, :, :], TOL)


@pytest.mark.parametrize("method", ["thomas", "thomas_blocked", "bcr"])
@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_gj_factor_solve_matches_jax(mode, method):
    """factorize(..., inv_method="gj") and factor_solve against JAX's at
    1 Hz and 0.01 Hz, nzi = 16 (bcr's five levels)."""
    for freq in (1.0, 0.01):
        jsys, tsys, b = _systems(mode, nz=17, freq=freq)
        tx, jx = _solve_pair(jsys, tsys, b, method, "gj")
        assert relerr(tx, jx) < TOL
        assert relerr(TS.apply_interior(tsys, tx), b) < TOL


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_complex64_thomas_blocked_refined(mode):
    """A complex64 thomas_blocked factor refined 3 times against the
    complex128 operator reaches the complex128 solve, and beats the
    unrefined complex64 one."""
    _, tsys, b = _systems(mode)
    want = TS.factor_solve(TS.factorize(tsys), torch.as_tensor(b))
    fac = TS.factorize(tsys, dtype=torch.complex64, method="thomas_blocked")
    assert fac.fac.G.dtype == fac.fac.Qf.dtype == torch.complex64
    raw = TS.factor_solve(fac, torch.as_tensor(b))
    refined = TS.refined_solve(tsys, fac, torch.as_tensor(b), iters=3)
    assert 1e-8 < relerr(raw, want) < 1e-3
    assert relerr(refined, want) < TOL


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_complex64_factor_refined(mode):
    """A complex64 bcr factor refined 3 times against the complex128
    operator reaches the complex128 solve, and beats the unrefined
    complex64 one."""
    _, tsys, b = _systems(mode)
    want = TS.factor_solve(TS.factorize(tsys), torch.as_tensor(b))
    fac = TS.factorize(tsys, dtype=torch.complex64, method="bcr")
    assert fac.fac.levels[0].Dinv.dtype == torch.complex64
    raw = TS.factor_solve(fac, torch.as_tensor(b))
    refined = TS.refined_solve(tsys, fac, torch.as_tensor(b), iters=3)
    assert 1e-8 < relerr(raw, want) < 1e-3
    assert relerr(refined, want) < TOL


@pytest.mark.parametrize("freq", [0.01, 100.0])
@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_complex64_bcr_unrefined_error_near_thomas(mode, freq):
    """The factor itself, with no refinement to hide its error: an
    unrefined complex64 bcr solve of the real operator (nzi = 16, five
    levels) stays within RAW_RATIO of the complex64 thomas solve's
    distance from the complex128 solve."""
    _, tsys, b = _systems(mode, nz=17, freq=freq)
    b = torch.as_tensor(b)
    want = TS.factor_solve(TS.factorize(tsys), b)
    err = {(m, inv): relerr(TS.factor_solve(TS.factorize(tsys, dtype=torch.complex64, method=m,
                                                         inv_method=inv), b), want)
           for m in ("thomas", "bcr", "thomas_blocked") for inv in ("lu", "gj")}
    assert 0 < err["thomas", "lu"] < 1e-3
    for key, e in err.items():
        assert e <= RAW_RATIO * err["thomas", "lu"], (key, err)


@pytest.mark.parametrize("method", ["bcr", "thomas", "thomas_blocked"])
def test_shared_factor_equals_per_row_solves(method):
    """A factor whose batch is 1 on a row axis, 5 rows in b (the Jacobian's
    slab): one solve equals 5 per-row solves."""
    _, tsys, _ = _systems("TM", nz=6)
    sys1 = TS.InteriorSystem(*(t[None] for t in tsys))          # (1, nzi, q)
    fac = TS.factorize(sys1, method=method)
    rng = np.random.default_rng(7)
    shape = (5,) + tuple(tsys.diag.shape)
    b = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    got = TS.factor_solve(fac, b)
    want = torch.cat([TS.factor_solve(fac, b[i:i + 1]) for i in range(5)])
    assert got.shape == b.shape
    assert relerr(got, want) < 1e-12


@pytest.mark.parametrize("method,inv,what", [("cholesky", "lu", "solver method"),
                                             ("thomas", "qr", "inverse method")],
                         ids=["cholesky", "inverse-qr"])
def test_unknown_engine_names_raise(method, inv, what):
    """An unknown engine or inverse name raises: nothing falls back."""
    _, tsys, _ = _systems("TE", nz=4)
    with pytest.raises(ValueError, match=what):
        TS.factorize(tsys, method=method, inv_method=inv)


# -- through the problem ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jprob, _, m0 = tiny_problems()
    m = m0 + 0.05 * np.random.default_rng(4).standard_normal((2, len(m0)))
    return jprob, m


def _engine_pair(jprob, method, inv="lu"):
    jp = jax_problem_with(jprob, JF.SolveConfig(jnp.complex128, 0, method, inv))
    tp = convert.problem_from_arrays(problem_arrays(jprob),
                                     SolveConfig(torch.complex128, 0, method, inv),
                                     device="cpu")
    return jp, tp


def test_potential_and_gradient_match_jax(tiny):
    jprob, m = tiny
    jp, tp = _engine_pair(jprob, "bcr")
    (jU, _), jg = jax.jit(jax_vg(jp, 1.0))(jnp.asarray(m), jnp.asarray(m))
    mt = torch.as_tensor(m)
    (U, _), g = make_potential_vg(tp, 1.0)(mt, mt)
    assert relerr(U, jU) < TOL
    jg = np.asarray(jg)
    assert np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg) < GRAD_TOL


@pytest.mark.parametrize("method,inv", [("thomas_blocked", "lu"), ("thomas", "gj"),
                                        ("bcr", "gj"), ("thomas_blocked", "gj")])
def test_new_engines_potential_and_gradient_match_jax(tiny, method, inv):
    """Potential and gradient through the problem under thomas_blocked and
    the Gauss-Jordan inverse, against JAX's under the same engine."""
    jprob, m = tiny
    jp, tp = _engine_pair(jprob, method, inv)
    (jU, _), jg = jax.jit(jax_vg(jp, 1.0))(jnp.asarray(m), jnp.asarray(m))
    mt = torch.as_tensor(m)
    (U, _), g = make_potential_vg(tp, 1.0)(mt, mt)
    assert relerr(U, jU) < 1e-12
    jg = np.asarray(jg)
    assert np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg) < 1e-12


def test_stale_factor_potential_matches_jax(tiny):
    """The trajectory-amortised path: a bcr factor taken at m + 0.02,
    refined against the operator at m, on both sides."""
    jprob, m = tiny
    jp, tp = _engine_pair(jprob, "bcr")
    jU, _ = jax.jit(lambda mm, mf: jp.potential(mm, mm, 1.0, fac=jp.factor_state(mf)))(
        jnp.asarray(m), jnp.asarray(m) + 0.02)
    mt = torch.as_tensor(m)
    tU, _ = tp.potential(mt, mt, 1.0, fac=tp.factor_state(mt + 0.02))
    assert relerr(tU, jU) < TOL


def test_jv_through_a_bcr_factor_matches_jax(tiny):
    jprob, m = tiny
    jp, tp = _engine_pair(jprob, "bcr")
    v = np.random.default_rng(5).standard_normal(m.shape[1])
    want = jax.jit(lambda a, b: JJ.jv(jp, a, b))(jnp.asarray(m[0]), jnp.asarray(v))
    mt = torch.as_tensor(m[0])
    got = TJ.jv(tp, mt, torch.as_tensor(v), fac=tp.factor_state(mt))
    assert relerr(got, want) < JV_TOL


def test_jacobian_rows_match_thomas(tiny):
    """All rows of J from one bcr factor shared by each chunk's right-hand
    sides (the GN mass's path), against the thomas engine's."""
    jprob, m = tiny
    _, tp = _engine_pair(jprob, "bcr")
    _, ref = _engine_pair(jprob, "thomas")
    mt = torch.as_tensor(m[0])
    J = TJ.full_jacobian_chunked(tp, mt, chunk=7)
    assert relerr(J, TJ.full_jacobian_chunked(ref, mt, chunk=7)) < JV_TOL


@pytest.fixture(scope="module")
def te_only():
    jprob, m0 = _flagship_problem(tiny=True)
    arrays = survey_arrays(problem_arrays(jprob), ("ZXY",))
    jp = jax_problem_from_arrays(arrays, JF.SolveConfig(jnp.complex128, 0, "bcr"))
    tp = convert.problem_from_arrays(arrays, SolveConfig(torch.complex128, 0, "bcr"),
                                     device="cpu")
    return jp, tp, arrays, chain_models(np.asarray(m0), 2)


def test_one_mode_bcr_potential_matches_jax(te_only):
    jp, tp, _, m = te_only
    (jU, _), jg = jax.jit(jax_vg(jp, 0.7))(jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    mt = torch.as_tensor(m)
    (U, _), g = make_potential_vg(tp, 0.7)(mt, mt.flip(0))
    assert relerr(U, jU) < TOL
    jg = np.asarray(jg)
    assert np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg) < GRAD_TOL


def test_frequency_sharded_bcr_matches_single_process(te_only):
    """parallel/multichain.py under bcr: a (1 chain x 2 freq) mesh of gloo
    ranks sums the single process's potential and gradient."""
    _, tp, arrays, m = te_only
    outs = multichain.spawn_ranks(single_mode_freq_rank, 2, args=(arrays, m, "bcr"),
                                  backend="gloo", device="cpu", timeout_s=240.0)
    mt = torch.as_tensor(m)
    (U, (mis, mn, _)), g = make_potential_vg(tp, 1.0)(mt, mt.flip(0))
    for out in outs:
        for name, want in (("U", U), ("misfit", mis), ("mnorm", mn), ("grad", g)):
            assert relerr(out[name], want) < 1e-12, name


# -- the command line ------------------------------------------------------

CLI_ARGVS = [
    ["--solver", "bcr", "run", "s"],
    ["--solver", "bcr", "--inv", "lu", "run", "s"],
    ["--precision", "f32", "--refine", "2", "--solver", "bcr", "run", "s"],
    ["--precision", "f64", "--solver", "thomas", "--inv", "lu", "run", "s"],
    ["--precision", "f32", "--refine", "6", "--solver", "fused", "run", "s",
     "--warmup-solver", "bcr"],
    ["--precision", "f32", "--solver", "fused", "--inv", "lu", "run", "s"],
    ["--precision", "f32", "--solver", "bcr", "run", "s", "--warmup-solver", "fused"],
    ["--solver", "bcr", "run", "s", "--warmup-solver", "thomas"],
    ["--precision", "f64", "--solver", "fused", "run", "s", "--warmup-solver", "bcr"],
    ["--solver", "fused", "run", "s"],
]
# command lines naming grouped block Thomas or the Gauss-Jordan inverse
GJ_BLOCKED_ARGVS = [
    ["--solver", "thomas_blocked", "run", "s"],
    ["--precision", "f32", "--refine", "2", "--solver", "thomas_blocked", "run", "s",
     "--warmup-solver", "bcr"],
    ["--solver", "bcr", "--inv", "gj", "run", "s"],
    ["--precision", "f32", "--solver", "fused", "--inv", "gj", "run", "s"],
    ["--precision", "f64", "--solver", "thomas_blocked", "--inv", "gj", "run", "s"],
    ["--precision", "f32", "--refine", "6", "--solver", "fused", "--inv", "gj", "run", "s",
     "--warmup-solver", "bcr"],
    ["--solver", "thomas", "--inv", "gj", "run", "s", "--warmup-solver", "bcr"],
]


def _fields(cfg):
    if cfg is None:
        return None
    itemsize = (cfg.real_dtype.itemsize if isinstance(cfg.real_dtype, torch.dtype)
                else np.dtype(cfg.real_dtype).itemsize)
    return (cfg.solver_method, cfg.inv_method, cfg.refine_iters, itemsize,
            cfg.stale_refine_iters)


def _resolve(solve_cfg, warmup_cfg, args):
    try:
        cfg = solve_cfg(args)
    except SystemExit as e:
        return ("SystemExit", type(e).__name__)
    return _fields(cfg), _fields(warmup_cfg(args, cfg))


@pytest.mark.parametrize("argv", CLI_ARGVS + GJ_BLOCKED_ARGVS,
                         ids=[" ".join(a) for a in CLI_ARGVS + GJ_BLOCKED_ARGVS])
def test_cli_solve_config_matches_jax(argv):
    """The same argv through the port's and JAX's _solve_cfg and
    _warmup_cfg: equal field by field, the engine's inverse included
    (dtype by its width); a refused config is refused on both sides."""
    args = cli.build_parser().parse_args(argv)
    got = _resolve(lambda a: cli._solve_cfg(a, torch.device("cpu")), cli._warmup_cfg, args)
    jargs = argparse.Namespace(**vars(args))
    want = _resolve(JC._solve_cfg, JC._warmup_cfg, jargs)
    if args.warmup_solver == "auto" and want[0] != "SystemExit" and want[1] is not None:
        # the port's auto warmup engine is bcr, JAX's thomas (on purpose, below)
        assert want[1][0] == "thomas"
        want = (want[0], ("bcr",) + want[1][1:])
    assert got == want


def test_cli_engine_choices_match_jax():
    """--solver and --inv take the JAX CLI's names; --inv auto is LU."""
    args = cli.build_parser().parse_args(["run", "s"])
    assert cli._solve_cfg(args, torch.device("cpu")).inv_method == "lu"
    for flag, names in (("--solver", ["auto", "thomas", "thomas_blocked", "bcr", "fused"]),
                        ("--inv", ["auto", "lu", "gj"])):
        for name in names:
            assert getattr(cli.build_parser().parse_args([flag, name, "run", "s"]),
                           flag[2:]) == name
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([flag, "cholesky", "run", "s"])


def test_cli_default_engine_differs_from_jax_on_purpose():
    """Without --solver the CPU default is exact thomas in the port, bcr in
    JAX (a TPU-latency choice there); under a fused main engine the auto
    warmup engine is bcr in the port (faster on the card at the same
    accept), thomas in JAX."""
    args = cli.build_parser().parse_args(["run", "s"])
    assert cli._solve_cfg(args, torch.device("cpu")).solver_method == "thomas"
    assert JC._solve_cfg(args).solver_method == "bcr"
    args = cli.build_parser().parse_args(["--precision", "f32", "--solver", "fused", "run", "s"])
    cfg, jcfg = cli._solve_cfg(args, torch.device("cpu")), JC._solve_cfg(args)
    assert cli._warmup_cfg(args, cfg).solver_method == "bcr"
    assert JC._warmup_cfg(args, jcfg).solver_method == "thomas"


@pytest.fixture(scope="module")
def startup(tmp_path_factory):
    d = tmp_path_factory.mktemp("engines_cli")
    mesh, start_sig, data, obs, err = tiny_setup()
    tmesh, tdata = port_setup(mesh, data)
    write_model(d / "start.mod", tmesh, start_sig)
    write_data(d / "obs.dat", tdata, obs, err)
    (d / "startup").write_text(STARTUP)
    return d / "startup"


FUSED = ["--precision", "f32", "--refine", "6", "--solver", "fused"]


@pytest.mark.parametrize("flags,warmup,hybrid", [
    (["--solver", "bcr"], [], None),
    (FUSED, ["--warmup-solver", "bcr"], "bcr -> main engine fused"),
    (FUSED, [], "bcr -> main engine fused"),
    (FUSED, ["--warmup-solver", "thomas"], "thomas -> main engine fused"),
    (["--solver", "thomas_blocked"], [], None),
    (FUSED + ["--inv", "gj"], [], "bcr -> main engine fused"),
], ids=["bcr", "bcr-warmup-fused-main", "auto-warmup-fused-main",
        "thomas-warmup-fused-main", "thomas_blocked", "gj-auto-warmup-fused-main"])
def test_cli_runs_under_each_engine(startup, tmp_path, capsys, flags, warmup, hybrid):
    """``hmcmt2d-torch --device cpu`` runs the tiny problem to its output
    files: all of it on bcr or thomas_blocked (GN mass, amortised stale
    factors), or warmup and GN mass on bcr (asked for, or by default, with
    LU or, under --inv gj, Gauss-Jordan) or thomas and the rest on the
    fused path (the kernels' plain versions on the CPU)."""
    run = ["run", str(startup), "--outdir", str(tmp_path), "--samples", "8", *warmup]
    assert cli.main(["--device", "cpu", *flags, *run]) == 0
    log = capsys.readouterr().out
    assert f"solve={flags[flags.index('--solver') + 1]}" in log
    assert f"inv={'gj' if '--inv' in flags else 'lu'}" in log
    assert ("hybrid: warmup engine " + (hybrid or "")) in log if hybrid else "hybrid" not in log
    assert "dense mass (gn)" in log
    for i in (1, 2):
        stats = np.loadtxt(tmp_path / f"hmcstatistics_id{i}.log", skiprows=4, ndmin=2)
        assert stats.shape[0] == 8 and np.isfinite(stats).all()
    assert (tmp_path / "meanModel.model").exists()
