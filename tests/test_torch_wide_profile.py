"""The fused engine on a profile wider than its kernels' widest line.

A mode's interior system of ny_i x nz_i unknowns is factorised in its
ordering of least work (``fused_factor.line_axis``): its lines along the
longer axis, each of min(ny_i, nz_i) unknowns, along z (one line of ny_i
unknowns a z-row) when ny_i <= nz_i, else transposed, its lines along y.
A mesh of 132 x (6 + 2 air) cells (ny_i = 131 > Q_MAX, nz_i = 7) can only
be solved on y-lines.  Here, through the kernels' plain versions on the
CPU: the fused potential, gradient and predictions on that mesh against
the benchmark's plain reference (``benchmark/reference``) and the port's
exact thomas engine; the y-line factor-and-solve against the z-line one,
dprism2d's interior shape included; the orientation rule; the eval on
emulated CUDA graphs, with its launch counts on either axis; and the tool
that makes the full COPROD2 profile's model file.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import forward as RF
from benchmark.tools import widen_model as WM
from hmcmt2d_tpu_torch.ops import fused_factor as FF
from hmcmt2d_tpu_torch.ops import solver as S
from hmcmt2d_tpu_torch.sampler import graphed as G
from tests.torch_parity import (counted_plain_versions, emulated_graph_capture,
                                no_host_round_trip)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NY, NZ, AIR = 132, 6, (1000.0, 10000.0)
CFG = dict(model_file="wide.model", receivers={"count": 4, "first_y_m": -20000.0,
                                               "last_y_m": 20000.0},
           freqs_hz=[1.0, 0.1], components=["ZXY", "ZYX"], chains=2, noise=0.03,
           start_spread=0.01)
EXACT = dict(dtype="complex128", refine=0, method="thomas", inv="lu")
# the fused factor is complex64; six refinement steps against the complex128
# operator carry its solve to complex128 rounding, so the port reads as its
# exact engine does against the reference (benchmark/tests/
# test_harness_reference.py's limits); without them it reads ~2e-5
FUSED_128 = dict(dtype="complex128", refine=6, method="fused", inv="lu")
# the production setting: complex64 stencils, boundary fields and factor,
# refine 6; it reads U 1e-4, pred 2e-5, grad 1.4e-4 against the reference,
# the complex64 rest of the eval's rounding, which an unrefined factor
# hardly moves (FUSED_128 is the case that needs the refinement)
FUSED_64 = dict(dtype="complex64", refine=6, method="fused", inv="lu")
TOL = {"exact": dict(U=1e-10, pred=1e-10, grad=1e-9),
       "complex64": dict(U=1e-3, pred=2e-4, grad=1e-3)}
PER_EVAL = {"schur_factor": 1, "bt_sweep_fwd": 14, "bt_sweep_bwd": 14}


def write_wide_model(path: Path, seed: int = 0, ny: int = NY) -> None:
    """ny (132) x 6 cells under 2 air layers, 400 m core cells, a seeded
    random log-conductivity (0.7 of a log unit about 0.01 S/m)."""
    rng = np.random.default_rng(seed)
    dy = np.array([3200.0, 1600, 800] + [400.0] * (ny - 6) + [800, 1600, 3200])
    dz = np.array([200.0, 300, 500, 800, 1500, 3000])
    sig = 0.01 * np.exp(0.7 * rng.standard_normal((NZ, ny)))
    lines = ["#Format: EMModel2DFile", f"NY: {ny}", " ".join(f"{v:.2f}" for v in dy),
             f"NAIR: {len(AIR)}", " ".join(f"{v:.2f}" for v in AIR), f"NZ: {NZ}",
             " ".join(f"{v:.2f}" for v in dz), "Resistivity Type: Conductivity",
             "Model Type: Linear"]
    lines += [" ".join(f"{v:.4e}" for v in row) for row in sig]
    lines.append(f"Origin (m): {dy.sum() / 2:.6e} 0.00e+00")
    path.write_text("\n".join(lines) + "\n")


def _mesh_inputs(root: Path, ny: int, cfg: dict):
    """A mesh of ny x (6 + 2 air) cells under ``root`` and its inputs
    (observations from the reference at the model, seed 5)."""
    write_wide_model(root / cfg["model_file"], ny=ny)
    return harness.make_inputs(root, cfg, 5, CPU)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The wide mesh's inputs, the reference over them, and two models 0.3
    of a log unit off the model."""
    root = tmp_path_factory.mktemp("wide")
    inp = _mesh_inputs(root, NY, CFG)
    ref = RF.Reference(inp.model, inp.rx_y, inp.freqs, CPU, obs=inp.obs,
                       weights=1.0 / inp.err, reg=1.0)
    gen = torch.Generator().manual_seed(0)
    m = ref.true_m()[None] + 0.3 * torch.randn((2, ref.n_param), generator=gen,
                                               dtype=torch.float64)
    return root, inp, ref, m, inp.m_start.double()


def _eval(wide, solve):
    root, inp, _, m, m_ref = wide
    problem, _ = harness.build_problem(root, CFG, inp, solve, CPU)
    rdt = torch.float32 if solve["dtype"] == "complex64" else torch.float64
    (U, (_, _, pred)), g = problem.potential_value_and_grad(m.to(rdt), m_ref.to(rdt), 1.0)
    return problem, (U.double(), pred.to(torch.complex128), g.double())


def _gaps(got, want) -> dict:
    (U, pred, g), (U2, pred2, g2) = got, want
    return dict(U=float(((U - U2).abs() / U2.abs()).max()),
                pred=float((pred - pred2).abs().max() / pred2.abs().max()),
                grad=float((g - g2).norm() / g2.norm()))


def test_the_mesh_is_wider_than_the_kernels(wide):
    """The port reads the mesh as the reference does, its z-lines wider
    than the kernels take and its y-lines narrow enough."""
    root, inp, ref, *_ = wide
    problem, m0 = harness.build_problem(root, CFG, inp, FUSED_64, CPU)
    assert (problem.mesh.ny - 1, problem.mesh.nz - 1) == (NY - 1, NZ + len(AIR) - 1)
    assert np.array_equal(m0, ref.true_m().numpy())
    assert FF.line_axis(problem.mesh.nz - 1, problem.mesh.ny - 1) == "y"


@pytest.mark.parametrize("solve,tol", [(FUSED_128, "exact"), (EXACT, "exact"),
                                       (FUSED_64, "complex64")],
                         ids=["fused-c128", "thomas-c128", "fused-c64"])
def test_wide_eval_matches_the_reference(wide, solve, tol):
    """Potential, predictions and gradient against the plain reference in
    complex128 (block Thomas over z-lines of 131, pivoted inverses)."""
    _, _, ref, m, m_ref = wide
    _, got = _eval(wide, solve)
    U, _, _, pred, g = ref.value_and_grad(m, m_ref)
    gaps = _gaps(got, (U, pred, g))
    assert all(gaps[k] < TOL[tol][k] for k in gaps), gaps


@pytest.mark.parametrize("solve,tol", [(FUSED_128, "exact"), (FUSED_64, "complex64")],
                         ids=["c128", "c64"])
def test_wide_fused_eval_matches_the_thomas_engine(wide, solve, tol):
    """The fused engine on y-lines against the port's thomas engine on
    z-lines in complex128 (LU inverses of 131-wide blocks)."""
    _, got = _eval(wide, solve)
    _, want = _eval(wide, EXACT)
    gaps = _gaps(got, want)
    assert all(gaps[k] < TOL[tol][k] for k in gaps), gaps


def _system(batch, nzi, nyi, seed):
    """A random equilibration-ready interior system (diagonally dominant,
    complex128) and a right-hand side."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(batch + shape, generator=gen, dtype=torch.float64)

    sys_ = S.InteriorSystem(torch.complex(4 + 0.1 * r(nzi, nyi), 0.5 * r(nzi, nyi)),
                            1 + 0.1 * r(nzi, nyi - 1), 1 + 0.1 * r(nzi - 1, nyi))
    return sys_, torch.complex(r(nzi, nyi), r(nzi, nyi))


def _factor_on(sys_: S.InteriorSystem, lines: str) -> S.Factorization:
    """The fused factor of ``sys_`` on lines along ``lines``, whatever its
    shape: what ``factorize`` builds for a system whose shorter side is
    that axis's, called directly."""
    ssys, s = S.equilibrate(sys_)
    fac = FF.fused_schur_factor(*(S.transposed(ssys) if lines == "y" else ssys), lines=lines)
    return S.Factorization(fac, s)


@pytest.mark.parametrize("batch,nzi,nyi", [((3,), 6, 9), ((2, 2), 5, 5), ((1,), 2, 4)])
def test_y_lines_solve_the_system_the_z_lines_solve(batch, nzi, nyi):
    """Where both orientations fit, the y-line factor-and-solve equals the
    z-line one: refined six times in complex128 both reach the solution to
    complex128 rounding; unrefined, each complex64 factor holds it to
    complex64's (they round apart: the orderings differ)."""
    sys_, b = _system(batch, nzi, nyi, 7)
    f_z, f_y = _factor_on(sys_, "z"), _factor_on(sys_, "y")
    assert (f_z.fac.lines, f_y.fac.lines) == ("z", "y")
    assert f_y.fac.G.shape == (int(np.prod(batch)), nyi, nzi, nzi)
    assert S.factorize(sys_, method="fused").fac.lines == FF.line_axis(nzi, nyi)
    exact = S.factor_solve(S.factorize(sys_), b)
    for f in (f_z, f_y):
        x = S.refined_solve(sys_, f, b, iters=6)
        assert float((x - exact).norm() / exact.norm()) < 1e-13
        assert float((S.factor_solve(f, b) - exact).norm() / exact.norm()) < 1e-5


@pytest.mark.parametrize("lines", ["z", "y"])
def test_both_orientations_solve_a_dprism2d_shaped_system(lines):
    """dprism2d's interior, 55 x 95, at B = 2 in complex128: its least-work
    factor (``factorize``: 95 lines of 55 along y) and the z-line factor
    (55 lines of 95, which no cell runs any more), each refined six times,
    agree with complex128 thomas to 1e-12."""
    sys_, b = _system((2,), 55, 95, 11)
    f = S.factorize(sys_, method="fused") if lines == "y" else _factor_on(sys_, "z")
    assert f.fac.lines == lines
    assert f.fac.G.shape == ((2, 95, 55, 55) if lines == "y" else (2, 55, 95, 95))
    exact = S.factor_solve(S.factorize(sys_), b)
    x = S.refined_solve(sys_, f, b, iters=6)
    assert float((x - exact).norm() / exact.norm()) < 1e-12


def test_y_line_factor_serves_a_wider_batch_of_right_hand_sides():
    """The GN build's and ``jv``'s case: one factor, right-hand sides on a
    wider batch axis, swept one index at a time in the factor's layout."""
    sys_, _ = _system((1, 1), 4, 131, 3)
    f = S.factorize(sys_, dtype=torch.complex64, method="fused")
    assert f.fac.lines == "y"
    b = torch.randn((5, 1, 1, 4, 131), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(4))
    exact = S.factor_solve(S.factorize(sys_), b)
    x = S.refined_solve(sys_, f, b, iters=6)
    assert x.shape == b.shape
    assert float((x - exact).norm() / exact.norm()) < 1e-13


@pytest.mark.parametrize("nzi,nyi,lines", [
    (55, 95, "y"), (51, 75, "y"),           # dprism2d's and coprod2's interiors
    (51, 225, "y"), (7, 131, "y"), (FF.Q_MAX, FF.Q_MAX + 1, "y"), (1, FF.Q_MAX, "y"),
    (FF.Q_MAX + 40, FF.Q_MAX, "z"),
    (10, 10, "z"), (FF.Q_MAX, FF.Q_MAX, "z"),   # ties keep z
    (FF.Q_MAX + 1, 60, "z"), (60, FF.Q_MAX + 1, "y")])   # only the shorter side fits
def test_orientation_rule(nzi, nyi, lines):
    """The ordering of least work: lines along the longer axis, each of
    min(ny_i, nz_i) unknowns; a tie keeps z; the longer side may be wider
    than the kernels."""
    assert FF.line_axis(nzi, nyi) == lines


def test_orientation_rule_refuses_a_system_too_wide_both_ways():
    with pytest.raises(ValueError, match=r"ny_i = 130 .* nz_i = 129"):
        FF.line_axis(129, 130)
    sys_, _ = _system((1,), 129, 130, 0)
    with pytest.raises(ValueError, match="nz_i = 129"):
        S.factorize(sys_, dtype=torch.complex64, method="fused")


def _flagship():
    from hmcmt2d_tpu_torch import entry
    from hmcmt2d_tpu_torch.models.forward import SolveConfig

    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(torch.complex64, 6, "fused"))
    m = torch.as_tensor(m0, dtype=torch.float32)[None].expand(2, -1).contiguous()
    return prob, m, m


def _tall(root: Path):
    """A mesh of 7 x (6 + 2 air) cells, interiors of ny_i = 6 < nz_i = 7
    (lines along z), under the fused production setting; chain 1's start
    for both models."""
    cfg = {**CFG, "receivers": {"count": 4, "first_y_m": -3000.0, "last_y_m": 3000.0}}
    inp = _mesh_inputs(root, 7, cfg)
    prob, _ = harness.build_problem(root, cfg, inp, FUSED_64, CPU)
    m = inp.m_start.float()
    return prob, m, m


@pytest.mark.parametrize("case,lines", [("wide", "y"), ("flagship", "y"), ("tall", "z")])
def test_graphed_eval_on_emulated_graphs_counts_its_lines(wide, case, lines, monkeypatch,
                                                          tmp_path):
    """The graphed fused eval on the CPU's emulated graphs: after its first
    call it reads nothing back to the host, and each replay counts one
    factor and 14 sweep pairs (refine 6, two solves) whichever axis its
    lines lie along: y on the wide mesh and on the tiny flagship's 10 x 11
    interiors, z on the tall mesh."""
    if case == "wide":
        root, inp, _, m, m_ref = wide
        prob, _ = harness.build_problem(root, CFG, inp, FUSED_64, CPU)
        m, m_ref = m.float(), m_ref.float()
    elif case == "flagship":
        prob, m, m_ref = _flagship()
    else:
        prob, m, m_ref = _tall(tmp_path)
    assert FF.line_axis(prob.mesh.nz - 1, prob.mesh.ny - 1) == lines
    monkeypatch.setattr(G, "unservable", lambda problem: None)
    monkeypatch.setattr(G, "capture", emulated_graph_capture)
    with counted_plain_versions():
        vg = G.GraphedPotential(prob, 1.0)
        (U0, _), g0 = vg(m, m_ref)
        assert FF.launches() == PER_EVAL
        with no_host_round_trip() as made:
            (U1, _), g1 = vg(m, m_ref)
        assert made == []
        assert FF.launches() == {k: 2 * n for k, n in PER_EVAL.items()}
        (cap,) = vg.captures.values()
        assert cap.launches == PER_EVAL
    assert torch.equal(U0, U1) and torch.equal(g0, g1)


@pytest.fixture(scope="module")
def widened():
    return WM.read_blocks(WM.SOURCE), WM.read_blocks(WM.OUT), WM.widen(WM.read_blocks(WM.SOURCE))


def test_widened_model_file_is_the_tools_output(widened):
    """The committed model file is what the tool writes, and both readers
    read it as 226 columns over 45 earth rows and 7 air layers: interior
    systems of 225 x 51, lines along y."""
    src, out, w = widened
    assert WM.OUT.read_text() == WM.render(w)
    model = RF.read_model(WM.OUT)
    assert (model.ny, model.nz, model.n_air) == (226, 52, 7)
    assert (model.sigma != RF.SIGMA_AIR).sum() == 226 * 45
    assert FF.line_axis(model.nz - 1, model.ny - 1) == "y"
    cfg = json.loads((ROOT / "benchmark/configs/coprod2_full.json").read_text())
    y = model.y_node()
    core = (y[WM.PAD], y[-WM.PAD - 1])
    rx = cfg["receivers"]
    assert core == (-12000.0, 412000.0)
    assert (rx["first_y_m"], rx["last_y_m"]) == (core[0] + 12000.0, core[1] - 12000.0)


def test_widened_model_keeps_the_examples_cells_and_values(widened):
    """The padding columns and their values are the example's, the core
    cells 2 km, every core value one of the example's core column at the
    nearest relative position, and the air layers and rows unchanged."""
    src, out, w = widened
    pad = WM.PAD
    assert np.array_equal(out["NY"][:pad], src["NY"][:pad])
    assert np.array_equal(out["NY"][-pad:], src["NY"][-pad:])
    assert np.all(out["NY"][pad:-pad] == 2000.0) and len(out["NY"]) == 226
    assert np.array_equal(out["NZ"], src["NZ"]) and np.array_equal(out["NAIR"], src["NAIR"])
    assert np.array_equal(out["sigma"][:, :pad], src["sigma"][:, :pad])
    assert np.array_equal(out["sigma"][:, -pad:], src["sigma"][:, -pad:])
    cols = w["core_columns"]
    assert np.array_equal(out["sigma"][:, pad:-pad], src["sigma"][:, pad:-pad][:, cols])
    assert cols[0] == 0 and cols[-1] == 61 and np.all(np.diff(cols) >= 0)
    assert np.all(np.bincount(cols, minlength=62) >= 3)
