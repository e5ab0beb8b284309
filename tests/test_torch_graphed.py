"""The graphed eval's CPU side: the fused eval, and every warmup engine's
(thomas, thomas_blocked and bcr, each with LU and with Gauss-Jordan) fresh
eval, factor and stale-factor eval, make no host round trip after their
first call (what a CUDA graph's capture needs); the LU inverse they take
equals ``torch.linalg.inv``; ``make_potential_vg`` picks the graphs for
every engine on a CUDA problem and the eager closure on a CPU one; the
graphed potential refuses a factor its factor graph did not make; and the
launch counts a replay adds.  The graphs themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 12 and 13).

The port runs the tiny flagship under the fused config (complex64 factors,
refine 6) on the CPU, through the kernels' plain versions; JAX runs the
same config with its Pallas kernels in interpret mode (Q = 32, PANEL = 8),
as ``tests/test_torch_fused.py`` does, and the eager eval is held to it with
that file's tolerances (U_TOL, GRAD_TOL, COS_MIN).
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.models.forward import SolveConfig as JaxConfig  # noqa: E402
from hmcmt2d_tpu.ops import pallas_factor as PF  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert, entry  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as S  # noqa: E402
from hmcmt2d_tpu_torch.sampler import graphed as G  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import (BatchedSampler, make_factor_fn,  # noqa: E402
                                              make_potential_vg, no_stale_factor)
from tests.torch_parity import (chain_models, emulated_capture, jax_problem_with,  # noqa: E402
                                no_host_round_trip, problem_arrays, tensors)

U_TOL = 1e-4      # tests/test_torch_fused.py's limits for the fused config
GRAD_TOL = 1e-3
COS_MIN = 0.9999
FUSED = SolveConfig(torch.complex64, 6, "fused")
SURVEYS = {"two_modes": dict(),
           "te_tipper": dict(data_comp=("ZXY", "TZY"), data_type="Impedance_Tipper"),
           "tm_rho_phase": dict(data_comp=("RhoYX", "PhsYX"), data_type="Rho_Phs")}
# the warmup engines, each with both inverses
ENGINES = [(method, inv) for method in ("thomas", "thomas_blocked", "bcr")
           for inv in ("lu", "gj")]


@pytest.mark.parametrize("survey", sorted(SURVEYS))
def test_fused_eval_makes_no_host_round_trip_after_its_first(survey):
    """After a first eval (which builds the problem's device constants), a
    fused eval of each survey kind reads nothing back to the host and copies
    nothing from it: the condition for capturing it as a CUDA graph.  The
    plain kernel versions it runs here read nothing either, so nothing is
    left out of the patch."""
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu", cfg=FUSED,
                                      **SURVEYS[survey])
    m = torch.as_tensor(chain_models(m0, 2).astype(np.float32))
    vg = make_potential_vg(prob, 1.0)
    (U0, _), g0 = vg(m, m)
    with no_host_round_trip() as made:
        (U1, (mis, mn, pred)), g1 = vg(m, m)
    assert made == []
    assert torch.equal(U0, U1) and torch.equal(g0, g1)
    assert pred.shape == (2, prob.fwd.data.n_data)


def test_host_reads_are_refused_inside_the_patch():
    """The patch catches what it names (a control for the test above)."""
    t = torch.ones(2)
    with no_host_round_trip() as made:
        for read in (lambda: t.sum().item(), lambda: bool(t.all()),
                     lambda: int(t[0]), lambda: float(t[0]), t.tolist, t.numpy):
            with pytest.raises(AssertionError, match="host round trip"):
                read()
        with pytest.raises(AssertionError, match="host round trip"):
            torch.linalg.inv(torch.eye(2))
        torch.as_tensor(np.zeros(2))
        torch.as_tensor(t)
    assert made == [("as_tensor", "ndarray")]


@pytest.mark.parametrize("method,inv", ENGINES)
def test_engine_evals_and_factor_make_no_host_round_trip_after_their_first(method, inv):
    """Each warmup engine under each inverse (gj through its plain version
    here), complex64 refined 6 times on the tiny flagship: after a first
    call of each, the fresh eval, ``factor_state`` and the stale-factor
    eval read nothing back to the host and copy nothing from it, and give
    what they gave the first time."""
    cfg = SolveConfig(torch.complex64, 6, method, inv)
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu", cfg=cfg)
    m = torch.as_tensor(chain_models(m0, 2).astype(np.float32))
    vg = make_potential_vg(prob, 1.0)
    factor = make_factor_fn(prob, vg)
    assert factor == prob.factor_state
    first = (vg(m, m), factor(m + 0.01))
    first += (vg(m, m, first[1]),)
    with no_host_round_trip() as made:
        again = (vg(m, m), factor(m + 0.01))
        again += (vg(m, m, again[1]),)
    assert made == []
    for x, y in ((first[0], again[0]), (first[2], again[2])):
        (Ux, auxx), gx = x
        (Uy, auxy), gy = y
        assert torch.equal(Ux, Uy) and torch.equal(gx, gy)
        assert all(torch.equal(p, q) for p, q in zip(auxx, auxy))
    fa, fb = (tensors(f) for f in (first[1], again[1]))
    assert len(fa) == len(fb) and all(torch.equal(p, q) for p, q in zip(fa, fb))
    # the stale factor's 10 refinement steps reach the fresh eval's value
    (U, _), _ = first[0]
    (Us, _), _ = first[2]
    assert float(((Us - U).abs() / U.abs()).max()) < U_TOL


def test_forward_constants_are_built_once():
    """The angular frequencies and the data's flat index are device
    tensors built once per key, with the values of the formula."""
    prob, _ = entry.flagship_problem(tiny=True, device="cpu", cfg=FUSED)
    fwd = prob.fwd
    sig = torch.ones(2, 3, dtype=torch.float64)
    om = fwd._omegas(sig)
    assert fwd._omegas(sig) is om
    assert torch.equal(om, 2.0 * np.pi * torch.as_tensor(fwd.data.freqs))
    sub = fwd._omegas(sig, fwd.data.freqs[1:3])
    assert torch.equal(sub, om[1:3])
    assert fwd._omegas(sig.float()).dtype == torch.float32
    cube = torch.arange(2 * fwd.data.n_freq * fwd.data.n_rx * fwd.data.n_comp)
    cube = cube.reshape(2, fwd.data.n_freq, fwd.data.n_rx, fwd.data.n_comp)
    want = cube.reshape(2, -1)[:, torch.as_tensor(fwd.data.flat_index)]
    fwd_pred = type(fwd).predict
    fwd_cube = types.SimpleNamespace(response_cube=lambda s, fac=None: cube,
                                     _cached=fwd._cached, data=fwd.data)
    assert torch.equal(fwd_pred(fwd_cube, sig), want)


@pytest.fixture(scope="module")
def jax_case():
    mp = pytest.MonkeyPatch()
    mp.setattr(PF, "Q", 32)
    mp.setattr(PF, "PANEL", 8)
    mp.setattr(PF, "INTERPRET", True)
    try:
        jprob, m0 = _flagship_problem(tiny=True)
        jfused = jax_problem_with(jprob, JaxConfig(jnp.complex64, 6, "fused"))
        m = chain_models(m0, 2).astype(np.float32)
        (U, _), g = jax.jit(jax_vg(jfused, 1.0))(jnp.asarray(m), jnp.asarray(m))
    finally:
        mp.undo()
    tprob = convert.problem_from_arrays(problem_arrays(jprob), cfg=FUSED, device="cpu")
    return dict(U=np.asarray(U), g=np.asarray(g).astype(np.float64), tprob=tprob,
                m=torch.as_tensor(m))


def test_cpu_problem_gets_the_eager_closure(jax_case):
    """On the CPU ``make_potential_vg`` is the eager closure, bit-equal to
    ``potential_value_and_grad`` and within test_torch_fused.py's limits of
    JAX's fused eval."""
    prob, m = jax_case["tprob"], jax_case["m"]
    vg = make_potential_vg(prob, 1.0)
    assert not isinstance(vg, G.GraphedPotential)
    assert G.unservable(prob) is not None
    (U, aux), g = vg(m, m)
    (U2, aux2), g2 = prob.potential_value_and_grad(m, m, 1.0)
    assert torch.equal(U, U2) and torch.equal(g, g2)
    assert all(torch.equal(a, b) for a, b in zip(aux, aux2))
    (U3, _), g3 = make_potential_vg(prob, 1.0, graphed=False)(m, m)
    assert torch.equal(U3, U) and torch.equal(g3, g)
    assert (np.abs(U.numpy() - jax_case["U"]) / np.abs(jax_case["U"])).max() < U_TOL
    tg = g.double().numpy()
    assert np.linalg.norm(tg - jax_case["g"]) / np.linalg.norm(jax_case["g"]) < GRAD_TOL
    for a, b in zip(tg, jax_case["g"]):
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > COS_MIN


def _on_card(method: str, inv: str = "lu"):
    """A stand-in problem that reports a CUDA device and an engine; the
    dispatch reads nothing else, and nothing here touches a card."""
    cfg = SolveConfig(torch.complex64, 6, method, inv)
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 fwd=types.SimpleNamespace(cfg=cfg),
                                 factor_state=lambda m: None)


@pytest.mark.parametrize("method,inv", ENGINES + [("fused", "lu")])
def test_graphed_serves_every_engine_on_the_card(method, inv):
    """Every engine and inverse on a CUDA problem gets the graphs by
    default, and with graphed=True, and graphed=False keeps the eager
    closure; either way the sampler's factor hook on the card makes no
    stale factor (every eval fresh).  graphed=True raises on a CPU problem,
    whose default is eager."""
    prob = _on_card(method, inv)
    for graphed in (None, True):
        vg = make_potential_vg(prob, 1.0, graphed=graphed)
        assert isinstance(vg, G.GraphedPotential) and vg.captures == {}
        assert make_factor_fn(prob, vg) is no_stale_factor
    assert no_stale_factor(torch.zeros(2, 3)) is None
    eng = BatchedSampler(prob, 1.0, amortize=True)
    assert isinstance(eng.potential_vg, G.GraphedPotential)
    assert eng.factor_fn is no_stale_factor and eng.release() == []
    eager = BatchedSampler(prob, 1.0, amortize=True, graphed=False)
    assert not isinstance(eager.potential_vg, G.GraphedPotential)
    assert eager.factor_fn is no_stale_factor and eager.release() == []
    assert BatchedSampler(prob, 1.0, amortize=False).factor_fn is None
    cpu = types.SimpleNamespace(device=torch.device("cpu"), fwd=prob.fwd)
    with pytest.raises(ValueError, match="CUDA problem"):
        make_potential_vg(cpu, 1.0, graphed=True)
    assert not isinstance(make_potential_vg(cpu, 1.0), G.GraphedPotential)


def test_fused_cuda_problem_gets_the_graph_by_default():
    """The default serves a CUDA problem on the fused engine from the graph
    (built lazily: nothing is captured before the first call), False gives
    the eager closure, and a stale factor it did not make is refused."""
    prob = _on_card("fused")
    vg = make_potential_vg(prob, 1.0)
    assert isinstance(vg, G.GraphedPotential) and vg.captures == {}
    assert not isinstance(make_potential_vg(prob, 1.0, graphed=False), G.GraphedPotential)
    m = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="stale factor"):
        vg(m, m, fac=object())
    with pytest.raises(ValueError, match="problem is on"):
        vg(m, m)
    with pytest.raises(ValueError, match="problem is on"):
        vg.factor(m)
    assert vg.captures == {}


def _stand_in_capture(kind: str, out) -> G.Capture:
    return G.Capture(kind, None, (torch.zeros(2, 3),), out, {}, {}, 0.0, 0)


def test_graphed_potential_refuses_a_foreign_factor():
    """The stale eval takes only the static output of its own factor graph:
    an eager factor of the same model, another graph's factor, or its own
    factor after ``release`` dropped the graph, all raise before anything
    is captured or replayed."""
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(torch.complex64, 6, "bcr"))
    m = torch.as_tensor(chain_models(m0, 2).astype(np.float32))
    eager_fac = prob.factor_state(m)
    vg, other = G.GraphedPotential(_on_card("bcr"), 1.0), G.GraphedPotential(_on_card("bcr"), 1.0)
    own = ("factor",) + G._signature(m)
    vg.captures[own] = _stand_in_capture("factor", eager_fac)
    other_fac = prob.factor_state(m + 0.01)
    other.captures[own] = _stand_in_capture("factor", other_fac)
    assert vg._factor_key(eager_fac) == own       # its own static output
    for foreign in (prob.factor_state(m), other_fac, eager_fac._replace(s=eager_fac.s)):
        with pytest.raises(ValueError, match="stale factor that this graphed eval"):
            vg(m, m, foreign)
    # an eval capture's output is no factor
    vg.captures[("eval",) + G._signature(m, m)] = _stand_in_capture("eval", other_fac)
    with pytest.raises(ValueError, match="stale factor"):
        vg(m, m, other_fac)
    summaries = vg.release()
    assert [c["kind"] for c in summaries] == ["factor", "eval"] and vg.captures == {}
    with pytest.raises(ValueError, match="stale factor"):
        vg(m, m, eager_fac)


@pytest.mark.parametrize("method,inv", [("thomas", "lu"), ("bcr", "gj")])
def test_graphed_trajectory_with_emulated_graphs_equals_eager(method, inv, monkeypatch):
    """The graphed potential's bookkeeping, with each capture emulated on
    the CPU by a graph that reruns its function into static buffers: an
    amortised leapfrog (5 steps, refactoring every 2) through the fresh
    eval, the factor graph and the stale eval graph equals the eager one
    bit for bit, so the stale eval reads the factor graph's outputs as the
    last factor replay left them; a factor is the graph's one static
    output, and each eval returns fresh tensors."""
    from hmcmt2d_tpu_torch.sampler import hmc as H

    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(torch.complex64, 6, method, inv))
    monkeypatch.setattr(G.GraphedPotential, "_capture", emulated_capture)
    vg = G.GraphedPotential(_on_card(method, inv), 1.0)
    vg.problem = prob                      # served on the CPU by the emulation
    eager = make_potential_vg(prob, 1.0, graphed=False)
    rng = np.random.default_rng(8)
    m = torch.as_tensor(m0 + 0.1 * rng.standard_normal((2, len(m0))), dtype=torch.float32)
    p0 = torch.as_tensor(np.clip(rng.standard_normal(m.shape), -2.5, 2.5), dtype=torch.float32)
    opts = H.HMCOptions(dt=0.02, steps_lo=5, steps_hi=5, log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0, refactor_every=2)
    mass = H.identity_mass(len(m0), torch.float32, "cpu")
    runs = []
    for fn, factor in ((vg, make_factor_fn(prob, vg)), (eager, make_factor_fn(prob))):
        state = H.sample_chain_init(fn, m, m)
        prop, p1 = H._leapfrog(fn, opts, mass, state, p0, m, 5, opts.dt, factor_fn=factor)
        runs.append(tuple(prop) + (p1,))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert sorted(c.kind for c in vg.captures.values()) == ["eval", "factor", "stale"]
    fac = vg.factor(m)
    assert vg.factor(m + 0.01) is fac
    (U1, _), g1 = vg(m, m, fac)
    (U2, _), g2 = vg(m, m, fac)
    assert torch.equal(U1, U2) and U1 is not U2 and g1 is not g2
    assert len(vg.captures) == 3


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_lu_inverse_equals_linalg_inv_at_a_thomas_line(dtype):
    """The engines' LU inverse is ``torch.linalg.inv`` without its error
    check: bit for bit at q = 95 on a flagship thomas line's batch (C = 8
    chains x 11 frequencies x 2 modes)."""
    rng = np.random.default_rng(3)
    n, B = 95, 176
    a = (rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
         + 4 * n * np.eye(n)) / n
    A = torch.as_tensor(a, dtype=dtype)
    assert S.INV_FN["lu"] is S.lu_inverse
    assert torch.equal(S.lu_inverse(A), torch.linalg.inv(A))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_lu_inverse_equals_linalg_inv_at_each_bcr_level(dtype):
    """Every batch of blocks a bcr factor inverts (the tiny flagship's
    levels, batch (nfreq, C, modes, lines), q = 11) gives the same bits
    under ``lu_inverse`` and ``torch.linalg.inv``, and so the same factor."""
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(dtype, 6, "bcr"))
    m = torch.as_tensor(chain_models(m0, 2).astype(np.float32))
    seen = []

    def recorded(A):
        X = S.lu_inverse(A)
        assert torch.equal(X, torch.linalg.inv(A))
        seen.append(tuple(A.shape))
        return X

    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(S.INV_FN, "lu", recorded)
        fac = prob.factor_state(m)
    finally:
        mp.undo()
    nzi = prob.mesh.nz - 1
    assert len(seen) == nzi.bit_length() == len(fac.fac.levels)
    assert seen[0][:-3] == (prob.fwd.data.n_freq, 2, 2)
    assert all(torch.equal(x, y) for x, y in zip(tensors(fac), tensors(prob.factor_state(m))))


def test_lu_inverse_of_a_singular_block_is_not_finite():
    """A singular block gives non-finite values where ``torch.linalg.inv``
    raises (as JAX's ``jnp.linalg.inv``), and the other blocks of the batch
    their inverses."""
    A = torch.eye(3, dtype=torch.complex64).repeat(2, 1, 1)
    A[1] = 0
    X = S.lu_inverse(A)
    assert torch.equal(X[0], A[0]) and not bool(torch.isfinite(X[1]).all())
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.inv(A)


@pytest.mark.parametrize("method,per_factor", [("thomas", 55), ("thomas_blocked", 55),
                                               ("bcr", 6)])
def test_gj_factor_replay_counts_its_inverses(method, per_factor):
    """A factor under ``inv_method="gj"`` at the flagship's 55 z-lines
    inverts its blocks in 55 batched calls (thomas, thomas_blocked: one a
    line) or 6 (bcr: one a level), each one ``gj_inverse`` launch on the
    card; a factor graph's capture records that delta, and each replay adds
    it."""
    rng = np.random.default_rng(7)
    nzi, q = 55, 4
    sys_ = S.InteriorSystem(
        torch.as_tensor(4.0 + rng.standard_normal((2, nzi, q))
                        + 0.5j * rng.standard_normal((2, nzi, q))),
        torch.as_tensor(1.0 + 0.1 * rng.standard_normal((2, nzi, q - 1))),
        torch.as_tensor(1.0 + 0.1 * rng.standard_normal((2, nzi - 1, q))))
    calls = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(S.INV_FN, "gj", lambda A: calls.append(A.shape) or FF.gj_inverse(A))
        S.factorize(sys_, dtype=torch.complex64, method=method, inv_method="gj")
    finally:
        mp.undo()
    assert len(calls) == per_factor
    FF.reset_launches()
    delta = FF.launch_delta(FF.launches(), {"gj_inverse": len(calls)})
    for k in (1, 2, 3):
        FF.add_launches(delta)
        assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0,
                                 "gj_inverse": k * per_factor}
    FF.reset_launches()


@pytest.mark.parametrize("k", [0, 1, 2, 7])
def test_replayed_launches_add_the_capture_delta(k):
    """A capture that moved the counts by (1, 14, 14), replayed k times,
    reads k x (1, 14, 14); a polish or gj_inverse delta counts apart."""
    FF.reset_launches()
    before = FF.launches()
    after = {"schur_factor": 1, "bt_sweep_fwd": 14, "bt_sweep_bwd": 14}
    delta = FF.launch_delta(before, after)
    assert delta == after
    for _ in range(k):
        FF.add_launches(delta)
    assert FF.launches() == {name: k * n for name, n in after.items()}
    FF.add_launches({"schur_factor_polish": 2, "gj_inverse": 3})
    assert FF.launches() == {**{name: k * n for name, n in after.items()},
                             "schur_factor_polish": 2, "gj_inverse": 3}
    FF.add_launches(FF.launch_delta(FF.launches(), before))
    assert FF.launches() == before
    FF.reset_launches()


def test_hybrid_run_on_emulated_graphs_equals_eager_and_releases_them(monkeypatch, capsys):
    """A whole hybrid run (warmup on complex64 thomas, trajectory-amortised;
    the rest on complex128 thomas) with every eval served by the graphed
    potential, its captures emulated on the CPU, equals the eager run bit
    for bit; at the switch the warmup engine's three graphs (fresh eval,
    factor, stale eval) are released and logged with their pool bytes."""
    from hmcmt2d_tpu_torch.io import HMCConfig
    from hmcmt2d_tpu_torch.sampler import driver as D
    from tests.test_e2e import tiny_setup
    from tests.torch_parity import port_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    tmesh, tdata = port_setup(mesh, data)
    cfg = HMCConfig(burnin=4, total_samples=8, sig_bounds=(1e-4, 10.0), dt=0.05,
                    timestep=(2, 3), reg_param=1.0, seed=0, adapt=True)

    def run():
        return D.run_inversion(cfg, tmesh, start_sig, tdata, obs, err, n_chains=2,
                               device="cpu", solve_cfg=SolveConfig(torch.complex128, 0),
                               warmup_solve_cfg=SolveConfig(torch.complex64, 3, "thomas"),
                               verbose=True)

    eager = run().result
    capsys.readouterr()
    made = []

    def capture(self, kind, fn, inputs):
        made.append((self.problem.fwd.cfg.solver_method, self.problem.fwd.cfg.solve_dtype, kind))
        return emulated_capture(self, kind, fn, inputs)

    monkeypatch.setattr(G, "unservable", lambda problem: None)
    monkeypatch.setattr(G.GraphedPotential, "_capture", capture)
    graphed = run().result
    log = capsys.readouterr().out
    for name in ("models", "stats", "accepts", "pred", "lf_steps"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name
    warm = [(k, torch.complex64) for k in ("eval", "factor", "stale")]
    assert [(dt, k) for _, dt, k in made[:3]] == [(dt, k) for k, dt in warm]
    assert [k for _, dt, k in made[3:]] == ["eval", "factor", "stale"]
    released = [line for line in log.splitlines() if "released the warmup engine's" in line]
    assert [line.split("engine's ")[1].split()[0] for line in released] == [
        "eval", "factor", "stale"]
    assert all("pool 0 bytes" in line for line in released)
    assert log.index("hybrid: warmup engine") < log.index(released[0])
