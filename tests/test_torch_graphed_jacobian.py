"""The Gauss-Newton build's graph on the CPU (``models/jacobian.py``):
``full_jacobian_chunked`` builds J from a CUDA graph of its slab pullback
on the card, and here, with the capture emulated
(``tests/torch_parity.py::emulated_graph_capture``: a replay reruns the
slab into the static buffers), it must equal the eager build bit for bit,
count the eager build's launches and stay within
``tests/test_torch_jacobian.py``'s limits of JAX's build.  The slab
pullback makes no host round trip after its first call, the condition for
its capture.  The graph itself runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 14).

Every engine and inverse (thomas, thomas_blocked, bcr with LU and with
Gauss-Jordan; fused), complex64 refined 6 times, and every survey kind on
the tiny flagship, at chunk 7: its 64 (32 for rho/phase) rows leave a
tail slab.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.models import jacobian as JJ  # noqa: E402
from hmcmt2d_tpu.sampler.driver import gauss_newton_mass as jax_gn  # noqa: E402
from hmcmt2d_tpu_torch import entry  # noqa: E402
from hmcmt2d_tpu_torch.models import jacobian as TJ  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.sampler import driver as D  # noqa: E402
from hmcmt2d_tpu_torch.sampler import graphed as G  # noqa: E402
from tests.torch_parity import (counted_plain_versions, emulated_graph_capture,  # noqa: E402
                                no_host_round_trip, relerr, tiny_problems)

TOL = 1e-9          # tests/test_torch_jacobian.py's limits against JAX
INV_TOL = 1e-7
CHUNK = 7
SURVEYS = {"two_modes": dict(),
           "te_tipper": dict(data_comp=("ZXY", "TZY"), data_type="Impedance_Tipper"),
           "tm_rho_phase": dict(data_comp=("RhoYX", "PhsYX"), data_type="Rho_Phs")}
ENGINES = [(method, inv) for method in ("thomas", "thomas_blocked", "bcr")
           for inv in ("lu", "gj")] + [("fused", "lu")]


def tiny(method: str, inv: str, survey: str = "two_modes"):
    """The tiny flagship under (method, inv), complex64 refined 6 times,
    and a model off its start (float32)."""
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu",
                                      cfg=SolveConfig(torch.complex64, 6, method, inv),
                                      **SURVEYS[survey])
    m = m0 + 0.05 * np.sin(np.arange(len(m0)))
    return prob, torch.as_tensor(m, dtype=torch.float32)


@pytest.fixture
def emulated(monkeypatch):
    """Graphs for a CPU problem, each capture emulated."""
    monkeypatch.setattr(G, "unservable", lambda problem: None)
    monkeypatch.setattr(G, "capture", emulated_graph_capture)


@pytest.mark.parametrize("survey", sorted(SURVEYS))
@pytest.mark.parametrize("method,inv", ENGINES)
def test_slab_pullback_makes_no_host_round_trip_after_its_first(method, inv, survey):
    """After a first slab, a slab of the pullback (the middle one and the
    clamped tail) reads nothing back to the host and copies nothing from
    it, and gives the rows it gave before."""
    prob, m = tiny(method, inv, survey)
    pull = TJ.SlabPullback(prob, m, CHUNK)
    assert pull.n == TJ.n_rows(prob) and pull.n % CHUNK
    pull(pull.starts[0])
    first = pull.out.clone()
    slabs = (pull.n_slabs // 2, pull.n_slabs - 1, 0)
    with no_host_round_trip() as made:
        for k in slabs:
            pull(pull.starts[k])
    assert made == []
    assert torch.equal(pull.out[:CHUNK], first[:CHUNK])
    for k in slabs:
        assert bool(torch.isfinite(pull.out[k * CHUNK:(k + 1) * CHUNK]).all())


@pytest.mark.parametrize("survey", sorted(SURVEYS))
@pytest.mark.parametrize("method,inv", ENGINES)
def test_graphed_jacobian_equals_eager_bit_for_bit(method, inv, survey, emulated):
    """The graphed build (three warm-up slabs, a capture, a replay for each
    slab from the fourth) equals the eager build bit for bit, and reports
    its capture as released."""
    prob, m = tiny(method, inv, survey)
    eager = TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, graphed=False)
    caps = []
    graphed = TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, graphed=True, captures=caps)
    assert graphed.dtype == np.float64 and graphed.shape == (TJ.n_rows(prob), prob.n_param)
    assert np.array_equal(graphed, eager)
    n_slabs = -(-TJ.n_rows(prob) // CHUNK)
    assert [(c["kind"], c["chains"], c["rows"], c["slabs"], c["replays"]) for c in caps] == [
        ("jacobian", None, CHUNK, n_slabs, n_slabs - G.WARMUP_CALLS)]


@pytest.mark.parametrize("method,inv", ENGINES)
def test_graphed_jacobian_counts_the_eager_launches(method, inv, emulated):
    """The plain versions' calls, counted as launches: a graphed build
    counts what an eager build does (the warm-up slabs count, the
    recording does not, each replay adds the captured slab's launches);
    none on thomas and bcr under LU, ``gj_inverse`` in the factor only
    under gj; on fused the factor once and the sweeps of the forward pass
    and of each slab."""
    prob, m = tiny(method, inv)
    with counted_plain_versions():
        TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, graphed=False)
        eager = FF.launches()
        FF.reset_launches()
        caps = []
        TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, graphed=True, captures=caps)
        graphed = FF.launches()
        FF.reset_launches()
        TJ.SlabPullback(prob, m, CHUNK)._forward()
        forward = FF.launches()
    assert graphed == eager
    per_slab = caps[0]["launches_per_replay"]
    if method == "fused":
        assert forward["schur_factor"] == 1 and per_slab["schur_factor"] == 0
        for k in ("bt_sweep_fwd", "bt_sweep_bwd"):
            assert per_slab[k] > 0
            assert eager[k] == forward[k] + caps[0]["slabs"] * per_slab[k]
    else:
        assert all(eager[k] == 0 for k in ("schur_factor", "bt_sweep_fwd", "bt_sweep_bwd"))
        nzi = prob.mesh.nz - 1
        per_factor = nzi.bit_length() if method == "bcr" else nzi
        assert eager.get("gj_inverse", 0) == (per_factor if inv == "gj" else 0)
        assert per_slab.get("gj_inverse", 0) == 0


def test_graphed_true_raises_on_the_cpu_where_none_is_eager(monkeypatch):
    """On a CPU problem graphed=True raises and graphed=None takes the
    eager build, capturing nothing; on a CUDA problem a build with no slab
    left to replay after the warm-ups is not servable either."""
    prob, m = tiny("thomas", "lu")

    def refused(*a, **k):
        raise AssertionError("captured")

    monkeypatch.setattr(G, "capture", refused)
    with pytest.raises(ValueError, match="CUDA problem"):
        TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, graphed=True)
    caps = []
    J = TJ.full_jacobian_chunked(prob, m, chunk=CHUNK, captures=caps)
    assert caps == [] and np.array_equal(J, TJ.full_jacobian_chunked(prob, m, chunk=CHUNK,
                                                                      graphed=False))
    monkeypatch.setattr(G, "unservable", lambda problem: None)
    assert TJ.unservable(prob, G.WARMUP_CALLS + 1) is None
    assert "none left to replay" in TJ.unservable(prob, G.WARMUP_CALLS)
    with pytest.raises(ValueError, match="none left to replay"):
        TJ.full_jacobian_chunked(prob, m, chunk=TJ.n_rows(prob), graphed=True)


@pytest.fixture(scope="module")
def jax_case():
    """tests/test_torch_jacobian.py's case: the tiny problem in complex128
    thomas on both sides, JAX's J (chunk 7) and Gauss-Newton mass."""
    jprob, tprob, m0 = tiny_problems()
    m = m0 + 0.05
    J = np.asarray(JJ.full_jacobian_chunked(jprob, jnp.asarray(m), chunk=CHUNK))
    gn = jax_gn(jprob, jnp.asarray(m), reg=1.0)
    return dict(tprob=tprob, m=m, J=J, gn_sqrt=np.asarray(gn.sqrt_m),
                gn_inv=np.asarray(gn.inv_m))


def test_graphed_jacobian_matches_jax(jax_case, emulated):
    caps = []
    J = TJ.full_jacobian_chunked(jax_case["tprob"], torch.as_tensor(jax_case["m"]),
                                 chunk=CHUNK, graphed=True, captures=caps)
    assert len(caps) == 1 and J.shape == jax_case["J"].shape
    assert relerr(J, jax_case["J"]) < TOL


def test_graphed_gauss_newton_mass_matches_jax_and_logs_its_graph(jax_case, emulated):
    """``gauss_newton_mass`` with the graphed J, held to JAX's mass, logs
    the Jacobian's graph it freed."""
    lines = []
    tm = D.gauss_newton_mass(jax_case["tprob"], torch.as_tensor(jax_case["m"]), 1.0,
                             chunk=CHUNK, graphed=True, log=lines.append)
    assert relerr(tm.sqrt_m, jax_case["gn_sqrt"]) < TOL
    assert relerr(tm.inv_m, jax_case["gn_inv"]) < INV_TOL
    assert len(lines) == 1 and lines[0].startswith("released the GN build's jacobian graph")
    assert "pool 0 bytes" in lines[0]


def test_run_inversion_threads_graphed_to_the_gn_build(monkeypatch, capsys):
    """A hybrid run under the Gauss-Newton mass with ``graphed=None`` on
    emulated graphs builds J from the graph (at chunk 7, so that slabs are
    left to replay) and logs it released, and its samples equal the eager
    run's (``graphed=False``, which builds no graph) bit for bit."""
    from hmcmt2d_tpu_torch.io import HMCConfig
    from tests.test_e2e import tiny_setup
    from tests.torch_parity import emulated_capture, port_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    tmesh, tdata = port_setup(mesh, data)
    cfg = HMCConfig(burnin=4, total_samples=8, sig_bounds=(1e-4, 10.0), dt=0.05,
                    timestep=(2, 3), reg_param=1.0, seed=0, adapt=True,
                    mass_type="gaussnewton", mass_warmup=2)
    gn = D.gauss_newton_mass
    built = []

    def at_chunk_7(*a, **k):
        built.append(k.get("graphed"))
        return gn(*a, **dict(k, chunk=CHUNK))

    monkeypatch.setattr(D, "gauss_newton_mass", at_chunk_7)

    def run(graphed):
        return D.run_inversion(cfg, tmesh, start_sig, tdata, obs, err, n_chains=2,
                               device="cpu", solve_cfg=SolveConfig(torch.complex128, 0),
                               warmup_solve_cfg=SolveConfig(torch.complex64, 3, "thomas"),
                               verbose=True, graphed=graphed)

    eager = run(False).result
    assert "GN build's" not in capsys.readouterr().out
    monkeypatch.setattr(G, "unservable", lambda problem: None)
    monkeypatch.setattr(G.GraphedPotential, "_capture", emulated_capture)
    monkeypatch.setattr(G, "capture", emulated_graph_capture)
    graphed = run(None).result
    log = capsys.readouterr().out
    assert built == [False, None]
    for name in ("models", "stats", "accepts", "pred", "lf_steps"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name
    line = [x for x in log.splitlines() if "released the GN build's jacobian graph" in x]
    assert len(line) == 1 and log.index(line[0]) < log.index("dense mass (gn) built")
