"""The graphed eval's CPU side: the fused eval makes no host round trip
after its first call (what a CUDA graph's capture needs), ``make_potential_vg``
picks the graph only for the fused engine on a CUDA problem, and the launch
counts a replay adds.  The graph itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 12).

The port runs the tiny flagship under the fused config (complex64 factors,
refine 6) on the CPU, through the kernels' plain versions; JAX runs the
same config with its Pallas kernels in interpret mode (Q = 32, PANEL = 8),
as ``tests/test_torch_fused.py`` does, and the eager eval is held to it with
that file's tolerances (U_TOL, GRAD_TOL, COS_MIN).
"""

import contextlib
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
from hmcmt2d_tpu_torch.sampler import graphed as G  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import chain_models, jax_problem_with, problem_arrays  # noqa: E402

U_TOL = 1e-4      # tests/test_torch_fused.py's limits for the fused config
GRAD_TOL = 1e-3
COS_MIN = 0.9999
FUSED = SolveConfig(torch.complex64, 6, "fused")
SURVEYS = {"two_modes": dict(),
           "te_tipper": dict(data_comp=("ZXY", "TZY"), data_type="Impedance_Tipper"),
           "tm_rho_phase": dict(data_comp=("RhoYX", "PhsYX"), data_type="Rho_Phs")}
# every Tensor method that copies a value to the host and waits on the device
HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "numpy")


@contextlib.contextmanager
def no_host_round_trip():
    """Make every host read of a tensor raise, and record each
    ``torch.as_tensor`` / ``torch.tensor`` of data that is not a tensor (a
    host-to-device copy on the card).  Yields the list of those calls."""
    made = []

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"host round trip: Tensor.{name}")
        return read

    def recorded(fn):
        def make(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                made.append((fn.__name__, type(data).__name__))
            return fn(data, *a, **k)
        return make

    mp = pytest.MonkeyPatch()
    try:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse(name))
        mp.setattr(torch, "as_tensor", recorded(torch.as_tensor))
        mp.setattr(torch, "tensor", recorded(torch.tensor))
        yield made
    finally:
        mp.undo()


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
        torch.as_tensor(np.zeros(2))
        torch.as_tensor(t)
    assert made == [("as_tensor", "ndarray")]


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


def _on_card(method: str):
    """A stand-in problem that reports a CUDA device and an engine; the
    dispatch reads nothing else, and nothing here touches a card."""
    cfg = SolveConfig(torch.complex64, 6, method)
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 fwd=types.SimpleNamespace(cfg=cfg))


@pytest.mark.parametrize("method", ["thomas", "bcr", "thomas_blocked"])
def test_graphed_raises_where_it_cannot_serve(method):
    """graphed=True raises on a CPU problem and on another engine; the
    default gives those the eager closure."""
    cpu, _ = entry.flagship_problem(tiny=True, device="cpu", cfg=FUSED)
    with pytest.raises(ValueError, match="CUDA problem"):
        make_potential_vg(cpu, 1.0, graphed=True)
    with pytest.raises(ValueError, match="fused engine"):
        make_potential_vg(_on_card(method), 1.0, graphed=True)
    with pytest.raises(ValueError, match="fused engine"):
        G.GraphedPotential(_on_card(method), 1.0)
    assert not isinstance(make_potential_vg(_on_card(method), 1.0), G.GraphedPotential)


def test_fused_cuda_problem_gets_the_graph_by_default():
    """The default serves a CUDA problem on the fused engine from the graph
    (built lazily: nothing is captured before the first call), False gives
    the eager closure, and a stale factor is refused."""
    prob = _on_card("fused")
    vg = make_potential_vg(prob, 1.0)
    assert isinstance(vg, G.GraphedPotential) and vg.captures == {}
    assert not isinstance(make_potential_vg(prob, 1.0, graphed=False), G.GraphedPotential)
    m = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="stale factor"):
        vg(m, m, fac=object())
    with pytest.raises(ValueError, match="problem is on"):
        vg(m, m)


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
