"""The program's spans (``hmcmt2d_tpu_torch/utils/trace.py``): with no
profiler running a span never reaches ``record_function``; under a
profiler one sampler iteration emits its spans, nested by call, one
``hmc.step`` a leapfrog step, a refactor inside the step that makes it,
and the graphed potential one span a call with its replay's phases as
children; the eager eval emits none; and nothing the program computes
changes with the profiler on.

The CPU tests run the tiny flagship (complex128 thomas) eagerly, and the
graphed potential's bookkeeping over captures emulated on the CPU.  The
test marked ``cuda`` runs the graphs on the card; this file imports no
JAX, so it runs there without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hmcmt2d_tpu_torch import entry
from hmcmt2d_tpu_torch.models.forward import SolveConfig
from hmcmt2d_tpu_torch.ops import fused_factor as FF
from hmcmt2d_tpu_torch.sampler import adapt as A
from hmcmt2d_tpu_torch.sampler import graphed as G
from hmcmt2d_tpu_torch.sampler import hmc as H
from hmcmt2d_tpu_torch.sampler.driver import make_factor_fn, make_potential_vg
from hmcmt2d_tpu_torch.utils import trace

torch.set_num_threads(1)

PROGRAM = ("hmc.", "adapt.", "graphed.", "gn.")
PROBE = "test.factor"
SEED = 2**31 + 77


def host_ranges(prof, prefixes=PROGRAM):
    """(name, start ns, end ns, parent) of the profile's host ranges whose
    name starts with one of ``prefixes``, in order of start, each with the
    index of the innermost such range around it (None at the top)."""
    got = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CPU
                  and e.name().startswith(prefixes)), key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, s, e in got:
        while stack and out[stack[-1]][2] < e:
            stack.pop()
        out.append((name, s, e, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def names(ranges, parent="any"):
    return [r[0] for r in ranges if parent == "any" or r[3] == parent]


def children(ranges, i):
    return names(ranges, parent=i)


@pytest.fixture(scope="module")
def tiny():
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu")
    rng = np.random.default_rng(3)
    m = torch.as_tensor(m0 + 0.05 * rng.standard_normal((2, len(m0))))
    return prob, m


def options(steps=3, refactor_every=4):
    return H.HMCOptions(dt=2e-3, steps_lo=steps, steps_hi=steps,
                        log_sig_lo=float(np.log(1e-4)), log_sig_hi=float(np.log(10.0)),
                        reg_param=1.0, refactor_every=refactor_every)


def sample(prob, m, n=1):
    vg = make_potential_vg(prob, 1.0)
    mass = H.identity_mass(m.shape[1], m.dtype, "cpu")
    return H.run_hmc(vg, options(), mass, m, m, n, SEED)


def warm(prob, m, n=1, factor_fn=None, opts=None):
    vg = make_potential_vg(prob, 1.0)
    opts = opts or options()
    carry = A.warmup_carry_init(vg, opts, m, m)
    ends = np.arange(n) == n - 1
    return A.warmup_scan(vg, opts, m, carry, A.warmup_keys(SEED, 0, n, "cpu"), ends,
                         A.WarmupOptions(), factor_fn=factor_fn)


def tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return []


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("hmc.step") is trace.span("graphed.eval")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("hmc.step"), torch.profiler.record_function)


def test_no_profiler_never_reaches_record_function(tiny, monkeypatch):
    """One main-phase iteration and one warmup iteration with a trajectory-
    amortised factor, while ``record_function`` raises."""
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    prob, m = tiny
    sample(prob, m)
    warm(prob, m, factor_fn=make_factor_fn(prob))


def test_main_phase_iteration_spans(tiny):
    prob, m = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sample(prob, m)
    got = host_ranges(prof)
    assert names(got, parent=None) == ["hmc.iteration"]
    assert children(got, 0) == ["hmc.draw", "hmc.step", "hmc.step", "hmc.step", "hmc.mh"]
    assert len(got) == 6          # the eager eval inside each step has none


def test_warmup_iteration_spans(tiny):
    prob, m = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        warm(prob, m, n=2)
    got = host_ranges(prof)
    assert names(got, parent=None) == ["hmc.iteration", "adapt.update"] * 2
    for i, r in enumerate(got):
        if r[0] == "hmc.iteration":
            assert children(got, i) == ["hmc.draw"] + ["hmc.step"] * 3 + ["hmc.mh"]
    assert len(got) == 2 * 7


def test_refactors_fall_in_the_steps_that_make_them(tiny):
    """L = 5, refactor_every = 2: the trajectory's first factor inside the
    iteration before its first step, then one in step k = 2 and one in
    step k = 4."""
    prob, m = tiny
    factor = make_factor_fn(prob)

    def marked(mm):
        with torch.profiler.record_function(PROBE):
            return factor(mm)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        warm(prob, m, factor_fn=marked, opts=options(steps=5, refactor_every=2))
    got = host_ranges(prof, PROGRAM + (PROBE,))
    steps = [i for i, r in enumerate(got) if r[0] == "hmc.step"]
    assert len(steps) == 5
    parents = [got[r[3]][0] if got[r[3]][0] == "hmc.iteration" else steps.index(r[3])
               for r in got if r[0] == PROBE]
    assert parents == ["hmc.iteration", 2, 4]


def test_eager_eval_emits_no_program_span(tiny):
    prob, m = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prob.potential_value_and_grad(m, m, 1.0)
        prob.potential_value_and_grad(m, m, 1.0, fac=prob.factor_state(m))
    assert host_ranges(prof) == []


def test_results_are_bit_identical_with_the_profiler_on(tiny):
    prob, m = tiny
    factor = make_factor_fn(prob)
    off = (sample(prob, m, n=2), warm(prob, m, n=2, factor_fn=factor))
    with profile(activities=[ProfilerActivity.CPU]):
        on = (sample(prob, m, n=2), warm(prob, m, n=2, factor_fn=factor))
    a, b = tensors(off), tensors(on)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def check_graphed_spans(got) -> None:
    """The calls eval, eval, factor, stale, stale on a fresh graphed
    potential: one span a call named by its kind, a capture in the first
    call of each kind, the replay's load and launch in every call and the
    clone in every eval."""
    top = [(i, r[0]) for i, r in enumerate(got) if r[3] is None]
    assert [n for _, n in top] == ["graphed.eval", "graphed.eval", "graphed.factor",
                                   "graphed.stale", "graphed.stale"]
    first = {"graphed.eval": True, "graphed.factor": True, "graphed.stale": True}
    for i, kind in top:
        want = ["graphed.capture"] if first[kind] else []
        first[kind] = False
        want += ["graphed.load", "graphed.launch"]
        want += [] if kind == "graphed.factor" else ["graphed.clone"]
        assert children(got, i) == want, (kind, children(got, i))
    assert len(got) == 5 + 3 + 2 * 5 + 4


def graphed_calls(vg, ma, mb):
    outs = [vg(ma, ma), vg(mb, ma)]
    fac = vg.factor(mb)
    outs += [vg(ma, ma, fac), vg(mb, ma, fac)]
    return tensors(outs) + tensors(fac)


def test_graphed_spans_over_emulated_captures(tiny, monkeypatch):
    """The graphed potential's bookkeeping, each capture emulated on the
    CPU by a graph that reruns its function (as in test_torch_graphed.py)."""
    from tests.torch_parity import emulated_capture

    prob, m = tiny
    monkeypatch.setattr(G.GraphedPotential, "_capture", emulated_capture)
    stand_in = types.SimpleNamespace(device=torch.device("cuda", 0))
    vgs = []
    for _ in range(2):
        vg = G.GraphedPotential(stand_in, 1.0)
        vg.problem = prob
        vgs.append(vg)
    off = graphed_calls(vgs[0], m, m + 0.01)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = graphed_calls(vgs[1], m, m + 0.01)
    check_graphed_spans(host_ranges(prof))
    assert all(torch.equal(x, y) for x, y in zip(off, on))


@pytest.fixture
def cuda_device():
    """The GPU, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fused", "thomas"])
def test_graphed_spans_on_the_card(cuda_device, method):
    """The graphs on the card, the fused eval and a warmup engine's (thomas
    + LU: eval, factor and stale eval), captured under the profiler (CPU
    and CUDA, as the benchmark traces) and without: the spans as on the
    CPU, and outputs and launch counts equal bit for bit, in the first
    calls (which capture) and in replays of one graph with the profiler on
    and off; then a main-phase iteration through the graphs, on and off."""
    cfg = SolveConfig(torch.complex64, 6, method)
    gpu, m0 = entry.flagship_problem(tiny=True, device=cuda_device, cfg=cfg)
    rng = np.random.default_rng(5)
    ma, mb = (torch.as_tensor(m0 + 0.05 * rng.standard_normal((2, len(m0))),
                              dtype=torch.float32, device=cuda_device) for _ in range(2))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def counted(vg):
        FF.reset_launches()
        outs = graphed_calls(vg, ma, mb)
        torch.cuda.synchronize()
        return outs, FF.launches()

    vg_off, vg_on = make_potential_vg(gpu, 1.0), make_potential_vg(gpu, 1.0)
    assert isinstance(vg_on, G.GraphedPotential)
    off = counted(vg_off)
    with profile(activities=acts) as prof:
        on = counted(vg_on)
    check_graphed_spans(host_ranges(prof))
    replay_off = counted(vg_on)
    with profile(activities=acts) as prof:
        replay_on = counted(vg_on)
    assert names(host_ranges(prof)).count("graphed.capture") == 0
    for x, y in ((off, on), (replay_off, replay_on)):
        assert x[1] == y[1]
        assert all(torch.equal(a, b) for a, b in zip(x[0], y[0]))

    mass = H.identity_mass(len(m0), torch.float32, cuda_device)
    runs = [H.run_hmc(vg_on, options(), mass, ma, ma, 1, SEED)]
    with profile(activities=acts) as prof:
        runs.append(H.run_hmc(vg_on, options(), mass, ma, ma, 1, SEED))
        torch.cuda.synchronize()
    assert names(host_ranges(prof)).count("hmc.step") == 3
    assert all(torch.equal(a, b) for a, b in zip(tensors(runs[0]), tensors(runs[1])))


def test_gauss_newton_mass_spans(tiny):
    """The GN mass's two set-up costs, for ``--profile`` readers: the
    Jacobian's build and the host's J'W^2J and Cholesky."""
    from hmcmt2d_tpu_torch.sampler.driver import gauss_newton_mass

    prob, m = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gauss_newton_mass(prob, m[0], 1.0, chunk=16)
    assert names(host_ranges(prof)) == ["gn.jacobian", "gn.host"]
