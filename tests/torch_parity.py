"""Shared helpers of the parity tests between the PyTorch port
(``hmcmt2d_tpu_torch``) and the JAX package (``hmcmt2d_tpu``).

Inputs are made with numpy from a seed and handed to both sides; data
crosses between the frameworks only as numpy arrays.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch


def relerr(a, b) -> float:
    """max |a - b| / max |b| over numpy-convertible arrays."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def problem_arrays(problem) -> dict:
    """The numpy arrays that describe a JAX ``InverseProblem``, in the form
    ``hmcmt2d_tpu_torch.convert.problem_from_arrays`` takes."""
    mesh, d = problem.mesh, problem.fwd.data
    return dict(y_len=np.asarray(mesh.y_len), z_len=np.asarray(mesh.z_len),
                air_layer=np.asarray(mesh.air_layer),
                origin=np.asarray(mesh.origin), rx_loc=d.rx_loc,
                freqs=d.freqs, data_type=np.asarray(d.data_type),
                data_comp=np.asarray(d.data_comp), freq_id=d.freq_id,
                rx_id=d.rx_id, dt_id=d.dt_id, obs=np.asarray(problem.obs),
                weights=np.asarray(problem.weights),
                active_idx=np.asarray(problem.active_idx),
                bg_flat=np.asarray(problem.bg_flat))


def port_setup(mesh, data):
    """A JAX mesh and ``MTData`` (as ``tests/test_e2e.py::tiny_setup`` makes
    them) rebuilt as the port's, on the CPU."""
    from hmcmt2d_tpu_torch import make_mesh
    from hmcmt2d_tpu_torch.models.data import MTData

    tmesh = make_mesh(np.asarray(mesh.y_len), np.asarray(mesh.z_len),
                      air_layer=np.asarray(mesh.air_layer),
                      origin=np.asarray(mesh.origin), device="cpu")
    tdata = MTData(rx_loc=data.rx_loc, freqs=data.freqs, data_type=data.data_type,
                   data_comp=data.data_comp, freq_id=data.freq_id,
                   rx_id=data.rx_id, dt_id=data.dt_id)
    return tmesh, tdata


def tiny_problems(cfg=None):
    """``tests/test_mass.py``'s tiny problem on both sides: (JAX problem
    under exact complex128 thomas, the port's problem on the CPU under
    ``cfg`` (default the same engine), start model m0)."""
    import jax.numpy as jnp

    from hmcmt2d_tpu.models import forward as F
    from hmcmt2d_tpu.models.posterior import build_inverse_problem
    from hmcmt2d_tpu_torch import convert
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from tests.test_e2e import tiny_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    jprob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                      cfg=F.SolveConfig(jnp.complex128, 0, "thomas"))
    tprob = convert.problem_from_arrays(
        problem_arrays(jprob), cfg or SolveConfig(torch.complex128, 0, "thomas"),
        device="cpu")
    return jprob, tprob, np.asarray(m0)


def jax_problem_with(problem, cfg):
    """The JAX problem rebuilt under another ``SolveConfig``."""
    from hmcmt2d_tpu.models.forward import make_forward
    from hmcmt2d_tpu.models.posterior import InverseProblem

    return InverseProblem(fwd=make_forward(problem.mesh, problem.fwd.data, cfg),
                          obs=problem.obs, weights=problem.weights,
                          active_idx=problem.active_idx, bg_flat=problem.bg_flat)


def realistic(problem, m0: np.ndarray):
    """The JAX problem with observations = its own prediction at m0 plus 3%
    complex noise (numpy seed 0) and errors of 3% of |obs|, as bench.py's
    ``_realistic`` builds them: a posterior whose potential is O(n_data)."""
    import jax
    import jax.numpy as jnp

    obs = np.asarray(jax.jit(problem.predict)(jnp.asarray(m0)))
    rng = np.random.default_rng(0)
    obs = obs * (1 + 0.03 * (rng.standard_normal(len(obs))
                             + 1j * rng.standard_normal(len(obs))) / np.sqrt(2))
    return problem.__class__(fwd=problem.fwd, obs=obs,
                             weights=1.0 / (0.03 * np.abs(obs)),
                             active_idx=problem.active_idx,
                             bg_flat=problem.bg_flat)


def survey_arrays(arrays: dict, comps, data_type: str = "Impedance") -> dict:
    """Problem arrays with the survey cut to the components ``comps``, every
    (freq, rx, comp) triple observed, observations ones (complex for the
    Impedance family) and errors 0.01, as the flagship's placeholders."""
    n_freq, n_rx = len(arrays["freqs"]), len(arrays["rx_loc"])
    f, r, d = np.meshgrid(np.arange(n_freq), np.arange(n_rx), np.arange(len(comps)),
                          indexing="ij")
    n = f.size
    obs = np.ones(n, complex) if "Impedance" in data_type else np.ones(n)
    return dict(arrays, data_type=np.asarray(data_type), data_comp=np.asarray(comps),
                freq_id=f.ravel(), rx_id=r.ravel(), dt_id=d.ravel(), obs=obs,
                weights=np.full(n, 100.0))


def jax_problem_from_arrays(arrays: dict, cfg):
    """The JAX ``InverseProblem`` that ``convert.problem_from_arrays`` builds
    on the port's side, under the JAX ``SolveConfig`` ``cfg``."""
    from hmcmt2d_tpu import make_mesh
    from hmcmt2d_tpu.models.data import MTData
    from hmcmt2d_tpu.models.forward import make_forward
    from hmcmt2d_tpu.models.posterior import InverseProblem

    mesh = make_mesh(arrays["y_len"], arrays["z_len"], air_layer=arrays["air_layer"],
                     origin=arrays["origin"])
    data = MTData(rx_loc=np.asarray(arrays["rx_loc"], float),
                  freqs=np.asarray(arrays["freqs"], float),
                  data_type=str(arrays["data_type"]),
                  data_comp=tuple(str(c) for c in np.atleast_1d(arrays["data_comp"])),
                  freq_id=np.asarray(arrays["freq_id"]), rx_id=np.asarray(arrays["rx_id"]),
                  dt_id=np.asarray(arrays["dt_id"])).validate()
    return InverseProblem(fwd=make_forward(mesh, data, cfg), obs=np.asarray(arrays["obs"]),
                          weights=np.asarray(arrays["weights"], float),
                          active_idx=np.asarray(arrays["active_idx"]),
                          bg_flat=np.asarray(arrays["bg_flat"], float))


# -- the graphed eval's CPU side: host reads refused, captures emulated ----
# every Tensor method that copies a value to the host and waits on the device
HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "numpy")


@contextlib.contextmanager
def no_host_round_trip():
    """Make every host read of a tensor raise, and ``torch.linalg.inv``
    (which reads its error code back from the device), and record each
    ``torch.as_tensor`` / ``torch.tensor`` of data that is not a tensor (a
    host-to-device copy on the card).  Yields the list of those calls."""
    made = []

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"host round trip: Tensor.{name}")
        return read

    def inv(*a, **k):
        raise AssertionError("host round trip: torch.linalg.inv reads its error code")

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
        mp.setattr(torch.linalg, "inv", inv)
        yield made
    finally:
        mp.undo()


def tensors(x) -> list:
    """The tensors of a (nested) tuple, a factorisation among them, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for part in x for t in tensors(part)]
    return []


class RerunGraph:
    """A stand-in for a CUDA graph on the CPU: a replay reruns the captured
    function on the static inputs and writes its results into the static
    outputs, in place, as a graph's replay rewrites its buffers."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        for dst, src in zip(tensors(self.out), tensors(self.fn(*self.inputs))):
            dst.copy_(src)


def emulated_capture(self, kind, fn, inputs):
    """``GraphedPotential._capture`` on the CPU: a :class:`RerunGraph` over
    static copies of the inputs, no launches and no pool."""
    from hmcmt2d_tpu_torch.sampler import graphed as G

    static = tuple(x.clone() for x in inputs)
    out = fn(*static)
    return G.Capture(kind, RerunGraph(fn, static, out), static, out, {}, {}, 0.0, 0)


class CountedRerunGraph(RerunGraph):
    """A :class:`RerunGraph` whose replay takes its rerun's launches back out
    of the counts, as a CUDA graph's replay launches nothing that the
    wrappers count (its caller adds the capture's delta)."""

    def replay(self):
        from hmcmt2d_tpu_torch.ops import fused_factor as FF

        before = FF.launches()
        super().replay()
        FF.add_launches(FF.launch_delta(FF.launches(), before))


def emulated_graph_capture(kind, fn, inputs, device, warmups=None):
    """``sampler.graphed.capture`` on the CPU, its launch accounting
    included: the warm-up calls on static copies of the inputs, then a
    :class:`CountedRerunGraph` whose recording is one call on ``inputs``;
    the launches of the warm-ups and of that call are taken back out of the
    counts and kept, as the real capture keeps them.  No pool."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.sampler import graphed as G

    static = tuple(x.clone() for x in inputs)
    before = FF.launches()
    for args in warmups or (inputs,) * G.WARMUP_CALLS:
        G._load(static, args)
        fn(*static)
    G._load(static, inputs)
    warmed = FF.launches()
    out = fn(*static)
    after = FF.launches()
    FF.add_launches(FF.launch_delta(after, before))
    return G.Capture(kind, CountedRerunGraph(fn, static, out), static, out,
                     FF.launch_delta(warmed, after), FF.launch_delta(before, warmed),
                     0.0, 0)


@contextlib.contextmanager
def counted_plain_versions():
    """Count each call of a kernel's plain version (the CPU's stand-in for
    a launch) on its wrapper's counter, ``gj_inverse`` through the engines'
    ``INV_FN["gj"]``; the counts start at 0."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    def counted(fn, wrapper):
        def call(*a, **k):
            wrapper.launches += 1
            return fn(*a, **k)
        return call

    mp = pytest.MonkeyPatch()
    try:
        for name in ("schur_factor", "bt_sweep_fwd", "bt_sweep_bwd"):
            mp.setattr(FF, f"{name}_plain", counted(getattr(FF, f"{name}_plain"),
                                                   getattr(FF, name)))
        mp.setitem(S.INV_FN, "gj", counted(S.INV_FN["gj"], FF.gj_inverse))
        FF.reset_launches()
        yield
    finally:
        mp.undo()
        FF.reset_launches()


def chain_models(m0: np.ndarray, n_chains: int, scale: float = 0.1,
                 seed: int = 0) -> np.ndarray:
    """(C, P) models around m0; chain 0 is m0 itself."""
    rng = np.random.default_rng(seed)
    m = m0 + scale * rng.standard_normal((n_chains, len(m0)))
    m[0] = m0
    return m


# -- ranks of the sharded tests (spawned by parallel.multichain.spawn_ranks;
#    they import only the port) ---------------------------------------------
SHARD_OPTS = dict(dt=0.05, steps_lo=2, steps_hi=3, log_sig_lo=float(np.log(1e-4)),
                  log_sig_hi=float(np.log(10.0)), reg_param=1.0)


def _numpy_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    return x


def _result(res, *extra) -> dict:
    out = {k: getattr(res, k) for k in ("models", "stats", "accepts", "pred",
                                        "lf_steps", "start_stats", "start_pred")}
    out["final_m"] = res.final.m
    for i, e in enumerate(extra):
        out[f"extra{i}"] = e
    return out


def sharded_cases(device, arrays, setup, m, cfgs, tmp):
    """One rank of the (2 chains x 2 freq) group of the sharded tests: the
    potential and gradient, a run, the warmup in one scan and in segments,
    run_inversion checkpointed and resumed and under the Gauss-Newton
    schedule, and the potential, warmup and run again from graphs emulated
    on the CPU (:func:`emulated_capture`), then released.  Every value
    returned is global (the same on every rank)."""
    torch.set_num_threads(1)
    from hmcmt2d_tpu_torch import convert
    from hmcmt2d_tpu_torch.io import HMCConfig
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from hmcmt2d_tpu_torch.parallel.multichain import ShardedSampler, make_device_mesh
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import driver as D
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.utils.collectives import all_gather_cat

    exact = SolveConfig(torch.complex128, 0, "thomas")
    prob = convert.problem_from_arrays(arrays, exact, device=device)
    mesh = make_device_mesh(2, 2, device=device)
    ss = ShardedSampler(prob, 1.0, mesh)
    mt = torch.as_tensor(m)
    n_l = mt.shape[0] // 2
    lo = mesh.get_local_rank("chains") * n_l
    (U, (mis, mn, _)), g = ss.potential_vg(mt[lo:lo + n_l], mt.flip(0)[lo:lo + n_l])
    out = {"U": all_gather_cat(U, ss.chains), "misfit": all_gather_cat(mis, ss.chains),
           "mnorm": all_gather_cat(mn, ss.chains), "grad": all_gather_cat(g, ss.chains)}

    opts = H.HMCOptions(**SHARD_OPTS)
    mass = H.identity_mass(mt.shape[1], torch.float64, device)
    run = ss.run(opts, mass, mt, mt, 3, 5)
    out["run"] = _result(run)
    eye = torch.eye(mt.shape[1], dtype=torch.float64)
    res, _state, info = ss.readapt(opts, run.final, mt, 3, 9, A.WarmupOptions(),
                                   H.MassMatrix(eye, eye, diagonal=False), it_offset=6)
    out["readapt"] = _result(res, info.dt)
    for name, seg in (("warmup", 0), ("warmup_seg", 2)):
        res, _state, wmass, info = ss.warmup(opts, mt, mt, 6, 7, seg=seg)
        out[name] = _result(res, wmass.inv_m, info.dt)

    def run(cfg_kw, **kw):
        return D.run_inversion(HMCConfig(**cfg_kw), *setup, n_chains=mt.shape[0],
                               device=device, solve_cfg=exact, device_mesh=mesh, **kw)

    full = run(cfgs["resume"], checkpoint_path=f"{tmp}/full.npz", checkpoint_every=3)
    run(cfgs["resume"], n_samples=6, checkpoint_path=f"{tmp}/part.npz",
        checkpoint_every=3)
    resumed = run(cfgs["resume"], checkpoint_path=f"{tmp}/part.npz", checkpoint_every=3,
                  resume=True)
    out["full"], out["resumed"] = _result(full.result), _result(resumed.result)
    gn = run(cfgs["gn"])
    out["gn"] = _result(gn.result, gn.n_warm)

    from hmcmt2d_tpu_torch.sampler import graphed as G

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(G, "unservable", lambda problem: None)
        mp.setattr(G.GraphedPotential, "_capture", emulated_capture)
        gs = ShardedSampler(prob, 1.0, mesh, graphed=True)
        (U, (mis, mn, _)), g = gs.potential_vg(mt[lo:lo + n_l], mt.flip(0)[lo:lo + n_l])
        graphed = {"U": all_gather_cat(U, gs.chains),
                   "misfit": all_gather_cat(mis, gs.chains),
                   "mnorm": all_gather_cat(mn, gs.chains),
                   "grad": all_gather_cat(g, gs.chains)}
        res, _state, wmass, info = gs.warmup(opts, mt, mt, 6, 7)
        graphed["warmup"] = _result(res, wmass.inv_m, info.dt)
        graphed["run"] = _result(gs.run(opts, mass, mt, mt, 3, 5))
        graphed["kinds"] = sorted(c.kind for c in gs.local_vg.captures.values())
        graphed["released"] = sorted((c["rank"], c["kind"]) for c in gs.release())
        graphed["left"] = len(gs.local_vg.captures)
    out["graphed"] = graphed
    return _numpy_tree(out)


def median_pool_rank(device) -> dict:
    """One of two chain ranks of 3 chains each warming up on a quadratic,
    the global chains 0 and 1 (both on rank 0) stuck behind a cliff that
    rejects every move: the adapted step size under each pooling (after
    JAX's test_sharded_median_alpha_pool_survives_stuck_chain)."""
    torch.set_num_threads(1)
    from hmcmt2d_tpu_torch.parallel.multichain import make_device_mesh
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import hmc as H

    mesh = make_device_mesh(2, 1, device=device)
    group = mesh.get_group("chains")
    C_l, P = 3, 3
    gid = mesh.get_local_rank("chains") * C_l + torch.arange(C_l)
    cliff = torch.where(gid < 2, 1e6, 0.0).double()

    def vg(m, m_ref, fac=None):
        U = 0.5 * (m * m).sum(-1)
        moved = ((m - m_ref) ** 2).sum(-1) > 1e-20
        U = U + torch.where(moved, cliff, torch.zeros_like(cliff))
        return (U, (U, torch.zeros_like(U), torch.zeros(C_l, 1, dtype=U.dtype))), m

    opts = H.HMCOptions(dt=0.5, steps_lo=2, steps_hi=3, log_sig_lo=-50.0,
                        log_sig_hi=50.0, reg_param=1.0)
    m0 = torch.zeros(C_l, P, dtype=torch.float64)
    n_it, dts = 120, {}
    for pool in ("median", "mean"):
        # the pooled scan that ShardedSampler.warmup_scan runs
        carry, _outs = A.warmup_scan(
            vg, opts, m0, A.warmup_carry_init(vg, opts, m0, m0),
            A.warmup_keys(0, 0, n_it, device), np.zeros(n_it, bool),
            A.WarmupOptions(adapt_mass=False, alpha_pool=pool), pool=group)
        dts[pool] = float(A.warmup_finalize(carry)[1].dt)
    return dts


def single_mode_freq_rank(device, arrays, m, method: str = "thomas") -> dict:
    """One of two frequency ranks of a (1 chain x 2 freq) mesh: the summed
    potential value and gradient of the survey in ``arrays`` (complex128,
    engine ``method``), reduced over the freq group."""
    torch.set_num_threads(1)
    from hmcmt2d_tpu_torch import convert
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from hmcmt2d_tpu_torch.parallel.multichain import ShardedSampler, make_device_mesh

    prob = convert.problem_from_arrays(arrays, SolveConfig(torch.complex128, 0, method),
                                       device=device)
    ss = ShardedSampler(prob, 1.0, make_device_mesh(1, 2, device=device))
    mt = torch.as_tensor(m)
    (U, (mis, mn, _)), g = ss.potential_vg(mt, mt.flip(0))
    return _numpy_tree({"U": U, "misfit": mis, "mnorm": mn, "grad": g})

