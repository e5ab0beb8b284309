"""The port's sharded sampler (``hmcmt2d_tpu_torch.parallel``) on the CPU.

The tiny problem of ``tests/test_e2e.py::tiny_setup`` (2 frequencies, 3
receivers) under exact complex128 thomas, float64 models, C = 4 chains.  The
multi-rank cases run in groups of gloo ranks spawned on this host
(``parallel.multichain.spawn_ranks``, each with a wall limit), one group a
module fixture and each case its own test.  On the (2 chains x 2 freq) mesh
each frequency rank solves one frequency.

The port's rule, which JAX's sharded sampler does not keep (its chain shards
draw from ``fold_in(key, shard)``): a sharded run equals the single-process
run of the same chains, up to the order of reduction.

On the card a rank serves its local work (value-and-grad, cube factor,
stale eval) from CUDA graphs.  Here the graphs are emulated
(``tests/torch_parity.py::emulated_capture``: a replay reruns the captured
function into static buffers), and the local work is held to make no host
round trip after its first call, which a capture needs.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.models import forward as JF  # noqa: E402
from hmcmt2d_tpu.models.posterior import build_inverse_problem  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert, entry  # noqa: E402
from hmcmt2d_tpu_torch.io import HMCConfig  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.parallel import ShardedSampler, multichain  # noqa: E402
from hmcmt2d_tpu_torch.sampler import adapt as A  # noqa: E402
from hmcmt2d_tpu_torch.sampler import driver as D  # noqa: E402
from hmcmt2d_tpu_torch.sampler import hmc as H  # noqa: E402
from tests.test_e2e import tiny_setup  # noqa: E402
from hmcmt2d_tpu_torch.sampler import graphed as G  # noqa: E402
from tests.torch_parity import (SHARD_OPTS, chain_models, median_pool_rank,  # noqa: E402
                                no_host_round_trip, port_setup, problem_arrays, relerr,
                                sharded_cases, tensors)

EXACT = SolveConfig(torch.complex128, 0, "thomas")
TOL = 1e-10
RANK_TIMEOUT_S = 240.0
BASE = dict(sig_bounds=(1e-4, 10.0), dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0)
CFGS = {"resume": dict(BASE, adapt=False, burnin=3, total_samples=9),
        "gn": dict(BASE, adapt=True, burnin=4, total_samples=10, warmup_pool="median",
                   mass_type="gaussnewton", mass_warmup=2, mass_dt0=0.2)}


@pytest.fixture(scope="module")
def tiny():
    mesh, start_sig, data, obs, err = tiny_setup()
    jprob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                      cfg=JF.SolveConfig(jnp.complex128, 0, "thomas"))
    arrays = problem_arrays(jprob)
    tmesh, tdata = port_setup(mesh, data)
    return dict(jprob=jprob, arrays=arrays, m=chain_models(np.asarray(m0), 4, 0.05),
                tprob=convert.problem_from_arrays(arrays, EXACT, device="cpu"),
                setup=(tmesh, start_sig, tdata, obs, err))


@pytest.fixture(scope="module")
def group(tiny, tmp_path_factory):
    """The (2 x 2) group's results, one dict a rank."""
    tmp = tmp_path_factory.mktemp("sharded")
    return multichain.spawn_ranks(
        sharded_cases, 4, args=(tiny["arrays"], tiny["setup"], tiny["m"], CFGS, str(tmp)),
        backend="gloo", device="cpu", timeout_s=RANK_TIMEOUT_S)


class _Mesh:
    """The calls ShardedSampler makes of a DeviceMesh, for the checks that
    come before any collective."""

    def __init__(self, n_chain, n_freq):
        self.shape = (n_chain, n_freq)

    def size(self, dim):
        return self.shape[dim]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


def _single_result(res) -> dict:
    return {k: getattr(res, k).numpy() for k in ("models", "stats", "accepts", "pred",
                                                 "lf_steps", "start_stats",
                                                 "start_pred")} | {
        "final_m": res.final.m.numpy()}


def _assert_close(got: dict, want: dict, tol=TOL):
    np.testing.assert_array_equal(got["accepts"], want["accepts"])
    np.testing.assert_array_equal(got["lf_steps"], want["lf_steps"])
    for k in ("models", "final_m", "stats", "pred", "start_stats", "start_pred"):
        assert got[k].shape == want[k].shape, k
        assert relerr(got[k], want[k]) < tol, k


def test_divisibility_errors(tiny):
    prob, m = tiny["tprob"], torch.as_tensor(tiny["m"])
    with pytest.raises(ValueError, match="must divide"):
        ShardedSampler(prob, 1.0, _Mesh(1, 3))
    ss = ShardedSampler(prob, 1.0, _Mesh(3, 2))
    opts = H.HMCOptions(**SHARD_OPTS)
    with pytest.raises(ValueError, match="must divide"):
        ss.run(opts, H.identity_mass(m.shape[1], device="cpu"), m, m, 2, 0)
    with pytest.raises(ValueError, match="must divide"):
        ss.warmup(opts, m, m, 2, 0)


def test_backend_follows_the_ranks_on_each_host(monkeypatch):
    """8 ranks joined with --coordinator over two hosts of 4 GPUs, their
    ranks interleaved: rank 5 finds 4 ranks on its host, takes the GPU of
    its place among them and NCCL; more ranks than GPUs on a host take
    gloo."""
    import torch.distributed as dist

    store = dist.HashStore()
    for r in range(8):
        if r != 5:
            store.set(f"hmcmt2d/host/{r}", "ab"[r % 2])
    joined = {}
    monkeypatch.setattr(multichain.socket, "gethostname", lambda: "b")
    monkeypatch.setattr(dist, "TCPStore", lambda *a, **k: store)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **k: joined.update(k, backend=backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    assert multichain.host_layout(store, 5, 8) == (2, 4)
    dev = multichain.distributed_init("h:29500", 8, 5)
    assert dev == torch.device("cuda", 2)
    assert (joined["backend"], joined["rank"], joined["world_size"]) == ("nccl", 5, 8)
    assert joined["store"] is store
    assert multichain.pick_backend(torch.device("cuda", 0), 4) == "nccl"
    assert multichain.pick_backend(torch.device("cuda", 0), 8) == "gloo"
    assert multichain.pick_backend(torch.device("cpu"), 1) == "gloo"


def test_potential_cube_on_a_frequency_subset_matches_jax(tiny):
    jprob, tprob, m = tiny["jprob"], tiny["tprob"], tiny["m"]
    obs, w = tprob.cube_arrays()
    for got, want in zip((obs, w), jprob.cube_arrays()):
        np.testing.assert_array_equal(got, want)
    freqs = np.asarray(tprob.fwd.data.freqs)[1:]
    U, (mis, mn, cube) = tprob.potential_cube(
        torch.as_tensor(m), torch.as_tensor(m[::-1].copy()), 0.7, freqs, obs[1:], w[1:],
        prior_scale=0.5)
    jU, (jmis, jmn, jcube) = jax.jit(lambda a, b: jprob.potential_cube(
        a, b, 0.7, jnp.asarray(freqs), jnp.asarray(obs[1:]), jnp.asarray(w[1:]),
        prior_scale=0.5))(jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    for a, b in ((U, jU), (mis, jmis), (mn, jmn)):
        assert relerr(a, b) < 1e-12
    assert cube.shape == jcube.shape and relerr(cube, jcube) < 1e-12


def test_cube_potential_matches_masked(tiny):
    tprob, m = tiny["tprob"], torch.as_tensor(tiny["m"])
    obs, w = tprob.cube_arrays()
    U, (mis, mn, cube) = tprob.potential_cube(m, m.flip(0), 1.0, tprob.fwd.data.freqs,
                                              obs, w)
    Uv, (misv, mnv, pred) = tprob.potential(m, m.flip(0), 1.0)
    for a, b in ((U, Uv), (mis, misv), (mn, mnv)):
        assert relerr(a, b) < 1e-12
    idx = torch.as_tensor(tprob.fwd.data.flat_index)
    assert torch.equal(cube[:, idx], pred)


def test_every_rank_returns_the_same_result(group):
    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)]

    want = dict(flat(group[0]))
    for other in group[1:]:
        got = dict(flat(other))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_value_and_grad_match_jax(tiny, group):
    m = tiny["m"]
    (U, (mis, mn, _)), g = jax.jit(jax_vg(tiny["jprob"], 1.0))(
        jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    got = group[0]
    for name, want in (("U", U), ("misfit", mis), ("mnorm", mn), ("grad", g)):
        assert got[name].shape == np.shape(want), name
        assert relerr(got[name], want) < TOL, name


def test_sharded_run_matches_single_process(tiny, group):
    m = torch.as_tensor(tiny["m"])
    opts = H.HMCOptions(**SHARD_OPTS)
    res = H.run_hmc(D.make_potential_vg(tiny["tprob"], 1.0), opts,
                    H.identity_mass(m.shape[1], device="cpu"), m, m, 3, 5,
                    factor_fn=D.make_factor_fn(tiny["tprob"]))
    _assert_close(group[0]["run"], _single_result(res))


def test_sharded_warmup_matches_single_process(tiny, group):
    m = torch.as_tensor(tiny["m"])
    res, _state, mass, info = A.warmup(D.make_potential_vg(tiny["tprob"], 1.0),
                                       H.HMCOptions(**SHARD_OPTS), m, m, 6, 7,
                                       factor_fn=D.make_factor_fn(tiny["tprob"]))
    got = group[0]["warmup"]
    _assert_close(got, _single_result(res))
    assert relerr(got["extra0"], mass.inv_m) < TOL
    assert relerr(got["extra1"], info.dt) < TOL


def test_sharded_readapt_matches_single_process(tiny, group):
    """Step-size-only adaptation under a fixed dense mass, from the run's
    final state, continuing the warmup stream at iteration 6."""
    m = torch.as_tensor(tiny["m"])
    vg = D.make_potential_vg(tiny["tprob"], 1.0)
    opts = H.HMCOptions(**SHARD_OPTS)
    state = H.run_hmc(vg, opts, H.identity_mass(m.shape[1], device="cpu"), m, m, 3, 5,
                      factor_fn=D.make_factor_fn(tiny["tprob"])).final
    eye = torch.eye(m.shape[1], dtype=torch.float64)
    carry, outs = A.warmup_scan(
        vg, opts, m, A.carry_from_state(state, opts.dt), A.warmup_keys(9, 6, 3, "cpu"),
        np.zeros(3, bool), A.WarmupOptions(adapt_mass=False),
        factor_fn=D.make_factor_fn(tiny["tprob"]),
        fixed_mass=H.MassMatrix(eye, eye, diagonal=False))
    _, info = A.warmup_finalize(carry)
    got = group[0]["readapt"]
    np.testing.assert_array_equal(got["accepts"], outs[2].numpy())
    for k, want in (("models", outs[0]), ("stats", outs[1]), ("final_m", carry.state.m),
                    ("extra0", info.dt)):
        assert relerr(got[k], want) < TOL, k


def test_checkpoint_resumes_only_on_its_kind_of_path(tmp_path):
    from hmcmt2d_tpu_torch.sampler import checkpoint as CK

    C, P, S, Dn = 2, 3, 4, 5
    z = torch.zeros
    state = H.ChainState(m=z(C, P), grad=z(C, P), misfit=z(C), mnorm=z(C),
                         pred=z(C, Dn, dtype=torch.complex64))
    for kind, other in (("sharded", "single"), ("single", "sharded")):
        path = str(tmp_path / f"{kind}.npz")
        CK.save_checkpoint(path, n_done=1, state=state, key=0, dt=0.1,
                           mass=H.identity_mass(P, device="cpu"), m_ref=z(C, P),
                           models=z(S, C, P), stats=z(S, C, 4),
                           accepts=z(S, C, dtype=torch.bool),
                           pred=z(S, C, Dn, dtype=torch.complex64),
                           lf_steps=z(S, C, dtype=torch.int32), start_stats=z(C, 4),
                           start_pred=z(C, Dn, dtype=torch.complex64), n_warm=0,
                           wall_time=1.0, path_kind=kind)
        assert CK.load_checkpoint(path, "cpu", kind)["path"] == kind
        with pytest.raises(ValueError, match=f"written by a {kind} run"):
            CK.load_checkpoint(path, "cpu", other)


def test_sharded_warmup_segmented_is_bit_exact(group):
    one, seg = group[0]["warmup"], group[0]["warmup_seg"]
    assert one.keys() == seg.keys()
    for k in one:
        np.testing.assert_array_equal(one[k], seg[k], err_msg=k)


def test_sharded_checkpointed_run_resumes_bit_exactly(group):
    full, resumed = group[0]["full"], group[0]["resumed"]
    assert full["models"].shape[:2] == (9, 4)
    for k in ("models", "stats", "accepts", "pred", "lf_steps", "final_m"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


def test_sharded_gauss_newton_schedule_matches_single_process(tiny, group):
    run = D.run_inversion(HMCConfig(**CFGS["gn"]), *tiny["setup"], n_chains=4,
                          device="cpu", solve_cfg=EXACT)
    got = group[0]["gn"]
    assert int(got["extra0"]) == run.n_warm == 6
    _assert_close(got, _single_result(run.result), tol=1e-9)


def test_sharded_median_alpha_pool_survives_stuck_chains():
    """Two of six global chains, both on rank 0, never move: the median of
    the gathered alphas keeps adapting, the mean drags dt toward zero."""
    dts = multichain.spawn_ranks(median_pool_rank, 2, backend="gloo", device="cpu",
                                 timeout_s=RANK_TIMEOUT_S)
    assert dts[0] == dts[1]
    assert dts[0]["median"] > 0.05, dts
    assert dts[0]["mean"] < dts[0]["median"] / 50, dts


def test_dryrun_multichip_on_four_cpu_ranks():
    out = entry.dryrun_multichip(4, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert len(out) == 4 and all(o == out[0] for o in out)
    assert tuple(out[0]["mesh"]) == (2, 2) and out[0]["chains"] == 4
    assert np.isfinite(out[0]["misfit"]).all() and out[0]["dt"] > 0


# -- the graphed sharded path ----------------------------------------------
def _cases(got: dict, want: dict):
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_graphed_sharded_warmup_and_run_equal_eager(group):
    """On the (2 x 2) group, a sharded warmup and an amortised run served
    from emulated graphs (fresh eval, cube factor, stale eval; the
    freq-group sum after each replay) equal the eager sharded ones bit for
    bit."""
    for rank in group:
        graphed = rank["graphed"]
        _cases(graphed["warmup"], rank["warmup"])
        _cases(graphed["run"], rank["run"])
        assert graphed["kinds"] == ["eval", "factor", "stale"]
        for name in ("U", "misfit", "mnorm", "grad"):
            np.testing.assert_array_equal(graphed[name], rank[name], err_msg=name)


def test_graphed_sharded_value_and_grad_match_jax(tiny, group):
    m = tiny["m"]
    (U, (mis, mn, _)), g = jax.jit(jax_vg(tiny["jprob"], 1.0))(
        jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    got = group[0]["graphed"]
    for name, want in (("U", U), ("misfit", mis), ("mnorm", mn), ("grad", g)):
        assert got[name].shape == np.shape(want), name
        assert relerr(got[name], want) < TOL, name


def test_graphed_sharded_release_empties_the_captures(group):
    """``release()`` drops every rank's graphs and returns every rank's
    capture summaries, each with its rank (a collective)."""
    for rank in group:
        assert rank["graphed"]["left"] == 0
        assert [tuple(c) for c in rank["graphed"]["released"]] == [
            (r, kind) for r in range(4) for kind in ("eval", "factor", "stale")]


SHARDED_ENGINES = {"fused": SolveConfig(torch.complex64, 6, "fused"),
                   "bcr_gj": SolveConfig(torch.complex64, 6, "bcr", "gj")}


@pytest.mark.parametrize("engine", sorted(SHARDED_ENGINES))
def test_sharded_local_work_makes_no_host_round_trip_after_its_first(engine):
    """A frequency rank's local eval, cube factor and stale eval (the tiny
    flagship's first two of four frequencies at prior_scale 1/2, fused and
    bcr+gj through their plain versions), after a first call of each, read
    nothing back to the host and copy nothing from it, and give what they
    gave the first time: what a capture of each needs."""
    prob, m0 = entry.flagship_problem(tiny=True, device="cpu", cfg=SHARDED_ENGINES[engine])
    ss = ShardedSampler(prob, 1.0, _Mesh(1, 2))
    assert ss.n_freq_dev == 2 and len(ss.freqs) == prob.fwd.data.n_freq // 2
    m = torch.as_tensor(chain_models(m0, 2).astype(np.float32))

    def calls():
        fac = ss.factor_fn(m + 0.01)
        return ss.local_vg(m, m), fac, ss.local_vg(m, m, fac)

    first = calls()
    with no_host_round_trip() as made:
        again = calls()
    assert made == []
    for x, y in zip(first, again):
        tx, ty = tensors(x), tensors(y)
        assert len(tx) == len(ty) > 0 and all(torch.equal(a, b) for a, b in zip(tx, ty))
    flat, cube, dtypes = first[0]
    assert flat.dtype == torch.float64 and flat.shape == (2, 3 + len(m0))
    assert dtypes[3] == m.dtype


def test_sharded_sampler_takes_the_graphs_where_they_serve(monkeypatch):
    """``graphed=None`` serves a CPU problem eagerly and takes the graphs
    where they serve (a CUDA problem; here ``unservable`` says so): the
    local eval is then a GraphedPotential over the rank's own functions,
    and the amortised factor its factor graph; ``graphed=False`` stays
    eager and ``amortize=False`` has no factor."""
    prob, _ = entry.flagship_problem(tiny=True, device="cpu")
    eager = ShardedSampler(prob, 1.0, _Mesh(1, 2))
    assert not isinstance(eager.local_vg, G.GraphedPotential)
    assert eager.local_vg == eager._local_vg and eager.factor_fn == eager._factor
    monkeypatch.setattr(G, "unservable", lambda problem: None)
    for graphed in (None, True):
        ss = ShardedSampler(prob, 1.0, _Mesh(1, 2), graphed=graphed)
        vg = ss.local_vg
        assert isinstance(vg, G.GraphedPotential) and vg.captures == {}
        assert vg.eval_fn == ss._local_vg and vg.factor_fn == ss._factor
        assert ss.factor_fn == vg.factor
    assert ShardedSampler(prob, 1.0, _Mesh(1, 2), amortize=False).factor_fn is None
    still = ShardedSampler(prob, 1.0, _Mesh(1, 2), graphed=False)
    assert not isinstance(still.local_vg, G.GraphedPotential)
    assert isinstance(D.make_sampler(prob, 1.0, True).potential_vg, G.GraphedPotential)
    assert not isinstance(D.make_sampler(prob, 1.0, True, graphed=False).potential_vg,
                          G.GraphedPotential)


def test_sharded_sampler_graphed_true_raises_off_the_card():
    prob, _ = entry.flagship_problem(tiny=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA problem"):
        ShardedSampler(prob, 1.0, _Mesh(1, 2), graphed=True)
    with pytest.raises(ValueError, match="CUDA problem"):
        D.make_sampler(prob, 1.0, True, graphed=True)
