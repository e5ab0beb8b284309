"""The plain reference against the program at a tiny size: the forward
model, potential and gradient against the program's exact complex128
engine, the Gauss-Newton product against the program's mass, the draws
recipe against the program's generator, and one reference iteration
against the program's with the same draws."""

import numpy as np
import torch

from benchmark import check as CK
from benchmark import harness
from benchmark.reference import forward as RF
from benchmark.reference import sampler as RS

EXACT = {"dtype": "complex128", "refine": 0, "method": "thomas", "inv": "lu"}
CPU = torch.device("cpu")


def _setup(root, seed=3):
    cfg = harness.load(root, "configs", "tiny")
    inp = harness.make_inputs(root, cfg, seed, CPU)
    problem, m0 = harness.build_problem(root, cfg, inp, EXACT, CPU)
    ref = RF.Reference(inp.model, inp.rx_y, inp.freqs, CPU, obs=inp.obs,
                       weights=1.0 / inp.err, reg=cfg["smoothparameter"])
    return cfg, inp, problem, m0, ref


def test_reference_reads_the_model_as_the_program(tiny_root):
    cfg, inp, problem, m0, ref = _setup(tiny_root)
    assert np.array_equal(ref.true_m().numpy(), m0)
    assert ref.n_param == problem.n_param


def test_potential_and_gradient_match_the_exact_engine(tiny_root):
    cfg, inp, problem, m0, ref = _setup(tiny_root)
    gen = torch.Generator().manual_seed(0)
    m = torch.as_tensor(m0)[None] + 0.1 * torch.randn((3, len(m0)), generator=gen,
                                                      dtype=torch.float64)
    m_ref = inp.m_start.double()[:1].expand(3, -1)
    (U, (mis, mn, pred)), g = problem.potential_value_and_grad(m, m_ref, 1.0)
    U2, mis2, mn2, pred2, g2 = ref.value_and_grad(m, m_ref)
    assert float(((U - U2).abs() / U2.abs()).max()) < 1e-10
    assert float((pred - pred2).abs().max() / pred2.abs().max()) < 1e-10
    assert float((g - g2).norm() / g2.norm()) < 1e-9
    assert torch.equal(mn, mn2)


def test_gauss_newton_product_matches_the_program_mass(tiny_root):
    from hmcmt2d_tpu_torch.sampler.driver import gauss_newton_mass

    cfg, inp, problem, m0, ref = _setup(tiny_root)
    mt = torch.as_tensor(m0)
    mass = gauss_newton_mass(problem, mt, 1.0, chunk=16, jitter=1e-6)
    V = torch.randn((3, len(m0)), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = CK.program_mass_product({"sqrt_m": mass.sqrt_m}, V, 1e-6)
    want = ref.gn_product(mt, V)
    assert max(float((a - b).norm() / b.norm()) for a, b in zip(got, want)) < 1e-7


def test_draws_follow_the_program_generator():
    from hmcmt2d_tpu_torch.sampler import hmc as H

    for seed, stream, index in ((1, RS.STREAM_MAIN, 0), (2**31 + 5, RS.STREAM_WARMUP, 77)):
        a = RS.generator(seed, stream, index, CPU)
        b = H.generator(seed, stream, index, CPU)
        assert a.initial_seed() == b.initial_seed()
    assert (H.STREAM_MAIN, H.STREAM_WARMUP) == (RS.STREAM_MAIN, RS.STREAM_WARMUP)


def test_one_iteration_matches_the_program(tiny_root):
    """The program's sampler step (exact engine, unit mass) and the
    reference's, with the draws the recipe makes, land on the same state."""
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

    cfg, inp, problem, m0, ref = _setup(tiny_root)
    vg = make_potential_vg(problem, 1.0)
    m_ref = inp.m_start.double()
    state = H.sample_chain_init(vg, inp.m_start.double(), m_ref)
    opts = harness.hmc_options(cfg, 0.02)
    mass = H.identity_mass(len(m0), torch.float64, CPU)
    for index in range(3):
        L, raw, u = RS.draws(9, RS.STREAM_MAIN, index, tuple(state.m.shape), cfg["timestep"],
                             CPU, dtype=torch.float64)
        new, acc, _, _, steps = H.make_sample_step(vg, opts)(
            state, H.generator(9, RS.STREAM_MAIN, index, CPU), m_ref, opts.dt, mass)
        assert steps == L

        def rvg(m):
            U, _, _, pred, g = ref.value_and_grad(m, m_ref)
            return U, pred, g

        U0, _, _, _, g0 = ref.value_and_grad(state.m, m_ref)
        p0 = raw.double()
        m1, p1, U1, _, g1 = RS.trajectory(rvg, state.m, g0, p0, L, opts.dt, lambda p: p,
                                          (opts.log_sig_lo, opts.log_sig_hi))
        a, _, _ = RS.mh(U0 + RS.kinetic(p0, lambda p: p), U1 + RS.kinetic(p1, lambda p: p),
                        torch.ones(len(u), dtype=torch.bool), u)
        assert torch.equal(a, acc)
        want = torch.where(a[:, None], m1, state.m)
        assert float((new.m - want).abs().max()) < 1e-9
        state = new
