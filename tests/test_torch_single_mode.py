"""Single-mode (TE-only or TM-only) surveys: the port's one-mode solve path
against the JAX package's, on the tiny flagship in complex128 on the CPU.

A single-mode survey solves only its own mode (C x nfreq systems), as
``hmcmt2d_tpu/models/forward.py`` ``response_cube`` does, and like it
ignores a stale factor ``fac``: the one-mode branches always factorise
afresh.  The surveys are the tiny flagship's mesh and receivers with every
(freq, rx, comp) triple of their components observed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.models import forward as JF  # noqa: E402
from hmcmt2d_tpu.sampler.driver import make_potential_vg as jax_vg  # noqa: E402
from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.models import forward as TF  # noqa: E402
from hmcmt2d_tpu_torch.parallel import multichain  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg  # noqa: E402
from tests.torch_parity import (chain_models, jax_problem_from_arrays,  # noqa: E402
                                problem_arrays, relerr, single_mode_freq_rank,
                                survey_arrays)

TOL = 1e-10
GRAD_TOL = 1e-8
MT1D_FLOOR = 1e-5    # boundary grids: the 1-D field's rounding floor
FIELD_FLOOR = 1e-3   # node fields: the bottom ring's noise spreads inward
EXACT_J = JF.SolveConfig(jnp.complex128, 0, "thomas")
EXACT_T = TF.SolveConfig(torch.complex128, 0, "thomas")
SURVEYS = {"ZXY": (("ZXY",), "Impedance"),
           "ZXY+TZY": (("ZXY", "TZY"), "Impedance_Tipper"),
           "ZYX": (("ZYX",), "Impedance"),
           "RhoYX+PhsYX": (("RhoYX", "PhsYX"), "Rho_Phs")}


@pytest.fixture(scope="module")
def base():
    jprob, m0 = _flagship_problem(tiny=True)
    return problem_arrays(jprob), np.asarray(m0)


def _above_floor_err(got, want, floor) -> float:
    """relerr over the entries above ``floor`` x max|want|: the deep tail of
    the 1-D boundary field is rounding noise in both frameworks (see
    tests/test_torch_mesh.py), and the solve carries it into the deepest
    node fields."""
    got, want = got.numpy(), np.asarray(want)
    keep = np.abs(want) > floor * np.abs(want).max()
    assert keep[..., :, 0].mean() > 0.5          # most of the left column
    return float(np.abs(got - want)[keep].max() / np.abs(want).max())


def _pair(base, name):
    arrays = survey_arrays(base[0], *SURVEYS[name])
    return (jax_problem_from_arrays(arrays, EXACT_J),
            convert.problem_from_arrays(arrays, EXACT_T, device="cpu"), arrays)


@pytest.mark.parametrize("name", list(SURVEYS))
def test_single_mode_cube_matches_jax(base, name):
    jprob, tprob, _ = _pair(base, name)
    m = chain_models(base[1], 2)
    cube_j = jax.jit(jprob.fwd.response_cube)(jprob.sigma2d(jnp.asarray(m)))
    cube_t = tprob.fwd.response_cube(tprob.sigma2d(torch.as_tensor(m)))
    assert cube_t.shape == cube_j.shape
    assert relerr(cube_t, cube_j) < TOL


@pytest.mark.parametrize("name", list(SURVEYS))
def test_single_mode_potential_and_gradient_match_jax(base, name):
    jprob, tprob, _ = _pair(base, name)
    m = chain_models(base[1], 2)
    (jU, _), jg = jax.jit(jax_vg(jprob, 0.7))(jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    mt = torch.as_tensor(m)
    (U, _), g = make_potential_vg(tprob, 0.7)(mt, mt.flip(0))
    assert relerr(U, jU) < TOL
    jg = np.asarray(jg)
    assert np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg) < GRAD_TOL


def test_single_mode_ignores_a_stale_factor(base):
    """A TE-only survey handed a factor taken at a perturbed model (active
    cells + 0.3 N(0, 1)) gives JAX's response cube, whose one-mode branch
    takes no factor and solves afresh."""
    jprob, tprob, _ = _pair(base, "ZXY")
    m = chain_models(base[1], 2)
    m_far = m + 0.3 * np.random.default_rng(5).standard_normal(m.shape)
    fac = tprob.factor_state(torch.as_tensor(m_far))
    sig = tprob.sigma2d(torch.as_tensor(m))
    cube_t = tprob.fwd.response_cube(sig, fac=fac)
    cube_j = jax.jit(jprob.fwd.response_cube)(jprob.sigma2d(jnp.asarray(m)))
    assert relerr(cube_t, cube_j) < TOL
    U_t = tprob.potential(torch.as_tensor(m), torch.as_tensor(m), 1.0, fac=fac)[0]
    U_j = jax.jit(lambda a: jprob.potential(a, a, 1.0))(jnp.asarray(m))[0]
    assert relerr(U_t, U_j) < TOL


def test_mode_helpers_match_jax(base):
    jprob, tprob, _ = _pair(base, "ZXY")
    m = chain_models(base[1], 2)
    sig_j, sig_t = jprob.sigma2d(jnp.asarray(m)), tprob.sigma2d(torch.as_tensor(m))
    freqs = np.asarray(tprob.fwd.data.freqs)[[2, 0]]
    om = 2 * np.pi * freqs
    for mode in ("TE", "TM"):
        bc_t = TF.boundary_grid(tprob.mesh, sig_t, torch.as_tensor(om), mode,
                                torch.complex128)
        bc_j = JF.boundary_grid(jprob.mesh, sig_j, jnp.asarray(om), mode, jnp.complex128)
        assert _above_floor_err(bc_t, bc_j, MT1D_FLOOR) < TOL
        f_t = tprob.fwd.mode_solution(sig_t, mode, freqs)
        f_j = jax.jit(lambda s, mode=mode: jprob.fwd.mode_solution(s, mode, freqs))(sig_j)
        assert f_t.shape == f_j.shape and _above_floor_err(f_t, f_j, FIELD_FLOOR) < TOL
        z_t = tprob.fwd.mode_impedance(sig_t, mode, freqs)
        z_j = jax.jit(lambda s, mode=mode: jprob.fwd.mode_impedance(s, mode, freqs))(sig_j)
        assert z_t.shape == z_j.shape and relerr(z_t, z_j) < TOL
    # one mode of the merged two-mode solve is that mode's own solve
    te, tm = tprob.fwd.both_mode_solutions(sig_t, freqs)
    assert relerr(tprob.fwd.mode_solution(sig_t, "TE", freqs), te) < 1e-12
    assert relerr(tprob.fwd.mode_solution(sig_t, "TM", freqs), tm) < 1e-12


def test_frequency_sharded_te_only_potential_matches_single_process(base):
    """A (1 chain x 2 freq) mesh of gloo ranks on a TE-only survey: the
    summed potential and gradient equal the single process's."""
    _, tprob, arrays = _pair(base, "ZXY")
    m = chain_models(base[1], 2)
    outs = multichain.spawn_ranks(single_mode_freq_rank, 2, args=(arrays, m),
                                  backend="gloo", device="cpu", timeout_s=240.0)
    mt = torch.as_tensor(m)
    (U, (mis, mn, _)), g = make_potential_vg(tprob, 1.0)(mt, mt.flip(0))
    for out in outs:
        for name, want in (("U", U), ("misfit", mis), ("mnorm", mn), ("grad", g)):
            assert out[name].shape == tuple(want.shape), name
            assert relerr(out[name], want) < 1e-12, name
