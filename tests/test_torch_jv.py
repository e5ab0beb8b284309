"""Forward-mode J v and the bounded transforms against the JAX package.

``jv`` runs ``torch.func.jvp`` through the whole forward model, the
Dirichlet solve by its ``jvp`` (one more solve on the same factor); it is
held to JAX's ``jax.jvp`` on the tiny flagship (two-mode) and on a TE-only
survey, in complex128 (1e-9), and through a stale factor to itself.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _flagship_problem  # noqa: E402
from hmcmt2d_tpu.models import forward as JF  # noqa: E402
from hmcmt2d_tpu.models import jacobian as JJ  # noqa: E402
from hmcmt2d_tpu.utils import transforms as JT  # noqa: E402
from hmcmt2d_tpu_torch import convert  # noqa: E402
from hmcmt2d_tpu_torch.models import forward as TF  # noqa: E402
from hmcmt2d_tpu_torch.models import jacobian as TJ  # noqa: E402
from hmcmt2d_tpu_torch.models.forward import SolveConfig  # noqa: E402
from hmcmt2d_tpu_torch.utils import transforms as TT  # noqa: E402
from tests.test_torch_gradcheck import _small_system  # noqa: E402
from tests.torch_parity import (jax_problem_from_arrays, problem_arrays,  # noqa: E402
                                relerr, survey_arrays)

JV_TOL = 1e-9
TRANSFORM_TOL = 1e-14
EXACT_T = SolveConfig(torch.complex128, 0, "thomas")


@pytest.fixture(scope="module")
def base():
    jprob, m0 = _flagship_problem(tiny=True)
    return problem_arrays(jprob), np.asarray(m0)


@pytest.mark.parametrize("comps", [("ZXY", "ZYX"), ("ZXY",)], ids=["both", "te"])
def test_jv_matches_jax(base, comps):
    arrays = survey_arrays(base[0], comps)
    jprob = jax_problem_from_arrays(arrays, JF.SolveConfig(jnp.complex128, 0, "thomas"))
    tprob = convert.problem_from_arrays(arrays, EXACT_T, device="cpu")
    rng = np.random.default_rng(11)
    m = base[1] + 0.1 * rng.standard_normal(base[1].shape)
    v = rng.standard_normal(m.shape)
    want = jax.jit(lambda a, b: JJ.jv(jprob, a, b))(jnp.asarray(m), jnp.asarray(v))
    got = TJ.jv(tprob, torch.as_tensor(m), torch.as_tensor(v))
    assert got.shape == want.shape
    assert relerr(got, want) < JV_TOL
    # the adjoint identity <J v, w> = <v, J' w> ties it to the reverse mode
    w = rng.standard_normal(got.shape)
    a = float(got @ torch.as_tensor(w))
    b = float(torch.as_tensor(v) @ TJ.jtv(tprob, torch.as_tensor(m), torch.as_tensor(w)))
    assert abs(a - b) <= 1e-10 * abs(b)


def test_jv_through_a_stale_factor(base):
    """Under a stale factor (10 refinement steps) J v is the fresh one's."""
    tprob = convert.problem_from_arrays(base[0], EXACT_T, device="cpu")
    rng = np.random.default_rng(12)
    m = torch.as_tensor(base[1] + 0.05 * rng.standard_normal(base[1].shape))
    v = torch.as_tensor(rng.standard_normal(m.shape))
    fac = tprob.factor_state(m + 0.01 * torch.as_tensor(rng.standard_normal(m.shape)))
    assert relerr(TJ.jv(tprob, m, v, fac=fac), TJ.jv(tprob, m, v)) < 1e-9


@pytest.mark.parametrize("refine", [0, 2])
def test_solve_jvp_gradcheck(refine):
    """The solve's ``jvp`` against finite differences (forward mode only)."""
    cfg = SolveConfig(torch.complex128, refine, "thomas")
    assert torch.autograd.gradcheck(
        lambda d, oy, oz, b: TF.interior_solve(d, oy, oz, b, cfg), _small_system(refine),
        eps=1e-6, atol=1e-8, rtol=1e-6, check_forward_ad=True, check_backward_ad=False)


@pytest.mark.parametrize("cp", [2.0, 0.7])
def test_bounded_transforms_match_jax(cp):
    rng = np.random.default_rng(13)
    m = rng.uniform(-3.0, 3.0, (4, 5))
    lb, ub = 1e-4, 10.0
    sig_j = JT.model_transform_bounded(jnp.asarray(m), lb, ub, cp)
    sig_t = TT.model_transform_bounded(torch.as_tensor(m), lb, ub, cp)
    assert relerr(sig_t, sig_j) < TRANSFORM_TOL
    back_j = JT.bounded_model(sig_j, lb, ub, cp)
    back_t = TT.bounded_model(sig_t, lb, ub, cp)
    assert relerr(back_t, back_j) < TRANSFORM_TOL
    np.testing.assert_allclose(back_t.numpy(), m, rtol=0, atol=1e-9)
