"""Port parity of the Jacobian and the Gauss-Newton mass
(``models/jacobian.py``, ``sampler/driver.py::gauss_newton_mass``).

On the tiny problem in complex128 on both sides.  The port takes all rows
of J from one factorisation at the model shared by ``chunk`` right-hand
sides per adjoint; JAX vmaps its pullback.  Tolerances: 1e-9 relative for
J and the mass (exact solves, other summation orders), 1e-12 for the
solver's multi-right-hand-side path against one solve per column.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.models import jacobian as JJ  # noqa: E402
from hmcmt2d_tpu.sampler.driver import gauss_newton_mass as jax_gn  # noqa: E402
from hmcmt2d_tpu_torch.models import jacobian as TJ  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as S  # noqa: E402
from hmcmt2d_tpu_torch.sampler.driver import gauss_newton_mass  # noqa: E402
from tests.torch_parity import relerr, tiny_problems  # noqa: E402

TOL = 1e-9


@pytest.fixture(scope="module")
def case():
    """The port's problem and JAX's results: J, J'w, the GN mass, Wm."""
    jprob, tprob, m0 = tiny_problems()
    m = m0 + 0.05
    J = np.asarray(JJ.full_jacobian_chunked(jprob, jnp.asarray(m), chunk=7))
    w = np.random.default_rng(0).standard_normal(J.shape[0])
    jtw = np.asarray(jax.jit(lambda mm, ww: JJ.jtv(jprob, mm, ww))(
        jnp.asarray(m), jnp.asarray(w)))
    gn = jax_gn(jprob, jnp.asarray(m), reg=1.0)
    return dict(tprob=tprob, m=m, J=J, w=w, jtw=jtw,
                gn_sqrt=np.asarray(gn.sqrt_m), gn_inv=np.asarray(gn.inv_m),
                wm=jprob.wm_dense())


def test_chunked_jacobian_matches_jax(case):
    J = TJ.full_jacobian_chunked(case["tprob"], torch.as_tensor(case["m"]), chunk=7)
    assert J.dtype == np.float64 and J.shape == case["J"].shape
    assert J.shape[0] % 7 != 0                   # the tail slab is exercised
    assert relerr(J, case["J"]) < TOL


def test_full_jacobian_is_one_chunk(case):
    J = TJ.full_jacobian(case["tprob"], torch.as_tensor(case["m"]))
    assert relerr(J, case["J"]) < TOL


def test_jtv_matches_jax(case):
    w = case["w"]
    got = TJ.jtv(case["tprob"], torch.as_tensor(case["m"]), torch.as_tensor(w))
    assert relerr(got, case["jtw"]) < TOL
    assert relerr(got, case["J"].T @ w) < TOL


def test_gauss_newton_mass_matches_jax(case):
    tm = gauss_newton_mass(case["tprob"], torch.as_tensor(case["m"]), 1.0)
    assert not tm.diagonal and tm.sqrt_m.dtype == torch.float64
    assert relerr(tm.sqrt_m, case["gn_sqrt"]) < TOL
    assert relerr(tm.inv_m, case["gn_inv"]) < 1e-7   # inverse of a cond ~1e6 matrix
    L, jL = tm.sqrt_m.numpy(), case["gn_sqrt"]
    M = L @ L.T
    assert relerr(M, jL @ jL.T) < TOL
    assert np.linalg.eigvalsh(M).min() > 0


def test_wm_dense_matches_jax(case):
    got = case["tprob"].wm_dense(chunk=13)
    np.testing.assert_allclose(got, case["wm"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("wide", [(1,), (0, 2)], ids=["one-axis", "two-axes"])
def test_solver_shares_a_factor_across_right_hand_sides(wide):
    """bt_solve (matrix products over the columns) and the fused path (one
    sweep pair per column; the kernels' plain versions here) against one
    solve per right-hand side."""
    rng = np.random.default_rng(1)
    nzi, q = 5, 6
    batch = [3, 4, 2]
    fbatch = [1 if i in wide else n for i, n in enumerate(batch)]
    d = torch.as_tensor(4.0 + rng.standard_normal(fbatch + [nzi, q])
                        + 1j * rng.standard_normal(fbatch + [nzi, q]))
    oy = torch.as_tensor(1.0 + 0.1 * rng.standard_normal(fbatch + [nzi, q - 1]))
    oz = torch.as_tensor(1.0 + 0.1 * rng.standard_normal(fbatch + [nzi - 1, q]))
    sys_ = S.InteriorSystem(d, oy, oz)
    b = torch.as_tensor(rng.standard_normal(batch + [nzi, q])
                        + 1j * rng.standard_normal(batch + [nzi, q]))
    want = torch.empty_like(b)
    fac = S.factorize(sys_, method="thomas")
    for idx in np.ndindex(*[batch[i] for i in wide]):
        sl = [slice(None)] * 3
        for i, k in zip(wide, idx):
            sl[i] = slice(k, k + 1)
        want[tuple(sl)] = S.factor_solve(fac, b[tuple(sl)])
    got = S.factor_solve(fac, b)
    assert relerr(got, want) < 1e-12
    assert relerr(S.apply_interior(sys_, got), b) < 1e-12
    fused = S.factorize(sys_, dtype=torch.complex64, method="fused")
    assert relerr(S.factor_solve(fused, b), want) < 1e-4
