"""Port parity: the block-tridiagonal solver in complex128 (thomas engine).

Systems are the real MT interior operator of a small graded mesh (TE and TM,
with air rows), built from the same numpy conductivities on both sides.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu import mesh as JM  # noqa: E402
from hmcmt2d_tpu.ops import solver as JS  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

TOL = 1e-10


def _systems(mode, freq=1.0, seed=0):
    dy, dz = small_mesh(10, 8)
    jm = JM.make_mesh(dy, dz)
    tm = TM.make_mesh(dy, dz, device="cpu")
    rng = np.random.default_rng(seed)
    sig = np.exp(rng.uniform(np.log(1e-3), np.log(1.0), (2, tm.nz, tm.ny)))
    sig[:, :2] = 1e-8
    om = np.array([2 * np.pi * freq, 2 * np.pi * 10 * freq]).reshape(2, 1, 1, 1)
    jfn = JM.te_stencil if mode == "TE" else JM.tm_stencil
    tfn = TM.te_stencil if mode == "TE" else TM.tm_stencil
    jsys = JS.interior_system(jfn(jm, jnp.asarray(sig)), jnp.asarray(om))
    tsys = TS.interior_system(tfn(tm, torch.as_tensor(sig)), torch.as_tensor(om))
    b = rng.standard_normal(jsys.diag.shape + (2,)) @ np.array([1, 1j])
    return jsys, tsys, b


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_interior_system_and_equilibrate_match_jax(mode):
    jsys, tsys, b = _systems(mode)
    for a, w in zip(tsys, jsys):
        assert relerr(a, w) < TOL
    (je, js), (te, ts) = JS.equilibrate(jsys), TS.equilibrate(tsys)
    for a, w in zip(te, je):
        assert relerr(a, w) < TOL
    assert relerr(ts, js) < TOL
    assert relerr(TS.apply_interior(tsys, torch.as_tensor(b)),
                  JS.apply_interior(jsys, jnp.asarray(b))) < TOL


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_bt_factor_and_solve_match_jax(mode):
    jsys, tsys, b = _systems(mode, seed=1)
    (jq, _), (tq, _) = JS.equilibrate(jsys), TS.equilibrate(tsys)
    jf, tf = JS.bt_factor(jq), TS.bt_factor(tq)
    assert tf.G.shape == jf.G.shape
    assert relerr(tf.G, jf.G) < TOL
    x = TS.bt_solve(tf, torch.as_tensor(b))
    assert relerr(x, JS.bt_solve(jf, jnp.asarray(b))) < TOL
    # the solve inverts the (equilibrated) operator
    assert relerr(TS.apply_interior(tq, x), b) < TOL


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_refined_solve_matches_jax(mode):
    jsys, tsys, b = _systems(mode, freq=0.01, seed=2)
    jx = JS.refined_solve(jsys, JS.factorize(jsys, method="thomas"),
                          jnp.asarray(b), iters=2)
    tx = TS.refined_solve(tsys, TS.factorize(tsys, method="thomas"),
                          torch.as_tensor(b), iters=2)
    assert relerr(tx, jx) < TOL
    x0 = TS.factor_solve(TS.factorize(tsys), torch.as_tensor(b))
    assert relerr(x0, jx) < TOL


def test_factorize_rejects_unknown_method():
    _, tsys, _ = _systems("TE")
    with pytest.raises(ValueError):
        TS.factorize(tsys, method="mumps")
