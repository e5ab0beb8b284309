"""The port's CPU oracles and small solver helpers against the JAX package.

``hmcmt2d_tpu_torch.native`` (ctypes band LDL^T over ``native/band_solver.cc``)
and ``hmcmt2d_tpu_torch.utils.cpu_reference`` (the scipy sparse assembly) are
numpy copies of the JAX package's oracles; here they check the port's thomas
solver and stencils as ``tests/test_native.py`` and ``tests/test_operators.py``
check the JAX package's, and ``mesh.boundary_rhs`` and ``solver.direct_solve``
are held to their JAX counterparts (1e-12).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu import mesh as JM  # noqa: E402
from hmcmt2d_tpu.ops import solver as JS  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch import native  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from hmcmt2d_tpu_torch.utils import cpu_reference as R  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.test_native import dense_from_interior, random_interior  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

TOL = 1e-12
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native toolchain unavailable")


def _setup(mode, ny=9, nz=7):
    """tests/test_operators.py's graded mesh and conductivity, both sides."""
    rng = np.random.default_rng(3)
    dy, dz = small_mesh(ny, nz, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(nz, ny))
    sigma[:2] = 1e-8
    tmsh = TM.make_mesh(dy, dz, device="cpu")
    jmsh = JM.make_mesh(dy, dz)
    stencil = TM.te_stencil if mode == "TE" else TM.tm_stencil
    jstencil = JM.te_stencil if mode == "TE" else JM.tm_stencil
    return (dy, dz, sigma, stencil(tmsh, torch.as_tensor(sigma)),
            jstencil(jmsh, jnp.asarray(sigma)))


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_stencil_matches_sparse_assembly(mode):
    dy, dz, sigma, st, _ = _setup(mode)
    ny, nz = len(dy), len(dz)
    omega = 2 * np.pi * 0.3
    A = R.dense_operator(dy, dz, sigma.ravel(), mode, omega).toarray()
    rng = np.random.default_rng(7)
    u = rng.standard_normal((nz + 1, ny + 1)) + 1j * rng.standard_normal((nz + 1, ny + 1))
    got = TM.apply_A(st, omega, torch.as_tensor(u)).numpy()
    want = (A @ u.ravel()).reshape(nz + 1, ny + 1)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_boundary_rhs_matches_Aio_and_jax(mode):
    dy, dz, sigma, st, jst = _setup(mode)
    ny, nz = len(dy), len(dz)
    omega = 2 * np.pi * 0.05
    A = R.dense_operator(dy, dz, sigma.ravel(), mode, omega)
    ii, io = R.boundary_index(ny, nz)
    rng = np.random.default_rng(9)
    bc_vals = rng.standard_normal(len(io)) + 1j * rng.standard_normal(len(io))
    bc_full = np.zeros((nz + 1) * (ny + 1), complex)
    bc_full[io] = bc_vals
    bc_full = bc_full.reshape(nz + 1, ny + 1)
    got = TM.boundary_rhs(st, omega, torch.as_tensor(bc_full)).numpy()
    want = -(A[np.ix_(ii, io)] @ bc_vals)
    np.testing.assert_allclose(got.ravel(), want, rtol=1e-11,
                               atol=1e-9 * np.abs(want).max())
    jgot = JM.boundary_rhs(jst, omega, jnp.asarray(bc_full))
    assert relerr(got, jgot) < TOL


def test_cell_gradient_normal_matches_sparse():
    dy, dz = small_mesh(6, 5)
    Gc = R.cell_gradient(dy, dz)
    v = np.random.default_rng(4).standard_normal((len(dz), len(dy)))
    want = (Gc.T @ (Gc @ v.ravel())).reshape(v.shape)
    np.testing.assert_allclose(TM.cell_gradient_normal(torch.as_tensor(v)).numpy(),
                               want, rtol=1e-12)
    np.testing.assert_allclose(float(TM.cell_gradient_sqnorm(torch.as_tensor(v))),
                               float(v.ravel() @ Gc.T @ Gc @ v.ravel()), rtol=1e-12)


@pytest.mark.parametrize("dtype", [None, jnp.complex128])
def test_direct_solve_matches_jax(rng, dtype):
    diag, offy, offz = random_interior(rng, 7, 6)
    b = rng.standard_normal((3,) + diag.shape) + 1j * rng.standard_normal((3,) + diag.shape)
    want = JS.direct_solve(JS.InteriorSystem(*(jnp.asarray(a) for a in (diag, offy, offz))),
                           jnp.asarray(b), dtype=dtype)
    got = TS.direct_solve(TS.InteriorSystem(*(torch.as_tensor(a) for a in (diag, offy, offz))),
                          torch.as_tensor(b), dtype=None if dtype is None else torch.complex128)
    assert got.shape == want.shape
    assert relerr(got, want) < TOL


@needs_native
def test_native_single_and_multi_rhs(rng):
    diag, offy, offz = random_interior(rng)
    A = dense_from_interior(diag, offy, offz)
    n = A.shape[0]
    with native.BandFactorization(native.band_from_interior(diag, offy, offz)) as f:
        b1 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        assert np.linalg.norm(A @ f.solve(b1) - b1) / np.linalg.norm(b1) < 1e-13
        B = rng.standard_normal((n, 7)) + 1j * rng.standard_normal((n, 7))
        assert np.linalg.norm(A @ f.solve(B) - B) / np.linalg.norm(B) < 1e-13


@needs_native
def test_native_lifetime_and_singular_pivot(rng):
    live0 = native.live_factor_count()
    d1, d2 = random_interior(rng, 4, 3), random_interior(rng, 5, 4)
    f1 = native.BandFactorization(native.band_from_interior(*d1))
    f2 = native.BandFactorization(native.band_from_interior(*d2))
    assert native.live_factor_count() == live0 + 2
    f1.destroy()
    f2.destroy()
    assert native.live_factor_count() == live0
    with pytest.raises(RuntimeError):
        f1.solve(np.ones(12, complex))
    band = native.band_from_interior(np.zeros((2, 2), complex), np.zeros((2, 1)),
                                     np.zeros((1, 2)))
    with pytest.raises(RuntimeError):
        native.BandFactorization(band)


@needs_native
def test_native_matches_the_thomas_solver(rng):
    """The native oracle and the port's block-Thomas solver (direct_solve)."""
    diag, offy, offz = random_interior(rng, 7, 6)
    b = rng.standard_normal(diag.shape) + 1j * rng.standard_normal(diag.shape)
    sys = TS.InteriorSystem(*(torch.as_tensor(a) for a in (diag, offy, offz)))
    x_dev = TS.direct_solve(sys, torch.as_tensor(b)).numpy()
    x_nat = native.solve_interior(diag, offy, offz, b.reshape(-1)).reshape(diag.shape)
    np.testing.assert_allclose(x_dev, x_nat, rtol=1e-9, atol=1e-11)
