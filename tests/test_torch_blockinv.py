"""The port's unpivoted Gauss-Jordan inverse (``ops/fused_factor.py``
``gj_inverse``, on a CPU tensor its plain version ``gj_inverse_blocked``,
the panel-16 order of the CUDA kernel) against the JAX package's
(``hmcmt2d_tpu/ops/blockinv.py`` ``inv_nopivot``, panels of 16), on the
same numpy matrices: the tridiagonal blocks of the equilibrated MT interior
operator (the blocks the engines invert) and random diagonally dominant
ones, at n on both sides of the 16-wide panel, batch 3.

Tolerances (max abs error over max abs):
- ``gj_inverse`` against JAX and against ``torch.linalg.inv`` (pivoted LU,
  another algorithm): 1e-12 in complex128 and 1e-5 in complex64, eight
  times float32's epsilon grown over n = 95 steps.
- ``gj_inverse_blocked`` at panel 16 against JAX: 1e-14 in complex128 and
  2e-6 in complex64.  Both take the same panels, the same pivot blocks and
  the same two products a panel; they differ only in rounding: the pivot
  block is inverted in place with the reciprocal pivot here, on an
  augmented [P | I] with a division in JAX, and the products sum in
  another order (read: at most 7e-16 and 4e-7 over three seeds).
- ``gj_inverse_blocked`` against ``gj_inverse_nopivot`` (one pivot a
  step): 1e-13 and 5e-6 (read: at most 1.4e-15 and 8e-7).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.ops import blockinv as JB  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

NS = [1, 5, 16, 17, 95]
TOL = {np.complex128: 1e-12, np.complex64: 1e-5}
# n on both sides of one and two panels of 16, and the flagship's 95
NS_BLOCKED = [1, 5, 15, 16, 17, 31, 33, 95]
TOL_BLOCKED_JAX = {np.complex128: 1e-14, np.complex64: 2e-6}
TOL_BLOCKED_NOPIVOT = {np.complex128: 1e-13, np.complex64: 5e-6}
DTYPES = [np.complex128, np.complex64]


def _operator_blocks(n, seed):
    """Three tridiagonal line blocks of the equilibrated TM interior
    operator of a graded mesh n + 1 cells wide (at least 3), at 1 Hz: their
    leading n x n corners, which keep the positive-definite real part."""
    rng = np.random.default_rng(seed)
    ny = max(n + 1, 3)
    dy, dz = small_mesh(ny, 5, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(5, ny))
    sigma[:2] = 1e-8
    st = TM.tm_stencil(TM.make_mesh(dy, dz, device="cpu"), torch.as_tensor(sigma))
    sys_, _ = TS.equilibrate(TS.interior_system(st, torch.tensor(2 * np.pi, dtype=torch.float64)))
    return TS._dense_blocks(sys_.diag, sys_.offy)[:3, :n, :n].numpy()


def _dominant(n, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * (rng.standard_normal((3, n, n)) + 1j * rng.standard_normal((3, n, n)))
            + (4.0 + 0.5j) * np.sqrt(n) * np.eye(n))


KINDS = {"operator": _operator_blocks, "dominant": _dominant}


@pytest.mark.parametrize("dtype", DTYPES, ids=["c128", "c64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", NS)
def test_inv_nopivot_matches_jax(n, kind, dtype):
    A = KINDS[kind](n, 10 + n).astype(dtype)
    want = np.asarray(JB.inv_nopivot(jnp.asarray(A)))
    got = FF.gj_inverse(torch.as_tensor(A))
    assert got.dtype == torch.as_tensor(A).dtype and tuple(got.shape) == A.shape
    assert relerr(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["c128", "c64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", NS)
def test_inverses_match_lu(n, kind, dtype):
    """The port's Gauss-Jordan inverse against LU, and a true inverse of A."""
    A = torch.as_tensor(KINDS[kind](n, 30 + n).astype(dtype))
    lu = torch.linalg.inv(A.to(torch.complex128))
    X = FF.gj_inverse(A).to(torch.complex128)
    assert relerr(X, lu) < TOL[dtype]
    eye = torch.eye(n, dtype=torch.complex128)
    assert relerr(A.to(torch.complex128) @ X, eye) < 100 * TOL[dtype]


@pytest.mark.parametrize("n", NS)
def test_kernel_order_matches_jax_order(n):
    """The engines' ``inv_method="gj"`` inverse (``solver.INV_FN``) is the
    kernel's order, held to JAX's panel order on the operator's blocks,
    complex128."""
    assert TS.INV_FN["gj"] is FF.gj_inverse
    A = _operator_blocks(n, 50 + n)
    want = np.asarray(JB.inv_nopivot(jnp.asarray(A)))
    assert relerr(TS.INV_FN["gj"](torch.as_tensor(A)), want) < 1e-12


def test_batch_axes_and_views():
    """Two batch axes, a transposed view and a lazy conjugate invert as the
    materialised matrices do."""
    A = torch.as_tensor(_dominant(7, 3).reshape(3, 1, 7, 7)).expand(3, 2, 7, 7)
    want = torch.linalg.inv(A)
    assert relerr(FF.gj_inverse(A), want) < 1e-12
    V = A.transpose(-1, -2).conj()
    assert relerr(FF.gj_inverse(V), torch.linalg.inv(V.resolve_conj())) < 1e-12


@pytest.mark.parametrize("dtype", DTYPES, ids=["c128", "c64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", NS_BLOCKED)
def test_blocked_matches_jax_inv_nopivot(n, kind, dtype):
    """At panel 16 the plain version takes JAX's order: its panels, pivot
    blocks and products."""
    A = KINDS[kind](n, 60 + n).astype(dtype)
    want = np.asarray(JB.inv_nopivot(jnp.asarray(A), block=16))
    got = FF.gj_inverse_blocked(torch.as_tensor(A), panel=16)
    assert got.dtype == torch.as_tensor(A).dtype and tuple(got.shape) == A.shape
    assert relerr(got, want) < TOL_BLOCKED_JAX[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["c128", "c64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", NS_BLOCKED)
def test_blocked_matches_nopivot_and_lu(n, kind, dtype):
    """The blocked order against one pivot a step and against LU."""
    A = torch.as_tensor(KINDS[kind](n, 70 + n).astype(dtype))
    X = FF.gj_inverse_blocked(A)
    assert relerr(X, FF.gj_inverse_nopivot(A)) < TOL_BLOCKED_NOPIVOT[dtype]
    assert relerr(X.to(torch.complex128), torch.linalg.inv(A.to(torch.complex128))) < TOL[dtype]


@pytest.mark.parametrize("panel", [1, 8, 16, 32, 128])
def test_blocked_at_other_panels(panel):
    """Any panel width inverts (1: one pivot a step; 128: one panel), in
    complex128 to 1e-12 of LU; the CPU path takes the kernel's panel."""
    A = torch.as_tensor(_operator_blocks(95, 80))
    lu = torch.linalg.inv(A)
    assert relerr(FF.gj_inverse_blocked(A, panel), lu) < 1e-12
    assert FF.gj_inverse_plan(95).panel == FF.GJ_PANEL == 16
    assert torch.equal(FF.gj_inverse(A), FF.gj_inverse_blocked(A, FF.GJ_PANEL))
