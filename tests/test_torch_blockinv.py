"""The port's unpivoted Gauss-Jordan inverse (``ops/fused_factor.py``
``gj_inverse``, on a CPU tensor its plain version ``gj_inverse_nopivot``,
the elimination order of the CUDA kernel) against the JAX package's
(``hmcmt2d_tpu/ops/blockinv.py`` ``inv_nopivot``, panels of 16), on the
same numpy matrices: the tridiagonal blocks of the equilibrated MT interior
operator (the blocks the engines invert) and random diagonally dominant
ones, at n on both sides of the 16-wide panel, batch 3.

Tolerances (max abs error over max abs): 1e-12 in complex128 and 1e-5 in
complex64 between the two packages, which take the same pivots, one at a
time here and 16 at a time in JAX, and so differ by rounding only; the
same against ``torch.linalg.inv`` (pivoted LU, another algorithm: in
complex64 at 1e-5, eight times float32's epsilon grown over n = 95 steps).
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
