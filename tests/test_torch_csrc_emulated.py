"""The CUDA sources of ``gj_inverse`` and ``schur_factor`` run on the CPU
(``tests/csrc_emulator.py``: one OS thread a CUDA thread, g++), held
against their plain versions, and their C entry points' plan checks held
against the launch plans of ``ops/fused_factor.py`` for every width.

The emulation runs the kernels' own indexing, padding, barriers and
shuffles, so it catches an index or a missing barrier here where only the
card could otherwise; it rounds as the host does, not as nvcc contracts,
so its tolerances are the card's (``chip_smoke.py``: 1e-4 and 1e-10 for
``gj_inverse``, 1e-5 of max |G| for the factor; read here: at most 1.3e-6,
2.3e-15 and 4.5e-7).  Small batches: each block is 512 threads.
"""

import numpy as np
import pytest
import torch

from hmcmt2d_tpu_torch.ops import fused_factor as FF
from tests import csrc_emulator

torch.set_num_threads(1)

GJ_TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}
FACTOR_TOL = 1e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not csrc_emulator.available():
        pytest.skip("needs g++ to build the emulated sources")
    return csrc_emulator.build(tmp_path_factory.mktemp("csrc_emulated"))


def relerr(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _gj_emulated(lib, A):
    B, n, _ = A.shape
    plan = FF.gj_inverse_plan(n, A.dtype)
    X = torch.full_like(A, float("nan"))
    err = lib.hmc_gj_inverse(A.data_ptr(), X.data_ptr(), B, n, plan.qp, plan.n_threads,
                             plan.smem_bytes, plan.panel,
                             int(A.dtype == torch.complex128), None)
    assert err == 0
    return X


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("n", [1, 17, 33, 95, 128])
def test_gj_inverse_source_matches_plain(lib, n, dtype):
    """Every width template (qp = 32, 64, 96, 128), a panel cut at n and a
    panel padded past it, on diagonally dominant matrices, batch 2."""
    rng = np.random.default_rng(40 + n)
    A = (0.3 * (rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n)))
         + (4.0 + 0.5j) * np.sqrt(n) * np.eye(n))
    A = torch.as_tensor(A, dtype=dtype)
    X = _gj_emulated(lib, A)
    assert bool(torch.isfinite(torch.view_as_real(X)).all())
    assert relerr(X, FF.gj_inverse_blocked(A)) < GJ_TOL[dtype]


@pytest.mark.parametrize("q,polish", [(17, 0), (17, 2), (64, 1), (95, 1), (128, 1)])
def test_schur_factor_source_matches_plain(lib, q, polish):
    """The factor at polish 0 and its Newton-Schulz variant: two shared
    buffers up to qp = 96 (with the rebuild of S_j for a second step), one
    at qp = 128; B = 2 systems of 3 lines."""
    rng = np.random.default_rng(20 + q)
    B, nzi = 2, 3
    d = torch.as_tensor((4.0 + 0.1 * rng.standard_normal((B, nzi, q))
                         + 0.5j * rng.standard_normal((B, nzi, q))).astype(np.complex64))
    oy = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))).astype(np.float32))
    oz = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))).astype(np.float32))
    plan = FF.schur_factor_plan(q, polish)
    G = torch.full((B, nzi, q, q), float("nan"), dtype=torch.complex64)
    err = lib.hmc_schur_factor(d.data_ptr(), oy.data_ptr(), oz.data_ptr(), G.data_ptr(), B,
                               nzi, q, plan.qp, plan.n_threads, plan.smem_bytes, polish, None)
    assert err == 0
    assert relerr(G, FF.schur_factor_plain(d, oy, oz, polish)) < FACTOR_TOL


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
def test_gj_inverse_entry_takes_exactly_the_plan(lib, dtype):
    """For every n, hmc_gj_inverse accepts the plan (B = 0: the check, no
    launch) and refuses its shared memory off by one element or another
    panel."""
    elem = dtype.itemsize
    for n in range(1, FF.Q_MAX + 1):
        p = FF.gj_inverse_plan(n, dtype)
        dbl = int(dtype == torch.complex128)

        def call(smem, panel, p=p, n=n, dbl=dbl):
            return lib.hmc_gj_inverse(None, None, 0, n, p.qp, p.n_threads, smem, panel, dbl,
                                      None)

        assert call(p.smem_bytes, p.panel) == 0, n
        assert call(p.smem_bytes + elem, p.panel) != 0, n
        assert call(p.smem_bytes - elem, p.panel) != 0, n
        assert call(p.smem_bytes, 2 * p.panel) != 0, n


@pytest.mark.parametrize("polish", [0, 1, 2])
def test_schur_factor_entry_takes_exactly_the_plan(lib, polish):
    """For every q, hmc_schur_factor accepts the plan (B = 0) and refuses
    its shared memory off by one complex."""
    for q in range(1, FF.Q_MAX + 1):
        p = FF.schur_factor_plan(q, polish)

        def call(smem, p=p, q=q):
            return lib.hmc_schur_factor(None, None, None, None, 0, 1, q, p.qp, p.n_threads,
                                        smem, polish, None)

        assert call(p.smem_bytes) == 0, q
        assert call(p.smem_bytes + 8) != 0, q
        assert call(p.smem_bytes - 8) != 0, q
