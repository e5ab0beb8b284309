"""The fused engine's kernels: plain versions against the JAX Pallas kernels.

On the CPU each wrapper of ``hmcmt2d_tpu_torch/ops/fused_factor.py`` runs its
kernel's plain PyTorch version; these tests hold those versions against
``hmcmt2d_tpu/ops/pallas_factor.py`` run in Pallas interpret mode the way
``tests/test_pallas_factor.py`` runs it (Q = 32, PANEL = 8), on the random
systems of that file.  tests/test_torch_cuda.py launches the CUDA kernels
themselves on the card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu.ops import pallas_factor as PF  # noqa: E402
from hmcmt2d_tpu.ops import solver as JS  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.ops import kernel_build  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from tests.test_pallas_factor import _random_system  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

FACTOR_TOL = 2e-5
SWEEP_TOL = 5e-5

# (batch shape, nzi, q, seed, JAX block_b): the cases of test_pallas_factor
CASES = [((3,), 5, 20, 0, 4), ((3,), 4, 17, 1, 2), ((2,), 3, 32, 2, 2),
         ((2, 3), 4, 12, 3, 4)]


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(PF, "Q", 32)
    monkeypatch.setattr(PF, "PANEL", 8)
    monkeypatch.setattr(PF, "INTERPRET", True)


def _system(batch, nzi, q, seed):
    B = int(np.prod(batch))
    js = _random_system(B, nzi, q, seed)
    js = JS.InteriorSystem(js.diag.reshape(batch + (nzi, q)),
                           js.offy.reshape(batch + (nzi, q - 1)),
                           js.offz.reshape(batch + (nzi - 1, q)))
    ts = TS.InteriorSystem(*(torch.tensor(np.asarray(a)) for a in js))
    return js, ts


def _rhs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (2,)) @ np.array([1, 1j])).astype(np.complex64)


@pytest.mark.parametrize("batch,nzi,q,seed,block_b", CASES)
def test_schur_factor_plain_matches_pallas(interp, batch, nzi, q, seed, block_b):
    js, ts = _system(batch, nzi, q, seed)
    G_jax = PF.fused_schur_factor(js.diag, js.offy, js.offz, block_b=block_b,
                                  interpret=True)
    fac = FF.fused_schur_factor(*ts)
    assert fac.batch == torch.Size(batch)
    assert fac.G.dtype == torch.complex64
    assert relerr(fac.G.reshape(G_jax.shape), G_jax) < FACTOR_TOL


@pytest.mark.parametrize("batch,nzi,q,seed,block_b", CASES)
def test_sweeps_plain_match_pallas(interp, batch, nzi, q, seed, block_b):
    """Both sweeps given the same factors (the JAX kernel's), then the whole
    equilibrated factor + solve of each engine."""
    js, ts = _system(batch, nzi, q, seed)
    b = _rhs(batch + (nzi, q), seed + 10)
    jf = JS.factorize(js, method="fused")
    want = JS.factor_solve(jf, jnp.asarray(b))
    B = int(np.prod(batch))
    G_jax = (np.asarray(jf.fac.gr) + 1j * np.asarray(jf.fac.gi))[:, :B, :q, :q]
    tq, s = TS.equilibrate(ts)
    fac = FF.FusedFactor(torch.as_tensor(np.swapaxes(G_jax, 0, 1).astype(np.complex64)),
                         tq.offz.reshape(B, nzi - 1, q).contiguous(),
                         torch.Size(batch))
    x = s * FF.fused_bt_solve(fac, s * torch.as_tensor(b))
    assert x.shape == want.shape and x.dtype == torch.complex64
    assert relerr(x, want) < SWEEP_TOL

    got = TS.factor_solve(TS.factorize(ts, method="fused"), torch.as_tensor(b))
    assert relerr(got, want) < SWEEP_TOL


def test_plain_versions_are_exact_in_complex128():
    """In complex128 the plain Schur chain with unpivoted Gauss-Jordan and the
    plain sweeps reproduce the thomas engine (pivoted LU inverses)."""
    _, ts = _system((3,), 6, 15, 4)
    sys128 = TS.InteriorSystem(ts.diag.to(torch.complex128), ts.offy.double(),
                               ts.offz.double())
    G = FF.schur_factor_plain(*sys128)
    ref = TS.bt_factor(sys128)
    assert relerr(G, ref.G) < 1e-12
    b = torch.as_tensor(_rhs((3, 6, 15), 5)).to(torch.complex128)
    x = FF.bt_sweep_bwd_plain(G, sys128.offz, FF.bt_sweep_fwd_plain(G, sys128.offz, b))
    assert relerr(x, TS.bt_solve(ref, b)) < 1e-12
    A = torch.as_tensor(_rhs((4, 9, 9), 6)).to(torch.complex128) + 9 * torch.eye(9)
    assert relerr(FF.gj_inverse_nopivot(A), torch.linalg.inv(A)) < 1e-12


def test_q_too_large_raises():
    _, ts = _system((1,), 2, 130, 0)
    with pytest.raises(ValueError):
        FF.fused_schur_factor(*ts)


def test_cpu_route_counts_no_launch():
    _, ts = _system((2,), 3, 8, 1)
    FF.reset_launches()
    fac = FF.fused_schur_factor(*ts)
    FF.fused_bt_solve(fac, torch.as_tensor(_rhs((2, 3, 8), 2)))
    assert FF.launches() == {"schur_factor": 0, "bt_sweep_fwd": 0,
                             "bt_sweep_bwd": 0}


def _meta_inputs(B=2, nzi=3, q=8):
    def m(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (m((B, nzi, q), torch.complex64), m((B, nzi, q - 1), torch.float32),
            m((B, nzi - 1, q), torch.float32), m((B, nzi, q, q), torch.complex64))


def test_non_cpu_tensor_without_gpu_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel, never to the plain version:
    with no GPU (and so no kernel library) the wrapper raises."""
    monkeypatch.setattr(kernel_build, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, oy, oz, G = _meta_inputs()
    FF.reset_launches()
    with pytest.raises(RuntimeError, match="GPU"):
        FF.schur_factor(d, oy, oz)
    with pytest.raises(RuntimeError, match="GPU"):
        FF.bt_sweep_fwd(G, oz, d)
    with pytest.raises(RuntimeError, match="GPU"):
        FF.bt_sweep_bwd(G, oz, d)
    assert sum(FF.launches().values()) == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_build, "_lib", None)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        FF.schur_factor(*_meta_inputs()[:3])
