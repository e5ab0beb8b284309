"""The factor's Newton-Schulz polish (``schur_factor(..., polish=)``).

On the CPU the wrapper runs its plain version, held here against the JAX
Pallas factor with the same polish in interpret mode (Q = 32, PANEL = 8, as
``tests/test_torch_kernels.py`` runs it), and, as JAX's
``test_polish_improves_real_operator_solve`` does, shown to cut the solve
error of the equilibrated TM operator at low frequency.  The polish = 0 path
is the factor of the main path, unchanged.  The CUDA variant is held to
this plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hmcmt2d_tpu.ops import pallas_factor as PF  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.ops import solver as TS  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.test_torch_kernels import CASES, _system  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

FACTOR_TOL = 2e-5   # as tests/test_torch_kernels.py: f32, other rounding order


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(PF, "Q", 32)
    monkeypatch.setattr(PF, "PANEL", 8)
    monkeypatch.setattr(PF, "INTERPRET", True)


# two of tests/test_torch_kernels.py's cases (each interpret run takes ~7 s):
# one batch axis and odd q, two batch axes
@pytest.mark.parametrize("batch,nzi,q,seed,block_b", [CASES[1], CASES[3]])
def test_polished_factor_plain_matches_pallas(interp, batch, nzi, q, seed, block_b):
    js, ts = _system(batch, nzi, q, seed)
    G_jax = PF.fused_schur_factor(js.diag, js.offy, js.offz, block_b=block_b,
                                  interpret=True, polish=1)
    fac = FF.fused_schur_factor(*ts, polish=1)
    assert fac.G.dtype == torch.complex64
    assert relerr(fac.G.reshape(G_jax.shape), G_jax) < FACTOR_TOL


def test_polish_zero_is_the_main_path_factor():
    d, oy, oz = (torch.as_tensor(np.array(a)) for a in _system((2,), 4, 12, 7)[0])
    assert torch.equal(FF.schur_factor_plain(d, oy, oz, polish=0),
                       FF.schur_factor_plain(d, oy, oz))
    assert torch.equal(FF.schur_factor(d, oy, oz), FF.schur_factor_plain(d, oy, oz))
    with pytest.raises(ValueError):
        FF.schur_factor(d, oy, oz, polish=-1)


def test_two_polish_steps_are_two_newton_schulz_steps():
    """polish = 2 takes two steps on each line's inverse, with the line's
    own S_j, before the next line's downdate (the kernel's polish >= 2
    path rebuilds S_j for the second step)."""
    d, oy, oz = (torch.as_tensor(np.array(a)) for a in _system((2,), 3, 9, 5)[0])
    G = FF.schur_factor_plain(d, oy, oz, polish=2)
    prev = None
    for j in range(d.shape[1]):
        S = FF._dense_line(d[:, j], oy[:, j])
        if j > 0:
            c = oz[:, j - 1]
            S = S - (c[:, :, None] * c[:, None, :]) * prev
        prev = FF.ns_polish(S, FF.ns_polish(S, FF.gj_inverse_nopivot(S)))
        assert torch.equal(G[:, j], prev)


def test_ns_polish_contracts_the_inverse_residual():
    """Quadratically, in complex128: I - S G' = (I - S G)^2."""
    rng = np.random.default_rng(1)
    S = torch.as_tensor(np.eye(6) * 4 + rng.standard_normal((6, 6))
                        + 1j * rng.standard_normal((6, 6)))
    G = torch.linalg.inv(S) * (1 + 1e-3 * torch.as_tensor(rng.standard_normal((6, 6))))
    eye = torch.eye(6, dtype=S.dtype)
    E = eye - S @ G
    assert relerr(eye - S @ FF.ns_polish(S, G), E @ E) < 1e-9


def _tm_operator(ny=24, nz=14, freq=0.01, seed=3):
    """tests/test_solver.py's ``_problem("TM", ...)`` built on the port's side:
    the equilibrated complex128 interior system and its scaling."""
    rng = np.random.default_rng(seed)
    dy, dz = small_mesh(ny, nz, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(nz, ny))
    sigma[:2] = 1e-8
    st = TM.tm_stencil(TM.make_mesh(dy, dz, device="cpu"), torch.as_tensor(sigma))
    sys = TS.interior_system(st, 2 * np.pi * freq)
    return TS.equilibrate(sys)


def test_polish_improves_real_operator_solve():
    """The port's mirror of JAX's test: one unrefined factor-solve of the
    equilibrated low-frequency TM operator is at least 1.5x more accurate
    with polish = 1 (JAX measured 1.4-8x)."""
    ssys, s = _tm_operator()
    nzi, nyi = ssys.diag.shape
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal((nzi, nyi, 2)) @ [1, 1j])
    x_e = TS.bt_solve(TS.bt_factor(ssys), s * b) * s
    d32 = ssys.diag.to(torch.complex64)[None]
    oy32, oz32 = ssys.offy.float()[None], ssys.offz.float()[None]

    def err(polish):
        G = FF.schur_factor(d32, oy32, oz32, polish)[0]
        x = TS.bt_solve(TS.BTFactor(G.to(torch.complex128), ssys.offz), s * b) * s
        return float((x - x_e).abs().pow(2).sum().sqrt() / x_e.abs().pow(2).sum().sqrt())

    e0, e1 = err(0), err(1)
    assert e1 < e0 / 1.5, (e0, e1)
