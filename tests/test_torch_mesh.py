"""Port parity: mesh operators, transforms and the 1-D analytic fields.

The same numpy inputs go through ``hmcmt2d_tpu`` (JAX, complex128) and
``hmcmt2d_tpu_torch`` (PyTorch, CPU, complex128).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hmcmt2d_tpu import mesh as JM  # noqa: E402
from hmcmt2d_tpu.ops import mt1d as JD  # noqa: E402
from hmcmt2d_tpu.utils import transforms as JT  # noqa: E402
from hmcmt2d_tpu_torch import mesh as TM  # noqa: E402
from hmcmt2d_tpu_torch.ops import mt1d as TD  # noqa: E402
from hmcmt2d_tpu_torch.utils import transforms as TT  # noqa: E402
from tests.conftest import small_mesh  # noqa: E402
from tests.torch_parity import relerr  # noqa: E402

OP_TOL = 1e-12
MT1D_TOL = 1e-10


def _meshes(ny=9, nz=7):
    dy, dz = small_mesh(ny, nz)
    air = dz[:2][::-1]
    origin = [dy.sum() / 2, dz[:2].sum()]
    return (JM.make_mesh(dy, dz, air_layer=air, origin=origin),
            TM.make_mesh(dy, dz, air_layer=air, origin=origin,
                          device="cpu"))


def _sigma(nz, ny, chains=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-3), np.log(1.0), (chains, nz, ny)))


@pytest.mark.parametrize("mode", ["TE", "TM"])
def test_stencil_matches_jax(mode):
    jm, tm = _meshes()
    sig = _sigma(tm.nz, tm.ny)
    jfn = JM.te_stencil if mode == "TE" else JM.tm_stencil
    tfn = TM.te_stencil if mode == "TE" else TM.tm_stencil
    js = jfn(jm, jnp.asarray(sig))
    ts = tfn(tm, torch.as_tensor(sig))
    for a, b in zip(ts, js):
        assert a.shape == b.shape
        assert relerr(a, b) < OP_TOL


def test_apply_A_and_interior_match_jax():
    jm, tm = _meshes()
    sig = _sigma(tm.nz, tm.ny)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, tm.nz + 1, tm.ny + 1, 2)) @ np.array([1, 1j])
    omega = 2 * np.pi * 3.0
    js = JM.tm_stencil(jm, jnp.asarray(sig))
    ts = TM.tm_stencil(tm, torch.as_tensor(sig))
    ja = JM.apply_A(js, omega, jnp.asarray(u))
    ta = TM.apply_A(ts, omega, torch.as_tensor(u))
    assert relerr(ta, ja) < OP_TOL
    ti = TM.interior(ta)
    assert relerr(ti, JM.interior(ja)) < OP_TOL
    back = TM.embed_interior(ti)
    assert relerr(back, JM.embed_interior(JM.interior(ja), tm.nz, tm.ny)) < OP_TOL


def test_cell_gradient_ops_match_jax():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((3, 7, 9))
    assert relerr(TM.cell_gradient_sqnorm(torch.as_tensor(v)),
                  JM.cell_gradient_sqnorm(jnp.asarray(v))) < OP_TOL
    assert relerr(TM.cell_gradient_normal(torch.as_tensor(v)),
                  JM.cell_gradient_normal(jnp.asarray(v))) < OP_TOL


def test_mesh_nodes_match_jax():
    jm, tm = _meshes()
    assert relerr(tm.y_node(), jm.y_node()) < OP_TOL
    assert relerr(tm.z_node(), jm.z_node()) < OP_TOL
    assert (tm.ny, tm.nz, tm.n_air, tm.n_cell, tm.n_node) == \
        (jm.ny, jm.nz, jm.n_air, jm.n_cell, jm.n_node)


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    sig = np.where(rng.uniform(size=40) < 0.3, 1e-8, rng.uniform(0.01, 1, 40))
    ja, jb = JT.active_cells(sig, (1e-8,), fix_index=[0])
    ta, tb = TT.active_cells(sig, (1e-8,), fix_index=[0])
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    v = rng.standard_normal((2, len(ta)))
    got = TT.scatter_active(torch.as_tensor(v), torch.as_tensor(ta), 40)
    want = JT.scatter_active(jnp.asarray(v), ta, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# The deep tail of a 1-D field decays below the rounding noise that the
# growing mode carries, and there the overflow guard cuts at a point that
# depends on how each framework rounds.  Entries under FLOOR x max|E| are that
# noise in both; the physically meaningful field above it must agree.
FLOOR = 1e-5


def _profiles(wide: bool, seed=4):
    """Flagship-like profiles (7 air layers over 49 graded earth layers, as
    in __graft_entry__._flagship_problem) for 5 frequencies 100..0.01 Hz:
    (nfreq, ncol, n) omegas, (ncol, n) conductivities, (n,) thicknesses.
    ``wide`` spans 1e-3..1 S/m instead of the flagship's 0.005..0.02."""
    rng = np.random.default_rng(seed)
    air = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])
    dz = np.concatenate([air[::-1], np.full(40, 100.0),
                         100.0 * 2.0 ** np.arange(1, 10)])
    lo, hi = (1e-3, 1.0) if wide else (0.005, 0.02)
    sig = np.exp(rng.uniform(np.log(lo), np.log(hi), (3, len(dz))))
    sig[:, :7] = 1e-8
    om = 2 * np.pi * np.logspace(2, -2, 5)[:, None, None]
    return sig, dz, om


def _meaningful(je, jh):
    return (np.abs(je) > FLOOR * np.abs(je).max()) & \
        (np.abs(jh) > FLOOR * np.abs(jh).max())


@pytest.mark.parametrize("wide", [False, True])
def test_analytic_field_matches_jax(wide):
    sig, dz, om = _profiles(wide)
    je, jh = JD.analytic_field(jnp.asarray(om), jnp.asarray(sig)[None],
                               jnp.asarray(dz), with_h=True)
    te, th = TD.analytic_field(torch.as_tensor(om), torch.as_tensor(sig)[None],
                               torch.as_tensor(dz), with_h=True)
    je, jh, te, th = (np.asarray(a) for a in (je, jh, te, th))
    assert te.shape == je.shape and th.shape == jh.shape
    assert np.isfinite(te).all() and np.isfinite(th).all()
    # the overflow guard zeroed the deep tail on both sides
    assert (je == 0).any() and (te == 0).any()
    keep = _meaningful(je, jh)
    assert keep.mean() > 0.5
    assert np.abs(te - je)[keep].max() / np.abs(je).max() < MT1D_TOL
    assert np.abs(th - jh)[keep].max() / np.abs(jh).max() < MT1D_TOL


@pytest.mark.parametrize("seed", [5, 9])
def test_analytic_field_gradient_matches_jax(seed):
    """Gradient w.r.t. the earth layers, the ones an inversion moves (air is
    frozen at 1e-8 S/m by active_cells)."""
    sig, dz, om = _profiles(False, seed=seed)
    je, jh = JD.analytic_field(jnp.asarray(om), jnp.asarray(sig)[None],
                               jnp.asarray(dz), with_h=True)
    keep = _meaningful(np.asarray(je), np.asarray(jh))
    rng = np.random.default_rng(6)
    we = (rng.standard_normal(keep.shape) + 1j * rng.standard_normal(keep.shape))
    we = np.where(keep, we, 0.0)
    hs = 1.0 / np.abs(np.asarray(jh)).max()

    def jloss(s):
        e, h = JD.analytic_field(jnp.asarray(om), s[None], jnp.asarray(dz),
                                 with_h=True)
        return jnp.sum(jnp.real(jnp.asarray(we) * (e + hs * h)))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(sig)))
    s = torch.as_tensor(sig).requires_grad_(True)
    e, h = TD.analytic_field(torch.as_tensor(om), s[None], torch.as_tensor(dz),
                             with_h=True)
    torch.real(torch.as_tensor(we) * (e + hs * h)).sum().backward()
    tg = s.grad.numpy()
    assert np.isfinite(tg).all()
    assert relerr(tg[:, 7:], jg[:, 7:]) < MT1D_TOL


def test_surface_impedance_and_safe_tanh_match_jax():
    sig, dz, om = _profiles(True, seed=7)
    jz = JD.surface_impedance(jnp.asarray(om), jnp.asarray(sig), jnp.asarray(dz))
    tz = TD.surface_impedance(torch.as_tensor(om), torch.as_tensor(sig),
                              torch.as_tensor(dz))
    assert relerr(tz, jz) < MT1D_TOL
    rng = np.random.default_rng(8)
    z = (rng.uniform(-40, 40, 50) + 1j * rng.uniform(-5, 5, 50))
    assert relerr(TD.safe_tanh(torch.as_tensor(z)), JD.safe_tanh(jnp.asarray(z))) < MT1D_TOL
