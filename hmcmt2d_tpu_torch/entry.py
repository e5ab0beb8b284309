"""Entry points on the flagship workload.

Counterpart of ``__graft_entry__.py:16-76``: the dprism-scale synthetic
inversion (96 x 56 cells with 7 air rows, 41 receivers, 11 frequencies,
TE+TM impedances, 902 data, 4,704 active cells).  ``tiny=True`` cuts it to
12 x 11 cells, 4 receivers and 4 frequencies for the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import SIGMA_AIR
from .mesh import make_mesh
from .models.data import MTData
from .models.forward import SolveConfig, default_config, resolve_device
from .models.posterior import InverseProblem, build_inverse_problem


def flagship_problem(tiny: bool = False, device=None,
                     cfg: SolveConfig | None = None) -> tuple[InverseProblem, np.ndarray]:
    """The flagship inverse problem on ``device`` (None: the GPU) and its
    start model (numpy log-sigma).  Observations are placeholders (ones,
    errors 0.01), as in `__graft_entry__._flagship_problem`; ``cfg`` defaults to
    ``default_config(device)``."""
    dev = resolve_device(device)
    ny, nz_earth, n_rx, n_freq = (12, 8, 4, 4) if tiny else (96, 49, 41, 11)

    # dprism-like graded mesh (examples/dprism3d/dprism2d_G96x49.mod)
    n_pad = min(8, (ny - 4) // 2)
    pad = 200.0 * 2.0 ** np.arange(1, n_pad + 1)
    dy = np.concatenate([pad[::-1], np.full(ny - 2 * n_pad, 200.0), pad])
    air = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])[:max(3, 7 - 4 * tiny)]
    n_fine = min(40, nz_earth - 5)
    dz_earth = np.concatenate([np.full(n_fine, 100.0),
                               100.0 * 2.0 ** np.arange(1, nz_earth - n_fine + 1)])
    z_len = np.concatenate([air[::-1], dz_earth])
    origin = np.array([dy.sum() / 2, air.sum()])
    mesh = make_mesh(dy, z_len, air_layer=air, origin=origin, device=dev)

    sigma2d = np.full((mesh.nz, mesh.ny), 0.01)
    sigma2d[:mesh.n_air] = SIGMA_AIR

    span = dy[n_pad:-n_pad].sum()
    rx_y = np.linspace(-span / 2 + 400, span / 2 - 400, n_rx)
    rx_loc = np.stack([rx_y, np.zeros(n_rx)], axis=1)
    freqs = np.logspace(2, -2, n_freq)
    f, r, d = np.meshgrid(np.arange(n_freq), np.arange(n_rx), np.arange(2),
                          indexing="ij")
    data = MTData(rx_loc=rx_loc, freqs=freqs, data_type="Impedance",
                  data_comp=("ZXY", "ZYX"), freq_id=f.ravel(), rx_id=r.ravel(),
                  dt_id=d.ravel()).validate()

    cfg = cfg or default_config(dev)
    obs = np.ones(data.n_data, complex)
    err = np.full(data.n_data, 0.01)
    return build_inverse_problem(mesh, data, obs, err, sigma2d.ravel(),
                                 cfg=cfg, device=dev)


def entry(device=None):
    """(step, (m0,)): the forward+gradient step of the flagship on
    ``device`` (None: the GPU); ``step(m) -> (U, misfit, grad)``."""
    problem, m0 = flagship_problem(device=device)
    m0_t = torch.as_tensor(m0, dtype=torch.float32, device=problem.device)

    def step(m):
        (U, (misfit, _mnorm, _pred)), grad = problem.potential_value_and_grad(
            m, m0_t.to(m.dtype), 1.0)
        return U, misfit, grad

    return step, (m0_t,)
