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
                     cfg: SolveConfig | None = None, data_comp=("ZXY", "ZYX"),
                     data_type: str = "Impedance") -> tuple[InverseProblem, np.ndarray]:
    """The flagship inverse problem on ``device`` (None: the GPU) and its
    start model (numpy log-sigma).  Observations are placeholders (ones,
    errors 0.01), as in `__graft_entry__._flagship_problem`; ``cfg`` defaults to
    ``default_config(device)``.  ``data_comp`` and ``data_type`` change the
    survey's components (every (freq, rx, comp) triple observed), for
    example ``("ZXY", "TZY")`` or ``("RhoYX", "PhsYX")`` under "Rho_Phs" for
    a one-mode survey."""
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
    f, r, d = np.meshgrid(np.arange(n_freq), np.arange(n_rx),
                          np.arange(len(data_comp)), indexing="ij")
    data = MTData(rx_loc=rx_loc, freqs=freqs, data_type=data_type,
                  data_comp=tuple(data_comp), freq_id=f.ravel(), rx_id=r.ravel(),
                  dt_id=d.ravel()).validate()

    cfg = cfg or default_config(dev)
    obs = np.ones(data.n_data, complex if data.is_complex else float)
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


def _dryrun_rank(device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import dataclasses

    from .parallel.multichain import ShardedSampler, make_device_mesh
    from .sampler import adapt as A
    from .sampler import hmc as H

    problem, m0 = flagship_problem(tiny=True, device=device)
    # (chains, freq) with freq | n_freq, both axes used where they can be
    n_freq = problem.fwd.data.n_freq
    kf = next((k for k in (2, 4) if n_devices % k == 0 and n_freq % k == 0), 1)
    mesh = make_device_mesh(n_devices // kf, kf, device=device)
    C, P = 2 * (n_devices // kf), len(m0)
    rdt = problem.fwd.cfg.real_dtype
    m_start = torch.as_tensor(m0, dtype=rdt, device=device).expand(C, P).contiguous()
    opts = H.HMCOptions(dt=0.02, steps_lo=2, steps_hi=3,
                        log_sig_lo=float(np.log(1e-4)), log_sig_hi=float(np.log(10.0)),
                        reg_param=1.0)

    # the production recipe: a hybrid schedule, warmup under another engine
    # with median alpha pooling over the gathered chains, then the main
    # engine from the warmed-up models, a second segment continued with
    # key_offset, and a dense-mass step
    cfg_w = dataclasses.replace(problem.fwd.cfg,
                                refine_iters=problem.fwd.cfg.refine_iters + 1)
    problem_w = dataclasses.replace(problem, fwd=dataclasses.replace(problem.fwd,
                                                                     cfg=cfg_w))
    wres, state, wmass, info = ShardedSampler(problem_w, 1.0, mesh).warmup(
        opts, m_start, m_start, 2, 0, A.WarmupOptions(alpha_pool="median"))
    assert tuple(wres.models.shape) == (2, C, P) and float(info.dt) > 0
    ss = ShardedSampler(problem, 1.0, mesh)
    res = ss.run(opts, wmass, state.m, m_start, 1, 0)
    res2 = ss.run(opts, wmass, res.final.m, m_start, 1, 0, init_state=res.final,
                  key_offset=1)
    eye = torch.eye(P, dtype=rdt, device=device)
    dense = H.MassMatrix(sqrt_m=eye, inv_m=eye, diagonal=False)
    res3 = ss.run(opts, dense, res2.final.m, m_start, 1, 1, init_state=res2.final,
                  key_offset=2)
    for r in (res, res2, res3):
        assert tuple(r.models.shape) == (1, C, P)
        assert tuple(r.pred.shape) == (1, C, problem.fwd.data.n_data)
        assert bool(torch.isfinite(r.stats).all())
    return {"mesh": (n_devices // kf, kf), "chains": C, "dt": float(info.dt),
            "misfit": res3.stats[-1, :, 0].tolist()}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0) -> list[dict]:
    """A sharded sampling step of the tiny flagship over ``n_devices``
    ranks spawned on this host (after ``__graft_entry__.dryrun_multichip``).
    ``device=None`` means the GPUs: one rank each with NCCL when there are
    ``n_devices`` of them, else gloo ranks sharing them (raises without a
    GPU); ``device="cpu"`` spawns gloo ranks on the CPU.  Returns each
    rank's summary; raises if a rank fails or runs past ``timeout_s``."""
    from .parallel.multichain import rank_device, spawn_ranks

    cpu = rank_device(device).type == "cpu"
    nccl = not cpu and torch.cuda.device_count() >= n_devices
    return spawn_ranks(_dryrun_rank, n_devices, args=(n_devices,),
                       backend="nccl" if nccl else "gloo",
                       device="cpu" if cpu else None, timeout_s=timeout_s)
