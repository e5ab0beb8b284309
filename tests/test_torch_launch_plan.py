"""Launch plans of the factor, the two sweep kernels and the Gauss-Jordan
inverse (in both of its types), checked on the CPU: for every line width
the kernels take, the plan's tile covers the line and its blocks per SM fit
in an H100 SM's shared memory; wider lines are refused."""

import pytest
import torch

from hmcmt2d_tpu_torch.ops import fused_factor as FF

PLANS = {"schur_factor": FF.schur_factor_plan,
         "schur_factor_polish": lambda q: FF.schur_factor_plan(q, polish=1),
         "bt_sweep_fwd": FF.bt_sweep_fwd_plan,
         "bt_sweep_bwd": FF.bt_sweep_bwd_plan,
         "gj_inverse_c64": lambda n: FF.gj_inverse_plan(n, torch.complex64),
         "gj_inverse_c128": lambda n: FF.gj_inverse_plan(n, torch.complex128)}


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("q", range(1, FF.Q_MAX + 1))
def test_plan_covers_q_and_fits(kernel, q):
    plan = PLANS[kernel](q)
    lanes, _ = plan.threads
    rows, cols = plan.tile
    assert plan.q == q and q <= plan.qp <= FF.Q_MAX and plan.qp % 32 == 0
    # rows: per thread of each of the 16 row warps (factor), per multiplying
    # warp (sweep); columns: per lane
    assert rows * FF.WARPS >= q and cols * lanes >= q
    assert rows * FF.WARPS == plan.qp and cols * lanes == plan.qp
    assert 0 < plan.smem_bytes <= FF.SMEM_PER_BLOCK
    assert plan.n_threads <= 1024 and plan.blocks_per_sm >= 1
    # each resident block also takes 1 KB of the SM's shared memory
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= FF.SMEM_PER_SM


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("q", [0, FF.Q_MAX + 1])
def test_plan_refuses_widths_outside_the_kernels(kernel, q):
    with pytest.raises(ValueError):
        PLANS[kernel](q)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("n", range(1, FF.Q_MAX + 1))
def test_gj_inverse_plan_matches_the_kernel(n, dtype):
    """The plan's bytes and blocks are what csrc/gj_inverse.cu takes
    (hmc_gj_inverse's ``want``): the panel's rows, its columns
    (double-buffered), the pivot block's inverse and R (double-buffered),
    panel (5 qp + panel) complex;
    a panel of 16 (the kernel's NB); two blocks an SM only where the matrix
    tile takes at most 36 of the 64 registers a thread has there (qp <= 96
    in complex64, qp <= 64 in complex128)."""
    plan = FF.gj_inverse_plan(n, dtype)
    elem = 8 if dtype == torch.complex64 else 16
    assert plan.panel == 16 and plan.qp - n < 32
    assert plan.smem_bytes == plan.panel * (5 * plan.qp + plan.panel) * elem
    assert plan.threads == (FF.LANES, FF.WARPS) and plan.ring == 0
    tile_registers = plan.tile[0] * plan.tile[1] * elem // 4
    assert plan.blocks_per_sm == (2 if tile_registers <= 36 else 1)


@pytest.mark.parametrize("polish", [0, 1, 2])
@pytest.mark.parametrize("q", range(1, FF.Q_MAX + 1))
def test_schur_factor_plan_matches_the_kernel(q, polish):
    """The plan's bytes and blocks are what csrc/schur_factor.cu takes
    (hmc_schur_factor's ``want`` and its launch's blocks an SM): 48 qp bytes
    of pivot and line buffers; with polish, the S_j and G_j buffers (16 qp^2
    bytes) up to qp = 96 and S_j alone (8 qp^2) at qp = 128; two blocks an
    SM up to qp = 96, but for the polish variant only up to qp = 64."""
    plan = FF.schur_factor_plan(q, polish)
    qp = plan.qp
    buffers = 0 if polish == 0 else (16 if qp <= 96 else 8) * qp * qp
    assert plan.smem_bytes == 48 * qp + buffers
    assert plan.blocks_per_sm == (2 if qp <= (64 if polish else 96) else 1)
    assert plan.panel == 0 and plan.ring == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex32])
def test_gj_inverse_plan_refuses_other_types(dtype):
    with pytest.raises(ValueError):
        FF.gj_inverse_plan(8, dtype)
