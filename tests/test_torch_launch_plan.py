"""Launch plans of the factor and the two sweep kernels, checked on the CPU:
for every line width the kernels take, the plan's tile covers the line and
its blocks per SM fit in an H100 SM's shared memory; wider lines are
refused."""

import pytest

from hmcmt2d_tpu_torch.ops import fused_factor as FF

PLANS = {"schur_factor": FF.schur_factor_plan,
         "schur_factor_polish": lambda q: FF.schur_factor_plan(q, polish=1),
         "bt_sweep_fwd": FF.bt_sweep_fwd_plan,
         "bt_sweep_bwd": FF.bt_sweep_bwd_plan}


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
