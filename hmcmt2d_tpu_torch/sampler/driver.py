"""Sampler wiring: the batched potential value-and-grad.

Counterpart of ``make_potential_vg`` in ``hmcmt2d_tpu/sampler/driver.py``.
The rest of that module (warmup, the Gauss-Newton mass, segments and
checkpoints of ``run_inversion``) is not ported yet.
"""

from __future__ import annotations

from ..models.posterior import InverseProblem


def make_potential_vg(problem: InverseProblem, reg: float):
    """Batched (chains-leading) potential value-and-grad.

    Chains are an ordinary batch axis of the forward model (one merged
    chains x freq x mode factor and solve), and the per-chain gradients are
    the gradient of the chain-summed potential: chains are independent.
    ``vg(m, m_ref) -> ((U, (misfit, mnorm, pred)), grad)``, all detached.
    """

    def vg(m, m_ref):
        return problem.potential_value_and_grad(m, m_ref, reg)

    return vg
