"""The run comes out not correct when the timed path is broken underneath
it, once for each fault a cell of one chip can have (no exchange between
chips exists there): a step that returns its state unchanged, half of the
batch left out with the mean of the rest in its place, and an answer
altered where it is produced."""

import time

import pytest
import torch

from benchmark import harness


def unchanged(monkeypatch):
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import hmc as H

    real = H.make_sample_step

    def make(*a, **k):
        step = real(*a, **k)

        def lazy(state, gen, m_ref, dt, mass, draws=None):
            new, acc, stats, alpha, L = step(state, gen, m_ref, dt, mass, draws)
            return state, torch.ones_like(acc), stats, alpha, L
        return lazy

    monkeypatch.setattr(H, "make_sample_step", make)
    monkeypatch.setattr(A, "make_sample_step", make)


def half_batch(monkeypatch):
    from hmcmt2d_tpu_torch.models.posterior import InverseProblem

    real = InverseProblem.potential_value_and_grad

    def half(self, m, m_ref, reg, fac=None):
        h = max(1, m.shape[0] // 2)
        (U, aux), g = real(self, m[:h], m_ref[:h], reg, fac=None)

        def fill(x):
            return torch.cat([x, x.mean(0, keepdim=True).expand((m.shape[0] - h,) + x.shape[1:])])
        return (fill(U), tuple(fill(a) for a in aux)), fill(g)

    monkeypatch.setattr(InverseProblem, "potential_value_and_grad", half)


def altered(monkeypatch):
    from hmcmt2d_tpu_torch.models.forward import ForwardOperator

    real = ForwardOperator.predict

    def predict(self, sigma2d, fac=None):
        pred = real(self, sigma2d, fac=fac)
        bump = torch.ones(pred.shape[-1], dtype=pred.real.dtype, device=pred.device)
        bump[0] = 1.05
        return pred * bump

    monkeypatch.setattr(ForwardOperator, "predict", predict)


@pytest.mark.parametrize("phase", ["sample", "warmup"])
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_is_not_correct(tiny_root, monkeypatch, phase, fault):
    fault(monkeypatch)
    out = harness.run_cell(tiny_root, f"tiny.{phase}", 2**32 + 3, 1.0, False,
                           torch.device("cpu"), time.perf_counter(), log=lambda m: None)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())

