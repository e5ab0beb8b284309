"""The window drives the program one iteration a call (``run_hmc`` with
``init_state`` and ``key_offset``, ``warmup_scan`` with one generator):
that chain is the one a single call makes, bit for bit."""

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import sampler as RS


def _phase(root, traffic):
    cfg = harness.load(root, "configs", "tiny")
    mix = harness.load(root, "traffic", traffic)
    dev = torch.device("cpu")
    inp = harness.make_inputs(root, cfg, 5, dev)
    return harness.PHASES[mix["phase"]](root, cfg, mix, inp, dev, harness.Spans(False, dev))


def test_run_hmc_one_iteration_a_call(tiny_root):
    from hmcmt2d_tpu_torch.sampler import hmc as H

    ph = _phase(tiny_root, "sample")
    start = ph.state
    whole = H.run_hmc(ph.vg, ph.opts, ph.mass, start.m, ph.m_ref, 4, 1, init_state=start)
    for i in range(4):
        it = ph.step(i)
        assert torch.equal(it.after.m, whole.models[i].to(it.after.m.dtype))
        assert torch.equal(it.accepts, whole.accepts[i])
    for a, b in zip(ph.state, whole.final):
        assert torch.equal(a, b)


def test_warmup_scan_one_iteration_a_call(tiny_root):
    from hmcmt2d_tpu_torch.sampler import adapt as A

    ph = _phase(tiny_root, "warmup")
    carry0 = ph.carry
    keys = [RS.generator(ph.mix["sampler_seed"], RS.STREAM_WARMUP, i, torch.device("cpu"))
            for i in range(4)]
    whole, outs = A.warmup_scan(ph.vg, ph.opts, ph.m_ref, carry0, keys, ph.ends[:4],
                                ph.wopts, factor_fn=ph.factor_fn)
    for i in range(4):
        it = ph.step(i)
        assert torch.equal(it.accepts, outs[2][i])
    flat = [torch.as_tensor(x) for x in torch.utils._pytree.tree_leaves(ph.carry)]
    want = [torch.as_tensor(x) for x in torch.utils._pytree.tree_leaves(whole)]
    assert len(flat) == len(want) and all(torch.equal(a, b) for a, b in zip(flat, want))


def test_window_schedule_matches_the_reference_rule():
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from benchmark import check as CK

    for n in (20, 150, 300, 1000):
        ends = A.window_schedule(n, A.WarmupOptions())
        mix = {"schedule_length": n}
        assert [CK.window_end(mix, i) for i in range(2 * n)] == list(np.tile(ends, 2))
