"""The readers that split the device's idle time between the program's
spans, ``idle_in_replay_pct`` and ``idle_in_sampler_pct``, on records made
up for the test, against sums worked by hand (times in ms of a 100 ms
window)."""

import importlib.util

import pytest

from conftest import ROOT

MS = 1_000_000   # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"benchmark/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def records(kernels, host, unit=MS):
    """A record of kernels and host ranges timed in ``unit`` ns, in a window
    of 100 ms."""
    host = [("bench.window", 0, 100 * MS)] + [(n, s * unit, e * unit) for n, s, e in host]
    return dict(phase="sample", window_s=10.0, eval_ms=[], factor_ms=[], iterations=5,
                profile=dict(kernels=[(n, s * unit, e * unit) for n, s, e in kernels],
                             host=host, evals=1, factors=0))


# kernels overlap both edges of the window: idle 10-20, 30-35 and 40-90
KERNELS = [("k1", -5, 10), ("k2", 20, 30), ("k3", 35, 40), ("k4", 90, 105)]
# hmc.step > bench.eval > graphed.stale > graphed.launch (bench.eval is the
# benchmark's, no program span); the gap 40-90 straddles graphed.stale,
# graphed.clone, hmc.step's and hmc.iteration's own time, no span at all
# (80-82, 86-90) and adapt.update
HOST = [("hmc.iteration", 2, 80), ("hmc.step", 12, 60), ("bench.eval", 14, 50),
        ("graphed.stale", 15, 48), ("graphed.launch", 16, 19), ("graphed.clone", 42, 47),
        ("adapt.update", 82, 86), ("aten::copy_", 86, 88)]


def test_idle_is_split_by_the_innermost_program_span():
    rec = records(KERNELS, HOST)
    # replay: stale 15-16, launch 16-19, stale 19-20; stale 30-35; stale
    # 40-42, clone 42-47, stale 47-48 = 1 + 3 + 1 + 5 + 2 + 5 + 1 = 18
    assert reader("idle_in_replay_pct")(rec) == pytest.approx(18.0)
    # sampler: iteration 10-12, step 12-15; step 48-60, iteration 60-80,
    # adapt 82-86 = 2 + 3 + 12 + 20 + 4 = 41
    assert reader("idle_in_sampler_pct")(rec) == pytest.approx(41.0)
    # neither: 80-82 and 86-90 (an aten op is no program span)
    idle = reader("device_idle_pct")(rec)
    assert idle == pytest.approx(65.0)
    assert reader("idle_in_replay_pct")(rec) + reader("idle_in_sampler_pct")(rec) \
        == pytest.approx(idle - 6.0)


def test_a_child_that_starts_with_its_parent_is_the_inner():
    rec = records([("k", 10, 100)], [("hmc.step", 0, 10), ("graphed.eval", 0, 8),
                                     ("graphed.load", 0, 1)])
    assert reader("idle_in_replay_pct")(rec) == pytest.approx(8.0)
    assert reader("idle_in_sampler_pct")(rec) == pytest.approx(2.0)


@pytest.mark.parametrize("kernels,host", [
    ([], HOST),                                                        # no kernels
    (KERNELS, [("bench.eval", 14, 50), ("cudaGraphLaunch", 16, 19)]),  # no program span
])
def test_nothing_to_read(kernels, host):
    for name in ("idle_in_replay_pct", "idle_in_sampler_pct"):
        assert reader(name)(records(kernels, host)) is None


def brute_force(kernels, host):
    """The split counted cell by cell of 0.1 ms, times given in those cells."""
    got = {"replay": 0, "sampler": 0}
    for t in range(1000):
        if any(s <= t < e for _, s, e in kernels):
            continue
        inner = [(s, -e, n) for n, s, e in host
                 if n.startswith(("hmc.", "adapt.", "graphed.")) and s <= t < e]
        if inner:
            got["replay" if max(inner)[2].startswith("graphed.") else "sampler"] += 0.1
    return got


@pytest.mark.parametrize("seed", range(5))
def test_random_nests_match_a_count_on_a_grid(seed):
    """Random kernels and properly nested spans on a grid of 0.1 ms: each
    share equals the count of idle cells by their innermost program span,
    and the two stay within device_idle_pct."""
    import random

    rnd = random.Random(seed)
    kernels = []
    for i in range(40):
        t = rnd.randrange(-50, 1000)
        kernels.append((f"k{i}", t, t + rnd.randrange(1, 30)))
    host, t = [], 10
    while t < 900:
        it_end = min(t + rnd.randrange(100, 300), 990)
        host.append(("hmc.iteration", t, it_end))
        s = t + 5
        while s + 20 < it_end:
            e = min(s + rnd.randrange(10, 60), it_end - 5)
            host += [("hmc.step", s, e), ("bench.eval", s + 1, e - 1),
                     ("graphed.eval", s + 2, e - 2), ("graphed.launch", s + 3, s + 6)]
            s = e + 1
        t = it_end + rnd.randrange(0, 20)
    rec = records(kernels, host, unit=MS // 10)
    want = brute_force(kernels, host)
    replay, sampler = (reader(n)(rec) for n in ("idle_in_replay_pct", "idle_in_sampler_pct"))
    assert replay == pytest.approx(want["replay"], abs=1e-9) and replay > 0
    assert sampler == pytest.approx(want["sampler"], abs=1e-9) and sampler > 0
    assert replay + sampler <= reader("device_idle_pct")(rec) + 1e-9
