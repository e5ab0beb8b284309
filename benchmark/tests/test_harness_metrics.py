"""Each per-layer reader against hand-worked operation and byte counts on
records made up for the test (the flagship's widths: q = 95, nzi = 55,
B = 176, refine 6; the H100 SXM's 67 TFLOP/s and 3.35 TB/s)."""

import importlib.util

import pytest

from conftest import ROOT

MS = 1_000_000   # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"benchmark/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def records(phase="sample", kernels=(), evals=1, eval_ms=(34.1,), factor_ms=()):
    return dict(phase=phase, window_s=10.0, eval_ms=list(eval_ms), factor_ms=list(factor_ms),
                iterations=5,
                profile=dict(kernels=list(kernels), host=[("bench.window", 0, 10 * MS)],
                             evals=evals, factors=len(factor_ms)),
                shapes=dict(q=95, nzi=55, B=176, solves_per_eval=14),
                peaks=dict(flops=67e12, bytes_per_s=3.35e12))


FACTOR = ("void schur_factor_kernel<6, 3, 2, false>(float2 const*)", 0, 7 * MS)
FWD = ("void bt_sweep_fwd_kernel<3, 2>(float2 const*)", 7 * MS, int(7.28 * MS))
BWD = ("void bt_sweep_bwd_kernel<3, 2>(float2 const*)", int(7.28 * MS), int(7.56 * MS))
OTHER = ("void at::native::elementwise_kernel<128, 4>()", int(7.56 * MS), int(9.56 * MS))


def test_factor_roofline():
    # 8 * 95^3 * 55 * 176 = 66,395,120,000 operations: 0.990972 ms at 67 TFLOP/s
    assert reader("schur_factor_roofline")(records(kernels=[FACTOR])) == pytest.approx(
        100 * 66_395_120_000 / 67e12 / 7e-3, rel=1e-12)
    assert reader("schur_factor_roofline")(records(kernels=[OTHER])) is None


def test_sweep_roofline():
    # forward: 698,896,000 B of G + 18,325,120 of offz, rhs, y = 717,221,120 B;
    # backward: 686,188,800 + 18,325,120 = 704,513,920 B
    want = 100 * (717_221_120 + 704_513_920) / 3.35e12 / 0.56e-3
    got = reader("bt_sweep_roofline")(records(kernels=[FWD, BWD]))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(75.785, abs=1e-3)


def test_eval_roofline():
    # 0.990972 ms + 14 x (0.214096 + 0.210303) ms = 6.932558 ms of 34.1
    got = reader("eval_roofline")(records(eval_ms=[34.0, 34.2]))
    assert got == pytest.approx(100 * 6.932558 / 34.1, rel=1e-5)
    assert reader("eval_roofline")(records(phase="warmup")) is None


def test_other_kernels_and_idle():
    rec = records(kernels=[FACTOR, FWD, BWD, OTHER], evals=2)
    assert reader("other_kernels_ms")(rec) == pytest.approx(1.0)
    # kernels cover 0 - 9.56 ms of the 10 ms window
    assert reader("device_idle_pct")(rec) == pytest.approx(4.4, rel=1e-9)
    overlap = records(kernels=[("a", 0, 2 * MS), ("b", 1 * MS, 3 * MS), ("c", 5 * MS, 6 * MS)])
    assert reader("device_idle_pct")(overlap) == pytest.approx(60.0)
    assert reader("device_idle_pct")(records()) is None


def test_span_readers():
    rec = records(phase="warmup", eval_ms=[1000.0] * 5, factor_ms=[500.0, 300.0])
    assert reader("outside_eval_pct")(rec) == pytest.approx(42.0)
    assert reader("eval_ms.warmup")(rec) == pytest.approx(1000.0)
    assert reader("factor_ms.warmup")(rec) == pytest.approx(400.0)
    assert reader("eval_ms.sample")(rec) is None
    assert reader("eval_ms.sample")(records(eval_ms=[30.0, 40.0])) == pytest.approx(35.0)
    assert reader("outside_eval_pct")(records(eval_ms=[])) is None
