"""Each per-layer reader against hand-worked operation and byte counts on
records made up for the test (the H100 SXM's 67 TFLOP/s and 3.35 TB/s).
The rooflines count the least work of the systems at the configurations'
shapes: dprism2d's 95 x 55 interior unknowns a mode (55 unknowns on each of
95 lines, B = 176), coprod2's 75 x 51 (51 on each of 75, B = 192); refine 6
(14 solves an eval) in the main phase, 3 (8 solves) in the warmup."""

import importlib.util
import json

import pytest
import torch

from benchmark import check as CK
from benchmark import harness
from benchmark.reference import forward as RF

from conftest import ROOT

MS = 1_000_000   # ns
PEAKS = dict(flops=67e12, bytes_per_s=3.35e12)
SHAPES = {"dprism2d": dict(width=55, lines=95, ny_i=95, nz_i=55, B=176, solves_per_eval=14),
          "coprod2": dict(width=51, lines=75, ny_i=75, nz_i=51, B=192, solves_per_eval=14)}


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"benchmark/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def records(phase="sample", kernels=(), evals=1, eval_ms=(34.1,), factor_ms=(),
            shapes=SHAPES["dprism2d"], peaks=PEAKS):
    return dict(phase=phase, window_s=10.0, eval_ms=list(eval_ms), factor_ms=list(factor_ms),
                iterations=5,
                profile=dict(kernels=list(kernels), host=[("bench.window", 0, 10 * MS)],
                             evals=evals, factors=len(factor_ms)),
                shapes=dict(shapes), peaks=peaks)


FACTOR = ("void schur_factor_kernel<6, 3, 2, false>(float2 const*)", 0, 7 * MS)
FWD = ("void bt_sweep_fwd_kernel<3, 2>(float2 const*)", 7 * MS, int(7.28 * MS))
BWD = ("void bt_sweep_bwd_kernel<3, 2>(float2 const*)", int(7.28 * MS), int(7.56 * MS))
OTHER = ("void at::native::elementwise_kernel<128, 4>()", int(7.56 * MS), int(9.56 * MS))
ROOFLINES = ["least_factor_roofline", "least_sweep_roofline", "least_eval_roofline"]


def mesh(ny, nz):
    """A stand-in for the reference's model: ny x nz cells."""
    return type("Mesh", (), {"ny": ny, "nz": nz})()


def z_line_counts(sh):
    """The counts of an ordering with its lines along z (ny_i unknowns on
    each of nz_i lines), the fused engine's ordering: the factor's
    operations, one forward and one backward sweep's bytes, an eval's least
    seconds at PEAKS."""
    q, n, B = sh["ny_i"], sh["nz_i"], sh["B"]
    vec = 4 * B * (n - 1) * q + 2 * 8 * B * n * q
    flops = 8.0 * q ** 3 * n * B
    fwd, bwd = 8 * B * n * q * q + vec, 8 * B * (n - 1) * q * q + vec
    eval_s = flops / PEAKS["flops"] + sh["solves_per_eval"] * (fwd + bwd) / PEAKS["bytes_per_s"]
    return flops, fwd, bwd, eval_s


def timed_at(flops, fwd, bwd, eval_s):
    """Records whose factor, sweeps and eval take exactly the least time of
    the given counts at PEAKS."""
    f_ns = flops / PEAKS["flops"] * 1e9
    s_ns = (fwd + bwd) / PEAKS["bytes_per_s"] * 1e9
    kernels = [("schur_factor_kernel", 0, f_ns), ("bt_sweep_fwd_kernel", f_ns, f_ns + s_ns / 2),
               ("bt_sweep_bwd_kernel", f_ns + s_ns / 2, f_ns + s_ns)]
    return kernels, [eval_s * 1e3]


@pytest.mark.parametrize("phase", ["sample", "warmup"])
@pytest.mark.parametrize("config", ["dprism2d", "coprod2"])
def test_shapes_of_the_configs(config, phase):
    cfg = harness.load(ROOT, "configs", config)
    mix = harness.load(ROOT, "traffic", phase)
    got = CK.shapes(RF.read_model(ROOT / cfg["model_file"]), cfg, mix)
    assert got == dict(SHAPES[config], solves_per_eval=14 if phase == "sample" else 8)


def test_shapes_take_refine_and_B_from_the_cell():
    cfg = dict(chains=3, freqs_hz=[1.0] * 5, solve=dict(refine=2))
    sample, warmup = dict(phase="sample"), dict(phase="warmup", engine=dict(refine=9))
    assert CK.shapes(mesh(40, 30), cfg, sample) == dict(
        width=29, lines=39, ny_i=39, nz_i=29, B=30, solves_per_eval=6)
    assert CK.shapes(mesh(40, 30), cfg, warmup)["solves_per_eval"] == 20


def test_records_take_the_shapes_from_the_cell(tiny_root, monkeypatch):
    """A traced run's records count from the model file and the cell's
    configured solve: a program run at another refine leaves them as the
    cell states them (tiny: 11 x 10 interior unknowns, B = 2 x 3 x 2)."""
    solve_config = harness.solve_config
    monkeypatch.setattr(harness, "solve_config", lambda d: solve_config(dict(d, refine=1)))
    metrics = tiny_root / "benchmark/metrics"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for key in ("solves_per_eval", "B", "width", "lines"):
        (metrics / f"seen_{key}.py").write_text(
            f"def read(rec):\n    return float(rec['shapes'][{key!r}])\n")
        spec["per_layer"].append(dict(spec["per_layer"][0], name=f"seen_{key}", unit="1",
                                      workloads=["tiny.sample", "tiny.warmup"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    for phase, solves in (("sample", 14), ("warmup", 8)):
        out = harness.run_cell(tiny_root, f"tiny.{phase}", 2**31 + 5, 0.5, True,
                               torch.device("cpu"), 0.0, log=lambda m: None)
        got = {k[5:]: v["value"] for k, v in out["metrics"].items() if k.startswith("seen_")}
        assert got == dict(solves_per_eval=solves, B=12, width=10, lines=11)


@pytest.mark.parametrize("config, flops", [("dprism2d", 22_254_320_000),
                                           ("coprod2", 15_281_395_200)])
def test_least_factor_roofline(config, flops):
    # 8 * 55^3 * 95 * 176 and 8 * 51^3 * 75 * 192 operations: 0.332154 and
    # 0.228081 ms at 67 TFLOP/s, over the factor's 7 ms
    read = reader("least_factor_roofline")
    got = read(records(kernels=[FACTOR, OTHER], shapes=SHAPES[config]))
    assert got == pytest.approx(100 * flops / 67e12 / 7e-3, rel=1e-12)
    assert read(records(kernels=[OTHER], shapes=SHAPES[config])) is None
    assert read(records(kernels=[FACTOR], shapes=SHAPES[config], peaks=None)) is None


@pytest.mark.parametrize("config, fwd, bwd", [("dprism2d", 422_977_280, 418_718_080),
                                              ("coprod2", 314_284_032, 310_288_896)])
def test_least_sweep_roofline(config, fwd, bwd):
    # dprism2d forward: 176 x (95 lines of 8 * 55^2 B of G + 94 couplings
    # of 4 * 55 B + rhs and y, 2 x 8 * 95 * 55 B); backward 94 lines of G
    read = reader("least_sweep_roofline")
    got = read(records(kernels=[FWD, BWD, OTHER], shapes=SHAPES[config]))
    assert got == pytest.approx(100 * (fwd + bwd) / 3.35e12 / 0.56e-3, rel=1e-9)
    fwd_only = read(records(kernels=[FWD], shapes=SHAPES[config]))
    assert fwd_only == pytest.approx(100 * fwd / 3.35e12 / 0.28e-3, rel=1e-9)
    assert read(records(kernels=[FACTOR, OTHER], shapes=SHAPES[config])) is None
    assert read(records(kernels=[FWD, BWD], shapes=SHAPES[config], peaks=None)) is None


@pytest.mark.parametrize("config, least_ms", [("dprism2d", (3.849687, 2.342173)),
                                              ("coprod2", (2.838236, 1.719598))])
def test_least_eval_roofline(config, least_ms):
    # dprism2d: 0.332154 ms + 14 (main phase) or 8 (warmup) x 0.251252 ms;
    # coprod2: 0.228081 + 14 or 8 x 0.186440
    read = reader("least_eval_roofline")
    sample = records(eval_ms=[17.9, 18.1], shapes=SHAPES[config])
    assert read(sample) == pytest.approx(100 * least_ms[0] / 18.0, rel=1e-6)
    warm = records(phase="warmup", eval_ms=[42.0, 42.5],
                   shapes=dict(SHAPES[config], solves_per_eval=8))
    assert read(warm) == pytest.approx(100 * least_ms[1] / 42.25, rel=1e-6)
    assert read(records(eval_ms=[], shapes=SHAPES[config])) is None
    assert read(records(shapes=SHAPES[config], peaks=None)) is None


@pytest.mark.parametrize("config, factor, sweep", [("dprism2d", 0.3352, 0.5920),
                                                   ("coprod2", 0.4624, 0.6925)])
def test_least_counts_against_the_z_line_counts(config, factor, sweep):
    """On the same records the new readers read the z-line ordering's
    readings times these ratios: (width / ny_i)^2 for the factor."""
    sh = SHAPES[config]
    flops, fwd, bwd, _ = z_line_counts(sh)
    rec = records(kernels=[FACTOR, FWD, BWD], shapes=sh)
    old_factor = 100 * flops / 67e12 / 7e-3
    old_sweep = 100 * (fwd + bwd) / 3.35e12 / 0.56e-3
    f_ratio = reader("least_factor_roofline")(rec) / old_factor
    s_ratio = reader("least_sweep_roofline")(rec) / old_sweep
    assert f_ratio == pytest.approx((sh["width"] / sh["ny_i"]) ** 2, rel=1e-12)
    assert round(f_ratio, 4) == factor and round(s_ratio, 4) == sweep


@pytest.mark.parametrize("name", ROOFLINES)
@pytest.mark.parametrize("ny, nz", [(96, 56), (76, 52), (41, 41), (300, 12)])
def test_a_mesh_and_its_transpose_read_alike(name, ny, nz):
    cfg = dict(chains=8, freqs_hz=[1.0] * 11, solve=dict(refine=6))
    mix = dict(phase="sample")
    rec = [records(kernels=[FACTOR, FWD, BWD], shapes=CK.shapes(m, cfg, mix))
           for m in (mesh(ny, nz), mesh(nz, ny))]
    assert reader(name)(rec[0]) == reader(name)(rec[1])


@pytest.mark.parametrize("name", ROOFLINES)
@pytest.mark.parametrize("ny, nz", [(41, 61), (50, 50), (20, 121)])
def test_the_z_line_count_where_z_is_the_long_axis(name, ny, nz):
    """Where ny - 1 <= nz - 1, lines along z are already the least-work
    ordering: the reader reads what the z-line count gives."""
    sh = CK.shapes(mesh(ny, nz), dict(chains=8, freqs_hz=[1.0] * 11, solve=dict(refine=6)),
                   dict(phase="sample"))
    flops, fwd, bwd, eval_s = z_line_counts(sh)
    rec = records(kernels=[FACTOR, FWD, BWD], shapes=sh)
    want = {"least_factor_roofline": 100 * flops / 67e12 / 7e-3,
            "least_sweep_roofline": 100 * (fwd + bwd) / 3.35e12 / 0.56e-3,
            "least_eval_roofline": 100 * eval_s / 34.1e-3}[name]
    assert reader(name)(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ROOFLINES)
@pytest.mark.parametrize("config", ["dprism2d", "coprod2"])
def test_the_other_ordering_reads_at_most_100(config, name):
    """A factor, sweeps and eval that take exactly the least time of the
    other ordering (lines of the longer axis's unknowns) read at most 100%;
    at the least ordering's own least time, exactly 100%."""
    sh = SHAPES[config]
    kernels, eval_ms = timed_at(*z_line_counts(sh))
    other = reader(name)(records(kernels=kernels, eval_ms=eval_ms, shapes=sh))
    least = dict(sh, ny_i=sh["nz_i"], nz_i=sh["ny_i"])
    kernels, eval_ms = timed_at(*z_line_counts(least))
    own = reader(name)(records(kernels=kernels, eval_ms=eval_ms, shapes=sh))
    assert other < 100.0 and own == pytest.approx(100.0, rel=1e-9)


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
    assert reader("eval_ms.sample")(rec) is None
    assert reader("eval_ms.sample")(records(eval_ms=[30.0, 40.0])) == pytest.approx(35.0)
    assert reader("outside_eval_pct")(records(eval_ms=[])) is None
