"""Port parity of the file layer (``io/model_io.py``, ``io/data_io.py``,
``io/startup.py``).

Files that JAX's writers wrote must read back identically through the
port's readers (tolerance 0), and the port's writers must write JAX's bytes
for the same inputs, apart from the ``file generated in ...`` timestamp.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hmcmt2d_tpu import io as JIO  # noqa: E402
from hmcmt2d_tpu.io import startup as JS  # noqa: E402
from hmcmt2d_tpu_torch import io as TIO  # noqa: E402
from hmcmt2d_tpu_torch.io import startup as TS  # noqa: E402
from tests.test_e2e import tiny_setup  # noqa: E402
from tests.test_forward import make_data  # noqa: E402
from tests.torch_parity import port_setup  # noqa: E402

STARTUP = """# a startup file with every key
datafile:        obs.dat
modelfile:       start.mod
burninsamples:   7
totalsamples:    31
resistivity:     1.0 1e4 0.05
fixedresistivity: 0.3
timeinterval:    0.03
timestep:        6 10
linearsolver:    mumps
masstype:        GaussNewton
masswarmup:      9
massdt0:         0.15
smoothparameter: 2.5
chains:          8
seed:            1
targetaccept:    0.7
adapt:           on
amortize:        off
warmuppool:      median
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny problem's model, complex and real data, and a startup file,
    all written by JAX's writers."""
    d = tmp_path_factory.mktemp("jaxfiles")
    mesh, start_sig, data, obs, err = tiny_setup()
    JIO.write_model(d / "start.mod", mesh, start_sig)
    JIO.write_data(d / "obs.dat", data, obs, err)
    rdata = make_data(data.rx_loc, data.freqs, comps=("RhoXY", "PhsYX"),
                      data_type="Rho_Pha")
    rng = np.random.default_rng(0)
    JIO.write_data(d / "rho.dat", rdata, 100 * rng.uniform(size=rdata.n_data), 0.05)
    (d / "startup").write_text(STARTUP)
    return d, dict(mesh=mesh, sig=start_sig, data=data, obs=obs, err=err,
                   rdata=rdata)


def _no_stamp(path):
    return [ln for ln in path.read_text().splitlines() if "file generated in" not in ln]


def test_read_model_matches_jax(files):
    d, _ = files
    jmesh, jsig = JIO.read_model(d / "start.mod")
    tmesh, tsig = TIO.read_model(d / "start.mod", device="cpu")
    np.testing.assert_array_equal(tsig, jsig)
    for f in ("y_len", "z_len", "air_layer", "origin"):
        np.testing.assert_array_equal(getattr(tmesh, f).numpy(), np.asarray(getattr(jmesh, f)))
    assert tmesh.device.type == "cpu"


@pytest.mark.parametrize("name", ["obs.dat", "rho.dat"])
def test_read_data_matches_jax(files, name):
    d, _ = files
    jd, jobs, jerr = JIO.read_data(d / name)
    td, tobs, terr = TIO.read_data(d / name)
    np.testing.assert_array_equal(tobs, jobs)
    np.testing.assert_array_equal(terr, jerr)
    for f in dataclasses.fields(jd):
        a, b = getattr(td, f.name), getattr(jd, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_read_startup_matches_jax(files):
    d, _ = files
    jcfg, _, jsig, _, jobs, _ = JS.read_startup(str(d / "startup"))
    tcfg, tmesh, tsig, _, tobs, _ = TS.read_startup(str(d / "startup"), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.adapt and not tcfg.amortize and tcfg.warmup_pool == "median"
    assert tcfg.mass_type == "gaussnewton" and tcfg.n_chains == 8
    assert tmesh.device.type == "cpu" and tmesh.nz == tsig.shape[0]
    np.testing.assert_array_equal(tsig, jsig)
    np.testing.assert_array_equal(tobs, jobs)
    assert dataclasses.asdict(TS.HMCConfig()) == dataclasses.asdict(JS.HMCConfig())


def test_bad_warmuppool_raises_on_both(tmp_path):
    p = tmp_path / "startup"
    p.write_text("datafile: a\nmodelfile: b\nwarmuppool: max\n")
    for mod in (JS, TS):
        with pytest.raises(ValueError, match="warmuppool"):
            mod.parse_startup(str(p))


@pytest.mark.parametrize("kind", ["model", "model-tensor", "complex-err",
                                  "complex-default-err", "real-scalar-err",
                                  "complex-tensor"])
def test_writers_write_jax_bytes(files, tmp_path, kind):
    _, f = files
    tmesh, tdata = port_setup(f["mesh"], f["data"])
    jp, tp = tmp_path / "jax.txt", tmp_path / "port.txt"
    if kind.startswith("model"):
        sig = f["sig"].copy()
        sig[5:7, 2:5] = 0.123456
        JIO.write_model(jp, f["mesh"], sig)
        TIO.write_model(tp, tmesh, torch.as_tensor(sig) if kind == "model-tensor" else sig)
    elif kind == "real-scalar-err":
        _, rdata = port_setup(f["mesh"], f["rdata"])
        vals = np.linspace(1.0, 300.0, rdata.n_data)
        JIO.write_data(jp, f["rdata"], vals, 0.05)
        TIO.write_data(tp, rdata, vals, 0.05)
    else:
        err = None if kind == "complex-default-err" else f["err"]
        vals = torch.as_tensor(f["obs"]) if kind == "complex-tensor" else f["obs"]
        JIO.write_data(jp, f["data"], f["obs"], err)
        TIO.write_data(tp, tdata, vals, err)
    jl, tl = _no_stamp(jp), _no_stamp(tp)
    assert len(jl) > 5 and tl == jl
    assert len(jp.read_text().splitlines()) == len(jl) + 1     # one stamp line


def test_read_model_defaults_to_the_gpu(files, monkeypatch):
    d, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TIO.read_model(d / "start.mod")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.read_startup(str(d / "startup"))
