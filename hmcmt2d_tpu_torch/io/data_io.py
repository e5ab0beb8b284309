"""Reader/writer for the reference's MT2D data text format.

Copy of ``hmcmt2d_tpu/io/data_io.py`` (readMT2DData.jl / writeMT2DData.jl):
keyword blocks ``Receiver Location``/``Frequencies``/``DataType``/
``DataComp``/``Data Block`` with rows ``freqID rxID dtID re [im] err``
(1-based ids in the file, 0-based inside).
"""

from __future__ import annotations

import time

import numpy as np

from ..models.data import DATA_TYPES, MTData
from ..device import to_numpy


def _content_lines(path):
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            yield line


def _need(lines, path):
    """Next content line of a keyword block, with a located parse error (not
    a raw StopIteration) when the block declares more rows than the file
    holds."""
    try:
        return next(lines)
    except StopIteration:
        raise ValueError(
            f"{path}: file ends mid-block (a keyword block declares more "
            "rows than the file contains)") from None


def read_data(path) -> tuple[MTData, np.ndarray, np.ndarray]:
    """Returns (MTData, obs, err); obs complex for Impedance, real for
    Rho_Pha (readMT2DData.jl:117-121)."""
    lines = _content_lines(path)
    rx_loc = freqs = None
    data_type = "Impedance"
    comps: list[str] = []
    freq_id = rx_id = dt_id = obs = err = None
    for line in lines:
        if "Receiver Location" in line:
            nr = int(line.split()[-1])
            rows = [_need(lines, path).split() for _ in range(nr)]
            rx_loc = np.array([[float(r[0]), float(r[1])] for r in rows])
        elif "Frequencies" in line:
            nf = int(line.split()[-1])
            freqs = np.array([float(_need(lines, path)) for _ in range(nf)])
        elif "DataType" in line:
            data_type = line.split()[-1]
            if data_type not in DATA_TYPES:
                raise ValueError(f"{data_type} is not supported.")
        elif "DataComp" in line:
            ndt = int(line.split()[-1])
            comps = [_need(lines, path).strip() for _ in range(ndt)]
        elif "Data Block" in line:
            ndata = int(line.split()[-1])
            is_complex = "Impedance" in data_type
            freq_id = np.zeros(ndata, int)
            rx_id = np.zeros(ndata, int)
            dt_id = np.zeros(ndata, int)
            obs = np.zeros(ndata, complex if is_complex else float)
            err = np.zeros(ndata)
            for k in range(ndata):
                t = _need(lines, path).split()
                freq_id[k], rx_id[k], dt_id[k] = int(t[0]) - 1, int(t[1]) - 1, int(t[2]) - 1
                if is_complex:
                    obs[k] = float(t[3]) + 1j * float(t[4])
                    err[k] = float(t[5])
                else:
                    obs[k] = float(t[3])
                    err[k] = float(t[4])

    data = MTData(rx_loc=rx_loc, freqs=freqs, data_type=data_type,
                  data_comp=tuple(comps), freq_id=freq_id, rx_id=rx_id,
                  dt_id=dt_id).validate()
    return data, obs, err


def write_data(path, data: MTData, values, err=None):
    """Writes the data block; missing errors default to 3% of amplitude
    (writeMT2DData.jl:53-57).  ``values`` may be a tensor on any device."""
    values = to_numpy(values)
    if err is None or len(np.atleast_1d(err)) == 0:
        err = np.abs(values) * 0.03
    elif np.ndim(err) == 0 or len(np.atleast_1d(err)) == 1:
        err = np.abs(values) * float(np.atleast_1d(err)[0])
    err = np.asarray(err)

    with open(path, "w") as f:
        f.write("%-20s%s\n" % ("Format:", "MT2DData_1.0"))
        f.write("# %s\n" % ("file generated in %s" % time.strftime("%a %b %d %H:%M:%S %Y")))
        f.write("%-25s %4d\n" % ("Receiver Location (m):", data.n_rx))
        f.write("# %5s %5s\n" % ("Y", "Z"))
        for y, z in data.rx_loc:
            f.write("%12.2f %12.2f\n" % (y, z))
        f.write("%-20s%3d\n" % ("Frequencies (Hz):", data.n_freq))
        for fr in data.freqs:
            f.write("%8.4e\n" % fr)
        f.write("%-12s %12s\n" % ("DataType:", data.data_type))
        f.write("%-15s %d\n" % ("DataComp:", data.n_comp))
        for c in data.data_comp:
            f.write("%4s\n" % c)
        f.write("%-15s %d\n" % ("Data Block:", data.n_data))
        if np.iscomplexobj(values):
            f.write("# %6s %6s %10s %10s %15s %12s\n"
                    % ("FreqNo.", "RxNo.", "dataComp", "RealValue", "ImagValue", "Error"))
            for k in range(data.n_data):
                f.write("%5d %6d %8d %15.6e %15.6e %15.6e\n"
                        % (data.freq_id[k] + 1, data.rx_id[k] + 1, data.dt_id[k] + 1,
                           values[k].real, values[k].imag, err[k]))
        else:
            f.write("# %6s %6s %10s %10s %12s\n"
                    % ("FreqNo.", "RxNo.", "dataComp", "RealValue", "Error"))
            for k in range(data.n_data):
                f.write("%5d %6d %8d %15.6e %15.6e\n"
                        % (data.freq_id[k] + 1, data.rx_id[k] + 1, data.dt_id[k] + 1,
                           values[k], err[k]))
