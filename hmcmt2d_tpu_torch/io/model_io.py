"""Reader/writer for the reference's 2-D model text format.

Copy of ``hmcmt2d_tpu/io/model_io.py`` (readEMModel2D.jl / writeEMModel2D.jl):
keyword blocks ``NY:``/``NZ:``/``NAIR:``/``Resistivity Type:``/``Model
Type:``/``Origin``, with air layers (file order bottom-up) prepended reversed
on top of the z-column, the origin shifted up by the air depth, and air cells
set to 1e-8 S/m.  The mesh is the port's, on the device the caller names.
"""

from __future__ import annotations

import time

import numpy as np

from ..constants import SIGMA_AIR
from ..device import to_numpy
from ..mesh import TensorMesh2D, make_mesh


def _content_lines(path):
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            yield line


def _read_floats(lines, n, path=""):
    vals = []
    while len(vals) < n:
        try:
            row = next(lines)
        except StopIteration:
            raise ValueError(
                f"{path}: file ends mid-block ({len(vals)}/{n} values read)"
            ) from None
        vals.extend(float(t) for t in row.split())
    return np.asarray(vals[:n])


def read_model(path, device=None) -> tuple[TensorMesh2D, np.ndarray]:
    """Returns (mesh, sigma2d): the mesh on ``device`` (None: the GPU, and
    raises without one) and sigma2d (nz, ny) numpy, air rows (1e-8 S/m)
    included."""
    lines = _content_lines(path)
    y_len = z_len = air = None
    sigma = None
    origin = np.zeros(2)
    res_type = "Conductivity"
    ny = nz = 0
    for line in lines:
        if line.startswith("NY"):
            ny = int(line.split()[-1])
            y_len = _read_floats(lines, ny, path)
        elif line.startswith("NZ"):
            nz = int(line.split()[-1])
            z_len = _read_floats(lines, nz, path)
        elif line.startswith("NAIR"):
            nair = int(line.split()[-1])
            air = _read_floats(lines, nair, path)
        elif "Resistivity Type" in line:
            res_type = line.split()[-1]
        elif "Model Type" in line:
            mod_type = line.split()[-1]
            sigma = _read_floats(lines, ny * nz, path)
            if res_type == "Resistivity":
                sigma = 1.0 / sigma
            if mod_type == "log":
                sigma = np.exp(sigma)
        elif line.startswith("Origin"):
            toks = line.split()
            origin = np.array([float(toks[-2]), float(toks[-1])])

    if air is None:
        air = np.zeros(0)
    else:
        # air listed bottom-up; prepend reversed, shift origin up
        z_len = np.concatenate([air[::-1], z_len])
        origin = origin + np.array([0.0, air.sum()])
        sigma = np.concatenate([np.full(ny * len(air), SIGMA_AIR), sigma])

    mesh = make_mesh(y_len, z_len, air_layer=air, origin=origin, device=device)
    sigma2d = sigma.reshape(len(z_len), ny)
    return mesh, sigma2d


def _write_block(f, vals, fmt, per_line=8):
    for i, v in enumerate(vals, 1):
        f.write(fmt % v)
        if i % per_line == 0:
            f.write("\n")
    if len(vals) % per_line != 0:
        f.write("\n")


def write_model(path, mesh: TensorMesh2D, sigma2d, comment: str | None = None):
    """Writes linear-conductivity format, stripping air rows back off
    (writeEMModel2D.jl:53-55)."""
    y_len = to_numpy(mesh.y_len)
    z_len = to_numpy(mesh.z_len)
    air = to_numpy(mesh.air_layer)
    origin = to_numpy(mesh.origin)
    n_air = len(air)
    ny, nz = len(y_len), len(z_len)
    sigma2d = to_numpy(sigma2d).reshape(nz, ny)

    with open(path, "w") as f:
        f.write("%-18s %s\n" % ("#Format:", "EMModel2DFile"))
        f.write("%-18s %s\n" % ("#Description:", "file generated in %s"
                                % time.strftime("%a %b %d %H:%M:%S %Y")))
        f.write("%-6s %4d\n" % ("NY:", ny))
        _write_block(f, y_len, "%10.2f")
        if n_air:
            f.write("%-6s %4d\n" % ("NAIR:", n_air))
            _write_block(f, air, "%12.2f")
        f.write("%-6s %4d\n" % ("NZ:", nz - n_air))
        _write_block(f, z_len[n_air:], "%10.2f")
        f.write("%-18s %s\n" % ("Resistivity Type:", "Conductivity"))
        f.write("%-18s %s\n" % ("Model Type:", "Linear"))
        for row in sigma2d[n_air:]:
            f.write("".join("%4.2e " % v for v in row) + "\n")
        f.write("%-15s %4.2e %4.2e" % ("Origin (m):", origin[0], origin[1] - air.sum()))
