"""ctypes bindings for the native host-side band solver.

Copy of ``hmcmt2d_tpu/native.py`` for the port, which imports nothing of
the JAX package: the Python face of ``native/band_solver.cc``, the
equivalent of the reference's MUMPS Julia wrapper (MUMPS/src/MUMPS.jl:7-21,
MUMPSfuncs.jl:24-176), with opaque-handle factor / apply / destroy and the
factorisation living in native memory.  A numpy oracle for the port's
block-Thomas solver on the host; no GPU path touches it.

It loads the repo's ``native/libband_solver.so`` and builds it with ``make
-C native`` (g++) when the library is missing or older than its source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    so = os.path.join(_NATIVE_DIR, "libband_solver.so")
    src = os.path.join(_NATIVE_DIR, "band_solver.cc")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(so)
    lib.band_ldlt_factor.restype = ctypes.c_int64
    lib.band_ldlt_factor.argtypes = [ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_int64, ctypes.c_int64]
    lib.band_ldlt_solve.restype = ctypes.c_int64
    lib.band_ldlt_solve.argtypes = [ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_int64]
    lib.band_ldlt_destroy.restype = ctypes.c_int64
    lib.band_ldlt_destroy.argtypes = [ctypes.c_int64]
    lib.band_ldlt_live.restype = ctypes.c_int64
    lib.band_ldlt_live.argtypes = []
    return lib


def available() -> bool:
    """True if the native library can be built/loaded on this host."""
    try:
        _lib()
        return True
    except Exception:
        return False


def live_factor_count() -> int:
    return int(_lib().band_ldlt_live())


def pack_band(A: np.ndarray, b: int) -> np.ndarray:
    """Pack the lower band of a dense symmetric matrix: out[j, r] = A[j+r, j]."""
    n = A.shape[0]
    out = np.zeros((n, b + 1), np.complex128)
    for r in range(b + 1):
        out[: n - r, r] = np.diagonal(A, -r)
    return out


def band_from_interior(diag: np.ndarray, offy: np.ndarray, offz: np.ndarray) -> np.ndarray:
    """Packed band of the interior 5-point system (InteriorSystem arrays:
    diag (nzi, nyi) complex, offy (nzi, nyi-1), offz (nzi-1, nyi); matrix
    entries are -offy / -offz, see hmcmt2d_tpu_torch.ops.solver.InteriorSystem)."""
    nzi, nyi = diag.shape
    n, b = nzi * nyi, nyi
    band = np.zeros((n, b + 1), np.complex128)
    band[:, 0] = diag.reshape(-1)
    sub1 = np.concatenate([-offy, np.zeros((nzi, 1))], axis=1).reshape(-1)
    band[: n - 1, 1] = sub1[: n - 1]
    band[: n - b, b] = -offz.reshape(-1)
    return band


class BandFactorization:
    """Owning handle to a native factorisation (MUMPSfactorization,
    MUMPS/src/MUMPS.jl:7-13)."""

    def __init__(self, band_packed: np.ndarray):
        band_packed = np.ascontiguousarray(band_packed, np.complex128)
        n, w = band_packed.shape
        self.n, self.b = n, w - 1
        ptr = band_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._id = _lib().band_ldlt_factor(ptr, self.n, self.b)
        if self._id < 0:
            raise RuntimeError(f"native band factorisation failed: {self._id}")

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """Solve A x = rhs; rhs is (n,) or (n, nrhs).  A is symmetric so this
        is also the transpose solve (applyMUMPS tr flag, MUMPSfuncs.jl:75)."""
        if self._id < 0:
            raise RuntimeError("factorisation already destroyed")
        rhs = np.asarray(rhs, np.complex128)
        squeeze = rhs.ndim == 1
        # always copy: the native solve overwrites the buffer in place
        x = np.array(rhs.reshape(self.n, -1), order="F", copy=True)
        ptr = x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        rc = _lib().band_ldlt_solve(self._id, ptr, x.shape[1])
        if rc != 0:
            raise RuntimeError(f"native band solve failed: {rc}")
        return x[:, 0] if squeeze else np.ascontiguousarray(x)

    def destroy(self):
        if self._id >= 0:
            _lib().band_ldlt_destroy(self._id)
            self._id = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.destroy()
        except Exception:
            pass


def solve_interior(diag, offy, offz, rhs) -> np.ndarray:
    """One-shot factor+solve of the interior system (mumpsSolver,
    MT2DFwdSolver.jl:251-275)."""
    with BandFactorization(band_from_interior(np.asarray(diag), np.asarray(offy),
                                              np.asarray(offz))) as f:
        return f.solve(np.asarray(rhs).reshape(f.n, -1).squeeze())
