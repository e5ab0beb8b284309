"""Build and load the CUDA kernels of ``hmcmt2d_tpu_torch/csrc``.

The sources have a plain C interface and are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library, loaded with ``ctypes``.  The
build happens at first use, never at import, into ``hmcmt2d_tpu_torch/_build``
(listed in ``.gitignore``); the library's file name carries a hash of the
sources, so an edited source is never served by a stale build.  Each source
compiles in its own ``nvcc`` process, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# name -> argument count of the C entry points; every pointer and the stream
# are c_void_p, the sizes c_int; each returns cudaGetLastError() as an int
_ENTRY_POINTS = {
    "hmc_schur_factor": (4, 7),   # B, nzi, q; plan: qp, threads, smem; polish
    "hmc_bt_sweep_fwd": (4, 7),   # B, nzi, q; plan: qp, ring, threads, smem
    "hmc_bt_sweep_bwd": (4, 7),   # B, nzi, q; plan: qp, ring, threads, smem
    "hmc_gj_inverse": (2, 7),     # B, n; plan: qp, threads, smem, panel; complex128
    "hmc_mt1d_field": (7, 5),     # N, n, dz_batched; plan: threads; float64
    "hmc_mt1d_vjp": (8, 5),       # N, n, dz_batched; plan: threads; float64
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link them
    into ``_build/libhmc_kernels_<hash>.so``; returns its path."""
    global build_seconds
    srcs, digest = _sources()
    out = BUILD_DIR / f"libhmc_kernels_{digest}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC),
                                   "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                               "-o", str(tmp_so)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use.  Raises when no
    GPU is present: the kernels have no CPU form (their plain PyTorch
    versions in :mod:`.fused_factor` serve CPU tensors)."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a GPU, and none is available")
    lib = ctypes.CDLL(str(build()))
    for name, (n_ptr, n_int) in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
