#!/usr/bin/env python3
"""Batch scaling of the port's redesigned kernels on one CUDA GPU.

Times ``schur_factor`` (and its Newton-Schulz variant, ``polish=1``),
``bt_sweep_fwd`` and ``bt_sweep_bwd`` (the CUDA kernels of
``hmcmt2d_tpu_torch/ops/fused_factor.py``) at the flagship line shape (nzi = 55 z-lines of q = 95 nodes) for B = 1, 44, 132 and 176
systems: one block alone, one block per SM, and the flagship's 176 systems
on 132 SMs.  Then it prints what ``nvcc -Xptxas -v`` reports for each kernel
(registers, spills; one "Compiling" line per template instance, the
polish variants among them).  Run from the root of a checkout:

    python3 scripts/torch_kernel_scaling.py

Prints one JSON object per line; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from hmcmt2d_tpu_torch.ops import fused_factor as FF  # noqa: E402
from hmcmt2d_tpu_torch.ops import kernel_build  # noqa: E402

NZI, Q = 55, 95
BATCHES = (1, 44, 132, 176)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def ptxas_report() -> list[str]:
    """The register and spill lines nvcc prints for the three sources."""
    lines = []
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        for name in ("schur_factor", "bt_sweep_fwd", "bt_sweep_bwd"):
            out = subprocess.run(
                [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-I", str(kernel_build.CSRC), "-c",
                 str(kernel_build.CSRC / f"{name}.cu"), "-o", f"{tmp}/{name}.o"],
                capture_output=True, text=True)
            lines += [f"{name}: {ln.strip()}"
                      for ln in (out.stdout + out.stderr).splitlines()
                      if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    kernel_build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    B = max(BATCHES)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a, dtype):
        return torch.as_tensor(a.astype(dtype), device=dev)

    # diagonally dominant systems, as tests/test_torch_cuda.py makes them
    d = t(4.0 + 0.1 * rng.standard_normal((B, NZI, Q))
          + 0.5j * rng.standard_normal((B, NZI, Q)), np.complex64)
    oy = t(1.0 + 0.1 * rng.standard_normal((B, NZI, Q - 1)), np.float32)
    oz = t(1.0 + 0.1 * rng.standard_normal((B, NZI - 1, Q)), np.float32)
    y = t(rng.standard_normal((B, NZI, Q)) + 1j * rng.standard_normal((B, NZI, Q)),
          np.complex64)
    G = FF.schur_factor(d, oy, oz)
    for n in BATCHES:
        print(json.dumps({
            "systems": n, "nzi": NZI, "q": Q,
            "schur_factor_ms": time_ms(lambda: FF.schur_factor(d[:n], oy[:n], oz[:n])),
            "schur_factor_polish_ms": time_ms(
                lambda: FF.schur_factor(d[:n], oy[:n], oz[:n], polish=1), reps=5),
            "bt_sweep_fwd_ms": time_ms(lambda: FF.bt_sweep_fwd(G[:n], oz[:n], y[:n])),
            "bt_sweep_bwd_ms": time_ms(lambda: FF.bt_sweep_bwd(G[:n], oz[:n], y[:n])),
        }), flush=True)
    for line in ptxas_report():
        print(json.dumps({"ptxas": line}), flush=True)


if __name__ == "__main__":
    main()
