#!/usr/bin/env python3
"""Which of PyTorch's CUDA linear-algebra backends lets the engines' LU
inverse (``torch.linalg.inv_ex``, no error check) be captured in a CUDA
graph, and what each costs, at the batches the thomas, thomas_blocked and
bcr engines invert on the flagship (n = 95):

* B = 176 complex64, one thomas line (C = 8 chains x 11 frequencies x 2
  modes);
* B = 5,632 complex64, bcr's level 0 (176 systems x 32 eliminated lines);
* B = 176 complex128.

For each of ``torch.backends.cuda.preferred_linalg_library``'s
"default", "cusolver" and "magma", in a process of its own (a refused
capture can leave the process's CUDA state unusable): the eager
``inv_ex`` against ``torch.linalg.inv`` under the same backend (bit for
bit), its median time in CUDA events over 10 calls, whether a
``torch.cuda.CUDAGraph`` captures it (3 warm-up calls on a side stream
first, as ``sampler/graphed.py`` does), and the replay against the eager
result (bit for bit).  A refused capture is reported, not chosen around:
this script only measures.  Run from the root of a checkout on a machine
with a CUDA GPU:

    python3 scripts/torch_lu_capture.py

Prints one JSON object per line; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

BACKENDS = ("default", "cusolver", "magma")
CASES = (("thomas_line", 176, "complex64"), ("bcr_level0", 5632, "complex64"),
         ("thomas_line_c128", 176, "complex128"))
N = 95


def probe(backend: str) -> None:
    import numpy as np
    import torch

    torch.backends.cuda.preferred_linalg_library(backend)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for name, B, dtype in CASES:
        a = (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))
             + 4 * N * np.eye(N)) / N
        A = torch.as_tensor(a, dtype=getattr(torch, dtype), device=dev)
        row = {"backend": backend, "case": name, "batch": B, "n": N, "dtype": dtype}
        X = torch.linalg.inv_ex(A).inverse
        row["inv_ex_equals_inv"] = bool(torch.equal(X, torch.linalg.inv(A)))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ms = []
        for _ in range(10):
            start.record()
            torch.linalg.inv_ex(A)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        row["eager_ms_median"] = float(np.median(ms))
        A_s = A.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                torch.linalg.inv_ex(A_s)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = torch.linalg.inv_ex(A_s).inverse
            graph.replay()
            torch.cuda.synchronize()
            row["captured"] = True
            row["replay_equals_eager"] = bool(torch.equal(out, X))
        except RuntimeError as e:   # reported: the point of the probe
            row["captured"] = False
            row["capture_error"] = str(e).splitlines()[0][:300]
            print(json.dumps(row), flush=True)
            return                   # the process's CUDA state may be broken
        print(json.dumps(row), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--backend":
        probe(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "default_backend": str(torch.backends.cuda.preferred_linalg_library())}),
          flush=True)
    rc = 0
    for backend in BACKENDS:
        p = subprocess.run([sys.executable, __file__, "--backend", backend],
                           capture_output=True, text=True, timeout=300)
        sys.stdout.write(p.stdout)
        if p.returncode:
            print(json.dumps({"backend": backend, "rc": p.returncode,
                              "stderr": p.stderr[-1500:]}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
