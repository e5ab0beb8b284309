#!/usr/bin/env python3
"""Batch scaling of the port's redesigned kernels on one CUDA GPU.

Times ``schur_factor`` (and its Newton-Schulz variant, ``polish=1``),
``bt_sweep_fwd`` and ``bt_sweep_bwd`` (the CUDA kernels of
``hmcmt2d_tpu_torch/ops/fused_factor.py``) at the flagship line shape
(nzi = 55 z-lines of q = 95 nodes) for B = 1, 44, 132 and 176 systems: one
block alone, one block per SM, and the flagship's 176 systems on 132 SMs.
Times ``gj_inverse`` (n = 95) alone (B = 1), one an SM (132), at the
engines' batches, B = 176 (one thomas line) and 5,632 (bcr's level 0), in
complex64, and B = 176 in complex128; with ``--variants``, the complex64
kernel at one and at two blocks an SM, and each step of its panel loop
alone (a scratch build that includes ``csrc/gj_inverse.cu``).  Times the
boundary fields' kernels (``ops/mt1d.py``: forward, vjp, tangent) at the
benchmark cells' column counts (11 x 8 x 97 columns of n = 56, 12 x 8 x 77
of n = 52) beside their plain version's forward and autograd backward,
each captured in a CUDA graph as an eval is (a checkout without the
kernels times the plain version alone).  Then it prints what ``nvcc -Xptxas -v`` reports
for each kernel (registers, spills; one "Compiling" line per template
instance).  Run from the root of a checkout:

    python3 scripts/torch_kernel_scaling.py [--variants]
    python3 scripts/torch_kernel_scaling.py --root OTHER_CHECKOUT
    python3 scripts/torch_kernel_scaling.py --sass-against OTHER_CHECKOUT

``--root`` times the kernels of another checkout of the repository (its
``hmcmt2d_tpu_torch``, built into its own ``_build``), so that two versions
are compared on one card in one call.  ``--sass-against`` compares the SASS
of ``schur_factor``'s polish = 0 instances and of every instance of both
sweeps here with those of another checkout, function by function, and
prints whether each is identical and each one's registers, stack and local
memory (``cuobjdump -res-usage``) on both sides.

Prints one JSON object per line; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
NZI, Q = 55, 95
BATCHES = (1, 44, 132, 176)
# one matrix alone, one an SM, one thomas line, bcr's level 0
GJ_CASES = (("complex64", 1), ("complex64", 132), ("complex64", 176), ("complex64", 5632),
            ("complex128", 176))
# blocks an SM of the complex64 kernel at qp = 96 with --variants
GJ_VARIANTS = (1, 2)
GJ_SMEM_96 = 16 * (5 * 96 + 16) * 8   # ops/fused_factor.py gj_inverse_plan(95)


def time_ms(torch, fn, reps: int = 20) -> float:
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


def stream_ms(torch, fn, calls: int = 20) -> float:
    """Median over 5 rounds of the CUDA-event time of ``calls`` back-to-back
    calls of fn(), per call: the device's time where it exceeds the host's
    ~25-40 us a call, which ``time_ms`` includes."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return float(np.median(ts))


def nvcc_compile(kernel_build, src: Path, out: Path, *extra: str) -> str:
    """Compile ``src`` to ``out`` with the library's flags; returns the
    compiler's output (raises if it fails)."""
    run = subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, *extra,
                          "-I", str(kernel_build.CSRC), "-c", str(src), "-o", str(out)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{run.stdout}{run.stderr}")
    return run.stdout + run.stderr


def ptxas_report(kernel_build) -> list[str]:
    """The register and spill lines nvcc prints for the kernels' sources."""
    lines = []
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        for src in sorted(kernel_build.CSRC.glob("*.cu")):
            log = nvcc_compile(kernel_build, src, Path(tmp) / f"{src.stem}.o",
                               "-Xptxas", "-v")
            lines += [f"{src.stem}: {ln.strip()}" for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return lines


# the instances --sass-against compares: (source files, kernel, a mark of the
# instance in its mangled name); the factor's polish = 0 instances (Lb0E)
# and every instance of both sweeps
SASS_KERNELS = (("schur_factor.cu", "schur_factor_kernel", "Lb0E"),
                ("bt_sweep*.cu", "bt_sweep_fwd_kernel", ""),
                ("bt_sweep*.cu", "bt_sweep_bwd_kernel", ""))


def unnamed(text: str) -> str:
    """``text`` with each anonymous namespace's mangled name, which carries
    its source file's path and name, read as ``_GLOBAL__N_``, so that a
    kernel compiled from another file keeps its name."""
    out, i = [], 0
    for m in re.finditer(r"(\d+)_GLOBAL__N_", text):
        if m.start() >= i:
            out += [text[i:m.start()], "_GLOBAL__N_"]
            i = m.end(1) + int(m.group(1))
    return "".join(out) + text[i:]


def sass_functions(kernel_build, src: Path, tmp: Path) -> dict[str, dict]:
    """SASS and resource usage (registers, stack, local memory) of each
    function compiled from ``src``, by mangled name."""
    obj = tmp / f"{len(list(tmp.iterdir()))}_{src.stem}.o"
    nvcc_compile(kernel_build, src, obj)
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")

    def dump(flag):
        text = subprocess.run([str(cuobjdump), flag, str(obj)], capture_output=True,
                              text=True, check=True).stdout
        funcs, name = {}, None
        for line in text.splitlines():
            m = re.match(r"\s*Function(?: :)? (\S+?):?\s*$", line)
            if m:
                name = unnamed(m.group(1))
                funcs[name] = []
            elif name is not None:
                funcs[name].append(unnamed(line.strip()))
        return funcs

    def labels(lines):
        # branch labels are numbered across the file, and their width sets the
        # columns: number them per function, one space between words
        seen = {}
        return [" ".join(re.sub(r"\.L_x_\d+",
                                lambda m: seen.setdefault(m.group(0), f".L{len(seen)}"),
                                ln).split()) for ln in lines]

    res = dump("-res-usage")
    return {k: {"sass": "\n".join(labels(v)), "res": " ".join(res.get(k, [])[:1])}
            for k, v in dump("-sass").items()}


def sass_against(kernel_build, other: Path) -> None:
    """Compare the SASS of the SASS_KERNELS instances here with those built
    from ``other``'s csrc, function by function, whichever files hold them
    there, and print each instance's resource usage on both sides."""
    sides = []
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        for csrc in (kernel_build.CSRC, other / "hmcmt2d_tpu_torch" / "csrc"):
            funcs = {}
            for pattern in sorted({p for p, _, _ in SASS_KERNELS}):
                for src in sorted(csrc.glob(pattern)):
                    funcs.update(sass_functions(kernel_build, src, Path(tmp)))
            sides.append(funcs)
    here, there = sides
    for _, kernel, mark in SASS_KERNELS:
        names = sorted(k for k in here if kernel in k and mark in k)
        for k in names:
            h, t = here[k], there.get(k, {"sass": None, "res": None})
            row = {"sass": k, "identical": h["sass"] == t["sass"],
                   "instructions": h["sass"].count(";"), "res_here": h["res"],
                   "res_there": t["res"]}
            if not row["identical"] and t["sass"] is not None:
                diff = difflib.unified_diff(t["sass"].splitlines(), h["sass"].splitlines(),
                                            lineterm="", n=0)
                row["diff_head"] = [ln for ln in diff if ln[:1] in "+-"][2:22]
            print(json.dumps(row), flush=True)
        if not names:
            print(json.dumps({"sass": f"no {kernel} instance found"}), flush=True)


# One block's time for each step of gj_inverse's panel loop at qp = 96,
# complex64, two blocks an SM: the step repeated ``reps`` times, each
# followed by a barrier, on made-up data in shared memory (pivot blocks
# 4 on their diagonal, every other entry 1e-3 at most).
GJ_STEPS = ("invert_pivot_block (warp 0)", "update_rows (the whole tile)", "form_R",
            "publish_cols", "a whole panel", "barrier alone",
            "invert_pivot_block (warp 0, one block an SM: 128 registers)")
GJ_STEPS_CU = r"""
template <int STEP, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) gj_step_kernel(float2* out, int reps) {
  constexpr int RT = 6, CT = 3, QP = 96;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* rowp = reinterpret_cast<float2*>(smem_raw);
  float2* colp = rowp + NB * QP;
  float2* pinv = colp + 2 * QP * NB;
  float2* R = pinv + NB * NB;
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * TX + lane;
  for (int e = tid; e < NB * (5 * QP + NB); e += THREADS)
    rowp[e] = make_float2(1e-3f * (e % 7), 1e-3f * (e % 5));
  __syncthreads();
  if (tid < NB) rowp[tid * QP + 16 + tid] = rowp[tid * QP + 32 + tid] = make_float2(4.f, 0.5f);
  __syncthreads();
  float2 S[RT][CT];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) S[t][cc] = make_float2(1e-3f * (t + cc), 0.f);
  if (lane == warp) S[1][1] = make_float2(4.f, 0.5f);   // the next pivot block's diagonal
  for (int r = 0; r < reps; ++r) {
    if constexpr (STEP == 0 || STEP == 6) {
      if (warp == 0) invert_pivot_block<float2, QP>(rowp, pinv, 16, 95, lane);
    } else if constexpr (STEP == 1) {
      update_rows<1, RT>(S, colp, R, 16, 0, lane, warp);
    } else if constexpr (STEP == 2) {
      form_R<float2, CT>(rowp, pinv, R + NB * QP, 16, lane, warp);
    } else if constexpr (STEP == 3) {
      publish_cols(S, colp + QP * NB, 32, 0, lane, warp);
    } else if constexpr (STEP == 4) {   // the kernel's loop body at k0 = 16
      update_rows<1, 2>(S, colp, R, 16, 0, lane, warp);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) rowp[warp * QP + lane + TX * cc] = S[1][cc];
      if (warp == 0) {
        bar_sync(NEXT_ROWS, THREADS);
        invert_pivot_block<float2, QP>(rowp, pinv, 32, 95, lane);
        bar_arrive(PINV_READY, THREADS);
      } else {
        bar_arrive(NEXT_ROWS, THREADS);
      }
      update_rows<2, RT>(S, colp, R, 16, 0, lane, warp);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) S[0][cc] = R[warp * QP + lane + TX * cc];
      if (warp != 0) bar_sync(PINV_READY, THREADS);
      form_R<float2, CT>(rowp, pinv, R + NB * QP, 32, lane, warp);
      publish_cols(S, colp + QP * NB, 32, 0, lane, warp);
    }
    __syncthreads();
  }
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) acc = make_float2(acc.x + S[t][cc].x, acc.y + S[t][cc].y);
  out[blockIdx.x * THREADS + tid] = acc;
}

template <int STEP>
int run_step(int blocks, int reps, void* out, cudaStream_t s) {
  const int smem = 16 * (5 * 96 + 16) * 8;
  const auto kernel = gj_step_kernel<STEP, STEP == 6 ? 1 : 2>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, dim3(TX, TY), smem, s>>>((float2*)out, reps);
  return (int)cudaGetLastError();
}

extern "C" int gj_step(int step, int blocks, int reps, void* out, void* s) {
  const cudaStream_t st = (cudaStream_t)s;
  switch (step) {
    case 0: return run_step<0>(blocks, reps, out, st);
    case 1: return run_step<1>(blocks, reps, out, st);
    case 2: return run_step<2>(blocks, reps, out, st);
    case 3: return run_step<3>(blocks, reps, out, st);
    case 4: return run_step<4>(blocks, reps, out, st);
    case 5: return run_step<5>(blocks, reps, out, st);
    default: return run_step<6>(blocks, reps, out, st);
  }
}
"""


def gj_steps(torch, lib) -> None:
    """Per-step microseconds of GJ_STEPS_CU: one block alone, and two
    blocks on each of the card's SMs."""
    fn = lib.gj_step
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reps = 200
    out = torch.empty(2 * sms * 512, dtype=torch.complex64, device="cuda")
    for step, name in enumerate(GJ_STEPS):
        row = {"gj_step": name}
        for blocks in (1, (1 if step == 6 else 2) * sms):
            def call(step=step, blocks=blocks):
                err = fn(step, blocks, reps, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"gj step {name}: CUDA error {err}")
            row[f"us_a_step_{'one' if blocks == 1 else 'every SM full'}"] = (
                time_ms(torch, call, reps=5) * 1e3 / reps)
        print(json.dumps(row), flush=True)


def gj_variants(torch, kernel_build, A_by_batch: dict) -> None:
    """The complex64 gj_inverse kernel at qp = 96 at each blocks an SM of
    GJ_VARIANTS, from a scratch library that includes csrc/gj_inverse.cu:
    its time at each batch and its error against the plain version; then
    the steps of GJ_STEPS_CU."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    body = ['#include "gj_inverse.cu"', GJ_STEPS_CU]
    for minb in GJ_VARIANTS:
        body.append(f'extern "C" int gj_variant_{minb}(const void* A, void* X, int B, '
                    f'int n, int smem, void* s) {{ return launch<float2, 6, 3, {minb}>'
                    f'(A, X, B, n, smem, (cudaStream_t)s); }}')
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        src = Path(tmp) / "gj_variants.cu"
        src.write_text("\n".join(body) + "\n")
        log = nvcc_compile(kernel_build, src, Path(tmp) / "gj_variants.o", "-Xptxas", "-v")
        so = Path(tmp) / "gj_variants.so"
        subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-shared",
                        str(Path(tmp) / "gj_variants.o"), "-o", str(so)], check=True)
        lib = ctypes.CDLL(str(so))
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(json.dumps({"ptxas_gj_variants": ln.strip()}), flush=True)
    gj_steps(torch, lib)
    for minb in GJ_VARIANTS:
        fn = getattr(lib, f"gj_variant_{minb}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = GJ_SMEM_96
        row = {"gj_variant": {"panel": 16, "blocks_per_sm": minb, "smem": smem}}
        for B, A in A_by_batch.items():
            X = torch.empty_like(A)

            def call(A=A, X=X):
                err = fn(A.data_ptr(), X.data_ptr(), A.shape[0], A.shape[-1], smem,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"gj variant {minb}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            want = FF.gj_inverse_blocked(A)
            row[f"B{B}_ms"] = time_ms(torch, call)
            row[f"B{B}_stream_ms"] = stream_ms(torch, call)
            row[f"B{B}_rel_err_vs_plain"] = float((X - want).abs().max() / want.abs().max())
        print(json.dumps(row), flush=True)


# the benchmark cells' boundary columns: frequencies x chains x profiles, layers
MT1D_SHAPES = (("dprism2d", 11, 8, 97, 56), ("coprod2", 12, 8, 77, 52))


def graph_ms(torch, fn, calls: int = 20) -> float:
    """``stream_ms`` of a CUDA graph of fn() (captured after 3 warm-ups on
    a side stream), as the eval replays its work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return stream_ms(torch, graph.replay, calls)


def mt1d_times(torch, dev) -> None:
    """The boundary fields at the cells' shapes (flagship-like profiles,
    complex64): each kernel's graphed time, and the plain version's forward
    and autograd backward, graphed, with its count of device kernels."""
    from hmcmt2d_tpu_torch.ops import mt1d as TD

    kernels = hasattr(TD, "mt1d_field_vjp")
    rng = np.random.default_rng(0)
    air = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])
    for name, nf, nc, ncol, n in MT1D_SHAPES:
        dz = np.concatenate([air[::-1], np.full(n - 16, 100.0), 100.0 * 2.0 ** np.arange(1, 10)])
        sig = np.exp(rng.uniform(np.log(0.005), np.log(0.02), (nc * ncol, n)))
        sig[:, :7] = 1e-8
        om = np.repeat(2 * np.pi * np.logspace(2, -2, nf), len(sig))
        om, sg, dz = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (om, np.tile(sig, (nf, 1)), dz))
        N = sg.shape[0]
        g = torch.ones((N, n + 1), dtype=torch.complex64, device=dev)

        def plain():
            s = sg.detach().requires_grad_(True)
            with torch.enable_grad():
                e, h, _ = TD._propagate(om[:, None], s, dz, True)
                return torch.autograd.grad((e.real + h.real).sum(), s)

        row = {"mt1d": name, "columns": N, "n": n, "plain_fwd_bwd_ms": graph_ms(torch, plain)}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            plain()
            torch.cuda.synchronize()
        row["plain_device_kernels"] = sum(e.count for e in prof.key_averages()
                                          if e.device_type.name == "CUDA")
        if kernels:
            _, _, cut = TD.mt1d_field(om, sg, dz)
            row["mt1d_field_ms"] = graph_ms(torch, lambda: TD.mt1d_field(om, sg, dz))
            row["mt1d_field_vjp_ms"] = graph_ms(
                torch, lambda: TD.mt1d_field_vjp(om, sg, dz, cut, g, g))
            row["mt1d_field_tangent_ms"] = graph_ms(
                torch, lambda: TD.mt1d_field_tangent(om, sg, dz, cut, sg))
            # one warp's columns alone: the latency of a column's chain of
            # dependent steps as these kernels run it, a replay's overhead
            # included; a yardstick, not the hardware's bound
            w = slice(0, 32)
            row["mt1d_field_one_warp_ms"] = graph_ms(
                torch, lambda: TD.mt1d_field(om[w], sg[w], dz))
            row["mt1d_field_vjp_one_warp_ms"] = graph_ms(
                torch, lambda: TD.mt1d_field_vjp(om[w], sg[w], dz, cut[w], g[w], g[w]))
            # least bytes: sigma in; e, h out (forward); cotangents in, the
            # gradient out and the scratch written and read once (vjp)
            cb = 8 * N * (n + 1)
            row["mt1d_field_bytes_bound_ms"] = (4 * N * n + 2 * cb) / 3.35e9
            row["mt1d_field_vjp_bytes_bound_ms"] = (
                4 * N * n * 2 + 2 * cb + 2 * 8 * N * TD.work_rows(n)) / 3.35e9
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose kernels are timed (default: this one)")
    ap.add_argument("--variants", action="store_true",
                    help="also time gj_inverse's panel / blocks-an-SM variants")
    ap.add_argument("--sass-against", type=Path, default=None,
                    help="compare the SASS of the factor's polish = 0 instances and of "
                         "both sweeps with this checkout's")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import kernel_build

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    if Path(kernel_build.__file__).resolve().parent.parent.parent != root:
        sys.exit(f"imported {kernel_build.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if args.sass_against is not None:
        print(json.dumps({"card": smi.stdout.strip(), "root": str(root)}), flush=True)
        kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sass_against(kernel_build, args.sass_against.resolve())
        return
    kernel_build.library()
    print(json.dumps({"card": smi.stdout.strip(), "root": str(root),
                      "build_seconds": kernel_build.build_seconds}), flush=True)
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
            "schur_factor_ms": time_ms(torch, lambda: FF.schur_factor(d[:n], oy[:n], oz[:n])),
            "schur_factor_polish_ms": time_ms(
                torch, lambda: FF.schur_factor(d[:n], oy[:n], oz[:n], polish=1), reps=5),
            "bt_sweep_fwd_ms": time_ms(torch, lambda: FF.bt_sweep_fwd(G[:n], oz[:n], y[:n])),
            "bt_sweep_bwd_ms": time_ms(torch, lambda: FF.bt_sweep_bwd(G[:n], oz[:n], y[:n])),
        }), flush=True)
    del G, y

    # gj_inverse: diagonally dominant blocks (as tests/test_torch_cuda.py)
    A_c64 = {}
    for dtype, nb in GJ_CASES:
        a = (0.3 * (rng.standard_normal((nb, Q, Q)) + 1j * rng.standard_normal((nb, Q, Q)))
             + (4.0 + 0.5j) * np.sqrt(Q) * np.eye(Q))
        A = torch.as_tensor(a, dtype=getattr(torch, dtype), device=dev)
        if dtype == "complex64" and nb in (176, 5632):
            A_c64[nb] = A
        print(json.dumps({"gj_inverse": dtype, "batch": nb, "n": Q,
                          "ms": time_ms(torch, lambda A=A: FF.gj_inverse(A),
                                        reps=20 if nb <= 176 else 5),
                          "stream_ms": stream_ms(torch, lambda A=A: FF.gj_inverse(A))}),
              flush=True)
    if args.variants:
        gj_variants(torch, kernel_build, A_c64)
    mt1d_times(torch, dev)
    for line in ptxas_report(kernel_build):
        print(json.dumps({"ptxas": line}), flush=True)


if __name__ == "__main__":
    main()
