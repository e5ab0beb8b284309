#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hmcmt2d_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc:

    python3 chip_smoke.py

``python3 chip_smoke.py --warmup-engines [N] [--with-eager]`` runs phases
1-2 and then, in place of the rest, the hybrid run's warmup under thomas
and under bcr (each served from its graphs, the default on the card; with
``--with-eager`` each also eagerly, right after, in the same call) at N
iterations (300, the production length) with the production leapfrog
keys, and prints each run's warmup seconds, adapted dt, accept rate and
misfit, and the graphs released at the switch.

Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the CUDA kernels from ``hmcmt2d_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the equilibrated
   flagship operator at C = 8 chains (B = 176 systems of 55 x 95), in the
   layout the main path gives it: the fused factor and sweeps on lines along
   y (95 lines of 55, the system transposed), ``gj_inverse`` at the blocks
   of the thomas and bcr engines' z-lines (55 lines of 95); with times, the
   card's bound for the same work, its share of that bound, and a library
   yardstick (the factor bit
   for bit); the factor's Newton-Schulz variant (polish = 1) too, and the
   unrefined solve error of polish 0 and 1 against complex128 thomas on
   that operator; then all three, which are compiled per padded width, at
   the edges of their templates and at the end of G (random diagonally
   dominant systems); and ``gj_inverse``, the engines' Gauss-Jordan
   inverse, against its plain version ``gj_inverse_blocked`` (the same
   panels of 16) at the blocks they invert (one thomas line, B = 176, n =
   95, in complex64 and complex128; bcr's level 0, B = 176 x 32) with
   ``torch.linalg.inv`` as its yardstick, and at n = 1, 2, 31, 32, 33, 64,
   95, 96, 127, 128 in both types; and the boundary fields' kernels
   (``mt1d_field`` with its tangent variant, ``mt1d_field_vjp``) at the
   main path's 8,536 columns of n = 56, against their plain versions in
   complex128 (to 1e-7) and complex64 (no less accurate against complex128
   than the plain version);
4. the main path: one batched potential value-and-grad of the flagship at
   full width, C = 8, on the fused kernels, served by a CUDA graph
   (``sampler/graphed.py``: captured in this first call, then replayed),
   with the launch counts of that run, held against the port's own
   complex128 thomas engine on the card;
12. the graphed eval against the eager one (``make_potential_vg(...,
   graphed=False)``) on phase 4's inputs and a second model, replayed in
   turn: U, misfit, mnorm, pred and the gradient bit-exact where two eager
   evals agree bit for bit, else within their spread (printed); the
   medians of 20 graphed and 20 eager evals, in turns; the capture's
   seconds and pool bytes; one profile of each (device ms, busy share,
   host launch calls against graph launches; the replay must run our
   kernels (1, 14, 14) times); (1, 14, 14) launches counted a replay;
5. three HMC samples at C = 8 driven by that gradient, eager and graphed
   from the same state: the same accepts, models within 1e-5;
7. the inversion run through the command line, ``hmcmt2d-torch run``, on the
   full-width flagship written to files: 8 chains, warmup under the bcr
   engine (the default under the fused kernels) served from its fresh
   eval's graph (no stale factor on the card; released at the switch), the
   Gauss-Newton mass, the switch to the fused kernels for the dense-mass
   re-adaptation and the main phase, checkpoints, then a resume to more
   samples; with the launch counts of each run held to its fused gradient
   evaluations (graphed: one fused capture a run), and every output file
   checked;
8. the sharded sampler (``hmcmt2d_tpu_torch.parallel``) in ranks spawned on
   the card, each group with its own wall limit, each rank's local eval
   (and amortised cube factor and stale eval) served from CUDA graphs by
   default, the freq-group sum after the replay: (a) one NCCL rank on a
   (1 x 1) mesh runs phase 5's samples graphed and then eager, each bit
   for bit with phase 5's graphed and eager run; (b) two gloo ranks on a
   (2 chains x 1 freq) mesh run them at B = 88 systems a rank, graphed,
   eager and eager again, unamortised and trajectory-amortised
   (``refactor_every`` 2): graphed equal to eager bit for bit where the
   two eager runs agree, else within their spread, with the same launches;
   eager held to phase 5 within tolerance; the ms an eval of each, capture
   seconds and pool bytes a rank; (c) four gloo ranks on a (2 x 2) mesh
   warm up and sample the tiny flagship, graphed, held exactly to one
   process on the card that sums in the ranks' order, and within looser
   limits to the plain single process, limits that two faulty controls
   must break; beside that drift, the plain process's spread over seeds
   0-3; every rank launches each kernel (1, 14, 14) times a fused eval and
   reports every rank's graphs released; (d) ``hmcmt2d-torch run`` in two
   gloo processes joined with --coordinator on phase 7's files, cut
   shorter: rank 0 alone writes, and logs each rank's warmup graphs
   released at the switch;
9. (a) one-mode surveys at full width: the flagship with Z_XY + tipper and
   with rho/phase YX only, C = 8 (B = 88 systems), one value-and-grad each
   on the kernels with its launch counts, held to complex128 thomas;
   (b) the checkpoint tools on phase 7's run: ``summarize_checkpoint``,
   ``refresh_extend`` (launches counted against its fused evals), the
   summary of its checkpoint, and ``map_fit``;
10. the other engines of ``ops/solver.py`` (torch ops, as XLA ops in the
   JAX package; their inverses by LU or by ``gj_inverse``), eager
   (``graphed=False``; phase 13 serves them from graphs): (a) at the
   flagship (phase 4's models), an unrefined complex64 factor-solve under
   thomas, bcr and thomas_blocked, each with LU and with gj, against the
   complex128 solve, each within 10x thomas+lu's; all six refined 6 times
   and held to phase 4's limits against complex128 thomas, with factor,
   solve and eval times, a profile, peak memory, no fused launch and
   gj_inverse 55 times a factor and an eval under thomas(_blocked)+gj, 6
   under bcr+gj, none under LU; complex128 bcr, thomas_blocked and bcr+gj
   within 1e-10 (gradient 1e-8); TF32 must be off; (b) the GN build at
   the start model under thomas and bcr, measured the same way: bcr's peak
   within 1 GB of thomas's, and one solve of its 128 right-hand sides
   sharing a bcr or a thomas_blocked factor within the factor plus 10
   copies of the right-hand sides (a copy of the factor per right-hand
   side would add ~25 GB); then ``hmcmt2d-torch run --warmup-solver
   thomas`` (the JAX package's default) on phase 7's files cut shorter:
   warmup and the GN build on thomas launch no fused kernel, then the
   fused kernels (1, 14, 14) an eval; (c) ``hmcmt2d-torch --precision
   f32 --refine 6 --solver fused --inv gj run`` on the same files: warmup
   and the GN build on bcr+gj launch gj_inverse and no fused kernel, then
   each eval (1, 14, 14) and no gj_inverse;
13. the warmup engines served from their CUDA graphs (``sampler/graphed.py``:
   the fresh eval, the trajectory-amortised factor and the stale-factor
   eval): (a) thomas, bcr and thomas_blocked, each with LU and with gj,
   complex64 refined 6 times (10 against a stale factor), on phase 4's
   models and phase 12's second one in turn, graphed against eager: U,
   misfit, mnorm, pred and the gradient of the fresh and the stale eval
   bit for bit where two eager rounds agree bit for bit, else within their
   spread; the medians of each call's ms; a profile of each (device ms,
   busy share; host launch calls of a graphed eval in single digits);
   capture seconds and pool bytes; gj_inverse 55 (thomas, thomas_blocked)
   or 6 (bcr) times a factor replay and a fresh eval, none a stale eval,
   none under LU (the graphs' own factor, which the sharded sampler
   amortises with; ``BatchedSampler`` on the card takes none); (b) a cut
   warmup (8 iterations at ``timestep: 6 10``
   from one seed, through ``BatchedSampler``) graphed against eager on
   bcr+lu, thomas+lu and bcr+gj: the same accepts and leapfrog steps, dt
   and models within 1e-5, and the seconds of each;
14. the Gauss-Newton build (``gauss_newton_mass`` at full width: 1,804
   rows of J in 15 slabs of 128) with its Jacobian from the CUDA graph of
   the slab pullback (``models/jacobian.py``, the default on the card)
   against the eager build, under thomas + LU (the bench's), bcr + LU and
   bcr + gj (the hybrid run's) and fused (the sweeps in the graph), at the
   start model and a second one in turn, in two rounds (the whole GN mass,
   then J alone): J bit for bit where two eager builds agree bit for bit,
   else within their spread (printed); the same launches, and each kernel
   of the path launched; each build's seconds of J and of the host's
   J'W^2J and Cholesky; capture seconds, pool bytes, the ms of a replayed
   and of an eager slab; the graph released and its memory freed.
   Phases 7, 10b, 10c, 11 and
   ``--warmup-engines`` build J from the graph too (10b prints the eager
   build's peak beside the graphed one's);
11. the port's bench (``hmcmt2d_tpu_torch.bench``) at full width, cut in
   length: ``measure_ess`` at C = 8 with warmup 8, the Gauss-Newton mass,
   re-adaptation 8 and a window of 16 samples, the chain sweep at C = 12
   and 16 (8 samples each), both CPU baselines, and the bench's JSON line
   with every key of ``bench.py``'s: finite positive rates, accept in
   (0, 1], the adapted Gauss-Newton kernel, the card beside the numbers;
   each timed window's batched evals graphed and (1, 14, 14) each, no
   ``gj_inverse`` launch in the run; TF32 off;
6. a JSON summary of the kernels, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``hmcmt2d_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
C = 8                 # chains of the main path
SEED = 0
FACTOR_REL_TOL = 1e-4  # f32 factor, other rounding order over 55 lines
SWEEP_REL_TOL = 1e-5   # f32 sweeps given the same G
POLISH_REL_TOL = 1e-5  # polished factor: its two products sum in another order
# gj_inverse against its plain version (gj_inverse_blocked: the same panels
# and pivot blocks); the rank-16 sums of each panel round in another order
GJ_REL_TOL = {"complex64": 1e-4, "complex128": 1e-10}
# n at the edges of gj_inverse's width templates (qp = 32, 64, 96, 128)
GJ_EDGE_N = (1, 2, 31, 32, 33, 64, 95, 96, 127, 128)
U_REL_TOL = 1e-3       # fused complex64 vs complex128 potential (see phase 4)
# phase 5's graphed run against its eager run: the same kernels and ops on
# the same inputs, so equal but for any atomics' order, which three
# samples of L = 4 amplify little
MODEL_REL_TOL_5 = 1e-5
GRAD_COS_MIN = 0.999
# (B, nzi, q): coprod2's z-line width, Q_MAX, more blocks than two waves,
# odd q with odd B nzi (the 16-byte span around G's last line would end
# past G), and the 64-wide tile the main path runs: its first and last
# widths, and coprod2's y-line width with odd B nzi
EDGE_SHAPES = ((4, 6, 75), (3, 4, 128), (300, 2, 32), (1, 1, 95), (3, 5, 75),
               (2, 3, 33), (4, 6, 64), (3, 5, 51))

# Published peaks (NVIDIA data sheets, dense, no sparsity), by the name
# torch reports: the arithmetic rate, and device-memory bandwidth.  The
# rate is float32's on the CUDA cores, which on these parts equals float64's
# best (its tensor-core rate: the CUDA cores give half), so one figure
# bounds both the complex64 and the complex128 kernels.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H200": (67e12, 4.8e12),
    "H100": (67e12, 3.35e12),       # SXM, "NVIDIA H100 80GB HBM3"
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float, str]:
    for key, (flops, bw) in PEAKS.items():
        if key in name:
            return flops, bw, key
    return (*PEAKS["H100"], "H100 (assumed)")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after ``warmup``."""
    for _ in range(warmup):
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


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max())


def interior_at(problem, m):
    """The interior system of the merged TE+TM solve at model m (C, P) in
    the problem's solve dtype, (nfreq, C, 2, nzi, q): what ``factorize``
    takes on the main path (models/forward.py factor_at)."""
    import torch
    from hmcmt2d_tpu_torch.models import forward as F
    from hmcmt2d_tpu_torch.ops import solver as S

    cfg = problem.fwd.cfg
    sig = problem.sigma2d(m)
    st = F._cast_stencil(problem.fwd.merged_stencil(sig), cfg.real_dtype)
    omegas = 2.0 * np.pi * torch.as_tensor(problem.fwd.data.freqs,
                                           dtype=sig.dtype, device=sig.device)
    om = omegas.to(cfg.real_dtype).reshape((-1, 1, 1, 1, 1))
    return S.interior_system(st, om, dtype=cfg.solve_dtype)


def flagship_system(problem, m):
    """The equilibrated complex64 interior system of the merged TE+TM solve
    at model m (C, P), flattened to (B, nzi, q): its lines along z, the
    block layout of the thomas and bcr engines (ops/solver.py factorize;
    the fused engine on the main path factorises it transposed, on lines
    along y, where ny_i > nz_i)."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    ssys, _ = S.equilibrate(interior_at(problem, m))
    return FF.flatten_system(*ssys)[:3]


# the boundary fields' kernels against their plain versions: complex128 to
# rounding; complex64 no less accurate against the complex128 plain version
# than the complex64 plain version (twice its error plus 1e-5 of a column's
# largest entry), as tests/test_torch_cuda.py holds them
MT1D_REL_TOL_C128 = 1e-7


def _mt1d_col_err(got, want, cols=slice(None)) -> float:
    """Largest error of a column over that column's largest entry."""
    d = (got - want)[:, cols].abs().max(1).values
    return float((d / want[:, cols].abs().max(1).values).max())


def mt1d_columns(torch, problem, m):
    """The main path's boundary columns (``models/forward.py``
    ``boundary_grids_both``) at model m (C, P): omega (N,), sigma (N, n)
    and dz (n,), float64, N = nfreq x C x (ny + 1), n = nz."""
    from hmcmt2d_tpu_torch.models import forward as F

    prof = F.boundary_profiles(problem.mesh, problem.sigma2d(m).double())  # (C, ny+1, nz)
    sig = prof.reshape(-1, prof.shape[-1])
    om = 2.0 * np.pi * torch.as_tensor(problem.fwd.data.freqs, dtype=torch.float64,
                                       device=sig.device)
    return (om.repeat_interleave(sig.shape[0]).contiguous(),
            sig.repeat(len(om), 1).contiguous(), problem.mesh.z_len.double().contiguous())


def check_mt1d(torch, problem, m) -> dict:
    """Phase 3's boundary fields: the forward (e, h), vjp and tangent
    kernels (``ops/mt1d.py``) at the main path's columns against their
    plain versions, in complex128 and complex64, with their times and least
    bytes; results as ``check_kernels`` keeps them."""
    from hmcmt2d_tpu_torch.ops import mt1d as TD

    om64, sg64, dz64 = mt1d_columns(torch, problem, m)
    N, n = sg64.shape
    n_air = problem.mesh.n_air
    say(f"[kernels] boundary fields: {N} columns of n = {n} ({n_air} air)")
    e, h, _ = TD.field_plain(om64, sg64, dz64)
    keep = (e.abs() > 1e-3 * e.abs().max(1, keepdim=True).values) & \
        (h.abs() > 1e-3 * h.abs().max(1, keepdim=True).values)
    gen = torch.Generator(device=sg64.device).manual_seed(SEED)

    def draw(like):
        return torch.randn(like.shape, dtype=like.dtype, device=like.device, generator=gen)

    ge = torch.where(keep, draw(e), 0)
    gh = torch.where(keep, draw(e), 0) / h.abs().max(1, keepdim=True).values
    ds = draw(sg64) * sg64
    ds[:, :n_air] = 0
    outs, calls, cut_differs = {}, {}, {}
    for rdt in (torch.float64, torch.float32):
        cdt = TD.MT1D_DTYPES[rdt]
        om, sg, dz, d = (t.to(rdt) for t in (om64, sg64, dz64, ds))
        g_e, g_h = ge.to(cdt), gh.to(cdt)
        pe, ph, cut = TD.field_plain(om, sg, dz)
        ke, kh, kcut = TD.mt1d_field(om, sg, dz)
        kv = TD.mt1d_field_vjp(om, sg, dz, cut, g_e, g_h)
        kde, kdh = TD.mt1d_field_tangent(om, sg, dz, cut, d)
        torch.cuda.synchronize()
        # the overflow guard's |E| test rounds as each version rounds: in
        # complex64 a column may cut an interface apart, where |E| is
        # already far below the 1e-3 that the comparison keeps
        cut_differs[str(cdt)] = int((kcut != cut).sum())
        if rdt == torch.float64 and cut_differs[str(cdt)]:
            fail(f"mt1d_field ({cdt}): {cut_differs[str(cdt)]} columns cut apart from "
                 "the plain forward's")
        pv = TD.field_vjp_plain(om, sg, dz, cut, g_e, g_h)
        pde, pdh = TD.field_tangent_plain(om, sg, dz, cut, d)
        outs[rdt] = {"mt1d_field": ((ke, pe, keep), (kh, ph, keep)),
                     "mt1d_field_vjp": ((kv, pv, None),),
                     "mt1d_field_tangent": ((kde, pde, keep), (kdh, pdh, keep))}
        if rdt == torch.float32:
            calls = {
                "mt1d_field": (lambda: TD.mt1d_field(om, sg, dz),
                               lambda: TD.field_plain(om, sg, dz)),
                "mt1d_field_vjp": (lambda: TD.mt1d_field_vjp(om, sg, dz, cut, g_e, g_h),
                                   lambda: TD.field_vjp_plain(om, sg, dz, cut, g_e, g_h)),
                "mt1d_field_tangent": (lambda: TD.mt1d_field_tangent(om, sg, dz, cut, d),
                                       lambda: TD.field_tangent_plain(om, sg, dz, cut, d))}
    earth = slice(n_air, None)
    cb, rb = 8 * N * (n + 1), 4 * N * n          # a complex64 field, a float32 profile
    least_bytes = {"mt1d_field": 4 * N + rb + 4 * n + 2 * cb + 4 * N,
                   "mt1d_field_vjp": 4 * N + rb + 4 * n + 4 * N + 2 * cb
                   + 2 * 8 * N * TD.work_rows(n) + rb,
                   "mt1d_field_tangent": 4 * N + 2 * rb + 4 * n + 4 * N + 2 * cb}
    results = {}
    for name in outs[torch.float32]:
        worst = None
        for (k64, p64, m64), (k32, p32, _) in zip(outs[torch.float64][name],
                                                  outs[torch.float32][name]):
            mask = 1 if m64 is None else m64
            cols = earth if m64 is None else slice(None)
            c128 = _mt1d_col_err(k64 * mask, p64 * mask, cols)
            if not c128 < MT1D_REL_TOL_C128:
                fail(f"{name} (complex128): error {c128:.3e} against its plain version, "
                     f"not below {MT1D_REL_TOL_C128:.0e}")
            k, p = (x.to(p64.dtype) * mask for x in (k32, p32))
            t = p64 * mask
            rel, plain_rel = _mt1d_col_err(k, t, cols), _mt1d_col_err(p, t, cols)
            tol = 2 * plain_rel + 1e-5
            abs_e = float((k - p)[:, cols].abs().max())
            if worst is None or rel / tol > worst["rel"] / worst["tol"]:
                worst = dict(rel=rel, tol=tol, abs=abs_e, plain_rel=plain_rel,
                             rel_c128=c128)
        kern, plain = calls[name]
        results[name] = dict(
            worst, columns=N, n=n, cut_differs=cut_differs,
            kernel_ms=time_ms(torch, kern, 20), plain_ms=time_ms(torch, plain, 3),
            library_ms=None, library="none: no PyTorch call computes it",
            flops=0.0, bytes=least_bytes[name],
            bound_formula="least bytes / bandwidth; a column's chain of dependent steps "
                          "(2n forward, ~4n vjp), not bytes, limits it, and its least "
                          "time is not computed here")
    del outs, calls
    return results


# a two-mode gradient eval's launches of each of phase 3's kernels (the
# sweeps 14; the tangent runs only in forward mode, jv)
LAUNCHES_PER_EVAL_3 = {"schur_factor": 1, "schur_factor_polish": 0, "mt1d_field": 1,
                       "mt1d_field_vjp": 1, "mt1d_field_tangent": 0}


def check_kernels(torch, problem, m, flops_peak, bw_peak):
    """Phase 3: every kernel against its plain version at main-path shapes:
    the fused factor and sweeps on the flagship system in the layout of the
    lines ``factorize(method="fused")`` lays (``fused_factor.line_axis``:
    along y, the system transposed); ``gj_inverse`` at the blocks the
    thomas and bcr engines invert, on z-lines; the boundary fields' kernels
    at the main path's columns."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    dz, oyz, ozz = flagship_system(problem, m)
    lines = FF.line_axis(*dz.shape[1:])
    if lines != "y":
        fail(f"the flagship's {tuple(dz.shape[1:])} interiors take lines along {lines}, not y")
    d, oy, oz = FF.flatten_system(*S.transposed(S.InteriorSystem(dz, oyz, ozz)))[:3]
    B, nzi, q = d.shape
    say(f"[kernels] flagship system B={B}, lines along {lines}: {nzi} lines of q={q}")
    results = {}

    # schur_factor
    G = FF.schur_factor(d, oy, oz)
    G_plain = FF.schur_factor_plain(d, oy, oz)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(G)).all()):
        fail("schur_factor produced non-finite values")
    abs_e, rel_e = rel_err(torch, G, G_plain)
    if abs_e != 0.0:   # every product rounds where the plain version's does
        fail(f"schur_factor is not bit-equal to its plain version: max abs error {abs_e:.3e}")
    flops = 8.0 * q ** 3 * nzi * B
    nbytes = B * nzi * (8 * q + 4 * (q - 1) + 8 * q * q) + 4 * B * (nzi - 1) * q
    shape = dict(shape=[B, nzi, q], lines=lines)
    results["schur_factor"] = dict(
        shape, rel=rel_e, abs=abs_e, tol=FACTOR_REL_TOL,
        kernel_ms=time_ms(torch, lambda: FF.schur_factor(d, oy, oz), 10),
        plain_ms=time_ms(torch, lambda: FF.schur_factor_plain(d, oy, oz), 5),
        library_ms=time_ms(torch, lambda: S.bt_factor(S.InteriorSystem(d, oy, oz)), 10),
        library="torch.linalg.inv per line (the thomas chain, S.bt_factor)",
        flops=flops, bytes=nbytes,
        bound_formula="max(8 q^3 nzi B / fp32 peak, (in + G out bytes) / bandwidth)")
    del G_plain

    # the factor's Newton-Schulz variant (polish = 1; not on the main path)
    G1 = FF.schur_factor(d, oy, oz, polish=1)
    G1_plain = FF.schur_factor_plain(d, oy, oz, polish=1)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(G1)).all()):
        fail("schur_factor(polish=1) produced non-finite values")
    abs_e, rel_e = rel_err(torch, G1, G1_plain)
    del G1, G1_plain
    results["schur_factor_polish"] = dict(
        shape, rel=rel_e, abs=abs_e, tol=POLISH_REL_TOL,
        kernel_ms=time_ms(torch, lambda: FF.schur_factor(d, oy, oz, polish=1), 5),
        plain_ms=time_ms(torch, lambda: FF.schur_factor_plain(d, oy, oz, polish=1), 2),
        library_ms=None, library="none: no single PyTorch call computes it",
        flops=3 * flops, bytes=nbytes,
        bound_formula="max(24 q^3 nzi B / fp32 peak, (in + G out bytes) / bandwidth)")
    results["schur_factor_polish"]["solve"] = polish_solve_error(torch, d, oy, oz)

    # the sweeps, given the same G
    rng = np.random.default_rng(SEED)
    b = torch.as_tensor((rng.standard_normal((B, nzi, q))
                         + 1j * rng.standard_normal((B, nzi, q))).astype(np.complex64),
                        device=d.device)
    y = FF.bt_sweep_fwd(G, oz, b)
    y_plain = FF.bt_sweep_fwd_plain(G, oz, b)
    x = FF.bt_sweep_bwd(G, oz, y_plain)
    x_plain = FF.bt_sweep_bwd_plain(G, oz, y_plain)
    torch.cuda.synchronize()
    vec_bytes = 4 * B * (nzi - 1) * q + 2 * 8 * B * nzi * q   # offz, rhs, out
    # the forward sweep reads every G_j, the backward one G_0 .. G_{nzi-2}
    for name, got, want, kern, plain, arg, lines in (
            ("bt_sweep_fwd", y, y_plain, FF.bt_sweep_fwd, FF.bt_sweep_fwd_plain, b, nzi),
            ("bt_sweep_bwd", x, x_plain, FF.bt_sweep_bwd, FF.bt_sweep_bwd_plain, y_plain,
             nzi - 1)):
        abs_e, rel_e = rel_err(torch, got, want)
        results[name] = dict(
            shape, rel=rel_e, abs=abs_e, tol=SWEEP_REL_TOL,
            kernel_ms=time_ms(torch, lambda k=kern, a=arg: k(G, oz, a), 10),
            plain_ms=time_ms(torch, lambda p=plain, a=arg: p(G, oz, a), 10),
            library_ms=None, library="none: no single PyTorch call computes it",
            flops=8.0 * q * q * lines * B, bytes=8 * B * lines * q * q + vec_bytes,
            bound_formula=f"max(8 q^2 {lines} B / fp32 peak, (G lines read + offz "
                          "+ rhs + out bytes) / bandwidth)")

    gj = check_gj_inverse(torch, dz, oyz, ozz)
    results["gj_inverse"] = dict(gj.pop("complex64_thomas_line"), variants=gj)
    results.update(check_mt1d(torch, problem, m))

    for name, r in list(results.items()) + [("gj_inverse/" + k, v) for k, v in gj.items()]:
        t_ops = r["flops"] / flops_peak * 1e3
        t_bytes = r["bytes"] / bw_peak * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        if name.startswith("gj_inverse"):
            say({"kernel": name, "batch": r["batch"], "n": r["n"], "dtype": r["dtype"],
                 "max_rel_err": r["rel"], "max_abs_err": r["abs"], "rel_tol": r["tol"],
                 "max_rel_err_vs_linalg_inv_complex128": r["rel_lu128"],
                 "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "share_of_bound": r["share_of_bound"], "bound_formula": r["bound_formula"],
                 "achieved_TFLOPs": r["flops"] / r["kernel_ms"] / 1e9,
                 "library_ms": r["library_ms"], "library": r["library"]})
            continue
        say({"kernel": name, "shape": r.get("shape"), "lines": r.get("lines"),
             "max_rel_err": r["rel"], "max_abs_err": r["abs"],
             "rel_tol": r["tol"], "kernel_ms": r["kernel_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "share_of_bound": r["share_of_bound"],
             "bound_formula": r["bound_formula"],
             "achieved_GBps": r["bytes"] / r["kernel_ms"] / 1e6,
             "achieved_TFLOPs": r["flops"] / r["kernel_ms"] / 1e9,
             "flops": r["flops"], "bytes": r["bytes"],
             "library_ms": r["library_ms"], "library": r["library"],
             "launches_per_eval": LAUNCHES_PER_EVAL_3.get(name, 14)})
    for name, r in list(results.items()) + [("gj_inverse/" + k, v) for k, v in gj.items()]:
        if not r["rel"] <= r["tol"]:
            fail(f"{name}: max relative error {r['rel']:.3e} > {r['tol']:.0e}")
    solve = results["schur_factor_polish"]["solve"]
    say({"polish_solve_error": solve})
    if not solve["err_polish1"] <= solve["err_polish0"]:
        fail(f"polish = 1 solves worse than polish = 0: {solve}")
    check_edges(torch, d.device)
    check_lines_y(torch, d.device)
    check_gj_edges(torch, d.device)
    return results


def gj_case(torch, A, reps: int) -> dict:
    """gj_inverse on the batch A (B, n, n) against its plain version
    (gj_inverse_blocked at the kernel's panel), with the kernel's, the plain
    version's and torch.linalg.inv's times."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    B, n, _ = A.shape
    panel = FF.gj_inverse_plan(n, A.dtype).panel
    X = FF.gj_inverse(A)
    X_plain = FF.gj_inverse_blocked(A, panel)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(X)).all()):
        fail(f"gj_inverse produced non-finite values at {(B, n)} {A.dtype}")
    abs_e, rel_e = rel_err(torch, X, X_plain)
    _, rel_lu = rel_err(torch, X.to(torch.complex128),
                        torch.linalg.inv(A.to(torch.complex128)))
    del X, X_plain
    dtype = str(A.dtype).removeprefix("torch.")
    return dict(
        batch=B, n=n, dtype=dtype, rel=rel_e, abs=abs_e, tol=GJ_REL_TOL[dtype],
        rel_lu128=rel_lu,
        kernel_ms=time_ms(torch, lambda: FF.gj_inverse(A), reps),
        plain_ms=time_ms(torch, lambda: FF.gj_inverse_blocked(A, panel), 2),
        library_ms=time_ms(torch, lambda: torch.linalg.inv(A), reps),
        library="torch.linalg.inv (pivoted LU) on the same batch",
        flops=8.0 * n ** 3 * B, bytes=2 * A.numel() * A.element_size(),
        bound_formula="max(8 n^3 B / peak rate (fp32 CUDA cores, fp64 tensor "
                      "cores), (A in + X out bytes) / bandwidth)")


def check_gj_inverse(torch, d, oy, oz) -> dict:
    """gj_inverse at the blocks the engines invert on the flagship: the
    tridiagonal blocks of line 0 of the equilibrated system (B = 176, n =
    95: one inverse of the thomas chain) in complex64 and complex128, and
    bcr's level 0 (the even lines padded with identity blocks to 32 a
    system, B = 176 x 32) in complex64."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    line = FF._dense_line(d[:, 0], oy[:, 0])
    T = S._dense_blocks(d, oy)                              # (B, nzi, q, q)
    B, nzi, q = d.shape
    n_even = (2 ** nzi.bit_length()) // 2                   # bcr pads to 2^m - 1
    eye = torch.eye(q, dtype=T.dtype, device=T.device)
    even = T[:, 0::2]
    level0 = torch.cat([even, eye.expand(B, n_even - even.shape[1], q, q)], dim=1)
    cases = {"complex64_thomas_line": (line, 10),
             "complex128_thomas_line": (line.to(torch.complex128), 10),
             "complex64_bcr_level0": (level0.reshape(-1, q, q).contiguous(), 5)}
    out = {}
    for name, (A, reps) in cases.items():
        out[name] = gj_case(torch, A, reps)
        del A
    del T, even, level0
    return out


def check_gj_edges(torch, dev):
    """gj_inverse at the edges of its width templates in both types, on
    random diagonally dominant matrices (B = 8)."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    rows = []
    for n in GJ_EDGE_N:
        rng = np.random.default_rng(SEED + n)
        A = (0.3 * (rng.standard_normal((8, n, n)) + 1j * rng.standard_normal((8, n, n)))
             + (4.0 + 0.5j) * np.sqrt(n) * np.eye(n))
        for dtype in (torch.complex64, torch.complex128):
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            X = FF.gj_inverse(At)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(torch.view_as_real(X)).all())
            _, rel = rel_err(torch, X, FF.gj_inverse_blocked(At, FF.gj_inverse_plan(n, dtype).panel))
            name = str(dtype).removeprefix("torch.")
            rows.append([n, name, rel])
            if not finite or not rel <= GJ_REL_TOL[name]:
                fail(f"gj_inverse at n = {n} {name}: finite {finite}, relative error {rel:.3e}")
    say({"gj_inverse_edges": rows, "rel_tol": GJ_REL_TOL,
         "plans": {n: FF.gj_inverse_plan(n)._asdict() for n in (1, 33, 95, 128)}})


def polish_solve_error(torch, d, oy, oz) -> dict:
    """One unrefined factor-solve of the equilibrated flagship system (d,
    oy, oz) on the kernels with polish 0 and 1, against its complex128
    thomas solve, for a fixed right-hand side (numpy seed 3); the launches
    of the polish = 1 factor-solve, counted from 0 just before it."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.standard_normal(tuple(d.shape))
                        + 1j * rng.standard_normal(tuple(d.shape)), device=d.device)
    x_e = S.bt_solve(S.bt_factor(S.InteriorSystem(d.to(torch.complex128), oy.double(),
                                                  oz.double())), b)
    out = {}
    for polish in (0, 1):
        torch.cuda.synchronize()
        FF.reset_launches()
        x = FF.fused_bt_solve(FF.fused_schur_factor(d, oy, oz, polish), b)
        torch.cuda.synchronize()
        out[f"launches_polish{polish}"] = FF.launches()
        out[f"err_polish{polish}"] = float((x - x_e).norm() / x_e.norm())
    out["ratio"] = out["err_polish0"] / out["err_polish1"]
    return out


def random_system(torch, B, nzi, q, seed, dev):
    """Diagonally dominant complex systems and a right-hand side, made
    with numpy (as tests/test_torch_cuda.py): diag, offy, offz, rhs."""
    rng = np.random.default_rng(seed)
    d = (4.0 + 0.1 * rng.standard_normal((B, nzi, q))
         + 1j * 0.5 * rng.standard_normal((B, nzi, q))).astype(np.complex64)
    oy = (1.0 + 0.1 * rng.standard_normal((B, nzi, q - 1))).astype(np.float32)
    oz = (1.0 + 0.1 * rng.standard_normal((B, nzi - 1, q))).astype(np.float32)
    v = (rng.standard_normal((B, nzi, q))
         + 1j * rng.standard_normal((B, nzi, q))).astype(np.complex64)
    return [torch.as_tensor(a, device=dev) for a in (d, oy, oz, v)]


def check_edges(torch, dev):
    """The factor and both sweeps against their plain versions at the
    edges of their width templates."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    for i, (B, nzi, q) in enumerate(EDGE_SHAPES):
        d, oy, oz, v = random_system(torch, B, nzi, q, SEED + i, dev)
        G = FF.schur_factor(d, oy, oz)
        y = FF.bt_sweep_fwd(G, oz, v)
        x = FF.bt_sweep_bwd(G, oz, v)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(torch.view_as_real(t)).all())
                     for t in (G, y, x))
        _, g_rel = rel_err(torch, G, FF.schur_factor_plain(d, oy, oz))
        _, y_rel = rel_err(torch, y, FF.bt_sweep_fwd_plain(G, oz, v))
        _, x_rel = rel_err(torch, x, FF.bt_sweep_bwd_plain(G, oz, v))
        say({"edge_shape": [B, nzi, q], "finite": finite,
             "schur_factor_rel_err": g_rel, "bt_sweep_fwd_rel_err": y_rel,
             "bt_sweep_bwd_rel_err": x_rel,
             "factor_plan": FF.schur_factor_plan(q)._asdict(),
             "fwd_plan": FF.bt_sweep_fwd_plan(q)._asdict(),
             "bwd_plan": FF.bt_sweep_bwd_plan(q)._asdict()})
        if not finite:
            fail(f"non-finite kernel output at shape {(B, nzi, q)}")
        if not g_rel <= FACTOR_REL_TOL:
            fail(f"schur_factor at {(B, nzi, q)}: relative error {g_rel:.3e}")
        for name, rel in (("bt_sweep_fwd", y_rel), ("bt_sweep_bwd", x_rel)):
            if not rel <= SWEEP_REL_TOL:
                fail(f"{name} at {(B, nzi, q)}: relative error {rel:.3e}")


def check_lines_y(torch, dev):
    """A mesh wider than the kernels' widest line (the wide COPROD2
    profile's interior, 51 x 225, at C = 1: B = 24) factorised by
    ``factorize`` on lines along y (its factor's record), refined six times
    against complex128 thomas, with its launches counted; its factor and one
    pair of sweeps against their plain versions on the same transposed
    inputs."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S

    d, oy, oz, v = random_system(torch, 24, 51, 225, SEED, dev)
    sys_ = S.InteriorSystem(d.to(torch.complex128), oy.double(), oz.double())
    b = v.to(torch.complex128)
    torch.cuda.synchronize()
    FF.reset_launches()
    f = S.factorize(sys_, dtype=torch.complex64, method="fused")
    x = S.refined_solve(sys_, f, b, iters=6)
    torch.cuda.synchronize()
    counts = FF.launches()
    exact = S.factor_solve(S.factorize(sys_), b)
    _, rel = rel_err(torch, x, exact)
    td, toy, toz = FF.flatten_system(*S.transposed(S.equilibrate(sys_)[0]))[:3]
    _, g_rel = rel_err(torch, f.fac.G, FF.schur_factor_plain(td, toy, toz))
    vt = v.mT.contiguous()
    y = FF.bt_sweep_fwd(f.fac.G, f.fac.offz, vt)
    _, y_rel = rel_err(torch, y, FF.bt_sweep_fwd_plain(f.fac.G, f.fac.offz, vt))
    _, x_rel = rel_err(torch, FF.bt_sweep_bwd(f.fac.G, f.fac.offz, y),
                       FF.bt_sweep_bwd_plain(f.fac.G, f.fac.offz, y))
    say({"lines_y_shape": [24, 51, 225], "lines": f.fac.lines, "launches": counts,
         "refined_rel_err": rel, "schur_factor_rel_err": g_rel,
         "bt_sweep_fwd_rel_err": y_rel, "bt_sweep_bwd_rel_err": x_rel})
    want = {"schur_factor": 1, "bt_sweep_fwd": 7, "bt_sweep_bwd": 7}
    if f.fac.lines != "y" or counts != want:
        fail(f"lines along y: {f.fac.lines}, launches {counts} != {want}")
    if not rel <= 1e-12:
        fail(f"refined solve on lines along y: relative error {rel:.3e}")
    if not (g_rel <= FACTOR_REL_TOL and y_rel <= SWEEP_REL_TOL and x_rel <= SWEEP_REL_TOL):
        fail(f"lines along y against the plain versions: factor {g_rel:.3e}, "
             f"sweeps {y_rel:.3e} {x_rel:.3e}")
    FF.reset_launches()


def profile_eval(torch, vg, m, m_ref) -> dict:
    """One gradient evaluation under torch.profiler: device time by kernel
    (ours by name, the rest summed), and the device's busy share of the
    profiled wall time (the profiler's own overhead inflates the wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vg(m, m_ref)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    host_calls = {"kernel": 0, "graph": 0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (us / 1e3, e.count)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            # the runtime calls that launch: one a kernel, or one a graph
            if "LaunchKernel" in e.key:
                host_calls["kernel"] += e.count
            elif "GraphLaunch" in e.key:
                host_calls["graph"] += e.count
    total = sum(ms for ms, _ in kernels.values())
    ours = {}
    for short in ("schur_factor_kernel", "bt_sweep_fwd_kernel", "bt_sweep_bwd_kernel",
                  "mt1d_field_kernel", "mt1d_vjp_kernel"):
        hit = [(ms, n) for k, (ms, n) in kernels.items() if short in k]
        ours[short] = {"ms": sum(ms for ms, _ in hit), "count": sum(n for _, n in hit)}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profiled_wall_ms": wall_ms, "device_ms": total,
            "device_busy_share": total / wall_ms,
            "device_kernels": sum(n for _, n in kernels.values()),
            "host_kernel_launch_calls": host_calls["kernel"],
            "host_graph_launch_calls": host_calls["graph"],
            "ours": ours,
            "other_device_ms": total - sum(v["ms"] for v in ours.values()),
            "top": [{"kernel": k[:80], "ms": ms, "count": n} for k, (ms, n) in top]}


# phase 12: the graphed eval against the eager one on phase 4's inputs
GRAPH_TIMED_EVALS = 20
# the boundary fields' kernels (ops/mt1d.py): a forward and a vjp a gradient eval
MT1D_PER_EVAL = {"mt1d_field": 1, "mt1d_field_vjp": 1}
# the fused launches of a two-mode gradient eval on the flagship
FUSED_PER_EVAL = {"schur_factor": 1, "bt_sweep_fwd": 14, "bt_sweep_bwd": 14}
EVAL_PER_REPLAY = {**FUSED_PER_EVAL, **MT1D_PER_EVAL}

OUTPUT_NAMES = ("U", "misfit", "mnorm", "pred", "grad")


def _flat_outputs(out):
    (U, (misfit, mnorm, pred)), g = out
    return dict(zip(OUTPUT_NAMES, (U, misfit, mnorm, pred, g)))


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def check_graphed(torch, problem, vg, vg_eager, m, m_ref, smi) -> dict:
    """Phase 12: phase 4's graphed eval (``vg``, captured there for (C, P))
    against the eager one (``vg_eager``) on phase 4's models and on a second
    model (numpy seed 2), each replayed in turn: U, misfit, mnorm, pred and
    the gradient bit-exact where two eager evals agree bit for bit, else
    within their spread; the medians of GRAPH_TIMED_EVALS evals of each, in
    turns; the capture's seconds and pool bytes; one profile of each; and
    the counts, (1, 14, 14) a replay.  Returns the summary."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    rng = np.random.default_rng(2)
    m2 = m + 0.01 * torch.as_tensor(rng.standard_normal(tuple(m.shape)),
                                    dtype=m.dtype, device=m.device)
    models = {"phase4": m, "seed2": m2}
    graphed = {}
    for _ in range(2):          # in turn, twice: inputs copied in, outputs fresh
        for name, mm in models.items():
            graphed.setdefault(name, []).append(_flat_outputs(vg(mm, m_ref)))
    eager = {name: [_flat_outputs(vg_eager(mm, m_ref)) for _ in range(2)]
             for name, mm in models.items()}
    compare, bad = {}, []
    for name in models:
        e0, e1 = eager[name]
        for k in OUTPUT_NAMES:
            spread = _max_abs(e0[k], e1[k])
            err = max(_max_abs(g[k], e0[k]) for g in graphed[name])
            compare[f"{name}.{k}"] = {"graphed_vs_eager": err, "eager_spread": spread}
            if err > spread:
                bad.append(f"{name}.{k}: {err:.3e} against an eager spread {spread:.3e}")

    graph_ms, eager_ms = [], []
    for _ in range(GRAPH_TIMED_EVALS):
        for fn, out in ((vg, graph_ms), (vg_eager, eager_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(m, m_ref)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)

    replays = 3
    torch.cuda.synchronize()
    FF.reset_launches()
    for _ in range(replays):
        vg(m, m_ref)
    torch.cuda.synchronize()
    counts = FF.launches()
    want = {k: replays * n for k, n in EVAL_PER_REPLAY.items()}

    prof_g = profile_eval(torch, vg, m, m_ref)
    prof_e = profile_eval(torch, vg_eager, m, m_ref)
    caps = {str(list(c.inputs[0].shape)): {"capture_s": c.seconds, "pool_bytes": c.pool_bytes,
                                "warmup_launches": c.warmup_launches,
                                "launches_per_replay": c.launches}
            for key, c in vg.captures.items()}
    ours_g = {k: v["count"] for k, v in prof_g["ours"].items()}
    summary = {"phase": 12, "graphed_eval": "CUDA graph of potential_value_and_grad",
               "card": smi, "chains": m.shape[0], "compare": compare,
               "graphed_ms": graph_ms, "eager_ms": eager_ms,
               "graphed_median_ms": float(np.median(graph_ms)),
               "eager_median_ms": float(np.median(eager_ms)),
               "eager_over_graphed": float(np.median(eager_ms) / np.median(graph_ms)),
               "captures": caps, "launches": counts, "replays": replays,
               "profile_graphed": prof_g, "profile_eager": prof_e}
    say(summary)
    if bad:
        fail("12: graphed against eager: " + "; ".join(bad))
    if counts != want:
        fail(f"12: launches {counts} != {want} for {replays} replays")
    if any(c.launches != EVAL_PER_REPLAY for c in vg.captures.values()):
        fail(f"12: a capture recorded {caps}, not {EVAL_PER_REPLAY} an eval")
    if ours_g != {"schur_factor_kernel": 1, "bt_sweep_fwd_kernel": 14, "bt_sweep_bwd_kernel": 14,
                  "mt1d_field_kernel": 1, "mt1d_vjp_kernel": 1} \
            or prof_g["host_graph_launch_calls"] < 1:
        fail(f"12: the profiled replay ran {ours_g} of our kernels in "
             f"{prof_g['host_graph_launch_calls']} graph launches")
    return summary


def hmc_options(H):
    """Phase 5's sampler controls (also phase 8a and 8b's)."""
    return H.HMCOptions(dt=1e-3, steps_lo=4, steps_hi=4,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)


def flagship_inputs(torch, dev):
    """The main path's problem (realistic observations) and its models:
    (problem, m0, m (C, P) around m0 from numpy seed 1, m_ref)."""
    from hmcmt2d_tpu_torch.bench import realistic
    from hmcmt2d_tpu_torch.entry import flagship_problem

    problem, m0 = flagship_problem(device=dev)
    m0_t = torch.as_tensor(m0, dtype=torch.float32, device=dev)
    problem = realistic(problem, m0_t)
    rng = np.random.default_rng(1)
    m = (m0_t + 0.01 * torch.as_tensor(rng.standard_normal((C, len(m0))),
                                       dtype=torch.float32, device=dev))
    return problem, m0, m, m0_t.expand(C, -1)


STARTUP = """datafile:      obs.dat
modelfile:     start.mod
burninsamples: 8
totalsamples:  16
chains:        8
seed:          1
resistivity:   1.0 1e4 0.05
timeinterval:  0.01
timestep:      4 4
adapt:         on
warmuppool:    median
masstype:      gaussnewton
masswarmup:    4
massdt0:       0.2
"""
RUN_PHASES = (("warmup", r"\[hmcmt2d\] warmup \d+/\d+:"),
              ("dense_mass_build", r"\[hmcmt2d\] dense mass"),
              ("engine_switch_eval", r"\[hmcmt2d\] mass-warmup init:"),
              ("dense_readapt", r"\[hmcmt2d\] mass-warmup \d+/\d+:"),
              ("main", r"\[hmcmt2d\] samples "))


class _Tee:
    """Echo what is written and keep a copy (the CLI's progress lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cli_run(torch, argv):
    """``cli.main(argv)`` in-process, launch counts set to 0 just before and
    read just after: (rc, launches, wall seconds, its stdout)."""
    import contextlib

    from hmcmt2d_tpu_torch import cli
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    FF.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = cli.main(argv)
    except Exception as e:  # noqa: BLE001 - reported, then the phase fails
        import traceback

        traceback.print_exc()
        fail(f"hmcmt2d-torch {' '.join(argv[:1])} raised {type(e).__name__}: {e}")
    torch.cuda.synchronize()
    return rc, FF.launches(), time.perf_counter() - t0, "".join(tee.lines)


@contextlib.contextmanager
def recorded_captures():
    """Yields the list of (engine, Capture) of the graphs
    (``sampler/graphed.py``) that graphed potentials capture inside the
    block, in order."""
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    caps, capture = [], GraphedPotential._capture

    def recording(self, kind, fn, inputs):
        caps.append((self.problem.fwd.cfg.solver_method, capture(self, kind, fn, inputs)))
        return caps[-1][1]

    GraphedPotential._capture = recording
    try:
        yield caps
    finally:
        GraphedPotential._capture = capture


def capture_summary(caps) -> list:
    return [dict(engine=engine, **c.summary()) for engine, c in caps]


def capture_kinds(caps) -> list:
    return [f"{engine}:{c.kind}" for engine, c in caps]


def phase_seconds(log: str) -> dict:
    """Seconds per phase, summed from the ``[hmcmt2d]`` lines."""
    import re

    out = {}
    for name, pat in RUN_PHASES:
        secs = 0.0
        for line in log.splitlines():
            if re.match(pat, line):
                m = re.search(r"([\d.]+) ?s\)?$", line.strip())
                secs += float(m.group(1)) if m else 0.0
        out[name] = secs
    return out


def write_run_files(problem, m0, d: Path, startup: str) -> None:
    """The start model, the observations and ``startup`` written to ``d``
    (the start model read back as a check)."""
    import torch

    from hmcmt2d_tpu_torch.io import read_model, write_data, write_model

    sig = problem.sigma2d(torch.as_tensor(m0, device=problem.device))
    write_model(d / "start.mod", problem.mesh, sig)
    mesh, sig_back = read_model(d / "start.mod", device=problem.device)
    if mesh.nz != problem.mesh.nz or not np.allclose(sig_back, sig.cpu().numpy(),
                                                     rtol=1e-2):
        fail("the start model did not read back")
    write_data(d / "obs.dat", problem.fwd.data, problem.obs, 1.0 / problem.weights)
    (d / "startup").write_text(startup)


def output_names(n_chains: int) -> list[str]:
    """The files ``hmcmt2d-torch run`` writes for ``n_chains`` chains."""
    return (["meanModel.model", "stdModel.model"]
            + [f"hmcsamples_id{i}.{e}" for i in range(1, n_chains + 1)
               for e in ("model", "data")]
            + [f"hmcstatistics_id{i}.log" for i in range(1, n_chains + 1)])


def check_cli_run(torch, problem, m0, smi, d: Path):
    """Phase 7: ``hmcmt2d-torch run`` on the flagship, written to files in
    ``d``, then resumed; the warmup runs on bcr from its fresh eval's
    graph (no stale factor on the card; released at the switch), and every fused
    gradient eval launches the factor once and each sweep 14 times (and,
    as every gradient eval, the boundary fields' forward and vjp once).
    Returns the launch counts of the two runs and
    the first run's phase seconds; the files and the checkpoint
    ``d / "run.ckpt.npz"`` stay for phase 9b."""
    from hmcmt2d_tpu_torch.sampler import diagnostics as D

    n_chains, n_burn, n_mass, n_total, n_resumed = 8, 8, 4, 16, 20
    write_run_files(problem, m0, d, STARTUP)
    ck = str(d / "run.ckpt.npz")
    base = ["run", str(d / "startup"), "--outdir", str(d), "--checkpoint", ck,
            "--checkpoint-every", "2"]

    with recorded_captures() as caps1:
        rc1, launches1, wall1, log1 = cli_run(torch, base)
    with np.load(ck) as z:
        lf1 = z["lf_steps"][:, 0].astype(int)
    with recorded_captures() as caps2:
        rc2, launches2, wall2, log2 = cli_run(torch, base + ["--samples", str(n_resumed),
                                                            "--resume"])
    with np.load(ck) as z:
        ck_ = {k: z[k] for k in ("models", "stats", "accepts", "lf_steps",
                                 "n_warm", "dt", "start_stats")}
    missing = [n for n in output_names(n_chains) if not (d / n).exists()]

    models, stats, accepts, lf = (ck_[k] for k in ("models", "stats", "accepts", "lf_steps"))
    n_warm = int(ck_["n_warm"])
    # fused gradient evals: run 1 evaluates once at the engine switch and
    # then along every leapfrog step of rows n_burn..n_total-1 (the dense
    # re-adaptation and the main phase); the resumed run only along rows
    # n_total..n_resumed-1 (its state comes from the checkpoint)
    evals = [1 + int(lf1[n_burn:n_total].sum()), int(lf[n_total:n_resumed, 0].sum())]
    secs = [phase_seconds(log1), phase_seconds(log2)]
    n_main = [n_total - n_burn - n_mass, n_resumed - n_total]
    rates = [n_chains * n / s["main"] if s["main"] > 0 else None
             for n, s in zip(n_main, secs)]
    rhat = D.split_rhat(models[n_warm:])
    switch = "hybrid: warmup engine bcr -> main engine fused" in log1
    released = log1.count("released the warmup engine's")
    gn_released = log1.count(GN_LOG_14)
    summary = {
        "cli_run": "hmcmt2d-torch run (flagship, full width, from files)",
        "card": smi, "chains": n_chains, "rc": [rc1, rc2], "switch_logged": switch,
        "wall_s": [wall1, wall2], "phase_s": secs,
        "adapted_dt": float(ck_["dt"]), "n_warm": n_warm, "rows": int(models.shape[0]),
        "accept_rate": {"warmup": float(accepts[:n_burn].mean()),
                        "dense_readapt": float(accepts[n_burn:n_warm].mean()),
                        "main": float(accepts[n_warm:].mean())},
        "nfevals": int(lf.sum()) + n_chains,
        "main_samples_per_s_per_chip": rates,
        "split_rhat_main": {"max": float(rhat.max()), "median": float(np.median(rhat))},
        "misfit": {"start_mean": float(ck_["start_stats"][:, 0].mean()),
                   "last_mean": float(stats[-1, :, 0].mean())},
        "fused_evals": evals, "launches": [launches1, launches2],
        "eval": "graphed" if caps1 and caps2 else "eager",
        "graph_captures": [capture_summary(caps1), capture_summary(caps2)],
        "warmup_graphs_released": released, "gn_graphs_released": gn_released,
        "leapfrog_steps": lf[:, 0].tolist()}
    say(summary)
    if rc1 != 0 or rc2 != 0:
        fail(f"hmcmt2d-torch run returned {rc1}, {rc2}")
    if not switch:
        fail("hmcmt2d-torch run did not warm up on bcr and switch to the fused kernels")
    # run 1: bcr's fresh eval in warmup (every eval: the card amortises no
    # factor, sampler/driver.py make_factor_fn), released at the switch,
    # then the fused eval; the resumed run only the fused eval
    want_caps = [["bcr:eval", "fused:eval"], ["fused:eval"]]
    if [capture_kinds(caps1), capture_kinds(caps2)] != want_caps or released != 1:
        fail(f"the two runs captured {[capture_kinds(caps1), capture_kinds(caps2)]}, not "
             f"{want_caps}, and released {released} warmup graphs at the switch, not 1")
    if gn_released != 1:
        fail(f"run 1 logged {gn_released} Gauss-Newton Jacobian graphs released, not 1")
    if missing:
        fail(f"missing output files: {missing}")
    if not (np.isfinite(stats).all() and np.isfinite(models).all()):
        fail("non-finite stats or models in the checkpoint")
    for name, a in summary["accept_rate"].items():
        if not 0.0 <= a <= 1.0:
            fail(f"{name} accept rate {a} outside [0, 1]")
    if models.shape[0] != n_resumed or n_warm != n_burn + n_mass:
        fail(f"resumed run holds {models.shape[0]} rows with n_warm {n_warm}, "
             f"expected {n_resumed} and {n_burn + n_mass}")
    for i, (counts, n_eval) in enumerate(zip((launches1, launches2), evals)):
        want = {"schur_factor": n_eval, "bt_sweep_fwd": 14 * n_eval,
                "bt_sweep_bwd": 14 * n_eval}
        if fused_only(counts) != want or n_eval == 0 or not mt1d_ran(counts, n_eval):
            fail(f"run {i + 1}: launches {counts} != {want} for {n_eval} fused evals")
    return (launches1, launches2), secs[0]


# phase 8
RANK_WALL_S = 240.0      # wall limit of each group of spawned ranks
MODEL_REL_TOL_8B = 1e-5  # B = 88 a rank may round batched calls otherwise
FLIP_MARGIN = 1e-6       # |u - exp(dH)| under which a flipped accept is reported
# 8c against one process summing in the ranks' batches and order (exact),
# and against the plain single process (one batch, autograd's own float32
# sum over frequencies): the second limit is about 4x its dt readings and
# 7x its model readings; a control fault must break each (PERF.md, phase 8)
DT_REL_TOL_8C, MODEL_REL_TOL_8C = 1e-5, 1e-4
DT_REL_TOL_8C_PLAIN, MODEL_REL_TOL_8C_PLAIN = 3e-2, 2e-3
TINY_C = 4
DRIFT_SEEDS = (0, 1, 2, 3)   # the plain tiny warmup's seeds, for the drift's yardstick


def tiny_inputs(torch, dev):
    """Phase 8c's problem (the tiny flagship, fused on the card), models
    and sampler controls."""
    from hmcmt2d_tpu_torch.entry import flagship_problem
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import hmc as H

    problem, m0 = flagship_problem(tiny=True, device=dev)
    rng = np.random.default_rng(2)
    m = torch.as_tensor(m0 + 0.05 * rng.standard_normal((TINY_C, len(m0))),
                        dtype=torch.float32, device=dev)
    opts = H.HMCOptions(dt=0.02, steps_lo=2, steps_hi=3, log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)
    return problem, m, opts, A.WarmupOptions(alpha_pool="median")


def serial_mesh_vg(torch, problem, n_chain, n_freq, fault=None):
    """The potential of an (n_chain x n_freq) mesh in one process, in the
    ranks' batches and order: each chain block's value and gradient summed
    in float64 over its frequency blocks, as ShardedSampler.potential_vg
    sums them over the freq group (two ranks add in either order alike).
    ``fault`` makes it a control: "prior_scale" gives every frequency block
    the whole prior (at the start the prior is 0, so its effect stays near
    the float32 drift and only the exact limits can catch it);
    "freq_block" makes every frequency block solve the first one's (the
    plain limits must catch it)."""
    obs, w = (torch.as_tensor(a, device=problem.device) for a in problem.cube_arrays())
    freqs = np.asarray(problem.fwd.data.freqs)
    k = len(freqs) // n_freq

    def vg(m, m_ref, fac=None):
        n = m.shape[0] // n_chain
        tots, preds = [], []
        for cb in range(n_chain):
            rows, tot, cubes = slice(cb * n, (cb + 1) * n), 0.0, []
            for fb in range(n_freq):
                fs = slice(0, k) if fault == "freq_block" else slice(fb * k, (fb + 1) * k)
                mm = m[rows].detach().requires_grad_(True)
                with torch.enable_grad():
                    U, (mis, mn, cube) = problem.potential_cube(
                        mm, m_ref[rows], 1.0, freqs[fs], obs[fs], w[fs],
                        prior_scale=1.0 if fault == "prior_scale" else 1.0 / n_freq)
                    (g,) = torch.autograd.grad(U.sum(), mm)
                parts = (U.detach(), mis.detach(), mn.detach(), g)
                tot = tot + torch.cat([p.reshape(n, -1).double() for p in parts], 1)
                cubes.append(cube.detach().reshape(n, k, -1))
            tots.append(tot)
            preds.append(torch.cat(cubes, 1).flatten(1))
        tot = torch.cat(tots)
        dts = [p.dtype for p in parts]
        return ((tot[:, 0].to(dts[0]), (tot[:, 1].to(dts[1]), tot[:, 2].to(dts[2]),
                                        torch.cat(preds))), tot[:, 3:].to(dts[3]))

    return vg


# phase 8's flagship runs a group makes, in order: (name, graphed,
# refactor_every; 0 is unamortised)
SHARDED_RUNS = {"8a": (("graphed", True, 0), ("eager", False, 0)),
                "8b": (("graphed", True, 0), ("eager", False, 0), ("eager_again", False, 0),
                       ("amortised_graphed", True, 2), ("amortised_eager", False, 2),
                       ("amortised_eager_again", False, 2))}


def sharded_rank(dev, n_chain, n_freq, job):
    """One rank of phase 8: ``job`` "8a" or "8b" runs phase 5's three
    samples through ShardedSampler.run once for each entry of
    SHARDED_RUNS[job] (graphed or eager, unamortised or trajectory-
    amortised), "tiny" a 4-iteration median-pooled warmup and a 2-sample
    run, graphed; launch counts set to 0 just before each run, read just
    after; a graphed sampler's captures released after its run."""
    import dataclasses

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.parallel.multichain import ShardedSampler, make_device_mesh
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    mesh = make_device_mesh(n_chain, n_freq, device=dev)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": f"{dev} {torch.cuda.get_device_name(dev)}", "runs": {}}

    def timed(ss, sample):
        torch.cuda.synchronize()
        FF.reset_launches()
        t0 = time.perf_counter()
        res, lf, extra = sample(ss)
        torch.cuda.synchronize()
        return res, lf, extra, time.perf_counter() - t0, FF.launches()

    def measured(ss, sample):
        res, lf, extra, wall, launches = timed(ss, sample)
        run = dict(extra, wall_s=wall, launches=launches, evals=1 + int(lf.sum()),
                   models=res.models.cpu().numpy(), accepts=res.accepts.cpu().numpy(),
                   stats=res.stats.cpu().numpy(), lf=lf,
                   graphed=isinstance(ss.local_vg, GraphedPotential))
        caps = [c.summary() for c in ss.local_vg.captures.values()] if run["graphed"] else []
        if run["graphed"]:
            # the same samples again, every graph captured: the replays'
            # own pace, which a rank's wall less its captures cannot give
            # (it also waits on the other ranks' captures)
            again, _, _, wall_again, launches_again = timed(ss, sample)
            run.update(replayed_wall_s=wall_again, replayed_launches=launches_again,
                       replayed_same=all(np.array_equal(getattr(again, k).cpu().numpy(), run[k])
                                         for k in ("models", "accepts", "stats")))
        released = ss.release()
        return dict(run, captures=caps, capture_s=sum(c["capture_s"] for c in caps),
                    pool_bytes=sum(c["pool_bytes"] for c in caps),
                    released=sorted((c["rank"], c["kind"]) for c in released))

    if job in SHARDED_RUNS:
        problem, _, m, m_ref = flagship_inputs(torch, dev)
        mass = H.identity_mass(problem.n_param, torch.float32, dev)
        for name, graphed, every in SHARDED_RUNS[job]:
            opts = hmc_options(H)
            if every:
                opts = dataclasses.replace(opts, refactor_every=every)

            def sample(ss, opts=opts):
                res = ss.run(opts, mass, m, m_ref, 3, SEED)
                return res, res.lf_steps[:, 0].cpu().numpy(), {}

            out["runs"][name] = measured(
                ShardedSampler(problem, 1.0, mesh, amortize=bool(every), graphed=graphed),
                sample)
    else:
        problem, m, opts, wopts = tiny_inputs(torch, dev)

        def sample(ss):
            wres, state, wmass, info = ss.warmup(opts, m, m, 4, SEED, wopts)
            res = ss.run(dataclasses.replace(opts, dt=float(info.dt)), wmass, state.m, m, 2,
                         SEED, init_state=state)
            lf = np.concatenate([wres.lf_steps[:, 0].cpu().numpy(),
                                 res.lf_steps[:, 0].cpu().numpy()])
            return res, lf, {"dt": float(info.dt)}

        out["runs"]["graphed"] = measured(ShardedSampler(problem, 1.0, mesh, amortize=False),
                                          sample)
    return out


def spawn_group(torch, n_chain, n_freq, backend, job):
    from hmcmt2d_tpu_torch.parallel.multichain import spawn_ranks

    t0 = time.perf_counter()
    try:
        outs = spawn_ranks(sharded_rank, n_chain * n_freq, args=(n_chain, n_freq, job),
                           backend=backend, timeout_s=RANK_WALL_S)
    except Exception as e:  # noqa: BLE001 - reported, then the phase fails
        fail(f"sharded ranks ({n_chain} x {n_freq}, {backend}, {job}) failed: "
             f"{type(e).__name__}: {e}")
    return outs, time.perf_counter() - t0


def flip_margin(torch, vg, opts, mass, m, m_ref, models, i, c):
    """|u - exp(min(dH, 0))| of chain c at sample i of phase 5, from the
    state it left sample i - 1 in: how close that accept was to flipping."""
    from hmcmt2d_tpu_torch.sampler import hmc as H

    m_prev = m if i == 0 else torch.as_tensor(models[i - 1], device=m.device)
    state = H.sample_chain_init(vg, m_prev, m_ref)
    _, _, _, alpha, _ = H.make_sample_step(vg, opts)(
        state, H.generator(SEED, H.STREAM_MAIN, i, m.device), m_ref, opts.dt, mass)
    gen = H.generator(SEED, H.STREAM_MAIN, i, m.device)
    torch.randint(opts.steps_lo, opts.steps_hi + 1, (), generator=gen, device=m.device)
    mass.draw(gen, m.shape)
    u = torch.rand(m.shape[0], generator=gen, dtype=torch.float64, device=m.device)
    return abs(float(u[c]) - float(alpha[c]))


def launch_check(name, rank, run):
    want = {"schur_factor": run["evals"], "bt_sweep_fwd": 14 * run["evals"],
            "bt_sweep_bwd": 14 * run["evals"]}
    if fused_only(run["launches"]) != want or not mt1d_ran(run["launches"], run["evals"]):
        fail(f"{name} rank {rank}: launches {run['launches']} != {want} for "
             f"{run['evals']} fused evals")


SAMPLE_KEYS = ("models", "stats", "accepts")


def run_summary_8(run) -> dict:
    """A rank's run in phase 8's lines: seconds and ms an eval (a graphed
    run's with its captures, and of its replayed second run), its captures
    and launches."""
    out = {"wall_s": run["wall_s"], "evals": run["evals"],
           "ms_per_eval": run["wall_s"] * 1e3 / run["evals"], "launches": run["launches"]}
    if run["graphed"]:
        out.update(ms_per_eval_replayed=run["replayed_wall_s"] * 1e3 / run["evals"],
                   capture_s=run["capture_s"], pool_bytes=run["pool_bytes"],
                   captures=[(c["kind"], c["capture_s"], c["pool_bytes"])
                             for c in run["captures"]])
    return out


def replay_check(name, outs) -> None:
    """Each graphed run's second pass, from its captured graphs, repeated
    the first bit for bit with the same launches."""
    for o in outs:
        for run_name, run in o["runs"].items():
            if run["graphed"] and not (run["replayed_same"]
                                       and run["replayed_launches"] == run["launches"]):
                fail(f"{name} rank {o['rank']} {run_name}: the replayed run differs "
                     f"(launches {run['replayed_launches']} against {run['launches']})")


def graphed_against_eager(name, rank, graphed, eager, eager_again) -> dict:
    """A rank's graphed run against its two eager runs of the same samples:
    the same accepts, models and stats bit for bit where the two eager runs
    agree bit for bit, else within their spread; the same launch counts."""
    cmp = {}
    for k in SAMPLE_KEYS:
        spread = float(np.abs(eager[k].astype(float) - eager_again[k].astype(float)).max())
        err = float(np.abs(graphed[k].astype(float) - eager[k].astype(float)).max())
        cmp[k] = {"graphed_vs_eager": err, "eager_spread": spread}
        if err > spread or (k == "accepts" and err):
            fail(f"{name} rank {rank}: graphed {k} {err:.3e} from eager (eager spread "
                 f"{spread:.3e})")
    if graphed["launches"] != eager["launches"]:
        fail(f"{name} rank {rank}: graphed launches {graphed['launches']} != eager "
             f"{eager['launches']}")
    return cmp


def check_released(name, outs) -> None:
    """Every rank's release() after a graphed run reported every rank's
    graphs: the fresh eval's, and an amortised run's factor and stale eval
    graphs too."""
    for o in outs:
        for run_name, run in o["runs"].items():
            if not run["graphed"]:
                continue
            kinds = ("eval", "factor", "stale") if "amortised" in run_name else ("eval",)
            want = [(r, k) for r in range(len(outs)) for k in kinds]
            if [tuple(c) for c in run["released"]] != want:
                fail(f"{name} rank {o['rank']} {run_name}: released {run['released']}, "
                     f"not {want}")


def tiny_serial_run(torch, vg_t, opts_t, mt, wopts, seed) -> dict:
    """Phase 8c's protocol in one process under ``vg_t``: the 4-iteration
    median-pooled warmup and 2 samples at the adapted dt from ``seed``."""
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import hmc as H

    t0 = time.perf_counter()
    _wres, state, wmass, info = A.warmup(vg_t, opts_t, mt, mt, 4, seed, wopts)
    ref = H.run_hmc(vg_t, dataclasses.replace(opts_t, dt=float(info.dt)),
                    wmass, state.m, mt, 2, seed, init_state=state)
    torch.cuda.synchronize()
    return {"dt": float(info.dt), "accepts": ref.accepts.cpu().numpy(),
            "models": ref.models.cpu().numpy(), "seconds": time.perf_counter() - t0}


def drift_spread(torch, vg_t, opts_t, mt, wopts) -> dict:
    """The plain single process's 8c runs at seeds 0-3: how far each other
    seed's adapted dt and models lie from seed 0's (relative), the
    yardstick of the (2 x 2) drift."""
    runs = [tiny_serial_run(torch, vg_t, opts_t, mt, wopts, seed) for seed in DRIFT_SEEDS]
    dts = [r["dt"] for r in runs]
    m0 = runs[0]["models"]
    return {"seeds": list(DRIFT_SEEDS), "dt": dts,
            "dt_rel_to_seed0": [abs(d - dts[0]) / dts[0] for d in dts[1:]],
            "dt_spread_rel": (max(dts) - min(dts)) / float(np.median(dts)),
            "model_rel_to_seed0": [float(np.abs(r["models"] - m0).max() / np.abs(m0).max())
                                   for r in runs[1:]]}


def check_sharded(torch, problem, m0, vg, opts, mass, m, m_ref, res5, res5_g, hmc5_s, smi):
    """Phase 8: 8a to 8d (see the module docstring); returns the per-rank
    launch counts of 8a, 8b and 8c's graphed runs."""
    problem_flagship, m0_flagship = problem, m0
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

    want = {k: getattr(res5, k).cpu().numpy() for k in SAMPLE_KEYS}
    want_g = {k: getattr(res5_g, k).cpu().numpy() for k in SAMPLE_KEYS}
    n_s = want["models"].shape[0]

    # 8a: one NCCL rank, graphed and eager, each bit for bit with phase 5's
    (a,), wall_a = spawn_group(torch, 1, 1, "nccl", "8a")
    ga, ea = a["runs"]["graphed"], a["runs"]["eager"]
    same = {"graphed": {k: bool(np.array_equal(ga[k], want_g[k])) for k in SAMPLE_KEYS},
            "eager": {k: bool(np.array_equal(ea[k], want[k])) for k in SAMPLE_KEYS}}
    say({"phase": "8a", "mesh": [1, 1], "backend": a["backend"], "device": a["device"],
         "card": smi, "bit_exact_with_phase5": same,
         "runs": {k: run_summary_8(r) for k, r in a["runs"].items()},
         "eager_over_graphed_replayed": ea["wall_s"] / ga["replayed_wall_s"],
         "eager_over_graphed_with_capture": ea["wall_s"] / ga["wall_s"],
         "released": ga["released"], "group_wall_s": wall_a})
    if not all(v for d in same.values() for v in d.values()):
        fail(f"8a: the (1 x 1) NCCL runs differ from phase 5's: {same}")
    for run in a["runs"].values():
        launch_check("8a", a["rank"], run)
    check_released("8a", [a])
    replay_check("8a", [a])

    # 8b: two gloo ranks on the card, B = 88 each, graphed and eager,
    # unamortised and amortised
    outs_b, wall_b = spawn_group(torch, 2, 1, "gloo", "8b")
    runs0 = outs_b[0]["runs"]
    for o in outs_b[1:]:
        for name, run in o["runs"].items():
            for k in SAMPLE_KEYS:
                if not np.array_equal(run[k], runs0[name][k]):
                    fail(f"8b: rank {o['rank']}'s {name} {k} differ from rank 0's")
    cmp_b = {}
    for o in outs_b:
        r = o["runs"]
        for pre in ("", "amortised_"):
            cmp_b[f"rank{o['rank']}.{pre or 'unamortised_'}graphed_vs_eager"] = (
                graphed_against_eager("8b", o["rank"], r[pre + "graphed"], r[pre + "eager"],
                                      r[pre + "eager_again"]))
        for name in ("graphed", "eager", "eager_again"):
            launch_check("8b " + name, o["rank"], r[name])
    check_released("8b", outs_b)
    replay_check("8b", outs_b)
    b = runs0["eager"]
    flips = np.argwhere(b["accepts"] != want["accepts"])
    margins = [flip_margin(torch, vg, opts, mass, m, m_ref, want["models"], int(i), int(c))
               for i, c in flips]
    keep = np.setdiff1d(np.arange(C), flips[:, 1]) if len(flips) else np.arange(C)
    rel = float(np.abs(b["models"][:, keep] - want["models"][:, keep]).max()
                / np.abs(want["models"][:, keep]).max())

    def per_eval(name, wall="wall_s"):
        """The two ranks' ms an eval: the slower rank's seconds over its evals."""
        return max(o["runs"][name][wall] for o in outs_b) * 1e3 / runs0[name]["evals"]

    graphed_runs = [name for name in runs0 if runs0[name]["graphed"]]

    say({"phase": "8b", "mesh": [2, 1], "card": smi,
         "devices": [o["device"] for o in outs_b], "backend": outs_b[0]["backend"],
         "systems_per_rank": C // 2 * problem.fwd.data.n_freq * 2,
         "eager_against_phase5": {"flipped_accepts": flips.tolist(), "flip_margins": margins,
                                  "model_max_rel_err": rel,
                                  "model_rel_tol": MODEL_REL_TOL_8B},
         "graphed_against_eager": cmp_b,
         "runs": {f"rank{o['rank']}": {k: run_summary_8(r) for k, r in o["runs"].items()}
                  for o in outs_b},
         "ms_per_eval_two_ranks": {name: per_eval(name) for name in runs0},
         "ms_per_eval_two_ranks_replayed": {name: per_eval(name, "replayed_wall_s")
                                            for name in graphed_runs},
         "eager_over_graphed_replayed": per_eval("eager")
         / per_eval("graphed", "replayed_wall_s"),
         "amortised_eager_over_graphed_replayed": per_eval("amortised_eager")
         / per_eval("amortised_graphed", "replayed_wall_s"),
         "samples_per_s_per_chip_two_ranks": {
             name: C * n_s / max(o["runs"][name]["wall_s"] for o in outs_b)
             for name in runs0},
         "samples_per_s_per_chip_phase5": C * n_s / hmc5_s,
         "ms_per_eval_phase5_eager": hmc5_s * 1e3 / int(res5.lf_steps[:, 0].sum()),
         "group_wall_s": wall_b})
    if len(flips) > 1 or any(mg >= FLIP_MARGIN for mg in margins):
        fail(f"8b: accepts {flips.tolist()} differ from phase 5 (margins {margins})")
    if not rel <= MODEL_REL_TOL_8B:
        fail(f"8b: models differ from phase 5 by {rel:.3e} relative")

    # 8c: (2 chains x 2 freq), four gloo ranks, graphed, against one process
    # on the card: held exactly to the process that evaluates the potential
    # in the ranks' batches and summation order, and within looser limits
    # to the plain single-process run (one batch, autograd's own sum over
    # frequencies), since in float32 a warmup amplifies that rounding
    # (PERF.md, phase 8); two faulty serial runs are the controls that show
    # each set of limits catching a wrong sharded path; and the plain run's
    # spread over seeds beside that drift
    outs_c, wall_c = spawn_group(torch, 2, 2, "gloo", "tiny")
    problem, mt, opts_t, wopts = tiny_inputs(torch, m.device)
    c0 = outs_c[0]["runs"]["graphed"]
    cmp = {}
    plain = make_potential_vg(problem, 1.0, graphed=False)
    for name, vg_t in (("serial_mesh", serial_mesh_vg(torch, problem, 2, 2)),
                       ("plain", plain),
                       ("control_prior_scale",
                        serial_mesh_vg(torch, problem, 2, 2, "prior_scale")),
                       ("control_freq_block",
                        serial_mesh_vg(torch, problem, 2, 2, "freq_block"))):
        ref = tiny_serial_run(torch, vg_t, opts_t, mt, wopts, SEED)
        cmp[name] = {"dt": ref["dt"], "dt_rel_err": abs(c0["dt"] - ref["dt"]) / ref["dt"],
                     "accepts_equal": bool(np.array_equal(c0["accepts"], ref["accepts"])),
                     "model_max_rel_err": float(np.abs(c0["models"] - ref["models"]).max()
                                                / np.abs(ref["models"]).max()),
                     "seconds": ref["seconds"]}
    spread = drift_spread(torch, plain, opts_t, mt, wopts)
    say({"phase": "8c", "mesh": [2, 2], "backend": outs_c[0]["backend"],
         "devices": [o["device"] for o in outs_c], "chains": TINY_C, "dt": c0["dt"],
         "against_single_process": cmp, "dt_rel_tol": DT_REL_TOL_8C,
         "model_rel_tol": MODEL_REL_TOL_8C, "plain_dt_rel_tol": DT_REL_TOL_8C_PLAIN,
         "plain_model_rel_tol": MODEL_REL_TOL_8C_PLAIN,
         "drift_from_plain": {"dt_rel": cmp["plain"]["dt_rel_err"],
                              "model_rel": cmp["plain"]["model_max_rel_err"]},
         "plain_over_seeds": spread,
         "drift_inside_seed_spread": bool(
             cmp["plain"]["dt_rel_err"] <= spread["dt_spread_rel"]
             and cmp["plain"]["model_max_rel_err"] <= max(spread["model_rel_to_seed0"])),
         "runs": [run_summary_8(o["runs"]["graphed"]) for o in outs_c],
         "group_wall_s": wall_c})

    def within(name, dt_tol, model_tol):
        c = cmp[name]
        return (c["dt_rel_err"] <= dt_tol and c["accepts_equal"]
                and c["model_max_rel_err"] <= model_tol)

    for o in outs_c:
        run = o["runs"]["graphed"]
        if not run["graphed"]:
            fail(f"8c: rank {o['rank']} ran eagerly")
        if run["dt"] != c0["dt"] or not np.array_equal(run["models"], c0["models"]):
            fail(f"8c: rank {o['rank']} disagrees with rank 0")
        launch_check("8c", o["rank"], run)
    check_released("8c", outs_c)
    replay_check("8c", outs_c)
    if not within("serial_mesh", DT_REL_TOL_8C, MODEL_REL_TOL_8C):
        fail(f"8c: against the ranks' summation order {cmp['serial_mesh']}")
    if not within("plain", DT_REL_TOL_8C_PLAIN, MODEL_REL_TOL_8C_PLAIN):
        fail(f"8c: against the plain single process {cmp['plain']}")
    for name, dt_tol, model_tol in (
            ("control_prior_scale", DT_REL_TOL_8C, MODEL_REL_TOL_8C),
            ("control_freq_block", DT_REL_TOL_8C_PLAIN, MODEL_REL_TOL_8C_PLAIN)):
        if within(name, dt_tol, model_tol):
            fail(f"8c: limits ({dt_tol}, {model_tol}) do not catch the {name} fault: "
                 f"{cmp[name]}")
    check_sharded_cli(problem_flagship, m0_flagship, smi)
    return {"8a": [a["runs"]["graphed"]["launches"]],
            "8b": [o["runs"]["graphed"]["launches"] for o in outs_b],
            "8c": [o["runs"]["graphed"]["launches"] for o in outs_c]}


SHARDED_RELEASE = (r"released the warmup engine's (\w+) graph on rank (\d+) \(C=(\d+)\): "
                   r"pool (\d+) bytes, captured in ([\d.]+) s")


def check_sharded_cli(problem, m0, smi):
    """8d: ``hmcmt2d-torch run`` in two gloo processes sharing the card,
    joined with --coordinator, on phase 7's files cut to burn-in 4,
    ``masswarmup: 2`` and 4 main samples: rank 0 alone prints and writes
    every output file and the checkpoint, and logs each rank's warmup
    graphs (fresh eval, factor, stale eval on bcr) released at the
    switch."""
    import re
    import tempfile

    from hmcmt2d_tpu_torch.parallel.multichain import free_port

    startup = (STARTUP.replace("burninsamples: 8", "burninsamples: 4")
               .replace("totalsamples:  16", "totalsamples:  10")
               .replace("masswarmup:    4", "masswarmup:    2"))
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_run_files(problem, m0, d, startup)
        ck, port = d / "run.ckpt.npz", free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hmcmt2d_tpu_torch.cli", "run", str(d / "startup"),
             "--outdir", str(d), "--checkpoint", str(ck), "--checkpoint-every", "2",
             "--backend", "gloo", "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(r)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=RANK_WALL_S) for p in procs]
        except subprocess.TimeoutExpired:
            fail(f"8d: the two ranks ran past {RANK_WALL_S} s")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"8d: rank {r} returned {p.returncode}:\n{err[-4000:]}")
        missing = [n for n in output_names(8) if not (d / n).exists()]
        with np.load(ck) as z:
            kind, rows, n_warm = str(z["path"]), z["models"].shape[0], int(z["n_warm"])
            finite = bool(np.isfinite(z["stats"]).all())
            acc = float(z["accepts"][n_warm:].mean())
    log0, log1 = outs[0][0], outs[1][0]
    secs = phase_seconds(log0)
    released = [(int(r), kind, int(c), int(pool), float(cap))
                for kind, r, c, pool, cap in re.findall(SHARDED_RELEASE, log0)]
    say({"phase": "8d", "cli_run": "hmcmt2d-torch run, 2 gloo ranks on one card",
         "card": smi, "wall_s": wall, "phase_s": secs, "checkpoint_path": kind,
         "rows": int(rows), "n_warm": n_warm, "main_accept_rate": acc,
         "main_samples_per_s_per_chip": 8 * 4 / secs["main"] if secs["main"] else None,
         "warmup_graphs_released": [dict(zip(("rank", "kind", "chains", "pool_bytes",
                                              "capture_s"), r)) for r in released],
         "rank1_printed": [ln for ln in log1.splitlines() if "[hmcmt2d]" in ln]})
    want = [(r, k) for r in range(2) for k in ("eval", "factor", "stale")]
    if (sorted((r, k) for r, k, *_ in released) != want
            or any(c != 4 for _, _, c, _, _ in released)):
        fail(f"8d: released warmup graphs {released}, not each rank's (C=4) {want}")
    if missing:
        fail(f"8d: missing output files {missing}")
    if "device mesh: chains=2 x freq=1" not in log0 or "[hmcmt2d]" in log1:
        fail("8d: the run was not sharded over the two ranks, or rank 1 printed")
    if kind != "sharded" or rows != 10 or n_warm != 6 or not finite:
        fail(f"8d: checkpoint {kind} with {rows} rows, n_warm {n_warm}, finite {finite}")


# phase 9
SINGLE_MODE_SURVEYS = ((("ZXY", "TZY"), "Impedance_Tipper"), (("RhoYX", "PhsYX"), "Rho_Phs"))
SINGLE_MODE_LAUNCHES = EVAL_PER_REPLAY   # the same mesh, so the same launches


def check_single_mode(torch, m, m_ref, eval_ms_phase4, smi):
    """9a: each one-mode flagship survey (full width, realistic observations,
    tipper errors 0.03 absolute; phase 4's models: C = 8, B = 88 systems),
    one potential value-and-grad on the kernels, launches counted, held to
    complex128 thomas on the card.  Returns {survey: launch counts}."""
    from hmcmt2d_tpu_torch.bench import realistic
    from hmcmt2d_tpu_torch.entry import flagship_problem
    from hmcmt2d_tpu_torch.models.forward import SolveConfig, make_forward
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

    out = {}
    for comps, dtype in SINGLE_MODE_SURVEYS:
        name = "+".join(comps)
        problem, m0 = flagship_problem(device=m.device, data_comp=comps, data_type=dtype)
        problem = realistic(problem, m0)
        if "TZY" in comps:
            # the start model is 1-D, so its tipper is rounding noise: the
            # tipper (dimensionless) takes an absolute error of 0.03, the
            # usual floor, not 3% of its own noise
            tip = problem.fwd.data.dt_id == comps.index("TZY")
            w = np.where(tip, 1.0 / 0.03, problem.weights)
            problem = dataclasses.replace(problem, weights=w)
        vg = make_potential_vg(problem, 1.0)
        torch.cuda.synchronize()
        FF.reset_launches()
        t0 = time.perf_counter()
        (U, _), g = vg(m, m_ref)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = FF.launches()
        eval_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            vg(m, m_ref)
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        prof = profile_eval(torch, vg, m, m_ref)
        ref = dataclasses.replace(problem, fwd=make_forward(
            problem.mesh, problem.fwd.data, SolveConfig(torch.complex128, 0, "thomas")))
        (U_ref, _), g_ref = make_potential_vg(ref, 1.0, graphed=False)(m.double(),
                                                                       m_ref.double())
        u_rel = float(((U - U_ref).abs() / U_ref.abs()).max())
        g64 = g.double()
        cos = float(((g64 * g_ref).sum(-1) / (g64.norm(dim=-1) * g_ref.norm(dim=-1))).min())
        finite = bool(torch.isfinite(U).all() and torch.isfinite(g).all())
        say({"phase": "9a", "survey": name, "data_type": dtype, "card": smi,
             "chains": m.shape[0], "systems": m.shape[0] * problem.fwd.data.n_freq,
             "n_data": problem.fwd.data.n_data, "launches": counts,
             "U_max_rel_err": u_rel, "U_rel_tol": U_REL_TOL, "grad_min_cosine": cos,
             "first_eval_ms": first_ms, "eval_ms": eval_ms,
             "eval_ms_phase4_two_modes": eval_ms_phase4,
             "profile": {k: prof[k] for k in ("profiled_wall_ms", "device_ms",
                                              "device_busy_share", "device_kernels",
                                              "ours")}})
        if counts != SINGLE_MODE_LAUNCHES:
            fail(f"9a {name}: launches {counts} != {SINGLE_MODE_LAUNCHES}")
        if not finite or not u_rel <= U_REL_TOL or not cos >= GRAD_COS_MIN:
            fail(f"9a {name}: finite {finite}, U error {u_rel:.3e}, cosine {cos:.6f}")
        out[name] = counts
    return out


def tool_run(torch, module, argv):
    """``module.main(argv)`` in-process, launch counts set to 0 just before
    and read just after: (launches, wall seconds)."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    torch.cuda.synchronize()
    FF.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = module.main(argv)
    except Exception as e:  # noqa: BLE001 - reported, then the phase fails
        import traceback

        traceback.print_exc()
        fail(f"{module.__name__} raised {type(e).__name__}: {e}")
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"{module.__name__} returned {rc}")
    return FF.launches(), time.perf_counter() - t0


def check_summary(out: Path, n_chains: int) -> dict:
    names = ["meanModel.model", "stdModel.model", "summary.json"] + [
        f"hmcstatistics_id{i}.log" for i in range(1, n_chains + 1)]
    missing = [n for n in names if not (out / n).exists()]
    summary = json.loads((out / "summary.json").read_text()) if not missing else {}
    numbers = [v for v in summary.values() if isinstance(v, (int, float))
               and not isinstance(v, bool)]
    numbers += [x for v in summary.values() if isinstance(v, list) for x in v]
    if missing or not np.isfinite(numbers).all():
        fail(f"9b: summary in {out}: missing {missing} or non-finite values")
    return summary


def check_tools(torch, d: Path, smi, dev):
    """9b: the checkpoint tools on phase 7's run (files and checkpoint in
    ``d``), each run as a user runs it, on the card by default.  Returns the
    launch counts of refresh_extend."""
    from hmcmt2d_tpu_torch.device import to_numpy
    from hmcmt2d_tpu_torch.io import read_startup
    from hmcmt2d_tpu_torch.models.posterior import build_inverse_problem
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg
    from hmcmt2d_tpu_torch.tools import map_fit, refresh_extend, summarize_checkpoint

    startup, ck, ck2 = str(d / "startup"), str(d / "run.ckpt.npz"), str(d / "refresh.npz")
    _, secs1 = tool_run(torch, summarize_checkpoint, [ck, startup, str(d / "art1")])
    sum1 = check_summary(d / "art1", 8)
    readapt, samples = 4, 4
    launches, secs2 = tool_run(torch, refresh_extend, [
        startup, ck, ck2, "--readapt", str(readapt), "--samples", str(samples),
        "--seg", "2", "--stride", "1"])
    with np.load(ck2) as z:
        rows, n_warm = z["models"].shape[0], int(z["n_warm"])
        evals = int(z["lf_steps"][:, 0].sum())
        finite = bool(np.isfinite(z["stats"]).all() and np.isfinite(z["mass_inv"]).all())
        diagonal = bool(z["mass_diagonal"])
    want = {"schur_factor": evals, "bt_sweep_fwd": 14 * evals, "bt_sweep_bwd": 14 * evals}
    _, secs3 = tool_run(torch, summarize_checkpoint, [ck2, startup, str(d / "art2")])
    sum2 = check_summary(d / "art2", 8)

    report = d / "map_fit.json"
    _, secs4 = tool_run(torch, map_fit, [startup, "--iters", "8", "--seg", "4", "--regs",
                                         "1.0", "--chains", "2", "--out", str(report)])
    rep = json.loads(report.read_text())["regs"]["1.0"]
    cfg, mesh, sig, data, obs, err = read_startup(startup, device=dev)
    prob, m0 = build_inverse_problem(mesh, data, obs, err, to_numpy(sig).ravel(),
                                     sigma_fixed=cfg.sig_fix, device=dev)
    m_start = H.random_homogeneous_start(cfg.seed, m0, 2, prob.fwd.cfg.real_dtype, dev)
    (_, (mis0, _, _)), _ = make_potential_vg(prob, 1.0)(m_start, m_start)
    chi2_start = (mis0 / len(prob.obs)).cpu().tolist()
    chi2_end = rep["chi2_per_datum_per_chain"]
    b = int(np.argmin(chi2_end))
    say({"phase": "9b", "card": smi,
         "summarize": {"seconds": secs1, "rows": sum1["samples"],
                       "split_rhat_max": sum1["split_rhat_max"],
                       "posterior_mean_nrms": sum1.get("posterior_mean_nrms")},
         "refresh_extend": {"seconds": secs2, "rows": int(rows), "n_warm": n_warm,
                            "fused_evals": evals, "launches": launches,
                            "dense_mass": not diagonal, "finite": finite,
                            "adapted_dt": sum2["adapted_dt"],
                            "accept_rate": sum2["accept_rate"]},
         "summarize_refreshed": {"seconds": secs3, "rows": sum2["samples"]},
         "map_fit": {"seconds": secs4, "chi2_start": chi2_start, "chi2_end": chi2_end,
                     "chi2_best": rep["chi2_best"]}})
    if rows != readapt + samples or n_warm != readapt or not finite or diagonal:
        fail(f"9b: refreshed checkpoint {rows} rows, n_warm {n_warm}, finite {finite}, "
             f"diagonal mass {diagonal}")
    if fused_only(launches) != want or evals == 0 or not mt1d_ran(launches, evals):
        fail(f"9b: refresh_extend launches {launches} != {want} for {evals} fused evals")
    if not np.isfinite(chi2_end).all() or not chi2_end[b] < chi2_start[b]:
        fail(f"9b: map_fit chi2 {chi2_end} against the start's {chi2_start}")
    return launches


# phase 10: (method, inv_method) of ops/solver.py factorize
ENGINES_C64 = (("thomas", "lu"), ("bcr", "lu"), ("thomas", "gj"), ("bcr", "gj"),
               ("thomas_blocked", "lu"), ("thomas_blocked", "gj"))
ENGINES_C128 = (("bcr", "lu"), ("thomas_blocked", "lu"), ("bcr", "gj"))
EXACT_U_REL_TOL, EXACT_GRAD_REL_TOL = 1e-10, 1e-8   # complex128 engines vs thomas
# an unrefined complex64 solve of the flagship operator may be at most this
# many times as far from the complex128 solve as the complex64 thomas one:
# after 6 refinement steps every engine reads the same U, which would hide
# a bad factor
RAW_RATIO = 10.0
# the GN build (full_jacobian_chunked at the start model) under bcr may
# peak this much above the same build under thomas: a copy of the flagship
# bcr factor (~195 MB) per right-hand side would add ~25 GB
GN_MARGIN_BYTES = 1e9
# one solve of the GN build's 128 right-hand sides sharing a bcr factor may
# peak at the factor's bytes plus this many times the right-hand sides'
# (the level-by-level partial solutions and the column layout); a copy of
# the factor per right-hand side would add 128 times the factor
SOLVE_RHS_COPIES = 10
GN_ROWS = 128
NO_LAUNCHES = {"schur_factor": 0, "bt_sweep_fwd": 0, "bt_sweep_bwd": 0}


def device_profile(torch, vg, m, m_ref) -> dict:
    """Device time and kernel count of one gradient eval, the largest
    kernels first: a profile of CUDA activity only (``profile_eval``'s CPU
    events cost ~30 s to gather at ~14,000-24,000 kernels an eval)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vg(m, m_ref)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0]
    top = sorted(kernels, key=lambda k: -k[1])[:5]
    return {"device_ms": sum(ms for _, ms, _ in kernels),
            "device_kernels": sum(n for _, _, n in kernels),
            "top": [{"kernel": k[:80], "ms": ms, "count": n} for k, ms, n in top]}


def engine_problem(problem, cfg):
    from hmcmt2d_tpu_torch.models.forward import make_forward

    return dataclasses.replace(problem, fwd=make_forward(problem.mesh, problem.fwd.data, cfg))


def gj_per_factor(method: str, inv: str, nzi: int) -> int:
    """gj_inverse launches of one factor: one a line for the thomas chain
    (55 at the flagship), one a level for bcr (nzi pads to 2^m - 1 lines,
    m levels: 6), none under LU."""
    if inv != "gj":
        return 0
    return nzi.bit_length() if method == "bcr" else nzi


def check_engines(torch, problem, m, m_ref, U_ref, g_ref, smi):
    """10a: the engines of ops/solver.py (thomas, bcr, thomas_blocked, each
    inverting by LU or by the gj_inverse kernel) on the flagship (phase 4's
    models, B = 176): an unrefined complex64 factor-solve of the interior
    system against the complex128 thomas solve, each within RAW_RATIO of
    thomas+lu's; complex64 refined 6 times against phase 4's complex128
    thomas potential and gradient within phase 4's limits, with factor,
    solve and eval times, a profile, the peak device memory, no fused
    launch and gj_per_factor gj_inverse launches a factor and an eval;
    complex128 bcr, thomas_blocked and bcr+gj against complex128 thomas
    within 1e-10 / 1e-8.  Returns the gj_inverse launches of one factor
    and of one eval, by engine."""
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import solver as S
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("10a: TF32 is on for matmuls; the engines' complex64 products need full fp32")
    rows, bad, vgs = [], [], []
    rng = np.random.default_rng(5)
    sys_ = interior_at(problem, m)              # complex64, (nfreq, C, 2, nzi, q)
    shape = tuple(sys_.diag.shape)
    b = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                        dtype=torch.complex64, device=m.device)
    x_ref = S.factor_solve(S.factorize(S.InteriorSystem(
        sys_.diag.to(torch.complex128), sys_.offy.double(), sys_.offz.double())),
        b.to(torch.complex128))
    nzi = shape[-2]
    gj_launches = {}
    for method, inv in ENGINES_C64:
        label = f"{method}+{inv}"
        t_engine = time.perf_counter()

        def factor(method=method, inv=inv):
            return S.factorize(sys_, dtype=torch.complex64, method=method, inv_method=inv)

        factor_ms = time_ms(torch, factor, 3)
        torch.cuda.synchronize()
        FF.reset_launches()
        fac = factor()
        torch.cuda.synchronize()
        per_factor = FF.launches()
        solve_ms = time_ms(torch, lambda fac=fac: S.factor_solve(fac, b), 5)
        _, raw = rel_err(torch, S.factor_solve(fac, b).to(torch.complex128), x_ref)
        del fac, factor
        prob = engine_problem(problem, SolveConfig(torch.complex64, 6, method, inv))
        vg = make_potential_vg(prob, 1.0, graphed=False)     # phase 10 measures eager
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FF.reset_launches()
        (U, _), g = vg(m, m_ref)
        torch.cuda.synchronize()
        counts, peak = FF.launches(), torch.cuda.max_memory_allocated()
        prof = device_profile(torch, vg, m, m_ref)
        u_rel = float(((U.double() - U_ref).abs() / U_ref.abs()).max())
        g64 = g.double()
        cos = float(((g64 * g_ref).sum(-1) / (g64.norm(dim=-1) * g_ref.norm(dim=-1))).min())
        finite = bool(torch.isfinite(U).all() and torch.isfinite(g).all())
        # one factor an eval: the eval launches what the factor did, and
        # the boundary fields' kernels
        want_gj = gj_per_factor(method, inv, nzi)
        want = dict(NO_LAUNCHES, **({"gj_inverse": want_gj} if want_gj else {}))
        gj_launches[label] = {"factor": per_factor.get("gj_inverse", 0),
                              "eval": counts.get("gj_inverse", 0)}
        rows.append({"phase": "10a", "engine": method, "inv": inv, "dtype": "complex64",
                     "refine": 6, "card": smi, "factor_ms": factor_ms, "solve_ms": solve_ms,
                     "unrefined_rel_err": raw, "eval_ms": [],
                     "device_ms": prof["device_ms"], "device_kernels": prof["device_kernels"],
                     "peak_gb": peak / 1e9, "launches_factor": per_factor,
                     "launches_eval": counts, "U_max_rel_err": u_rel, "grad_min_cosine": cos,
                     "finite": finite, "top": prof["top"],
                     "seconds": time.perf_counter() - t_engine})
        vgs.append(vg)
        if (per_factor != want or counts != {**want, **MT1D_PER_EVAL} or not finite
                or not u_rel <= U_REL_TOL or not cos >= GRAD_COS_MIN):
            bad.append(f"{label}: launches a factor {per_factor}, an eval {counts} "
                       f"(wanted {want} and the boundary fields'), finite {finite}, "
                       f"U {u_rel:.3e}, cosine {cos:.6f}")
        del prob, U, g
    del x_ref, b
    raw = {f"{row['engine']}+{row['inv']}": row["unrefined_rel_err"] for row in rows}
    for label, err in raw.items():
        if not err <= RAW_RATIO * raw["thomas+lu"]:
            bad.append(f"unrefined complex64 {label} solve {err:.3e} > {RAW_RATIO:g} x "
                       f"thomas+lu's {raw['thomas+lu']:.3e}")
    # the eval's wall time varies with the host by +-30%: time the engines
    # in turns, three rounds
    for _ in range(3):
        for row, vg in zip(rows, vgs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vg(m, m_ref)
            torch.cuda.synchronize()
            row["eval_ms"].append((time.perf_counter() - t0) * 1e3)
    del vgs
    for row in rows:
        row["eval_ms_median"] = float(np.median(row["eval_ms"]))
        row["device_busy_share"] = row["device_ms"] / row["eval_ms_median"]
        say(row)
    for method, inv in ENGINES_C128:
        prob = engine_problem(problem, SolveConfig(torch.complex128, 0, method, inv))
        torch.cuda.synchronize()
        FF.reset_launches()
        t0 = time.perf_counter()
        (U, _), g = make_potential_vg(prob, 1.0, graphed=False)(m.double(), m_ref.double())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = FF.launches()
        u_rel = float(((U - U_ref).abs() / U_ref.abs()).max())
        g_rel = float(((g - g_ref).norm(dim=-1) / g_ref.norm(dim=-1)).max())
        say({"phase": "10a", "engine": method, "inv": inv, "dtype": "complex128",
             "refine": 0, "card": smi, "eval_ms": wall_ms, "launches_eval": counts,
             "U_max_rel_err": u_rel, "grad_max_rel_norm_err": g_rel})
        if (not u_rel <= EXACT_U_REL_TOL or not g_rel <= EXACT_GRAD_REL_TOL
                or counts.get("gj_inverse", 0) != gj_per_factor(method, inv, nzi)):
            bad.append(f"complex128 {method}+{inv}: U {u_rel:.3e}, grad {g_rel:.3e}, "
                       f"launches {counts}")
        del prob, U, g
    if bad:
        fail("10a: " + "; ".join(bad))
    return gj_launches


def output_finite(d: Path, names) -> list[str]:
    """The files among ``names`` in ``d`` that hold a nan or an inf."""
    import re

    pat = re.compile(r"(?i)(?<![a-z])(nan|inf)")
    return [n for n in names if pat.search((d / n).read_text())]


def gn_peak_bytes(torch, problem, m, method, graphed=None) -> int:
    """The peak device memory of ``full_jacobian_chunked`` at model m (P,)
    under ``method`` (complex64, refine 3: the hybrid run's warmup engine),
    from its graph (the default) or eager, over what was allocated when it
    started: the GN mass's Jacobian, one forward pass of 128 rows, each
    backward pass 128 right-hand sides sharing one factor."""
    from hmcmt2d_tpu_torch.models import jacobian as JJ
    from hmcmt2d_tpu_torch.models.forward import SolveConfig

    prob = engine_problem(problem, SolveConfig(torch.complex64, 3, method))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    JJ.full_jacobian_chunked(prob, m, chunk=GN_ROWS, graphed=graphed)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def gn_solve_bytes(torch, problem, m, method) -> dict:
    """One factor-solve as the GN build makes it: the complex64 factor of
    the interior system at model m (P,), batch 1 on the chain axis, and
    GN_ROWS right-hand sides on that axis.  The peak over what was
    allocated before the factor, the factor's bytes and the right-hand
    sides'."""
    from hmcmt2d_tpu_torch.ops import solver as S

    sys_ = interior_at(problem, m[None])           # (nfreq, 1, 2, nzi, q)
    shape = list(sys_.diag.shape)
    shape[1] = GN_ROWS
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                        dtype=torch.complex64, device=m.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fac = S.factorize(sys_, dtype=torch.complex64, method=method)
    x = S.factor_solve(fac, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    parts = fac.fac.levels if method == "bcr" else (fac.fac,)
    fac_bytes = sum(t.numel() * t.element_size() for part in parts for t in part
                    if t is not None)
    if tuple(x.shape) != tuple(b.shape) or not bool(torch.isfinite(x).all()):
        fail(f"10b: the {method} solve of {GN_ROWS} right-hand sides gave {tuple(x.shape)}")
    return {"peak_bytes": peak, "factor_bytes": fac_bytes,
            "rhs_bytes": b.numel() * b.element_size()}


def short_hybrid_run(torch, problem, m0, flags, run_flags) -> dict:
    """``hmcmt2d-torch [flags] run ... [run_flags]`` on phase 7's files cut to
    burn-in 4, ``masswarmup: 2`` and 4 samples, with the GN build
    (``full_jacobian_chunked``) wrapped to read the launch counts and the
    device memory around it.  Returns rc, the run's launches, its log, the
    GN build's readings, the fused evals after the switch, the output
    files missing or not finite, the checkpoint's finiteness and the main
    accept rate."""
    import tempfile

    from hmcmt2d_tpu_torch.models import jacobian as JJ
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    n_burn, n_mass, n_total = 4, 2, 10
    startup = (STARTUP.replace("burninsamples: 8", f"burninsamples: {n_burn}")
               .replace("totalsamples:  16", f"totalsamples:  {n_total}")
               .replace("masswarmup:    4", f"masswarmup:    {n_mass}"))
    gn = {}
    full_jacobian = JJ.full_jacobian_chunked

    def measured(*args, **kw):
        torch.cuda.synchronize()
        gn.update(launches_before=FF.launches(), base_bytes=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = full_jacobian(*args, **kw)
        torch.cuda.synchronize()
        gn.update(seconds=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(),
                  launches_after=FF.launches())
        return out

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_run_files(problem, m0, d, startup)
        ck = d / "run.ckpt.npz"
        JJ.full_jacobian_chunked = measured
        try:
            rc, launches, wall, log = cli_run(torch, [
                *flags, "run", str(d / "startup"), "--outdir", str(d), "--checkpoint",
                str(ck), "--checkpoint-every", "2", *run_flags])
        finally:
            JJ.full_jacobian_chunked = full_jacobian
        names = output_names(8)
        missing = [n for n in names if not (d / n).exists()]
        nonfinite = output_finite(d, [n for n in names if n not in missing])
        with np.load(ck) as z:
            lf = z["lf_steps"][:, 0].astype(int)
            finite = bool(np.isfinite(z["stats"]).all() and np.isfinite(z["models"]).all())
            acc = float(z["accepts"][n_burn + n_mass:].mean())
    return {"rc": rc, "launches": launches, "wall": wall, "log": log, "gn": gn,
            "evals": 1 + int(lf[n_burn:n_total].sum()), "lf": lf, "missing": missing,
            "nonfinite": nonfinite, "finite": finite, "acc": acc}


def run_summary(run: dict, phase7_s) -> dict:
    gn = run["gn"]
    return {"rc": run["rc"], "wall_s": run["wall"], "phase_s": phase_seconds(run["log"]),
            "phase7_phase_s": phase7_s, "fused_evals": run["evals"],
            "launches": run["launches"], "gn_build": gn,
            "gn_graphs_released": run["log"].count(GN_LOG_14),
            "gn_peak_over_start_gb": (gn["peak_bytes"] - gn["base_bytes"]) / 1e9
            if "peak_bytes" in gn else None,
            "main_accept_rate": run["acc"], "leapfrog_steps": run["lf"].tolist()}


def check_outputs(tag: str, run: dict) -> None:
    if run["missing"] or run["nonfinite"] or not run["finite"]:
        fail(f"{tag}: missing {run['missing']}, non-finite files {run['nonfinite']}, "
             f"checkpoint finite {run['finite']}")


def fused_only(counts: dict) -> dict:
    return {k: counts.get(k, 0) for k in NO_LAUNCHES}


def mt1d_ran(counts: dict, evals: int) -> bool:
    """Whether a run that made ``evals`` fused gradient evals among others
    (warmup, predictions, a GN build's one forward and a vjp a slab)
    launched the boundary fields' forward and vjp at least once an eval."""
    return min(counts.get("mt1d_field", 0), counts.get("mt1d_field_vjp", 0)) >= evals


def check_gn_and_thomas_hybrid(torch, problem, m0, smi, phase7_s):
    """10b: the GN build's memory under bcr and thomas, measured the same
    way at the start model: the whole build within GN_MARGIN_BYTES of
    thomas's, and one solve of its 128 right-hand sides sharing a bcr or a
    thomas_blocked factor within the factor plus SOLVE_RHS_COPIES
    right-hand sides.  Then ``hmcmt2d-torch run --warmup-solver thomas``
    (``short_hybrid_run``): warmup and the GN build on thomas (complex64,
    refine 3) launch no fused kernel, every fused eval after the switch
    launches (1, 14, 14), and every output file is finite."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    m0_t = torch.as_tensor(m0, dtype=torch.float32, device=problem.device)
    FF.reset_launches()
    gn_peak = {meth: gn_peak_bytes(torch, problem, m0_t, meth) for meth in ("thomas", "bcr")}
    gn_peak_eager = {meth: gn_peak_bytes(torch, problem, m0_t, meth, graphed=False)
                     for meth in ("thomas", "bcr")}
    solve = {meth: gn_solve_bytes(torch, problem, m0_t, meth)
             for meth in ("thomas", "bcr", "thomas_blocked")}
    gn_launches = FF.launches()
    limits = {k: solve[k]["factor_bytes"] + SOLVE_RHS_COPIES * solve[k]["rhs_bytes"]
              for k in ("bcr", "thomas_blocked")}
    say({"phase": "10b", "gn_build_at_start_model": True, "card": smi,
         "gn_peak_over_start_gb": {k: v / 1e9 for k, v in gn_peak.items()},
         "gn_peak_over_start_gb_eager": {k: v / 1e9 for k, v in gn_peak_eager.items()},
         "gn_margin_gb": GN_MARGIN_BYTES / 1e9,
         "solve_128_rhs": {k: {kk: vv / 1e9 for kk, vv in v.items()} for k, v in solve.items()},
         "solve_limit_gb": {k: v / 1e9 for k, v in limits.items()}, "launches": gn_launches})
    if fused_only(gn_launches) != NO_LAUNCHES:
        fail(f"10b: a GN build on thomas or bcr launched fused kernels: {gn_launches}")
    if not gn_peak["bcr"] <= gn_peak["thomas"] + GN_MARGIN_BYTES:
        fail(f"10b: the bcr GN build peaked {gn_peak['bcr'] / 1e9:.2f} GB over its start, "
             f"thomas's {gn_peak['thomas'] / 1e9:.2f} GB + {GN_MARGIN_BYTES / 1e9:g} allowed")
    for k, limit in limits.items():
        if not solve[k]["peak_bytes"] <= limit:
            fail(f"10b: one {k} solve of {GN_ROWS} right-hand sides peaked "
                 f"{solve[k]['peak_bytes'] / 1e9:.2f} GB > {limit / 1e9:.2f} GB")

    run = short_hybrid_run(torch, problem, m0, [], ["--warmup-solver", "thomas"])
    evals, gn = run["evals"], run["gn"]
    want = {"schur_factor": evals, "bt_sweep_fwd": 14 * evals, "bt_sweep_bwd": 14 * evals}
    switch = "hybrid: warmup engine thomas -> main engine fused" in run["log"]
    say({"phase": "10b", "cli_run": "hmcmt2d-torch run --warmup-solver thomas", "card": smi,
         "switch_logged": switch, **run_summary(run, phase7_s)})
    if run["rc"] != 0 or not switch:
        fail(f"10b: rc {run['rc']}, engine switch logged {switch}")
    check_outputs("10b", run)
    if "peak_bytes" not in gn or fused_only(gn["launches_after"]) != NO_LAUNCHES:
        fail(f"10b: the GN build did not run, or warmup and GN launched fused kernels: {gn}")
    if run["log"].count(GN_LOG_14) != 1:
        fail("10b: the run's GN build did not log its Jacobian graph released")
    if fused_only(run["launches"]) != want or not mt1d_ran(run["launches"], evals):
        fail(f"10b: launches {run['launches']} != {want} for {evals} fused evals")


GJ_CLI_FLAGS = ["--precision", "f32", "--refine", "6", "--solver", "fused", "--inv", "gj"]


def check_gj_cli(torch, problem, m0, smi, phase7_s) -> dict:
    """10c: ``hmcmt2d-torch --precision f32 --refine 6 --solver fused --inv
    gj run`` (``short_hybrid_run``): warmup (bcr+gj, the auto warmup engine
    with the run's inverse) and the GN build launch gj_inverse, a whole
    number of bcr factors' worth, and no fused kernel; after the switch
    each fused eval launches (1, 14, 14) and no gj_inverse.  Returns the
    run's launches."""
    nzi = problem.mesh.nz - 1                # interior z-lines of the solve
    per_factor = gj_per_factor("bcr", "gj", nzi)
    run = short_hybrid_run(torch, problem, m0, GJ_CLI_FLAGS, [])
    evals, gn = run["evals"], run["gn"]
    switch = "hybrid: warmup engine bcr -> main engine fused" in run["log"]
    say({"phase": "10c", "cli_run": "hmcmt2d-torch " + " ".join(GJ_CLI_FLAGS) + " run",
         "card": smi, "switch_logged": switch, "gj_inverse_per_bcr_factor": per_factor,
         **run_summary(run, phase7_s)})
    if run["rc"] != 0 or not switch or "inv=gj" not in run["log"]:
        fail(f"10c: rc {run['rc']}, engine switch logged {switch}, inv=gj logged "
             f"{'inv=gj' in run['log']}")
    check_outputs("10c", run)
    if "peak_bytes" not in gn or run["log"].count(GN_LOG_14) != 1:
        fail("10c: the GN build did not run, or did not log its Jacobian graph released")
    before, after = (gn[k].get("gj_inverse", 0) for k in ("launches_before", "launches_after"))
    fused = {"schur_factor": evals, "bt_sweep_fwd": 14 * evals, "bt_sweep_bwd": 14 * evals}
    if (fused_only(gn["launches_after"]) != NO_LAUNCHES or not 0 < before < after
            or before % per_factor or after % per_factor):
        fail(f"10c: warmup and GN launches {gn}: want gj_inverse in multiples of "
             f"{per_factor} in both, and no fused kernel")
    if fused_only(run["launches"]) != fused or run["launches"].get("gj_inverse", 0) != after:
        fail(f"10c: launches {run['launches']}: want {fused} and gj_inverse {after} (none "
             f"after the switch) for {evals} fused evals")
    return run["launches"]


# phase 13: the warmup engines served from their graphs (sampler/graphed.py)
ROUNDS_13 = 2           # rounds over both models, graphed and eager in turn
WARMUP_ENGINES_13 = (("bcr", "lu"), ("thomas", "lu"), ("bcr", "gj"))
N_WARM_13 = 8           # warmup iterations of 13b
# 13b's graphed warmup against its eager one: the same evals on the same
# inputs (13a holds them bit for bit or within the eager spread), so the
# same accepts, and dt and models equal but for that spread, which 8
# adapted iterations amplify little
MODEL_REL_TOL_13 = 1e-5
HOST_CALLS_MAX_13 = 9   # host launch calls of a graphed eval: single digits


def _timed(torch, fn, *args):
    """(fn(*args), host ms, the launch counts it moved), synchronised."""
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    torch.cuda.synchronize()
    before = FF.launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    delta = FF.launch_delta(before, FF.launches())
    return out, ms, {k: n for k, n in delta.items() if n}


def check_graphed_engines(torch, problem, m, m_ref, smi) -> dict:
    """13a: each of phase 10's six engine and inverse pairs (complex64,
    refine 6, stale refine 10) on phase 4's models and a second one (numpy
    seed 2, phase 12's), served from its graphs against its eager closure:
    per model the fresh eval, the factor at the other model and the stale
    eval against it, ROUNDS_13 rounds in turn after the graphs' captures;
    U, misfit, mnorm, pred and the gradient of both evals bit for bit where
    two eager rounds agree bit for bit, else within their spread; the
    medians of each call's ms; one profile each of the graphed and the
    eager fresh and stale eval (device ms; host launch calls of the graphed
    ones, single digits); capture seconds and pool bytes; gj_inverse
    launched per_factor times by a factor and a fresh eval, none by a stale
    eval, none under LU, and no fused kernel.  Returns the gj_inverse
    launches of a graphed factor replay, by engine."""
    from hmcmt2d_tpu_torch.models.forward import SolveConfig
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    rng = np.random.default_rng(2)
    m2 = m + 0.01 * torch.as_tensor(rng.standard_normal(tuple(m.shape)),
                                    dtype=m.dtype, device=m.device)
    models = (("phase4", m, m2), ("seed2", m2, m))    # (name, model, the factor's)
    nzi = problem.mesh.nz - 1
    gj_factor, bad = {}, []
    for method, inv in ENGINES_C64:
        label = f"{method}+{inv}"
        t_engine = time.perf_counter()
        prob = engine_problem(problem, SolveConfig(torch.complex64, 6, method, inv))
        vg = make_potential_vg(prob, 1.0)
        if not isinstance(vg, GraphedPotential):
            fail(f"13: make_potential_vg did not serve {label} on the card from graphs")
        kinds = {"graphed": (vg, vg.factor),
                 "eager": (make_potential_vg(prob, 1.0, graphed=False),
                           prob.factor_state)}
        # the three captures (fresh eval, factor, stale eval), before timing
        vg(m, m_ref)
        vg(m, m_ref, vg.factor(m2))
        per = gj_per_factor(method, inv, nzi)
        gj = {"gj_inverse": per} if per else {}
        want = {"eval": {**gj, **MT1D_PER_EVAL}, "factor": gj, "stale": MT1D_PER_EVAL}
        ms = {k: {c: [] for c in want} for k in kinds}
        outs = {k: {name: [] for name, _, _ in models} for k in kinds}
        for _ in range(ROUNDS_13):
            for name, mm, mf in models:
                for kind, (fn, factor) in kinds.items():
                    fresh, t_e, n_e = _timed(torch, fn, mm, m_ref)
                    fac, t_f, n_f = _timed(torch, factor, mf)
                    stale, t_s, n_s = _timed(torch, fn, mm, m_ref, fac)
                    del fac
                    for call, t, n in (("eval", t_e, n_e), ("factor", t_f, n_f),
                                       ("stale", t_s, n_s)):
                        ms[kind][call].append(t)
                        if n != want[call]:
                            bad.append(f"{label} {kind} {call}: launches {n} != {want[call]}")
                    outs[kind][name].append({"eval": _flat_outputs(fresh),
                                             "stale": _flat_outputs(stale)})
        compare = {}
        for name, _, _ in models:
            e0, e1 = outs["eager"][name][:2]
            for call in ("eval", "stale"):
                for k in OUTPUT_NAMES:
                    spread = _max_abs(e0[call][k], e1[call][k])
                    err = max(_max_abs(g[call][k], e0[call][k]) for g in outs["graphed"][name])
                    compare[f"{name}.{call}.{k}"] = {"graphed_vs_eager": err,
                                                     "eager_spread": spread}
                    if err > spread:
                        bad.append(f"{label} {name}.{call}.{k}: {err:.3e} against an "
                                   f"eager spread {spread:.3e}")
        del outs
        fac_g = vg.factor(m2)
        prof = {"graphed_eval": profile_eval(torch, vg, m, m_ref),
                "graphed_stale": profile_eval(torch, lambda a, b: vg(a, b, fac_g), m, m_ref)}
        del fac_g
        eager_vg, eager_factor = kinds["eager"]
        fac_e = eager_factor(m2)
        prof["eager_eval"] = device_profile(torch, eager_vg, m, m_ref)
        prof["eager_stale"] = device_profile(torch, lambda a, b: eager_vg(a, b, fac_e), m, m_ref)
        del fac_e
        medians = {k: {c: float(np.median(v)) for c, v in d.items()} for k, d in ms.items()}
        busy = {f"{k}_{c}": prof[f"{k}_{c}"]["device_ms"] / medians[k][c]
                for k in kinds for c in ("eval", "stale")}
        host = {c: prof[f"graphed_{c}"]["host_kernel_launch_calls"]
                + prof[f"graphed_{c}"]["host_graph_launch_calls"] for c in ("eval", "stale")}
        caps = vg.release()
        gj_factor[label] = per
        row = {"phase": "13a", "engine": method, "inv": inv, "dtype": "complex64",
               "refine": 6, "stale_refine": prob.fwd.cfg.stale_refine_iters, "card": smi,
               "chains": m.shape[0], "ms": ms, "ms_median": medians,
               "eager_over_graphed": {c: medians["eager"][c] / medians["graphed"][c]
                                      for c in want},
               "device_ms": {k: v["device_ms"] for k, v in prof.items()},
               "device_kernels": {k: v["device_kernels"] for k, v in prof.items()},
               "device_busy_share": busy, "graphed_host_launch_calls": host,
               "graph_launch_calls": {c: prof[f"graphed_{c}"]["host_graph_launch_calls"]
                                      for c in ("eval", "stale")},
               "captures": caps, "launches_per_call": want, "compare": compare,
               "seconds": time.perf_counter() - t_engine}
        say(row)
        if [c["kind"] for c in caps] != ["eval", "factor", "stale"]:
            bad.append(f"{label}: captures {[c['kind'] for c in caps]}")
        if (any(n > HOST_CALLS_MAX_13 for n in host.values())
                or not all(row["graph_launch_calls"].values())):
            bad.append(f"{label}: graphed host launch calls {host}, graph launches "
                       f"{row['graph_launch_calls']}")
        del vg, kinds, prob
    if bad:
        fail("13a: " + "; ".join(bad))
    return gj_factor


def cut_warmup(torch, prob, m_start, m_ref, graphed: bool) -> dict:
    """N_WARM_13 warmup iterations (dual-averaged dt, windowed diagonal
    mass) at the production leapfrog keys (``timestep: 6 10``,
    ``timeinterval: 0.03``), from seed SEED, through the sampler a run
    takes (``BatchedSampler``, asked to amortise: on the card every eval
    is fresh, graphed or eager); its graphs, if any, are
    released at the end.  Returns the iterations' records, dt and
    seconds."""
    from hmcmt2d_tpu_torch.sampler import adapt as A
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.driver import BatchedSampler, warmup_segments

    opts = H.HMCOptions(dt=0.03, steps_lo=6, steps_hi=10, log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(1.0)), reg_param=1.0)
    wopts = A.WarmupOptions()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = BatchedSampler(prob, 1.0, amortize=True, graphed=graphed)
    carry = eng.carry_init(opts, m_start, m_ref)
    carry = warmup_segments(eng, opts, m_ref, carry, SEED, 0,
                            A.window_schedule(N_WARM_13, wopts), wopts, 0,
                            on_segment=lambda done, n, c, o, secs: outs.append(o))
    _, info = A.warmup_finalize(carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    models, stats, accepts, _, lf = outs[0]
    return {"models": models, "accepts": accepts, "lf": lf[:, 0].cpu().tolist(),
            "dt": float(info.dt), "accept_mean": float(accepts.float().mean()),
            "misfit_end": float(stats[-1, :, 0].mean()), "seconds": seconds,
            "captures": eng.release()}


def check_graphed_warmups(torch, problem, m, m_ref, smi) -> None:
    """13b: a cut warmup (``cut_warmup``) graphed against eager on bcr+lu,
    thomas+lu and bcr+gj from phase 4's models: the same accepts, dt and
    models within MODEL_REL_TOL_13, and the seconds of each."""
    from hmcmt2d_tpu_torch.models.forward import SolveConfig

    bad = []
    for method, inv in WARMUP_ENGINES_13:
        prob = engine_problem(problem, SolveConfig(torch.complex64, 6, method, inv))
        g = cut_warmup(torch, prob, m, m_ref, graphed=True)
        e = cut_warmup(torch, prob, m, m_ref, graphed=False)
        same_acc = bool(torch.equal(g["accepts"], e["accepts"]))
        dt_rel = abs(g["dt"] - e["dt"]) / e["dt"]
        model_rel = float((g["models"] - e["models"]).abs().max() / e["models"].abs().max())
        say({"phase": "13b", "engine": method, "inv": inv, "card": smi,
             "warmup_iters": N_WARM_13, "timestep": [6, 10], "chains": m.shape[0],
             "leapfrog_steps": g["lf"], "graphed_s": g["seconds"], "eager_s": e["seconds"],
             "graphed_capture_s": sum(c["capture_s"] for c in g["captures"]),
             "eager_over_graphed": e["seconds"] / g["seconds"],
             "dt": [g["dt"], e["dt"]], "dt_equal": g["dt"] == e["dt"], "dt_rel_err": dt_rel,
             "accepts_equal": same_acc, "accept_mean": [g["accept_mean"], e["accept_mean"]],
             "model_max_rel_err": model_rel, "model_rel_tol": MODEL_REL_TOL_13,
             "misfit_end": [g["misfit_end"], e["misfit_end"]], "captures": g["captures"]})
        if (not same_acc or g["lf"] != e["lf"] or not dt_rel <= MODEL_REL_TOL_13
                or not model_rel <= MODEL_REL_TOL_13):
            bad.append(f"{method}+{inv}: accepts equal {same_acc}, dt {dt_rel:.3e}, "
                       f"models {model_rel:.3e}")
        del prob, g, e
    if bad:
        fail("13b: graphed against eager: " + "; ".join(bad))


# phase 14: the GN build's Jacobian from its graph against the eager one;
# (method, inv_method, refine): the bench's (thomas + LU, refine 6 as its
# main engine), the hybrid run's defaults (bcr with LU or gj, refine 3 as
# the CLI's warmup engine) and fused (--warmup-solver same under --solver
# fused): the sweeps in the slab graph
GN_ENGINES_14 = (("thomas", "lu", 6), ("bcr", "lu", 3), ("bcr", "gj", 3), ("fused", "lu", 6))
# rounds over both models, graphed and eager in turn: the first builds the
# whole GN mass, the second J alone (the host half is the same either way)
HOST_ROUNDS_14 = (True, False)
# a released graph leaves no tensor allocated and no memory cached (the
# build empties the cache) beyond this share of its pool (2.2-2.6 GB on
# the flagship)
RELEASE_SLACK_14 = 0.1
GN_LOG_14 = "released the GN build's jacobian graph"


@contextlib.contextmanager
def recorded_gn_builds():
    """Yields the list of the Gauss-Newton Jacobians built inside the block
    (``full_jacobian_chunked``): for each build the summaries of its
    captures, none for an eager build."""
    from hmcmt2d_tpu_torch.models import jacobian as JJ

    builds, build = [], JJ.full_jacobian_chunked

    def recording(*args, captures=None, **kw):
        builds.append([])
        out = build(*args, captures=builds[-1], **kw)
        if captures is not None:
            captures.extend(builds[-1])
        return out

    JJ.full_jacobian_chunked = recording
    try:
        yield builds
    finally:
        JJ.full_jacobian_chunked = build


def gn_build(torch, problem, prob, m, graphed: bool, host: bool) -> dict:
    """One Gauss-Newton build under ``prob``'s engine at m (P,), measured:
    with ``host``, ``gauss_newton_mass(problem, m, 1.0, jac_problem=prob,
    graphed=)``, else its Jacobian alone.  The seconds of J
    (``full_jacobian_chunked``, up to J on the host) and of the host's
    J'W^2J and Cholesky, the launches, the captures, the CUDA-event ms of
    each slab (an eager ``SlabPullback`` call after the first, which makes
    the forward pass; a replay), what the build left (graph objects alive,
    tensors allocated, memory cached but free beyond what was cached before
    it), the GN mass's log and J."""
    import weakref

    from hmcmt2d_tpu_torch.models import jacobian as JJ
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.sampler import driver as D
    from hmcmt2d_tpu_torch.sampler import graphed as G

    out, events, graphs, lines, caps = {}, [], [], [], []
    build, call, replay, capture = (JJ.full_jacobian_chunked, JJ.SlabPullback.__call__,
                                    G.replay, G.capture)

    def timed_slab(fn):
        def run(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = fn(*args)
            ev[1].record()
            events.append(ev)
            return res
        return run

    def captured(*args, **kw):
        cap = capture(*args, **kw)
        graphs.append(weakref.ref(cap.graph))
        return cap

    def cached():
        return torch.cuda.memory_reserved() - torch.cuda.memory_allocated()

    def measured(*args, **kw):
        torch.cuda.synchronize()
        allocated, cached0 = torch.cuda.memory_allocated(), cached()
        t0 = time.perf_counter()
        J = build(*args, **kw)
        out.update(j_s=time.perf_counter() - t0, J=J)
        caps.extend(kw.get("captures") or [])
        torch.cuda.synchronize()
        # a live graph's pool would stay cached here: the build empties
        # the cache after freeing it
        out.update(allocated_left=torch.cuda.memory_allocated() - allocated,
                   cached_gain=cached() - cached0)
        return J

    JJ.full_jacobian_chunked, G.capture = measured, captured
    if graphed:
        G.replay = timed_slab(replay)
    else:
        JJ.SlabPullback.__call__ = timed_slab(call)
    try:
        torch.cuda.synchronize()
        FF.reset_launches()
        t0 = time.perf_counter()
        if host:
            D.gauss_newton_mass(problem, m, 1.0, jac_problem=prob, graphed=graphed,
                                log=lines.append)
        else:
            JJ.full_jacobian_chunked(prob, m, chunk=GN_ROWS, graphed=graphed, captures=[])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        JJ.full_jacobian_chunked, JJ.SlabPullback.__call__ = build, call
        G.replay, G.capture = replay, capture
    slab_ms = [a.elapsed_time(b) for a, b in events[0 if graphed else 1:]]
    return {"J": out["J"], "j_s": out["j_s"], "host_s": total - out["j_s"] if host else None,
            "launches": {k: n for k, n in FF.launches().items() if n},
            "slab_ms": float(np.median(slab_ms)), "log": lines, "captures": caps,
            "graphs_left": sum(g() is not None for g in graphs),
            "allocated_left": out["allocated_left"], "cached_gain": out["cached_gain"]}


def released_14(r: dict, host: bool) -> bool:
    """A graphed build freed its graph: no graph object alive, no tensor
    left allocated and no memory cached beyond RELEASE_SLACK_14 of its
    pool, and with the host half its line in the GN mass's log."""
    if r["graphs_left"] or len(r["captures"]) != 1:
        return False
    slack = RELEASE_SLACK_14 * r["captures"][0]["pool_bytes"]
    logged = len(r["log"]) == 1 and r["log"][0].startswith(GN_LOG_14)
    return (r["allocated_left"] <= slack and r["cached_gain"] <= slack
            and (logged or not host))


def check_graphed_gn(torch, problem, m0, smi) -> dict:
    """Phase 14: the Gauss-Newton build at the full flagship (1,804 rows of
    J, 15 slabs of 128) under each of GN_ENGINES_14, its J from the slab
    pullback's CUDA graph against the eager build, at the start model and
    a second one (numpy seed 2) in turn, in HOST_ROUNDS_14 (the whole
    ``gauss_newton_mass``, J and the host half) and then J alone: J bit
    for bit where two eager builds agree bit for bit, else within their
    spread; the same launches; each build's seconds of J and of the host
    half; capture seconds, pool bytes, ms of a replayed and of an eager
    slab; the graph released.  Returns the launches of one build on each
    engine."""
    from hmcmt2d_tpu_torch.models.forward import SolveConfig

    m0_t = torch.as_tensor(m0, dtype=torch.float32, device=problem.device)
    rng = np.random.default_rng(2)
    m2 = m0_t + 0.01 * torch.as_tensor(rng.standard_normal(m0_t.shape), dtype=m0_t.dtype,
                                       device=m0_t.device)
    models = (("start", m0_t), ("seed2", m2))
    launches, bad = {}, []
    for method, inv, refine in GN_ENGINES_14:
        label = f"{method}+{inv}"
        t_engine = time.perf_counter()
        prob = engine_problem(problem, SolveConfig(torch.complex64, refine, method, inv))
        runs = {k: {name: [] for name, _ in models} for k in ("graphed", "eager")}
        for host in HOST_ROUNDS_14:
            for name, mm in models:
                for kind in runs:
                    runs[kind][name].append(gn_build(torch, problem, prob, mm,
                                                     kind == "graphed", host))
        compare = {}
        for name, _ in models:
            e0, e1 = (r["J"] for r in runs["eager"][name][:2])
            spread = float(np.abs(e0 - e1).max())
            err = max(float(np.abs(r["J"] - e0).max()) for r in runs["graphed"][name])
            compare[name] = {"graphed_vs_eager": err, "eager_spread": spread,
                             "max_abs_J": float(np.abs(e0).max())}
            if err > spread:
                bad.append(f"{label} {name}: J {err:.3e} from eager, against an eager "
                           f"spread {spread:.3e}")
        every = [r for kind in runs.values() for rs in kind.values() for r in rs]
        want = runs["eager"]["start"][0]["launches"]
        if any(r["launches"] != want for r in every):
            bad.append(f"{label}: launches {[r['launches'] for r in every]}, not all {want}")
        released = [released_14(r, host) for rs in runs["graphed"].values()
                    for r, host in zip(rs, HOST_ROUNDS_14)]
        left = [{k: r[k] for k in ("log", "graphs_left", "allocated_left", "cached_gain")}
                for rs in runs["graphed"].values() for r in rs]
        if not all(released):
            bad.append(f"{label}: a graph was not released: {left}")
        if any(r["log"] for rs in runs["eager"].values() for r in rs):
            bad.append(f"{label}: an eager build logged a graph")
        launches[label] = want
        caps = [c for rs in runs["graphed"].values() for r in rs for c in r["captures"]]

        def col(kind, key):
            return {name: [r[key] for r in rs] for name, rs in runs[kind].items()}

        slab = {k: float(np.median([r["slab_ms"] for rs in runs[k].values() for r in rs]))
                for k in runs}
        say({"phase": 14, "engine": method, "inv": inv, "dtype": "complex64",
             "refine": refine, "card": smi, "rows_of_J": int(e0.shape[0]),
             "slabs": -(-int(e0.shape[0]) // GN_ROWS), "with_host_half": HOST_ROUNDS_14,
             "j_s": {k: col(k, "j_s") for k in runs},
             "host_s": {k: col(k, "host_s") for k in runs},
             "slab_ms_median": slab,
             "eager_over_graphed_slab": slab["eager"] / slab["graphed"],
             "capture_s": [c["capture_s"] for c in caps],
             "pool_bytes": [c["pool_bytes"] for c in caps],
             "replays": [c["replays"] for c in caps], "released": all(released),
             "left_after_graphed": left, "launches": want, "compare": compare,
             "seconds": time.perf_counter() - t_engine})
        del runs, every, prob
    if bad:
        fail("14: " + "; ".join(bad))
    return launches


# ``--warmup-engines [N]``: the hybrid run's warmup engines at the production
# warmup length, with the round-5 production keys
# (runs/dprism3d_r5/startupfile) in place of phase 7's cuts
PRODUCTION_KEYS = (("timeinterval:  0.01", "timeinterval:  0.03"),
                   ("timestep:      4 4", "timestep:      6 10"),
                   ("masswarmup:    4", "masswarmup:    0"))
WARMUP_DONE = (r"warmup (\d+) iters in [\d.]+s: adapted dt=([^,]+), accept~([^,]+), "
               r"misfit (\S+) -> (\S+)")


@contextlib.contextmanager
def eager_evals():
    """Inside the block ``make_potential_vg`` serves every problem eagerly,
    as ``graphed=False`` does: the eager run that ``--with-eager`` times
    beside the graphed one in the same call."""
    from hmcmt2d_tpu_torch.sampler import graphed as G

    unservable = G.unservable
    G.unservable = lambda problem: "eager on request (chip_smoke.py --with-eager)"
    try:
        yield
    finally:
        G.unservable = unservable


def compare_warmup_engines(torch, problem, m0, smi, n_burn: int,
                           with_eager: bool = False) -> None:
    """``hmcmt2d-torch run --warmup-solver thomas``, then ``bcr``, on the
    flagship from files: 8 chains, ``n_burn`` warmup iterations, the GN mass
    under the warmup engine, then 2 samples on the fused kernels, served
    from graphs (the default), and with ``with_eager`` each run again
    eagerly right after (``eager_evals``).  The runs take the same seed
    and so the same draws: the engines differ only in rounding, graphed and
    eager not at all.  Per run: the warmup's seconds and seconds an
    iteration, the adapted dt, the warmup's accept rate, the misfit from
    start to end, the misfit and dt every 25 iterations, the GN build's
    seconds and the graphs released at the switch."""
    import re
    import tempfile

    startup = (STARTUP.replace("burninsamples: 8", f"burninsamples: {n_burn}")
               .replace("totalsamples:  16", f"totalsamples:  {n_burn + 2}"))
    for old, new in PRODUCTION_KEYS:
        if old not in startup:
            fail(f"warmup engines: phase 7's startup has no {old!r}")
        startup = startup.replace(old, new)
    rows = {}
    for engine in ("thomas", "bcr"):
        for kind in ("graphed", "eager") if with_eager else ("graphed",):
            with tempfile.TemporaryDirectory() as d, (
                    eager_evals() if kind == "eager" else contextlib.nullcontext()):
                d = Path(d)
                write_run_files(problem, m0, d, startup)
                rc, launches, wall, log = cli_run(torch, [
                    "run", str(d / "startup"), "--outdir", str(d), "--progress-every", "25",
                    "--warmup-solver", engine])
            done = re.search(WARMUP_DONE, log)
            segs = [tuple(float(x) for x in mm) for mm in re.findall(
                r"\[hmcmt2d\] warmup \d+/\d+: misfit=(\S+) dt=(\S+) ", log)]
            secs = phase_seconds(log)
            released = re.findall(r"released the warmup engine's (\w+) graph \(C=\d+\): "
                                  r"pool (\d+) bytes, captured in ([\d.]+) s", log)
            gn_released = log.count(GN_LOG_14)
            if (rc != 0 or not done or f"hybrid: warmup engine {engine}" not in log
                    or len(released) != (3 if kind == "graphed" else 0)
                    or gn_released != (kind == "graphed")):
                fail(f"warmup engines: the {kind} {engine} run gave rc {rc}, warmup line "
                     f"{bool(done)}, released graphs {released}, GN graphs {gn_released}")
            n, dt, acc, mis0, mis1 = done.groups()
            rows[engine, kind] = {
                "phase": "warmup_engines", "warmup_solver": engine, "eval": kind,
                "card": smi, "warmup_iters": int(n), "warmup_s": secs["warmup"],
                "s_per_iter": secs["warmup"] / int(n), "adapted_dt": float(dt),
                "warmup_accept": float(acc), "misfit_start": float(mis0),
                "misfit_end": float(mis1), "gn_build_s": secs["dense_mass_build"],
                "phase_s": secs, "wall_s": wall, "launches": launches,
                "graphs_released": released, "gn_graphs_released": gn_released,
                "segments_misfit_dt": segs}
            say(rows[engine, kind])
    t, b = rows["thomas", "graphed"], rows["bcr", "graphed"]
    summary = {"phase": "warmup_engines", "card": smi,
               "bcr_over_thomas_graphed": {
                   "s_per_iter": b["s_per_iter"] / t["s_per_iter"],
                   "adapted_dt": b["adapted_dt"] / t["adapted_dt"],
                   "misfit_end": b["misfit_end"] / t["misfit_end"],
                   "gn_build_s": b["gn_build_s"] / t["gn_build_s"]},
               "warmup_accept_graphed": [t["warmup_accept"], b["warmup_accept"]]}
    if with_eager:
        summary["eager_over_graphed_warmup_s"] = {
            e: rows[e, "eager"]["warmup_s"] / rows[e, "graphed"]["warmup_s"]
            for e in ("thomas", "bcr")}
        summary["graphed_equals_eager"] = {
            e: all(rows[e, "eager"][k] == rows[e, "graphed"][k]
                   for k in ("adapted_dt", "warmup_accept", "misfit_end"))
            for e in ("thomas", "bcr")}
    say(summary)


# phase 11: the port's bench (hmcmt2d_tpu_torch.bench) at cut lengths.
# BENCH_KEYS: every key of bench.py's JSON line (its main and measure_ess)
# and the bench's own ``device``
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_note",
              "cpu_samples_per_sec_scipy_1t", "cpu_samples_per_sec_native_mt",
              "chains_sweep", "samples_per_sec", "ess_per_sec_per_chip",
              "ess_median", "ess_median_first200", "ess_window_samples",
              "kernel_mass", "solves_per_sec", "nfevals", "accept_rate",
              "kernel_dt", "kernel_adapted", "flops_per_sec_est", "device")
BENCH_POSITIVE = ("value", "ess_per_sec_per_chip", "solves_per_sec", "nfevals",
                  "vs_baseline")
BENCH_CUT = dict(n_samples=16, n_warm=8, gn_mass=True, n_readapt=8)
BENCH_SWEEP = ((12, 8), (16, 8))       # (chains, samples)


def window_launch_check(tag: str, w, init_eval: bool) -> dict:
    """The timed window ``w`` of ``bench._measure``: its batched evals (one
    a leapfrog step, the chains of an iteration sharing L, and with
    ``init_eval`` the start model's, a window without warmup) each launched
    (1, 14, 14) on lines along y and the boundary fields' forward and vjp
    once, and no other kernel.  Returns its summary."""
    evals = int(w.result.lf_steps[:, 0].sum()) + int(init_eval)
    want = {k: evals * n for k, n in EVAL_PER_REPLAY.items()}
    got = {k: n for k, n in w.launches.items() if n or k in want}
    if got != want or evals == 0:
        fail(f"bench {tag}: window launches {w.launches} != {want} for {evals} evals")
    if not w.graphed:
        fail(f"bench {tag}: the window's evals were not graphed")
    return {"batched_evals": evals, "eval": "graphed", "seconds": w.seconds,
            "ms_per_batched_eval": w.seconds * 1e3 / evals, "launches": got}


def check_bench(torch, smi, dev) -> dict:
    """Phase 11: the port's bench pipeline on the flagship at full width, cut
    in length: ``measure_ess`` at C = 8 (BENCH_CUT: warmup, the GN mass,
    the re-adaptation, a priming run and the timed window), the chain
    sweep (BENCH_SWEEP) and both CPU baselines, then the bench's line by
    its ``report``.  The counts are set to 0 before ``measure_ess`` and read
    after it; each timed window's own launches come from the bench.
    Returns the counts of the ``measure_ess`` run."""
    from hmcmt2d_tpu_torch import bench
    from hmcmt2d_tpu_torch.entry import flagship_problem
    from hmcmt2d_tpu_torch.ops import fused_factor as FF

    def factory():
        return flagship_problem(device=dev)

    windows = []
    measure = bench._measure

    def recorded(*args, **kw):
        windows.append(measure(*args, **kw))
        return windows[-1]

    bench._measure = recorded
    logged, bench_log = [], bench.log

    def log(msg):
        logged.append(msg)
        bench_log(msg)

    bench.log = log
    try:
        torch.cuda.synchronize()
        FF.reset_launches()
        t0 = time.perf_counter()
        with recorded_gn_builds() as gn_builds:
            stats = bench.measure_ess(factory, C, **BENCH_CUT)
        torch.cuda.synchronize()
        ess_s = time.perf_counter() - t0
        counts = FF.launches()
    finally:
        bench._measure, bench.log = measure, bench_log
    if len(windows) != 1:
        fail(f"bench: measure_ess timed {len(windows)} windows, not 1")
    if [[c["kind"] for c in b] for b in gn_builds] != [["jacobian"]]:
        fail(f"bench: the GN builds captured {gn_builds}, not one Jacobian graph")
    sweep = {str(C): stats["samples_per_sec"]}
    for c, n in BENCH_SWEEP:
        windows.append(bench._measure(factory, c, n))
        sweep[str(c)] = round(c * n / windows[-1].seconds, 4)
    problem, _ = factory()
    t0 = time.perf_counter()
    cpu_sps = bench.measure_cpu_baseline(problem, n_freq=problem.fwd.data.n_freq)
    cpu_native_sps = bench.measure_cpu_baseline_native(problem,
                                                       n_freq=problem.fwd.data.n_freq)
    cpu_s = time.perf_counter() - t0
    line = bench.report(stats, sweep, cpu_sps, cpu_native_sps,
                        bench.unit_of(problem, False), bench.device_name(dev))
    tags = [f"C={C}"] + [f"sweep C={c}" for c, _ in BENCH_SWEEP]
    summary = {"phase": 11, "card": smi, "cut": BENCH_CUT,
               "sweep": [list(cn) for cn in BENCH_SWEEP],
               "measure_ess_s": ess_s, "cpu_baselines_s": cpu_s,
               "gn_build_captures": gn_builds,
               "gn_log": [x for x in logged if "Gauss-Newton" in x or "GN build" in x],
               "measure_ess_launches": counts,
               "windows": {t: window_launch_check(t, w, i > 0)
                           for i, (t, w) in enumerate(zip(tags, windows))},
               "tf32": [torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32]}
    say(summary)
    say(line)
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing:
        fail(f"bench line lacks {missing}")
    for k in BENCH_POSITIVE:
        if not (np.isfinite(line[k]) and line[k] > 0):
            fail(f"bench {k} = {line[k]}, not finite and positive")
    if not 0.0 < line["accept_rate"] <= 1.0:
        fail(f"bench accept_rate {line['accept_rate']} outside (0, 1]")
    if line["kernel_adapted"] is not True or line["kernel_mass"] != "gauss-newton":
        fail(f"bench kernel {line['kernel_mass']}, adapted {line['kernel_adapted']}")
    if line["device"] != smi:
        fail(f"bench device {line['device']!r} is not the card's {smi!r}")
    lf = windows[0].result.lf_steps
    if line["nfevals"] != int(lf.sum()) + C or not bool((lf == lf[:, :1]).all()):
        fail(f"bench nfevals {line['nfevals']} against the window's leapfrog steps")
    if counts.get("gj_inverse", 0) or counts.get("schur_factor_polish", 0):
        fail(f"bench launched a kernel off its path: {counts}")
    if any(counts[k] <= n for k, n in windows[0].launches.items() if n):
        fail(f"bench: no launch outside the window in {counts}")
    if any(summary["tf32"]):
        fail("TF32 is on in the bench (matmul, cudnn)")
    return counts


def main() -> None:
    n_warmup, args = 0, sys.argv[1:]
    with_eager = "--with-eager" in args
    if with_eager:
        args.remove("--with-eager")
    if args or with_eager:
        if not args or args[0] != "--warmup-engines" or len(args) > 2:
            fail("usage: python3 chip_smoke.py [--warmup-engines [N] [--with-eager]]")
        n_warmup = int(args[1]) if len(args) == 2 else 300

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    smi = smi_line() if torch.cuda.is_available() else None
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA GPU")
    if not (ROOT / "hmcmt2d_tpu_torch" / "__init__.py").exists():
        fail(f"no hmcmt2d_tpu_torch package beside {Path(__file__).name}: "
             "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT))

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    flops_peak, bw_peak, peak_key = peaks(name)
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
        f"(matmul and cudnn); peaks for {peak_key}: fp32 and fp64 {flops_peak / 1e12:g} "
        f"TFLOP/s, {bw_peak / 1e12:g} TB/s")

    from hmcmt2d_tpu_torch.models.forward import SolveConfig, make_forward
    from hmcmt2d_tpu_torch.ops import fused_factor as FF
    from hmcmt2d_tpu_torch.ops import kernel_build
    from hmcmt2d_tpu_torch.sampler import hmc as H
    from hmcmt2d_tpu_torch.sampler.driver import make_potential_vg
    from hmcmt2d_tpu_torch.sampler.graphed import GraphedPotential

    # phase 2
    t0 = time.perf_counter()
    kernel_build.library()
    say(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernel_build.build_seconds and round(kernel_build.build_seconds, 1)} s)")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    problem, m0, m, m_ref = flagship_inputs(torch, dev)
    if problem.fwd.cfg.solver_method != "fused":
        fail(f"default config on the GPU is {problem.fwd.cfg}, not fused")
    say(f"[setup] flagship {problem.mesh.nz}x{problem.mesh.ny} cells, "
        f"{problem.fwd.data.n_data} data, {problem.n_param} parameters, C={C}; "
        f"{time.perf_counter() - t0:.1f} s")
    if n_warmup:
        compare_warmup_engines(torch, problem, m0, smi, n_warmup, with_eager)
        say(smi_line())
        say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                    "count": torch.cuda.device_count()}})
        return

    # phase 3
    kres = check_kernels(torch, problem, m, flops_peak, bw_peak)

    # phase 4: the main path (the graphed eval, captured in its first call),
    # counted
    vg = make_potential_vg(problem, 1.0)
    vg_eager = make_potential_vg(problem, 1.0, graphed=False)
    if not isinstance(vg, GraphedPotential):
        fail("make_potential_vg did not serve the fused engine on the card from a graph")
    torch.cuda.synchronize()
    FF.reset_launches()
    t0 = time.perf_counter()
    (U, (misfit, mnorm, pred)), g = vg(m, m_ref)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = FF.launches()
    say({"main_path_launches": counts})
    want = EVAL_PER_REPLAY
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    if not (torch.isfinite(U).all() and torch.isfinite(g).all()):
        fail("non-finite potential or gradient on the main path")
    if tuple(g.shape) != (C, problem.n_param) or tuple(pred.shape) != (C, problem.fwd.data.n_data):
        fail(f"unexpected shapes: grad {tuple(g.shape)}, pred {tuple(pred.shape)}")
    eval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vg(m, m_ref)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)

    ref = dataclasses.replace(problem, fwd=make_forward(
        problem.mesh, problem.fwd.data, SolveConfig(torch.complex128, 0, "thomas")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (U_ref, _), g_ref = make_potential_vg(ref, 1.0, graphed=False)(m.double(),
                                                                   m_ref.double())
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    u_rel = float(((U - U_ref).abs() / U_ref.abs()).max())
    g64 = g.double()
    cos = (g64 * g_ref).sum(-1) / (g64.norm(dim=-1) * g_ref.norm(dim=-1))
    g_rel = float(((g64 - g_ref).norm(dim=-1) / g_ref.norm(dim=-1)).max())
    say({"main_path": "potential_value_and_grad", "eval": "graphed", "chains": C,
         "systems": C * problem.fwd.data.n_freq * 2,
         "U": U.cpu().tolist(), "U_complex128": U_ref.cpu().tolist(),
         "U_max_rel_err": u_rel, "U_rel_tol": U_REL_TOL,
         "grad_min_cosine": float(cos.min()), "grad_cos_min": GRAD_COS_MIN,
         "grad_max_rel_norm_err": g_rel,
         "first_eval_ms": first_ms, "eval_ms": eval_ms,
         "grad_evals_per_s": 1e3 / float(np.median(eval_ms)),
         "solves_per_s": C * problem.fwd.data.n_freq * 2 * 1e3 / float(np.median(eval_ms)),
         "complex128_thomas_eval_ms": ref_ms})
    if not u_rel <= U_REL_TOL:
        fail(f"U relative error {u_rel:.3e} > {U_REL_TOL}")
    if not float(cos.min()) >= GRAD_COS_MIN:
        fail(f"gradient cosine {float(cos.min()):.6f} < {GRAD_COS_MIN}")
    del ref

    # phase 12: the graphed eval against the eager one, on phase 4's inputs
    graph_summary = check_graphed(torch, problem, vg, vg_eager, m, m_ref, smi)

    # phase 5: a few HMC iterations on the main path, eager and graphed (the
    # default), from the same state: phase 8a's references
    opts = hmc_options(H)
    mass = H.identity_mass(problem.n_param, torch.float32, dev)
    init = H.ChainState(m=m, grad=g, misfit=misfit, mnorm=mnorm, pred=pred)
    n_samples = 3
    runs5 = {}
    for kind, fn in (("eager", vg_eager), ("graphed", vg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = H.run_hmc(fn, opts, mass, m, m_ref, n_samples, SEED, init_state=init)
        torch.cuda.synchronize()
        runs5[kind] = (r, time.perf_counter() - t0)
    res, hmc_s = runs5["eager"]
    res_g, _ = runs5["graphed"]
    acc = float(res_g.accepts.float().mean())
    finite = all(bool(torch.isfinite(r.stats).all() and torch.isfinite(r.models).all())
                 for r, _ in runs5.values())
    same_accepts = bool(torch.equal(res_g.accepts, res.accepts))
    model_rel = float((res_g.models - res.models).abs().max() / res.models.abs().max())
    say({"hmc_samples": n_samples, "chains": C, "accept_rate": acc,
         "stats_finite": finite, "leapfrog_steps": res_g.lf_steps[:, 0].tolist(),
         "ms_per_sample": {k: s * 1e3 / n_samples for k, (_, s) in runs5.items()},
         "samples_per_s_per_chip": {k: C * n_samples / s for k, (_, s) in runs5.items()},
         "graphed_accepts_equal_eager": same_accepts,
         "graphed_model_max_rel_err": model_rel, "model_rel_tol": MODEL_REL_TOL_5,
         "misfit_last": res_g.stats[-1, :, 0].cpu().tolist()})
    if not finite:
        fail("non-finite HMC stats or models")
    if not 0.0 <= acc <= 1.0:
        fail(f"accept rate {acc} outside [0, 1]")
    if not same_accepts or not model_rel <= MODEL_REL_TOL_5:
        fail(f"5: the graphed run's accepts equal the eager run's: {same_accepts}, "
             f"models {model_rel:.3e} apart (limit {MODEL_REL_TOL_5})")

    import shutil
    import tempfile

    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_run_"))
    try:
        # phase 7: the inversion run through the command line
        run_launches, phase7_s = check_cli_run(torch, problem, m0, smi, run_dir)

        # phase 8: the sharded sampler in spawned ranks
        sharded_launches = check_sharded(torch, problem, m0, vg_eager, opts, mass, m,
                                         m_ref, res, res_g, hmc_s, smi)

        # phase 9: one-mode surveys, then the checkpoint tools on phase 7's run
        single_launches = check_single_mode(torch, m, m_ref, eval_ms, smi)
        tool_launches = check_tools(torch, run_dir, smi, dev)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    # phase 10: the engines, their GN builds, a run warmed up on thomas, and
    # a run under --inv gj
    gj_engine_launches = check_engines(torch, problem, m, m_ref, U_ref, g_ref, smi)
    del U_ref, g_ref
    check_gn_and_thomas_hybrid(torch, problem, m0, smi, phase7_s)
    gj_run_launches = check_gj_cli(torch, problem, m0, smi, phase7_s)

    # phase 13: the warmup engines served from their graphs, against eager
    t13 = time.perf_counter()
    gj_graphed_launches = check_graphed_engines(torch, problem, m, m_ref, smi)
    check_graphed_warmups(torch, problem, m, m_ref, smi)
    say(f"[phase 13] {time.perf_counter() - t13:.1f} s")

    # phase 14: the GN build's Jacobian from its slab graph, against eager;
    # its path's kernels: the fused engine's three, gj_inverse under bcr+gj
    t14 = time.perf_counter()
    gn_launches = check_graphed_gn(torch, problem, m0, smi)
    say(f"[phase 14] {time.perf_counter() - t14:.1f} s")
    gn_path = {k: gn_launches["fused+lu"].get(k, 0)
               for k in ("schur_factor", "bt_sweep_fwd", "bt_sweep_bwd")}
    gn_path["gj_inverse"] = gn_launches["bcr+gj"].get("gj_inverse", 0)
    if not all(gn_path.values()):
        fail(f"14: a kernel of the GN build's path was not launched: {gn_path}")

    # phase 11: the bench's pipeline at cut lengths
    bench_launches = check_bench(torch, smi, dev)

    # phase 6
    replaces = {
        "schur_factor": "hmcmt2d_tpu/ops/pallas_factor.py:137",
        "schur_factor_polish": "hmcmt2d_tpu/ops/pallas_factor.py:120",
        "bt_sweep_fwd": "hmcmt2d_tpu/ops/pallas_factor.py:357",
        "bt_sweep_bwd": "hmcmt2d_tpu/ops/pallas_factor.py:383",
        "gj_inverse": "hmcmt2d_tpu/ops/blockinv.py:41 (inv_nopivot, XLA ops)",
        "mt1d_field": "hmcmt2d_tpu/ops/mt1d.py (the lax.scans of surface_impedance and "
                      "analytic_field, XLA ops)",
    }
    replaces["mt1d_field_vjp"] = replaces["mt1d_field_tangent"] = replaces["mt1d_field"]
    source = {
        "schur_factor": "hmcmt2d_tpu_torch/csrc/schur_factor.cu",
        "schur_factor_polish": "hmcmt2d_tpu_torch/csrc/schur_factor.cu",
        "bt_sweep_fwd": "hmcmt2d_tpu_torch/csrc/bt_sweep.cu",
        "bt_sweep_bwd": "hmcmt2d_tpu_torch/csrc/bt_sweep.cu",
        "gj_inverse": "hmcmt2d_tpu_torch/csrc/gj_inverse.cu",
        "mt1d_field": "hmcmt2d_tpu_torch/csrc/mt1d_field.cu",
        "mt1d_field_vjp": "hmcmt2d_tpu_torch/csrc/mt1d_field.cu",
        "mt1d_field_tangent": "hmcmt2d_tpu_torch/csrc/mt1d_field.cu",
    }
    kernels = []
    for k, r in kres.items():
        entry = {"name": k, "route": "cuda", "source": source[k], "replaces": replaces[k],
                 "shape": r.get("shape"), "lines": r.get("lines"), "max_abs_err": r["abs"], "max_rel_err": r["rel"],
                 "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "share_of_bound": r["share_of_bound"], "library_ms": r["library_ms"]}
        if k == "schur_factor_polish":
            # not on the main path (polish = 0 there): its launches are those
            # of the phase-3 polished factor-solve, counted from 0
            entry.update(launches=r["solve"]["launches_polish1"][k],
                         launches_path="phase 3: polish = 1 factor-solve of the flagship")
        elif k == "gj_inverse":
            # not on the fused main path (0 launches there): the engines'
            # inverse under --inv gj; its launches are those of 10c's run
            entry.update(
                launches=gj_run_launches["gj_inverse"],
                launches_path="phase 10c: hmcmt2d-torch " + " ".join(GJ_CLI_FLAGS) + " run",
                launches_main_path=counts.get(k, 0),
                launches_bench=bench_launches.get(k, 0),
                launches_per_factor_and_eval=gj_engine_launches,
                launches_per_graphed_factor_replay=gj_graphed_launches,
                launches_gn_build_bcr_gj=gn_path[k],
                variants={v: {kk: r2[kk] for kk in ("batch", "n", "dtype", "abs", "rel",
                                                    "kernel_ms", "plain_ms", "bound_ms",
                                                    "share_of_bound", "library_ms")}
                          for v, r2 in r["variants"].items()})
        elif k.startswith("mt1d"):
            # the tangent variant counts under mt1d_field and runs only in jv
            counted = "mt1d_field" if k == "mt1d_field_tangent" else k
            entry.update(columns=r["columns"], n=r["n"], rel_tol=r["tol"],
                         columns_cut_apart=r["cut_differs"],
                         plain_max_rel_err=r["plain_rel"], max_rel_err_c128=r["rel_c128"],
                         launches=LAUNCHES_PER_EVAL_3[k] and counts.get(counted, 0),
                         launches_graphed_replays=LAUNCHES_PER_EVAL_3[k]
                         and graph_summary["launches"].get(counted, 0),
                         launches_bench=LAUNCHES_PER_EVAL_3[k]
                         and bench_launches.get(counted, 0),
                         launches_counted_as=counted)
        else:
            entry.update(launches=counts[k],
                         launches_graphed_replays=graph_summary["launches"][k],
                         launches_cli_run=[c[k] for c in run_launches],
                         launches_sharded_per_rank={ph: [c[k] for c in counts_]
                                                    for ph, counts_ in sharded_launches.items()},
                         launches_single_mode={n: c[k] for n, c in single_launches.items()},
                         launches_refresh_extend=tool_launches[k],
                         launches_bench=bench_launches[k],
                         launches_gn_build_fused=gn_path[k])
        kernels.append(entry)
    say({"kernels": kernels})
    say(smi_line())
    say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
