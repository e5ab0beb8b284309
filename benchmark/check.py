"""Whether a run's timed path was correct, and the device records of a
traced run.

After the window the benchmark keeps, of iterations drawn from the seed,
the program's state before and after, its accept decisions and leapfrog
steps, and the mass it sampled under; then the program is freed and the
plain reference (``benchmark/reference``, complex128) follows each drawn
iteration from the program's state before it, with the same draws:

* ``u_gap``, ``grad_gap``, ``pred_gap``: the potential, its gradient and
  the predicted impedances the program carries at that state, against the
  reference's there (worst chain; relative);
* ``traj_gap``: the program's state after the iteration against the
  reference's (where its leapfrog lands if it accepts, the state before if
  it rejects), over the length of the reference's move (worst chain).  A
  decision of the program that differs from the reference's stands where
  the reference's energy margin |dH - log u| is within ``mh_margin`` (the
  energies of a complex64 eval move dH by that much); elsewhere the chain
  has to be where the reference's decision puts it, so a Metropolis test
  that accepts or rejects wrongly reads about 1;
* ``steps_wrong``: drawn iterations whose leapfrog count is not the one
  the draws give (exact);
* ``mass_gap`` (main phase): the program's dense mass times probe vectors
  drawn from the seed, its jitter taken out, against the reference's
  J'W^2J + reg Wm times them, J worked out again at the model the mass was
  built at (worst probe; relative);
* ``adapt_gap`` (warmup): the largest of the gap between the pooled
  acceptance probability that the program's dual-averaging step implies
  and the median of the reference's, and the gaps between the program's
  adapter after the iteration (dual averaging, the window's sums, the
  diagonal mass) and the reference's update from the adapter before it,
  driven by that same pooled acceptance.

The reference follows the program's chain state and mass; the mass is
checked by itself (``mass_gap``), and each drawn state by the first three
numbers.  The control puts a reference computed in complex64 with TF32 on
in the program's place (:func:`control_readings`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .peaks import peaks
from .reference import forward as RF
from .reference import sampler as RS

SEED_NOISE, SEED_STARTS, SEED_CHECK, SEED_PROBES = 1, 2, 3, 4


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use (``SEED_*``) of the run's seed."""
    s = np.random.SeedSequence([seed, purpose]).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def shapes(model: RF.Model, cfg: dict, mix: dict) -> dict:
    """The systems an eval solves, for the readers' operation and byte
    counts, from the model file and the cell's configured solve alone, so
    that the program cannot move its own yardstick.

    A mode's interior system has ``ny_i x nz_i`` unknowns.  Its least-work
    block-tridiagonal ordering has lines of ``width`` unknowns, as many as
    the shorter axis has, stacked along the longer axis: ``lines`` of them.
    That is the least work of the systems, the same whichever ordering or
    engine solves them.  ``B`` systems (chains x frequencies x two modes)
    and ``solves_per_eval`` refined solves an eval (forward and adjoint,
    1 + refine each)."""
    ny_i, nz_i = model.ny - 1, model.nz - 1
    solve = cfg["solve"] if mix["phase"] == "sample" else mix["engine"]
    return dict(width=min(ny_i, nz_i), lines=max(ny_i, nz_i), ny_i=ny_i, nz_i=nz_i,
                B=cfg["chains"] * len(cfg["freqs_hz"]) * 2,
                solves_per_eval=2 * (1 + solve["refine"]))


def peak_rates(dev: torch.device) -> dict | None:
    if dev.type != "cuda":
        return None
    flops, bw = peaks(torch.cuda.get_device_name(dev))
    return {"flops": flops, "bytes_per_s": bw}


@dataclasses.dataclass
class Drawn:
    """One drawn iteration as the program left it (float64, on the device)."""

    index: int
    steps: int
    m0: torch.Tensor
    U0: torch.Tensor
    g0: torch.Tensor
    pred0: torch.Tensor
    m1: torch.Tensor
    accepts: torch.Tensor
    adapter0: tuple | None = None     # (da, window, inv_m) before (warmup)
    adapter1: tuple | None = None     # the same after


def _carry_parts(carry):
    da = tuple(x.double() for x in carry.da)
    window = tuple(x.double() for x in carry.acc)
    return da, window, carry.inv_m.double()


def keep_for_check(phase, kept, first: int, n_iter: int, mix: dict, seed: int) -> dict:
    """What the check needs of the program, drawn before it is freed:
    ``check_iterations`` window iterations drawn from the seed, the mass,
    and the count of window iterations whose new state is not finite."""
    window = kept[first:first + n_iter]
    rng = np.random.default_rng(sub_seed(seed, SEED_CHECK))
    picks = sorted(rng.choice(n_iter, size=min(mix["check_iterations"], n_iter),
                              replace=False))
    warm = mix["phase"] == "warmup"
    failed = 0
    for it in window:
        st = it.after.state if warm else it.after
        failed += int((~(torch.isfinite(st.misfit) & torch.isfinite(st.m).all(-1))).sum())
    drawn = []
    for k in picks:
        it = window[k]
        b = it.before.state if warm else it.before
        a = it.after.state if warm else it.after
        drawn.append(Drawn(
            index=it.index, steps=int(it.steps[0]), m0=b.m.double(),
            U0=(b.misfit + b.mnorm).double(), g0=b.grad.double(), pred0=b.pred.to(torch.complex128),
            m1=a.m.double(), accepts=it.accepts.bool(),
            adapter0=_carry_parts(it.before) if warm else None,
            adapter1=_carry_parts(it.after) if warm else None))
    out = {"drawn": drawn, "failed": failed, "phase": mix["phase"]}
    if not warm:
        out["dt"] = phase.opts.dt
        out["sqrt_m"] = phase.mass.sqrt_m
        out["inv_m"] = phase.mass.inv_m
        out["m_true"] = phase.m_true
    return out


def _masses(kept: dict, d: Drawn, dtype):
    """(p0 from raw, M^-1 p, dt) of the iteration: the dense mass of the
    main phase, or the adapter's diagonal one before the iteration."""
    if kept["phase"] == "sample":
        L, inv_m = kept["sqrt_m"].to(dtype), kept["inv_m"].to(dtype)
        return (lambda raw: raw.to(dtype) @ L.T), (lambda p: p @ inv_m.T), kept["dt"]
    da, _, inv_m = d.adapter0
    inv_m = inv_m.to(dtype)
    sqrt_m = torch.rsqrt(inv_m)
    return (lambda raw: sqrt_m * raw.to(dtype)), (lambda p: inv_m * p), torch.exp(da[0]).to(dtype)


def follow(ref: RF.Reference, kept: dict, d: Drawn, cfg: dict, mix: dict, m_ref):
    """The reference's iteration from the program's state before ``d``:
    its potential there, its leapfrog with the iteration's draws and its
    decision.  Returns a dict of its results."""
    rdt = ref.rdt
    m0 = d.m0.to(rdt)
    L, raw, u = RS.draws(mix["sampler_seed"], RS.STREAM_MAIN if kept["phase"] == "sample"
                         else RS.STREAM_WARMUP, d.index, tuple(m0.shape),
                         cfg["timestep"], m0.device)
    momenta, inv_mass, dt = _masses(kept, d, rdt)
    U0, mis0, mn0, pred0, g0 = ref.value_and_grad(m0, m_ref)

    def vg(m):
        U, mis, mn, pred, g = ref.value_and_grad(m, m_ref)
        return U, pred, g

    rho_lo, rho_hi = cfg["resistivity"]
    bounds = (float(np.log(1.0 / rho_hi)), float(np.log(1.0 / rho_lo)))
    p0 = momenta(raw)
    m1, p1, U1, _, g1 = RS.trajectory(vg, m0, g0, p0, L, dt, inv_mass, bounds)
    h0 = U0 + RS.kinetic(p0, inv_mass)
    h1 = U1 + RS.kinetic(p1, inv_mass)
    finite = torch.isfinite(h1) & torch.isfinite(g1).all(-1) & torch.isfinite(m1).all(-1)
    accept, alpha, margin = RS.mh(h0.double(), h1.double(), finite, u)
    return dict(L=L, U0=U0.double(), g0=g0.double(), pred0=pred0.to(torch.complex128),
                m1=m1.double(), accept=accept, alpha=alpha, margin=margin)


WARMUP_DA = dict(gamma=0.05, t0=10.0, kappa=0.75)   # Stan's dual-averaging constants


def adapter_after(d: Drawn, r: dict, accepts, a, mix: dict):
    """The reference's adaptation from the program's adapter before ``d``
    with the pooled acceptance ``a`` and the new states the decisions
    ``accepts`` keep of the reference's proposals."""
    da, window, inv_m = d.adapter0
    new_m = torch.where(accepts[:, None], r["m1"], d.m0)
    w = dict(WARMUP_DA, target_accept=mix["target_accept"])
    return RS.adapt(da, window, inv_m, a, new_m, window_end(mix, d.index), len(d.m0), w)


def adapt_gap(d: Drawn, r: dict, after: tuple, accepts, mix: dict) -> float:
    """The largest of: the pooled acceptance that the adapter after the
    iteration implies against the median of the reference's, and that
    adapter against the reference's update driven by the same pooled
    acceptance (the dual-averaging state, and the relative gaps of the
    window's sums and of the inverse mass)."""
    w = dict(WARMUP_DA, target_accept=mix["target_accept"])
    a = RS.implied_acceptance(d.adapter0[0], after[0][0], w)
    want = adapter_after(d, r, accepts, a, mix)
    (da_p, win_p, inv_p), (da_r, win_r, inv_r) = after, want
    gaps = [abs(float(x - y)) for x, y in zip(da_p[:4], da_r[:4])]
    gaps += [_rel(win_p[1], win_r[1]), _rel(win_p[2], win_r[2]), _rel(inv_p, inv_r)]
    return max(gaps + [abs(float(a - RS.median(r["alpha"])))])


def window_end(mix: dict, index: int) -> bool:
    """Whether the program's schedule closes a mass window at ``index``
    (Stan's: a buffer of 75, windows from 25 doubling, a buffer of 50)."""
    n = mix["schedule_length"]
    init_b, term_b, base = 75, 50, 25
    if n < init_b + term_b + base:
        s = n / (init_b + term_b + base)
        init_b, term_b = max(1, int(init_b * s)), max(1, int(term_b * s))
        base = max(2, n - init_b - term_b)
    ends, pos, size, last = set(), init_b, base, n - term_b
    while pos < last:
        end = pos + size
        if end + 2 * size > last:
            end = last
        ends.add(min(end, last) - 1)
        pos, size = end, size * 2
    return index % n in ends


def _rel(a, b):
    return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else float((a - b).norm())


def compare(side: dict, r: dict, d: Drawn, mh_margin: float) -> dict:
    """Readings of one iteration: ``side`` holds what is judged (the
    program's, or the control's) at the state ``d.m0``."""
    gaps = dict(
        u_gap=float(((side["U0"] - r["U0"]).abs() / r["U0"].abs()).max()),
        grad_gap=max(_rel(a, b) for a, b in zip(side["g0"], r["g0"])),
        pred_gap=max(_rel(a, b) for a, b in zip(side["pred0"], r["pred0"])))
    move = (r["m1"] - d.m0).norm(dim=-1)
    if "proposal" in side:      # the control shows where its leapfrog landed
        got, expect = side["proposal"], r["m1"]
    else:
        near = r["margin"] <= mh_margin
        decided = torch.where(near, side["accepts"], r["accept"])
        got, expect = side["m1"], torch.where(decided[:, None], r["m1"], d.m0)
    gaps["traj_gap"] = float(((got - expect).norm(dim=-1) / move).max())
    gaps["steps_wrong"] = int(side["L"] != r["L"])
    return gaps


def mass_probes(kept: dict, mix: dict, seed: int, dev) -> torch.Tensor:
    """``mass_probes`` normal vectors drawn from the seed, float64."""
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, SEED_PROBES))
    P = kept["sqrt_m"].shape[0]
    return torch.randn((mix["mass_probes"], P), generator=gen, dtype=torch.float64, device=dev)


def program_mass_product(kept: dict, V: torch.Tensor, jitter: float) -> torch.Tensor:
    """The program's M V with its jitter (1e-6 of the mean diagonal) out."""
    L = kept["sqrt_m"].double()
    MV = (V @ L) @ L.T
    mu = float((L * L).sum()) / L.shape[0] / (1.0 + jitter)
    return MV - jitter * mu * V


def program_side(d: Drawn) -> dict:
    return dict(U0=d.U0, g0=d.g0, pred0=d.pred0, m1=d.m1, accepts=d.accepts, L=d.steps)


def readings(ref: RF.Reference, kept: dict, cfg: dict, mix: dict, inp, seed: int,
             limits: dict, dev, side_of=None) -> dict:
    """Every compared number: the program's (``side_of`` None), or those of
    ``side_of(d, r) -> side`` in the program's place (the control)."""
    m_ref = inp.m_start.to(ref.rdt)
    out: dict[str, float] = {}

    def worst(name, v):
        out[name] = max(out.get(name, 0), v)

    for d in kept["drawn"]:
        r = follow(ref, kept, d, cfg, mix, m_ref)
        side = program_side(d) if side_of is None else side_of(d, r)
        for k, v in compare(side, r, d, limits["mh_margin"]).items():
            if k == "steps_wrong":
                out[k] = out.get(k, 0) + v
            else:
                worst(k, v)
        if kept["phase"] == "warmup":
            after = d.adapter1 if side_of is None else side["adapter1"]
            worst("adapt_gap", adapt_gap(d, r, after, side["accepts"], mix))
    if kept["phase"] == "sample":
        V = mass_probes(kept, mix, seed, dev)
        want = ref.gn_product(kept["m_true"].double(), V)
        if side_of is None:
            got = program_mass_product(kept, V, cfg["gn_mass"]["jitter"])
        else:
            got = side_of.mass(kept, V)
        out["mass_gap"] = max(_rel(a, b) for a, b in zip(got, want))
    return out


def judge(kept: dict, cfg: dict, mix: dict, inp, limits: dict, dev, seed: int) -> dict:
    """The verdict: each reading that the cell's limits name beside its
    limit, ``correct`` when every one is at or under it (a reading that
    does not separate the program from the control in a cell has no limit
    there and is not compared)."""
    ref = RF.Reference(inp.model, inp.rx_y, inp.freqs, dev, obs=inp.obs,
                       weights=1.0 / inp.err, reg=cfg["smoothparameter"])
    got = readings(ref, kept, cfg, mix, inp, seed, limits, dev)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items() if k in limits}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and kept["failed"] == 0
    return {"correct": correct, "failed": kept["failed"], "checks": checks}


class Control:
    """The plain reference put in the program's place, computed in
    complex64 and float32 with TF32 on (the program states complex64 with
    TF32 off): from the drawn states and draws of ``kept`` it gives what the
    program would have, and where its leapfrog landed on every chain."""

    def __init__(self, kept: dict, inp, cfg: dict, mix: dict, dev):
        self.ref = RF.Reference(inp.model, inp.rx_y, inp.freqs, dev, dtype=torch.complex64,
                                obs=inp.obs, weights=1.0 / inp.err, reg=cfg["smoothparameter"])
        self.kept, self.cfg, self.mix, self.inp = kept, cfg, mix, inp

    def __call__(self, d: Drawn, r: dict) -> dict:
        with tf32():
            c = follow(self.ref, self.kept, d, self.cfg, self.mix,
                       self.inp.m_start.to(torch.float32))
            side = dict(U0=c["U0"], g0=c["g0"], pred0=c["pred0"], proposal=c["m1"],
                        m1=torch.where(c["accept"][:, None], c["m1"], d.m0),
                        accepts=c["accept"], L=c["L"])
            if self.kept["phase"] == "warmup":
                side["adapter1"] = adapter_after(d, c, c["accept"], RS.median(c["alpha"]),
                                                 self.mix)
        return side

    def mass(self, kept: dict, V: torch.Tensor) -> torch.Tensor:
        with tf32():
            return self.ref.gn_product(kept["m_true"].float(), V.float()).double()


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def control_readings(kept: dict, cfg: dict, mix: dict, inp, seed: int, limits: dict,
                     dev) -> dict:
    """The compared numbers with the control in the program's place."""
    ref = RF.Reference(inp.model, inp.rx_y, inp.freqs, dev, obs=inp.obs,
                       weights=1.0 / inp.err, reg=cfg["smoothparameter"])
    return readings(ref, kept, cfg, mix, inp, seed, limits, dev,
                    side_of=Control(kept, inp, cfg, mix, dev))


# -- the traced run's device records ------------------------------------------

def window_range(records: dict) -> tuple[int, int] | None:
    for name, start, end in records["profile"]["host"]:
        if name == "bench.window":
            return start, end
    return None


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy(records: dict) -> tuple[float, float]:
    """(seconds in which a kernel ran, seconds of the traced window)."""
    rng = window_range(records)
    if rng is None:
        return 0.0, 0.0
    lo, hi = rng
    spans = merged([(s, e) for _, s, e in records["profile"]["kernels"]], lo, hi)
    return sum(e - s for s, e in spans) / 1e9, (hi - lo) / 1e9


def host_label(records: dict, t: int) -> str:
    """What the host was doing at ``t``: the innermost host range around
    it, inside the benchmark's span of that moment."""
    inner, span = None, "sampler"
    for name, s, e in records["profile"]["host"]:
        if s <= t < e and name != "bench.window":
            if name.startswith("bench."):
                span = name[len("bench."):]
            elif inner is None or e - s < inner[1]:
                inner = (name, e - s)
    return f"{inner[0] if inner else 'idle host'} in {span}"


def breakdown(records: dict) -> dict:
    """The ten device operations that took most time, and the idle gaps by
    what the host was doing, summed by that label (seconds)."""
    rng = window_range(records)
    ops: dict[str, float] = {}
    for name, s, e in records["profile"]["kernels"]:
        ops[name[:96]] = ops.get(name[:96], 0.0) + (e - s) / 1e9
    gaps: dict[str, float] = {}
    if rng is not None:
        lo, hi = rng
        spans = merged([(s, e) for _, s, e in records["profile"]["kernels"]], lo, hi)
        edges = [lo] + [x for s, e in spans for x in (s, e)] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                label = host_label(records, a)
                gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in top], "idle_gaps": [list(kv) for kv in idle]}
