"""idle_in_replay_pct: the share of the profiled window in which no kernel
ran on the card while the host's innermost program span was one of the
compiled eval's (``graphed.*``: loading the static inputs, launching the
graph, cloning its outputs, a capture).  The idle intervals are those of
``device_idle_pct``; each idle instant goes to the innermost program span
(a host range named ``hmc.*``, ``adapt.*`` or ``graphed.*``) around it,
``hmc.*`` and ``adapt.*`` to the sampler (``idle_in_sampler_pct``), and an
instant in no program span (the benchmark's own code, its synchronisation,
the profiler) to neither.  None without kernels or program spans."""

PROGRAM = ("hmc.", "adapt.", "graphed.")


def _layer(name):
    return "replay" if name.startswith("graphed.") else "sampler"


def _idle(kernels, lo, hi):
    """The window's intervals in which no kernel ran, in order."""
    out, end = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in kernels):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


def _segments(spans):
    """(start, end, layer) of the intervals over which the innermost program
    span stays the same: the one of latest start (then earliest end) among
    those that cover the interval; host ranges of one thread nest."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        inner = [(s, -e, name) for name, s, e in spans if s <= a and e >= b]
        if inner:
            out.append((a, b, _layer(max(inner)[2])))
    return out


def split(rec):
    """{"replay": %, "sampler": %} of the window, or None."""
    prof = rec["profile"]
    window = [(s, e) for name, s, e in prof["host"] if name == "bench.window"]
    spans = [h for h in prof["host"] if h[0].startswith(PROGRAM)]
    if not prof["kernels"] or not window or not spans:
        return None
    lo, hi = window[0]
    idle = _idle(prof["kernels"], lo, hi)
    got = {"replay": 0, "sampler": 0}
    i = 0
    for a, b, layer in _segments(spans):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            got[layer] += max(0, min(b, idle[j][1]) - max(a, idle[j][0]))
            j += 1
    return {k: 100.0 * v / (hi - lo) for k, v in got.items()}


def read(rec):
    got = split(rec)
    return None if got is None else got["replay"]
