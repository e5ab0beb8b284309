"""device_idle_pct: the share of the profiled iterations' window in which
no kernel ran on the card: the union of the kernels' intervals on the
profiler's timeline against the window's host range."""


def read(rec):
    prof = rec["profile"]
    window = [(s, e) for name, s, e in prof["host"] if name == "bench.window"]
    if not prof["kernels"] or not window:
        return None
    lo, hi = window[0]
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in prof["kernels"])
    busy, end = 0, lo
    for s, e in spans:
        s = max(s, end)
        if e > s:
            busy += e - s
            end = e
    return 100.0 * (1.0 - busy / (hi - lo))
