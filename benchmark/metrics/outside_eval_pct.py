"""outside_eval_pct: the share of the timed window outside every call into
the eval and the factor, as the benchmark's CUDA events around those calls
time them; what the sampler layer (leapfrog, mass products, Metropolis
test, adaptation) and the host's waits take."""


def read(rec):
    inside = (sum(rec["eval_ms"]) + sum(rec["factor_ms"])) / 1e3
    if not rec["eval_ms"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (rec["window_s"] - inside) / rec["window_s"]
