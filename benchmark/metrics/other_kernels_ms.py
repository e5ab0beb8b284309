"""other_kernels_ms: device milliseconds, per eval, of every kernel in the
profiled iterations except the hand-written factor and sweeps: the torch
kernels of the forward model and posterior around them (and the few of the
leapfrog between evals, tens of microseconds a step)."""

OURS = ("schur_factor_kernel", "bt_sweep_fwd_kernel", "bt_sweep_bwd_kernel")


def read(rec):
    prof = rec["profile"]
    if rec["phase"] != "sample" or not prof["kernels"] or not prof["evals"]:
        return None
    ns = sum(e - s for name, s, e in prof["kernels"] if not any(k in name for k in OURS))
    return ns / 1e6 / prof["evals"]
