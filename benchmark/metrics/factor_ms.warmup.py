"""factor_ms.warmup: milliseconds of one amortised factor of the warmup
engine (the factor_fn the leapfrog calls at a trajectory's start and every
few steps), the CUDA-evented time of every call over their count."""


def read(rec):
    if rec["phase"] != "warmup" or not rec["factor_ms"]:
        return None
    return sum(rec["factor_ms"]) / len(rec["factor_ms"])
