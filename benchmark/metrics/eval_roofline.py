"""eval_roofline: the least time of the work a fused eval's shapes
require, the factor's 8 q^3 nzi B operations at the float32 peak plus, for
each refined solve (forward and adjoint, 1 + refine each), one forward and
one backward sweep's bytes at the memory bandwidth, over the CUDA-evented
milliseconds of an eval."""


def read(rec):
    sh, pk = rec["shapes"], rec["peaks"]
    if rec["phase"] != "sample" or not rec["eval_ms"] or pk is None:
        return None
    q, nzi, B = sh["q"], sh["nzi"], sh["B"]
    vec = 4 * B * (nzi - 1) * q + 2 * 8 * B * nzi * q
    pair = 8 * B * nzi * q * q + 8 * B * (nzi - 1) * q * q + 2 * vec
    least_s = 8.0 * q ** 3 * nzi * B / pk["flops"] + sh["solves_per_eval"] * pair / pk["bytes_per_s"]
    eval_s = sum(rec["eval_ms"]) / len(rec["eval_ms"]) / 1e3
    return 100.0 * least_s / eval_s
