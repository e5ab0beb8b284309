"""eval_ms.sample: milliseconds of one batched potential value-and-grad of
the main phase (the graphed fused eval), the CUDA-evented time of every
eval call in the timed window over their count."""


def read(rec):
    if rec["phase"] != "sample" or not rec["eval_ms"]:
        return None
    return sum(rec["eval_ms"]) / len(rec["eval_ms"])
