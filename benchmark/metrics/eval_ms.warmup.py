"""eval_ms.warmup: milliseconds of one eval of the warmup engine, fresh and
stale alike, the CUDA-evented time of every eval call in the timed window
over their count."""


def read(rec):
    if rec["phase"] != "warmup" or not rec["eval_ms"]:
        return None
    return sum(rec["eval_ms"]) / len(rec["eval_ms"])
