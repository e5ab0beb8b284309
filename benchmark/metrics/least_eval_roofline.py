"""least_eval_roofline: the least time of the work an eval's systems
require, over the CUDA-evented milliseconds of an eval, in either phase:
the least-work factor (``least_factor_roofline.py``) at the float32 peak
plus, for each refined solve (forward and adjoint, 1 + refine each, the
cell's configured refine), one least-work forward and backward sweep
(``least_sweep_roofline.py``) at the memory bandwidth.  On the card every
eval of either phase factors afresh, so the factor counts once an eval."""

import importlib.util
from pathlib import Path


def _sibling(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_factor = _sibling("least_factor_roofline")
_sweep = _sibling("least_sweep_roofline")


def read(rec):
    sh, pk = rec["shapes"], rec["peaks"]
    if not rec["eval_ms"] or pk is None:
        return None
    least_s = (_factor.flops(sh) / pk["flops"]
               + sh["solves_per_eval"] * sum(_sweep.sweep_bytes(sh)) / pk["bytes_per_s"])
    eval_s = sum(rec["eval_ms"]) / len(rec["eval_ms"]) / 1e3
    return 100.0 * least_s / eval_s
