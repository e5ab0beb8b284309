"""idle_in_sampler_pct: the share of the profiled window in which no kernel
ran on the card while the host's innermost program span was the sampler's
(``hmc.*``: the draws with their host read of L, a leapfrog step's own
drift, reflection and kick, the Metropolis test; ``adapt.*``: the
adapter's update).  Split as ``idle_in_replay_pct.py`` says, which reads
the other part.  None without kernels or program spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "idle_in_replay_pct", Path(__file__).with_name("idle_in_replay_pct.py"))
_replay = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_replay)


def read(rec):
    got = _replay.split(rec)
    return None if got is None else got["sampler"]
