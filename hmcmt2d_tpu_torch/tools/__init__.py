"""Command-line tools on a run's checkpoint, each a module with
``main(argv=None) -> int``, run as ``python -m hmcmt2d_tpu_torch.tools.<name>``:

* :mod:`.summarize_checkpoint`: posterior artifacts (``summary.json``, the
  mean and std models, the chain logs) from a checkpoint;
* :mod:`.refresh_extend`: rebuild the Gauss-Newton mass at the current
  pooled model, re-adapt the step size and sample an extension;
* :mod:`.map_fit`: the MAP misfit floor of a startup file, by Adam.

Counterparts of ``scripts/summarize_checkpoint.py``, ``scripts/refresh_extend.py``
and ``scripts/map_fit.py``.  Like the CLI they run on the GPU (``--device
cuda``, the default, which raises without one) unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises without a "
                         "GPU; cpu runs on the CPU)")


def device_of(args) -> torch.device:
    return resolve_device(None if args.device == "cuda" else args.device)
