"""Named host spans at the port's layer boundaries, recorded only while a
``torch.profiler`` profile runs.

``with span("hmc.step"): ...`` is a ``torch.profiler.record_function``
range under a profiler, so the span lands in the profile beside the
kernels, in the device trace's clock (and in ``cli.py``'s ``--profile``
chrome trace).  With no profiler running it is one shared
``contextlib.nullcontext``: an ungated ``record_function`` costs a
dispatcher call a span even then.  A span reads no tensor and changes no
number; the count of the spans of one name in a profile is the count of
calls at that boundary.

The spans lie in ``sampler/hmc.py`` (``hmc.iteration``, ``hmc.draw``,
``hmc.step``, ``hmc.mh``), ``sampler/adapt.py`` (``adapt.update``),
``sampler/graphed.py`` (``graphed.eval``, ``.stale``, ``.factor``, and
inside them ``.load``, ``.launch``, ``.clone``, ``.capture``) and the
Gauss-Newton mass's build (``gn.jacobian``, ``gn.host``); the README's
``--profile`` paragraph says what each covers.  Nothing a CUDA graph
captures holds a span: ``models/``, ``ops/`` and ``csrc/`` have none.  So
what the graph decides inside itself shows in no span, such as the axis
along which the fused engine lays a system's lines (z, or y on a mesh
wider than tall): ``cli.py --profile`` prints that beside the launch
counts (its ``[hmcmt2d] fused lines:`` line, ``fused_factor.line_axis`` of
the mesh's shape).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    context that does nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
