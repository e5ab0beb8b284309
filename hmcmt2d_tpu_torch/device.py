"""Where the port's tensors go when the caller does not say.

One rule for every public constructor and entry point: ``device=None`` means
the GPU, and raises when there is none, so nothing carries on quietly on the
CPU.  Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the GPU, and raises when
    there is none (entry points never carry on quietly on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
