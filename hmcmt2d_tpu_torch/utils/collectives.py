"""The collectives of the sharded sampler, over ``torch.distributed`` groups.

Every rank of a group must make the same calls in the same order: callers
branch only on values that are the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def chain_rows(group, n_local: int) -> tuple[tuple[int, int] | None, int]:
    """(rows, n_global) of this rank's ``n_local`` chains in the batch that
    ``group`` (the chains group, ranks in chain order) holds together:
    ``rows`` is ``(lo, hi)``, or None without a group."""
    if group is None:
        return None, n_local
    r = dist.get_rank(group)
    return (r * n_local, (r + 1) * n_local), n_local * dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a new tensor)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order.
    Complex tensors travel as their real view, bool ones as uint8."""
    n = dist.get_world_size(group)
    is_bool, is_complex = x.dtype == torch.bool, x.is_complex()
    y = x.detach()
    if is_bool:
        y = y.to(torch.uint8)
    if is_complex:
        y = torch.view_as_real(y)
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    if is_complex:
        parts = [torch.view_as_complex(p) for p in parts]
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if is_bool else out
