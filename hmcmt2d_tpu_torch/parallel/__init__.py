"""Sharded sampling over a (chains, freq) process mesh (torch.distributed)."""

from .multichain import (ShardedSampler, distributed_init, make_device_mesh,
                         run_sharded_hmc)

__all__ = ["ShardedSampler", "distributed_init", "make_device_mesh", "run_sharded_hmc"]
