"""Domain decomposition over several devices and processes: the deck's
n_gpu split."""

from .comm import ensure_distributed
from .mesh import (
    DomainMesh, ShardedState, domain_mesh, gather_state, shard_state,
)

__all__ = ["DomainMesh", "ShardedState", "domain_mesh", "ensure_distributed",
           "gather_state", "shard_state"]
