"""Domain decomposition over several devices: the deck's n_gpu split."""

from .mesh import (
    DomainMesh, ShardedState, domain_mesh, gather_state, shard_state,
)

__all__ = ["DomainMesh", "ShardedState", "domain_mesh", "gather_state",
           "shard_state"]
