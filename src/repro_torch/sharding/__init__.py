"""Sharding rules and local-shard compute on ``torch.distributed``.

``rules`` maps parameter paths to PartitionSpecs (the JAX package's rules)
and specs to DTensor placements; ``spmd`` runs a program on each rank's
shards with explicit collectives whose gradients are their adjoints.
"""

from .rules import (
    AbstractMesh, NamedSharding, P, PartitionSpec, batch_shardings, cache_shardings,
    param_shardings, placements, spec_for_param,
)

__all__ = [
    "AbstractMesh", "NamedSharding", "P", "PartitionSpec", "batch_shardings",
    "cache_shardings", "param_shardings", "placements", "spec_for_param",
]
