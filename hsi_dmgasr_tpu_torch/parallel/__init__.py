"""Multi-rank inference: process groups, the rank mesh, the H-shard halo."""

from .mesh import Mesh, dmgasr_mesh, local_batch_size, shard_spatial

__all__ = ["Mesh", "dmgasr_mesh", "local_batch_size", "shard_spatial"]
