"""Solves sharded over several ranks: the counterpart of ``opt_tpu/parallel``
(2-D and 3-D grid problems as spatial tiles, graph problems as owner
blocks of their vertex spaces and edges, over a 2-D mesh of
``torch.distributed`` ranks)."""

from .distributed import initialize, is_primary
from .mesh import GraphShardingRules, Mesh, ShardingRules, grid_reach, make_mesh

__all__ = ["initialize", "is_primary", "GraphShardingRules", "Mesh", "ShardingRules",
           "grid_reach", "make_mesh"]
