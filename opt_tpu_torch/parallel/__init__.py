"""Solves sharded over several ranks: the counterpart of ``opt_tpu/parallel``
(its grid half: 2-D grid problems as spatial tiles over a 2-D mesh of
``torch.distributed`` ranks)."""

from .distributed import initialize, is_primary
from .mesh import Mesh, ShardingRules, grid_reach, make_mesh

__all__ = ["initialize", "is_primary", "Mesh", "ShardingRules", "grid_reach", "make_mesh"]
