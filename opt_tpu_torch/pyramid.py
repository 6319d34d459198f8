"""Coarse-to-fine pyramid helpers.

PyTorch counterpart of ``opt_tpu/pyramid.py``'s prolongation. A pyramid
solve here is the host-driven level loop (one plan per level, the unknowns
upsampled between levels, as the reference's optical_flow app drives it);
the JAX package's one-program ``PyramidPlan`` is not ported yet (ROADMAP.md
queue 1 item 11).
"""

from __future__ import annotations

import torch


def upsample2x_nearest(arr: torch.Tensor, shape, scale: float = 1.0) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling to `shape` (spatial dims), values
    multiplied by `scale`: the flow-style prolongation (displacements double
    at double resolution)."""
    out = torch.repeat_interleave(torch.repeat_interleave(arr, 2, dim=0), 2, dim=1) * scale
    return out[: shape[0], : shape[1]]
