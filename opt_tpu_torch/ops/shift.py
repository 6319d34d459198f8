"""Zero-padded stencil shifts on grid images and their adjoints.

PyTorch counterpart of ``opt_tpu/ops/shift.py``. Stencil reads are
whole-array pad+slice ops, the replacement for the reference's per-thread
offset indexing with zero padding.

Conventions
-----------
``shift(img, off)[q] = img[q + off]`` when ``q + off`` is in bounds, else 0.
The adjoint of ``shift(., off)`` is ``shift(., -off)``: out-of-bounds reads
produce zeros and out-of-range writes are dropped.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def shift(img: torch.Tensor, off: Sequence[int]) -> torch.Tensor:
    """Shifted zero-padded view: result[q] = img[q + off] (0 if out of bounds).

    ``img`` has shape [*spatial, C]; ``off`` has one entry per leading dim
    it shifts (trailing dims are left alone).
    """
    off = tuple(int(o) for o in off)
    if all(o == 0 for o in off):
        return img
    nsp = len(off)
    if img.dim() < nsp:
        raise ValueError(f"image rank {img.dim()} < spatial rank {nsp}")
    # F.pad lists (lo, hi) pairs from the LAST dim backwards
    pad = []
    for d in reversed(range(img.dim())):
        if d < nsp:
            pad += [max(0, -off[d]), max(0, off[d])]
        else:
            pad += [0, 0]
    padded = F.pad(img, pad)
    index = tuple(
        slice(max(0, o), max(0, o) + n) for o, n in zip(off, img.shape[:nsp])
    )
    return padded[index]


def shift_adjoint(field: torch.Tensor, off: Sequence[int]) -> torch.Tensor:
    """Adjoint of :func:`shift`: scatter ``field`` back by ``off``."""
    return shift(field, tuple(-int(o) for o in off))


def _axis_coords(spatial_shape, d, device):
    idx_shape = [1] * (len(spatial_shape) + 1)
    idx_shape[d] = int(spatial_shape[d])
    return torch.arange(int(spatial_shape[d]), device=device).reshape(idx_shape)


def in_bounds_mask(
    spatial_shape: Tuple[int, ...],
    off: Sequence[int],
    expand: int = 0,
    dtype=torch.bool,
    *,
    device,
) -> torch.Tensor:
    """Mask[q] = all coordinates of q+off lie within bounds shrunk by `expand`.

    The reference's ``InBounds``/``InBoundsExpanded``: with expand=e,
    requires e <= q_d + off_d < size_d - e for every spatial dim d. Shape
    [*spatial, 1], for broadcasting against [*spatial, C] residuals.
    """
    off = tuple(int(o) for o in off)
    mask = None
    for d, (n, o) in enumerate(zip(spatial_shape, off)):
        coords = _axis_coords(spatial_shape, d, device)
        ok = (coords + o >= expand) & (coords + o < int(n) - expand)
        mask = ok if mask is None else (mask & ok)
    return mask.to(dtype)


def bbox_mask(
    spatial_shape: Tuple[int, ...],
    bmin: Sequence[int],
    bmax: Sequence[int],
    dtype=torch.bool,
    *,
    device,
) -> torch.Tensor:
    """Mask[q] = q+s in bounds for every offset s in the bbox [bmin, bmax]:
    the reference's automatic zeroing of residuals that read off the grid.
    Shape [*spatial, 1]."""
    mask = None
    for d, n in enumerate(spatial_shape):
        coords = _axis_coords(spatial_shape, d, device)
        ok = (coords + int(bmin[d]) >= 0) & (coords + int(bmax[d]) < int(n))
        mask = ok if mask is None else (mask & ok)
    return mask.to(dtype)


def coordinate_field(
    spatial_shape: Tuple[int, ...], axis: int, dtype, *, device
) -> torch.Tensor:
    """Pixel-coordinate field along `axis` (reference ``Index(d)``).
    Shape [*spatial, 1]."""
    coords = _axis_coords(spatial_shape, int(axis), device)
    return coords.expand(tuple(int(n) for n in spatial_shape) + (1,)).to(dtype)
