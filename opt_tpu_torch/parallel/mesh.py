"""Spatial tiling of 2-D grid problems over a 2-D mesh of ranks: the grid
half of ``opt_tpu/parallel/mesh.py``.

The JAX package shards a grid's tensors over a ('gx', 'gy') device mesh
with ``NamedSharding`` and lets XLA's partitioner turn stencil reads into
halo exchanges. Here every rank is a process of one ``torch.distributed``
group and holds its own tile; the communication is written out:

* :meth:`Mesh.extend`: a tile's halo from its neighbours along one mesh
  axis (``batch_isend_irecv``; under gloo with CUDA tensors the strips pass
  through pinned host buffers, as gloo moves CPU tensors only). A halo
  beyond the global edge is zeros: the port's operator reads zero outside
  the domain, where the JAX package's torus wrap reads values its folded
  masks multiply by zero;
* :meth:`Mesh.all_reduce_dots`: dot products as float32 products summed in
  float64 per tile, then one float64 ``all_reduce`` for any number of them,
  rounded to float32 the same on every rank, so every rank takes the same
  exits;
* :class:`ShardingRules`: this rank's tile (a ceil split, uneven sizes
  allowed) and its extended region (the tile plus the stencil's reach,
  clipped at the global edges), the slicing of the caller's global inputs
  and the gather of the results.

The mesh counts its all_reduces and its P2P phases (``counts``). The graph
half of the JAX module (owner blocks, halo tables) is not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

def _world(group) -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def make_mesh(shape: Optional[Tuple[int, int]] = None, group=None, device=None) -> "Mesh":
    """This rank's place in a 2-D mesh over the ranks of ``group`` (the
    default group; a world of one when no process group runs). ``shape``
    defaults to the most-square factorisation of the rank count, as the JAX
    package's ``make_mesh``. ``device`` defaults to the card
    ``cuda:(local rank % cards)``; the CPU only when the caller asks for it
    (``device="cpu"``)."""
    n, rank = _world(group)
    if shape is None:
        a = math.isqrt(n)
        while n % a:
            a -= 1
        shape = (a, n // a)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != rank count {n}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' for CPU ranks")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda'")
    if n > 1 and dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' moves CUDA tensors only: give the mesh a card")
    return Mesh(shape, rank, device, group)


class Mesh:
    """One rank's view of a 2-D mesh of ranks: its coordinates (gx, gy),
    its neighbours along each axis (None at the global edge), its device,
    and the collectives of the sharded solve."""

    def __init__(self, shape: Tuple[int, int], rank: int, device: torch.device, group=None):
        self.shape = (int(shape[0]), int(shape[1]))
        self.size = self.shape[0] * self.shape[1]
        self.rank = int(rank)
        self.coords = divmod(self.rank, self.shape[1])
        self.device = device
        self.group = group
        self.backend = dist.get_backend(group) if self.size > 1 else None
        gx, gy = self.coords
        self.neighbours = ((self._peer(gx - 1, gy), self._peer(gx + 1, gy)),
                           (self._peer(gx, gy - 1), self._peer(gx, gy + 1)))
        self._host: Dict[tuple, torch.Tensor] = {}  # pinned staging buffers
        self.reset_counts()

    def _peer(self, gx: int, gy: int) -> Optional[int]:
        """The global rank at mesh position (gx, gy), or None off the mesh."""
        if not (0 <= gx < self.shape[0] and 0 <= gy < self.shape[1]):
            return None
        r = gx * self.shape[1] + gy
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def reset_counts(self) -> None:
        """Set the all_reduce and P2P-phase counts to 0."""
        self.counts = {"all_reduce": 0, "p2p_phases": 0}

    # -- moving tensors ------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` passes through host memory: gloo moves CPU tensors."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host_buffer(self, key, shape, dtype) -> torch.Tensor:
        buf = self._host.get((key, tuple(shape), dtype))
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._host[(key, tuple(shape), dtype)] = buf
        return buf

    def extend(self, p: torch.Tensor, a: int, axis: int, edge: str = "zeros") -> torch.Tensor:
        """A packed tile [C, rows, cols] with ``a`` rows (``axis`` 0) or
        columns (``axis`` 1) of its neighbours' tiles on each side: the last
        ``a`` of the neighbour one step lower along the axis, the first
        ``a`` of the one a step higher. Beyond the global edge ``edge``
        decides: "zeros" pads zeros (the CG operator's halo), "clip" adds
        nothing (the extended region of a plan). One P2P phase; extend
        along axis 0 and then axis 1 of the result, and the corners come
        along."""
        if a == 0:
            return p
        if edge not in ("zeros", "clip"):
            raise ValueError(f"edge must be 'zeros' or 'clip', got {edge!r}")
        dim = axis + 1
        n = int(p.shape[dim])
        if a > n:
            raise ValueError(f"a halo of {a} is wider than the tile's {n}: a one-hop exchange")
        strip = list(p.shape)
        strip[dim] = a
        ops, got = [], {}
        for side, peer, start in (("lo", self.neighbours[axis][0], 0),
                                  ("hi", self.neighbours[axis][1], n - a)):
            if peer is None:
                continue
            out = p.narrow(dim, start, a)
            if self._staged(p):
                send = self._host_buffer(("send", side), strip, p.dtype)
                send.copy_(out)
                recv = self._host_buffer(("recv", side), strip, p.dtype)
            else:
                send = out.contiguous()
                recv = torch.empty(strip, dtype=p.dtype, device=p.device)
            ops += [dist.P2POp(dist.isend, send, peer, self.group),
                    dist.P2POp(dist.irecv, recv, peer, self.group)]
            got[side] = recv
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            self.counts["p2p_phases"] += 1

        def halo(side):
            t = got.get(side)
            if t is not None:
                # the next exchange's blocking copy to the host waits for
                # this copy, before the buffer is received into again
                return t.to(p.device, non_blocking=True)
            return p.new_zeros(strip) if edge == "zeros" else None

        lo, hi = halo("lo"), halo("hi")
        return torch.cat([t for t in (lo, p, hi) if t is not None], dim)

    def _all_reduce(self, t: torch.Tensor, host: bool = False) -> torch.Tensor:
        """Sum ``t`` over the ranks (every rank gets the same bits). A sum
        that went through host memory stays there with ``host``."""
        if self.size == 1:
            return t
        h = t.cpu() if self._staged(t) else t.clone()
        dist.all_reduce(h, group=self.group)
        self.counts["all_reduce"] += 1
        return h if host else h.to(t.device)

    def all_reduce_dots(self, pairs: Sequence[tuple]) -> list:
        """⟨x, y⟩ over the whole grid for each pair of tiles: float32
        products summed in float64 per tile, one float64 all_reduce for all
        of them, each rounded to float32 (``fused_cg._dot``'s rounding).
        Under gloo the dots of CUDA tiles stay on the host as 0-dim
        tensors: the loop's scalar algebra and its exit test then run
        there, and the vector updates take them as scalars, with no copy
        back to the card and no wait for one."""
        local = torch.stack([torch.sum(x * y, dtype=torch.float64) for x, y in pairs])
        return list(self._all_reduce(local, host=True).to(pairs[0][0].dtype).unbind())

    def all_reduce_dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """⟨x, y⟩ over the whole grid (:meth:`all_reduce_dots` of one pair)."""
        return self.all_reduce_dots([(x, y)])[0]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A float64 sum over the ranks."""
        return self._all_reduce(t.to(torch.float64))

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        bad = torch.tensor([0.0 if flag else 1.0], dtype=torch.float64, device=self.device)
        return float(self._all_reduce(bad)) == 0.0

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (all of one shape), in rank order."""
        if self.size == 1:
            return [t]
        h = t.cpu() if self._staged(t) else t.contiguous()
        out = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(out, h, group=self.group)
        return [o.to(t.device) for o in out]


def split_bounds(n: int, parts: int) -> list:
    """[start, stop) of each of ``parts`` tiles of an axis of ``n``: the
    ceil split, the last tiles shorter (or empty) where ``parts`` does not
    divide ``n``."""
    t = -(-int(n) // int(parts))
    return [(min(n, k * t), min(n, (k + 1) * t)) for k in range(int(parts))]


def grid_reach(compiled) -> Tuple[int, int]:
    """The halo (rows, columns) a rank's extended region needs: per axis,
    the largest distance between two reads of one residual or exclusion
    term (its centre counts as a read; an ``InBoundsExpanded`` gate reads
    its offset ± its expansion). Every field at a tile's point q is a sum
    over residuals that read q; their centres and all their other reads
    lie within this distance of q, inside the region, where the region's
    arithmetic is the whole grid's. It covers the CG operator's offsets,
    which are differences of two reads of one residual."""
    reg = compiled.registry
    reach = [0, 0]
    for term in list(compiled.terms) + list(reg.exclude_terms):
        lo, hi = [0, 0], [0, 0]
        for sid in term.slot_ids:
            s = reg.slots[sid]
            if s.offset is None:
                continue
            e = int(s.expand) if s.kind == "bounds" else 0
            for d in (0, 1):
                lo[d] = min(lo[d], int(s.offset[d]) - e)
                hi[d] = max(hi[d], int(s.offset[d]) + e)
        for d in (0, 1):
            reach[d] = max(reach[d], hi[d] - lo[d])
    return reach[0], reach[1]


class ShardingRules:
    """This rank's part of a 2-D grid [H, W] over a mesh: its tile, a ceil
    split of each axis over the mesh's (the tile of mesh position (gx, gy)
    is rows ``bounds[0][gx]``, columns ``bounds[1][gy]``), and its extended
    region, the tile plus ``halo`` (rows, columns) on each side, clipped at
    the global edges. Every rank is given the same global inputs (as the
    JAX package's host-global arrays): :meth:`local` slices the region out
    of them, :meth:`crop` the tile out of the region, and :meth:`gather`
    puts the tiles back together on every rank."""

    def __init__(self, mesh: Mesh, dom: Sequence[int], halo: Sequence[int] = (0, 0)):
        self.mesh = mesh
        self.dom = (int(dom[0]), int(dom[1]))
        self.halo = (int(halo[0]), int(halo[1]))
        self.bounds = tuple(split_bounds(self.dom[d], mesh.shape[d]) for d in (0, 1))
        for d in (0, 1):
            for s, e in self.bounds[d]:
                if e - s < max(1, self.halo[d]):
                    raise ValueError(
                        f"grid axis {d} of {self.dom[d]} over {mesh.shape[d]} ranks gives a "
                        f"tile of {e - s}, narrower than the halo of {self.halo[d]}"
                    )
        gx, gy = mesh.coords
        self.tile = (self.bounds[0][gx], self.bounds[1][gy])
        self.region = tuple((max(0, s - h), min(n, e + h))
                            for (s, e), h, n in zip(self.tile, self.halo, self.dom))

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return tuple(e - s for s, e in self.tile)

    @property
    def region_shape(self) -> Tuple[int, int]:
        return tuple(e - s for s, e in self.region)

    def local(self, x):
        """The extended region of a global [H, W, ...] array."""
        (r0, r1), (c0, c1) = self.region
        return x[r0:r1, c0:c1]

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """The tile of a region-shaped [rows, cols, ...] tensor."""
        (r0, r1), (c0, c1) = self.tile
        (e0, _), (f0, _) = self.region
        return x[r0 - e0:r1 - e0, c0 - f0:c1 - f0]

    def crop_fields(self, F: torch.Tensor) -> torch.Tensor:
        """The tile of region-shaped fields [T, rows, cols], contiguous."""
        return self.crop(F.movedim(0, -1)).movedim(-1, 0).contiguous()

    def extend_region(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tile-shaped [rows, cols, C_u] tensors, one a name, as region-shaped
        ones: the neighbours' values in the halo (one exchange a mesh axis
        for all of them together)."""
        names = list(d)
        widths = [int(d[k].shape[-1]) for k in names]
        packed = torch.cat([d[k] for k in names], dim=-1).movedim(-1, 0)
        packed = self.mesh.extend(packed, self.halo[0], 0, edge="clip")
        packed = self.mesh.extend(packed, self.halo[1], 1, edge="clip")
        parts = torch.split(packed.movedim(0, -1), widths, dim=-1)
        return {k: v.contiguous() for k, v in zip(names, parts)}

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global [H, W, ...] array from every rank's region-shaped
        ``x`` (each rank contributes its tile), on every rank."""
        t = self.crop(x)
        rows = max(e - s for s, e in self.bounds[0])
        cols = max(e - s for s, e in self.bounds[1])
        pad = t.new_zeros((rows, cols) + tuple(t.shape[2:]))
        pad[:t.shape[0], :t.shape[1]] = t
        out = t.new_empty(self.dom + tuple(t.shape[2:]))
        for r, part in enumerate(self.mesh.all_gather(pad)):
            gx, gy = divmod(r, self.mesh.shape[1])
            (r0, r1), (c0, c1) = self.bounds[0][gx], self.bounds[1][gy]
            out[r0:r1, c0:c1] = part[:r1 - r0, :c1 - c0]
        return out

    def owned_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The float64 sum of a region-shaped tensor over the tiles of every
        rank: each point of the grid counted once."""
        return torch.sum(self.crop(t), dtype=torch.float64)
