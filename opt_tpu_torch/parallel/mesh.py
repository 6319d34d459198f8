"""Solves sharded over a 2-D mesh of ranks: ``opt_tpu/parallel/mesh.py``.

The JAX package shards a grid's tensors over a ('gx', 'gy') device mesh
with ``NamedSharding`` and lets XLA's partitioner turn stencil reads into
halo exchanges. Here every rank is a process of one ``torch.distributed``
group and holds its own tile; the communication is written out. The grid
half:

* :meth:`Mesh.extend`: a tile's halo from its neighbours along one mesh
  axis (``batch_isend_irecv``; under gloo with CUDA tensors the strips pass
  through pinned host buffers, as gloo moves CPU tensors only). A halo
  beyond the global edge is zeros: the port's operator reads zero outside
  the domain, where the JAX package's torus wrap reads values its folded
  masks multiply by zero;
* :meth:`Mesh.all_reduce_dots`: dot products as products in the vectors'
  dtype (float32, or float64 for a float64 plan) summed in float64 per
  tile, then one float64 ``all_reduce`` for any number of them, rounded to
  the vectors' dtype the same on every rank, so every rank takes the same
  exits;
* :class:`ShardingRules`: this rank's tile (a ceil split, uneven sizes
  allowed) and its extended region (the tile plus the stencil's reach,
  clipped at the global edges), the slicing of the caller's global inputs
  and the gather of the results.

The graph half (owner blocks): each 1-D vertex space that a graph slot
points into splits into contiguous owner blocks over the ranks in flat
(row-major) order, the JAX package's ``"gv"`` axis, and each graph's edges
into contiguous blocks of edge ids (after the optional owner reorder).
Every irregular read of another rank's rows goes through one exchange
whose tables are built once at bind time on the host:

* :func:`build_halo_tables`: for an id table whose rows are split over the
  ranks, what each rank sends every other one (``send``) and the ids
  localized into [own block | received halo | zero row] (``loc``);
* :meth:`Mesh.all_to_all` moves the rows (one ``all_to_all_single``);
  :func:`halo_gather` / :func:`halo_gather_parts` read through it, and
  :func:`halo_gather_many` serves several tables with one exchange,
  :func:`grouped_slot_halo_gather` serves every array read at one
  (graph, slot) with one exchange, and :func:`slot_halo_scatter_add` is the
  reverse exchange (the transpose of the read);
* :class:`GraphShardingRules`: the owner bounds of every vertex space,
  this rank's edge block, the slicing of the caller's global inputs and
  the gather of the results.

Where the device count divides the sizes, the tables are the JAX
package's bit for bit; elsewhere the JAX package replicates, and the
port's ranks, being processes, split by :func:`split_bounds`' ceil split
instead (some blocks shorter, the last ones possibly empty).

The mesh counts its all_reduces, all_to_alls, all_gathers and P2P phases
(``counts``); under a timed solve (``utils/timer.py``) the halo phases,
all_reduces and all_to_alls are rows of the rank's timing table:
``haloExchange``, ``allReduce``, ``allToAll``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.timer import phase


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
        """Set the collective and P2P-phase counts to 0."""
        self.counts = {"all_reduce": 0, "p2p_phases": 0, "all_to_all": 0, "all_gather": 0}

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
        """A packed tile [C, rows, cols, *whole] with ``a`` rows (``axis`` 0) or
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
        with phase("haloExchange"):
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
        with phase("allReduce"):
            h = t.cpu() if self._staged(t) else t.clone()
            dist.all_reduce(h, group=self.group)
            self.counts["all_reduce"] += 1
            return h if host else h.to(t.device)

    def all_reduce_dots(self, pairs: Sequence[tuple]) -> list:
        """⟨x, y⟩ over the whole grid for each pair of tiles: products in
        the tiles' dtype summed in float64 per tile, one float64 all_reduce
        for all of them, each rounded to the tiles' dtype (``fused_cg._dot``'s
        rounding).
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
        self.counts["all_gather"] += 1
        return [o.to(t.device) for o in out]

    def all_to_all(self, send_rows: torch.Tensor) -> torch.Tensor:
        """One all_to_all of equal parts: ``send_rows`` [size, M, ...] holds
        in row d what this rank sends rank d; returns [size, M, ...] with
        row s what rank s sent this rank. Under gloo, CUDA rows pass
        through pinned host buffers."""
        if self.size == 1:
            return send_rows
        with phase("allToAll"):
            staged = self._staged(send_rows)
            if staged:
                inp = self._host_buffer("a2a_send", send_rows.shape, send_rows.dtype)
                inp.copy_(send_rows)
                out = self._host_buffer("a2a_recv", send_rows.shape, send_rows.dtype)
            else:
                inp = send_rows.contiguous()
                out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp, group=self.group)
            self.counts["all_to_all"] += 1
            # the next exchange's blocking copy to the host waits for this
            # copy, before the buffer is received into again
            return out.to(send_rows.device, non_blocking=True) if staged else out


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
    its offset ± its expansion; a ComputedArray read at an offset reads
    what its expression reads about that offset, the expression's reach
    recorded at discovery, ``registry.computed_reach``). Every field at
    a tile's point q is a sum over residuals that read q; their centres and
    all their other reads lie within this distance of q, inside the region,
    where the region's arithmetic is the whole grid's. It covers the CG
    operator's offsets, which are differences of two reads of one residual.
    A ComputedArray that is inlined (``computed_failed``) has no slot of
    its own: its reads are the term's slots at their composed offsets,
    counted as any read. A SampledImage reads the whole image and needs no
    halo."""
    reg = compiled.registry
    reach = [0, 0]
    for term in list(compiled.terms) + list(reg.exclude_terms):
        lo, hi = [0, 0], [0, 0]
        for sid in term.slot_ids:
            s = reg.slots[sid]
            if s.offset is None:
                continue
            e = int(s.expand) if s.kind == "bounds" else 0
            r_lo, r_hi = (-e, -e), (e, e)
            if s.kind in ("cimg", "cgrad"):
                r_lo, r_hi = reg.computed_reach[s.image]
            for d in (0, 1):
                lo[d] = min(lo[d], int(s.offset[d]) + r_lo[d])
                hi[d] = max(hi[d], int(s.offset[d]) + r_hi[d])
        for d in (0, 1):
            reach[d] = max(reach[d], hi[d] - lo[d])
    return reach[0], reach[1]


class ShardingRules:
    """This rank's part of a 2-D grid [H, W] over a mesh, or of a 3-D grid
    [H, W, D] split along its first two axes (the JAX package's
    ``_spec_for_image``, opt_tpu/parallel/mesh.py:72-73): its tile, a ceil
    split of each split axis over the mesh's (the tile of mesh position
    (gx, gy) is rows ``bounds[0][gx]``, columns ``bounds[1][gy]``, and all
    of every further axis, ``whole``), and its extended region, the tile
    plus ``halo`` (rows, columns) on each side, clipped at the global edges.
    A further axis is whole on every rank, so its reads need no halo. Every
    rank is given the same global inputs (as the JAX package's host-global
    arrays): :meth:`local` slices the region out of them, :meth:`crop` the
    tile out of the region, and :meth:`gather` puts the tiles back together
    on every rank. Regions and tiles are [rows, cols, *whole, ...]; fields
    [T, rows, cols, *whole]."""

    kind = "grid"

    def __init__(self, mesh: Mesh, dom: Sequence[int], halo: Sequence[int] = (0, 0)):
        self.mesh = mesh
        self.dom = (int(dom[0]), int(dom[1]))
        self.whole = tuple(int(n) for n in dom[2:])
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

    @property
    def origin(self) -> Tuple[int, ...]:
        """The global coordinates of the region's first point, a further
        (whole) axis's 0 included."""
        return tuple(s for s, _e in self.region) + (0,) * len(self.whole)

    def local(self, x, name=None):
        """The extended region of a global [H, W, *whole, ...] array
        (``name``, the image's, as :class:`GraphShardingRules` takes it: not
        needed here)."""
        (r0, r1), (c0, c1) = self.region
        return x[r0:r1, c0:c1]

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """The tile of a region-shaped [rows, cols, *whole, ...] tensor."""
        (r0, r1), (c0, c1) = self.tile
        (e0, _), (f0, _) = self.region
        return x[r0 - e0:r1 - e0, c0 - f0:c1 - f0]

    def crop_fields(self, F: torch.Tensor) -> torch.Tensor:
        """The tile of region-shaped fields [T, rows, cols, *whole],
        contiguous."""
        return self.crop(F.movedim(0, -1)).movedim(-1, 0).contiguous()

    def extend_region(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tile-shaped [rows, cols, *whole, C_u] tensors, one a name, as
        region-shaped ones: the neighbours' values in the halo (one exchange
        a split axis for all of them together)."""
        names = list(d)
        widths = [int(d[k].shape[-1]) for k in names]
        packed = torch.cat([d[k] for k in names], dim=-1).movedim(-1, 0)
        packed = self.mesh.extend(packed, self.halo[0], 0, edge="clip")
        packed = self.mesh.extend(packed, self.halo[1], 1, edge="clip")
        parts = torch.split(packed.movedim(0, -1), widths, dim=-1)
        return {k: v.contiguous() for k, v in zip(names, parts)}

    def gather(self, x: torch.Tensor, name=None) -> torch.Tensor:
        """The global [H, W, *whole, ...] array from every rank's
        region-shaped ``x`` (each rank contributes its tile), on every rank
        (``name`` as in :meth:`local`)."""
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


# ---------------------------------------------------------------------------
# Owner blocks: the graph half
# ---------------------------------------------------------------------------


def _owners(ids, bounds) -> np.ndarray:
    """The block of ``bounds`` ([start, stop) a rank, contiguous, in rank
    order) holding each of ``ids``; ids past the last block map to the
    last rank."""
    stops = np.asarray([e for _s, e in bounds], np.int64)
    return np.minimum(np.searchsorted(stops, np.asarray(ids, np.int64), side="right"),
                      len(bounds) - 1)


def build_halo_tables(cross, num_vertices: int, ndev: int, m_bucket=None,
                      bounds=None) -> Optional[Dict[str, Any]]:
    """The exchange schedule of an id table (host-side, numpy): the
    counterpart of the JAX package's ``build_halo_tables``.

    ``cross``: int array [R, ...] of global source-row ids, sentinel
    ``num_vertices``. The requester rows (axis 0) and the source rows may
    live in different block-split spaces (vertex rows requesting stacked
    edge rows for the assembly's incidence gather); for the CG loop's p
    reads they coincide. ``bounds``: (source blocks, requester blocks),
    each [(start, stop)] a rank; by default the ceil split of each
    (:func:`split_bounds`), which where ``ndev`` divides both counts is the
    JAX package's even split, and then the tables are its tables.

    Returns {send [ndev, ndev, M] int32: row s, column d, the rows of s's
    own source block (sender-local, sentinel: s's block size, its zero
    row) that s sends d; loc [R, ...] int32: each id localized into the
    requester's [own source block | halo (ndev·M, rank s's rows at s·M) |
    zero row]; M}, or None for one rank. ``m_bucket`` rounds M up (a
    dynamic topology's bucket)."""
    cross = np.asarray(cross)
    n = int(num_vertices)
    R = int(cross.shape[0])
    if ndev <= 1:
        return None
    src_b, req_b = bounds if bounds is not None else (split_bounds(n, ndev),
                                                      split_bounds(R, ndev))
    src_start = np.asarray([s for s, _e in src_b], np.int64)
    src_size = np.asarray([e - s for s, e in src_b], np.int64)
    row_dev = _owners(np.arange(R), req_b).reshape((-1,) + (1,) * (cross.ndim - 1))
    row_dev_b = np.broadcast_to(row_dev, cross.shape)
    valid = cross < n
    owner = _owners(np.where(valid, cross, 0), src_b)
    remote = valid & (owner != row_dev_b)

    # the unique (requester d, source s, global id g) triples as one
    # np.unique over a key sorted by (d, s, g): each (d, s) group is
    # contiguous with its ids ascending
    d_all = row_dev_b[remote].astype(np.int64)
    g_all = cross[remote].astype(np.int64)
    key = (d_all * ndev + owner[remote]) * n + g_all
    uk = np.unique(key)
    grp = uk // n  # = d * ndev + s
    g_u = uk % n
    counts = np.bincount(grp, minlength=ndev * ndev)
    M = int(counts.max()) if len(uk) else 0
    Mp = max(1, M)
    if m_bucket is not None:
        Mp = int(m_bucket(Mp))
    starts = np.zeros(ndev * ndev + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(uk)) - starts[grp]
    d_u, s_u = grp // ndev, grp % ndev

    send = np.broadcast_to(src_size[:, None, None], (ndev, ndev, Mp)).astype(np.int32)
    send[s_u, d_u, slot] = (g_u - src_start[s_u]).astype(np.int32)
    halo_index = (src_size[d_u] + s_u * Mp + slot).astype(np.int32)

    loc = (src_size[row_dev_b] + ndev * Mp).astype(np.int32)  # the zero row
    own = valid & (owner == row_dev_b)
    loc[own] = (cross[own] - src_start[row_dev_b[own]]).astype(np.int32)
    if len(uk):
        loc[remote] = halo_index[np.searchsorted(uk, key)]
    return {"send": send, "loc": loc, "M": Mp}


def map_stacked_rows_device_major(inc, E: int, m: int, ndev: int, bounds=None):
    """A combined-incidence table (ids k·E + e into m slot-major stacked
    edge-row blocks, sentinel m·E) re-indexed into rank-major order, so that
    each rank's source block is what it assembles from its own edges:
    [slot-0 rows of its edges | slot-1 rows | ...], row (k, e) ↦
    m·e0 + k·E_d + (e − e0) for the edge block [e0, e0 + E_d) holding e.
    ``bounds``: the edge blocks (default the ceil split of E; where ndev
    divides E this is the JAX package's mapping). The sentinel stays.
    Returns the int64 table, or None for one rank."""
    inc = np.asarray(inc)
    if ndev <= 1:
        return None
    eb = bounds if bounds is not None else split_bounds(E, ndev)
    k = inc // E
    e = inc % E
    d = _owners(e, eb)
    e0 = np.asarray([s for s, _e in eb], np.int64)[d]
    size = np.asarray([t - s for s, t in eb], np.int64)[d]
    mapped = m * e0 + k * size + (e - e0)
    return np.where(inc >= m * E, m * E, mapped).astype(np.int64)


def owner_edge_order(idx0, n0: int, ndev: int) -> np.ndarray:
    """The owner reorder of a graph's edges: a stable argsort by the owner
    block (the ceil split of the n0 vertices) of each edge's first-slot
    vertex. Where ndev divides n0 this is the JAX package's
    ``Plan._reorder_edges`` permutation."""
    owner = _owners(np.asarray(idx0, np.int64), split_bounds(n0, ndev))
    return np.argsort(owner, kind="stable")


def halo_gather_parts(mesh: "Mesh", parts, send: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Rows read through a localized id table with one all_to_all: this
    rank's source block is ``parts`` ([rows_i, C] each) concatenated;
    ``send`` [ndev, M] is this rank's row of the tables' send (what it
    sends each rank), ``loc`` [rows, ...] this rank's requester rows of
    loc. Returns [*loc.shape, C]."""
    blk = torch.cat(list(parts)) if len(parts) > 1 else parts[0]
    return halo_gather_many(mesh, [(blk, send, loc)])[0]


def halo_gather_many(mesh: "Mesh", reqs) -> list:
    """Several reads through localized id tables with one all_to_all: each
    request (blk [rows, C_k] this rank's source block, send [ndev, M_k],
    loc) as :func:`halo_gather` takes it. What this rank sends a rank, of
    every request, travels side by side in one [ndev, Σ_k M_k·C_k]
    exchange. Returns each request's [*loc.shape, C_k]."""
    if not reqs:
        return []
    ndev = int(reqs[0][1].shape[0])
    parts, zeros = [], []
    for blk, send, _loc in reqs:
        zero = blk.new_zeros((1,) + tuple(blk.shape[1:]))
        zeros.append(zero)
        parts.append(torch.cat([blk, zero])[send].reshape(ndev, -1))
    recv = mesh.all_to_all(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])
    out, o = [], 0
    for (blk, _send, loc), part, zero in zip(reqs, parts, zeros):
        w = int(part.shape[1])
        got = recv[:, o:o + w].reshape((-1,) + tuple(blk.shape[1:]))
        o += w
        out.append(torch.cat([blk, got, zero])[loc])
    return out


def halo_gather(mesh: "Mesh", pp: torch.Tensor, send: torch.Tensor, loc: torch.Tensor):
    """p read through a localized id table with one all_to_all: pp [B, C]
    this rank's owner block; returns [*loc.shape, C]."""
    return halo_gather_parts(mesh, [pp], send, loc)


def slot_halo_gather(mesh: "Mesh", arr: torch.Tensor, tables: Dict) -> torch.Tensor:
    """Per-edge reads X[idx[e]] of this rank's edges through a slot's
    exchange tables ({send, loc [E_d, 1]}): arr [B, C] the owner block.
    Returns [E_d, C]."""
    return halo_gather(mesh, arr, tables["send"], tables["loc"])[:, 0, :]


def grouped_slot_halo_gather(mesh: "Mesh", items, tables: Dict) -> Dict[str, torch.Tensor]:
    """Several owner blocks' per-edge reads at one (graph, slot) with one
    exchange a dtype: ``items`` [(name, [B, C_i])] stack along channels.
    Returns {name: [E_d, C_i]}."""
    groups: Dict[Any, list] = {}
    for name, arr in items:
        groups.setdefault(arr.dtype, []).append((name, arr))
    out = {}
    for grp in groups.values():
        cat = grp[0][1] if len(grp) == 1 else torch.cat([a for _n, a in grp], dim=-1)
        got = slot_halo_gather(mesh, cat, tables)
        o = 0
        for name, a in grp:
            out[name] = got[:, o:o + a.shape[-1]]
            o += a.shape[-1]
    return out


def slot_halo_scatter_add(mesh: "Mesh", ct: torch.Tensor, num_rows: int, tables: Dict):
    """The transpose of :func:`slot_halo_gather`: per-edge values ct
    [E_d, C] summed into this rank's owner block [num_rows, C] (out[idx[e]]
    += ct[e]) through the reverse exchange: the contributions to received
    rows go back to their owners in one all_to_all, and each owner adds
    them at the rows it sent."""
    send, loc = tables["send"], tables["loc"][:, 0]
    ndev, M = int(send.shape[0]), int(send.shape[1])
    C = tuple(ct.shape[1:])
    full = ct.new_zeros((num_rows + ndev * M + 1,) + C).index_add_(0, loc, ct)
    back = mesh.all_to_all(full[num_rows:num_rows + ndev * M].reshape((ndev, M) + C))
    own = ct.new_zeros((num_rows + 1,) + C).index_add_(0, send.reshape(-1),
                                                     back.reshape((-1,) + C))
    return full[:num_rows] + own[:num_rows]


class GraphShardingRules:
    """This rank's part of a graph problem over a mesh: every 1-D vertex
    space that a graph slot points into is split into owner blocks
    (``space_bounds``), each graph's edges into edge blocks (by their
    count at bind time, :meth:`edge_bounds`). Images on a split space are
    held as this rank's block, the unknowns on any number of split spaces;
    images on other 1-D spaces are replicated and read by a plain take. A
    space of fewer vertices than ranks leaves the last ranks an empty block
    (the ceil split). A split image read at a slot that points into another
    split space is exchanged against its own space's bounds
    (:meth:`read_tables`). Every rank is given the same global inputs:
    :meth:`local` slices a rank's part out of them and :meth:`gather` puts
    the blocks back together on every rank. ``compiled`` is the problem at
    the global dims; the rank's plan compiles it at :attr:`local_dims`."""

    kind = "graph"

    def __init__(self, mesh: Mesh, compiled):
        self.mesh = mesh
        reg = compiled.registry
        self.global_dims = dict(compiled.dim_sizes)
        spaces = []
        for g in reg.graphs.values():
            for isp in g.slots.values():
                if isp not in spaces:
                    spaces.append(isp)
        self.spaces = spaces
        self.space_bounds = {
            isp: split_bounds(int(np.prod(isp.shape(self.global_dims))), mesh.size)
            for isp in spaces}
        self.local_dims = {}
        for isp, b in self.space_bounds.items():
            s, e = b[mesh.rank]
            self.local_dims[isp.dims[0].name] = e - s
        self.split_images = {n for n, d in reg.images.items() if d.ispace in self.space_bounds}
        self.image_space = {n: d.ispace for n, d in reg.images.items()}
        # {graph: {(slot, space key): space}}: a split image read at a slot
        # that points into another split space, whose exchange is built
        # against the bounds of the image's space
        self.split_reads: Dict[str, Dict[tuple, Any]] = {}
        for s in reg.slots:
            if s.kind != "gimg" or s.image not in self.split_images:
                continue
            isp = self.image_space[s.image]
            if isp != reg.graphs[s.graph].slots[s.key[3]]:
                self.split_reads.setdefault(s.graph, {})[(s.key[3], self.space_key(isp))] = isp
        self.slot_space = {(g, k): isp for g, gd in reg.graphs.items()
                           for k, isp in gd.slots.items()}
        self._const_cache = None

    # -- blocks -----------------------------------------------------------------
    def block(self, isp) -> Tuple[int, int]:
        """This rank's [start, stop) of a split space (empty where the space
        has fewer vertices than the ceil split reaches this rank with)."""
        return self.space_bounds[isp][self.mesh.rank]

    def space_size(self, isp) -> int:
        """The global vertex count of a split space."""
        return int(np.prod(isp.shape(self.global_dims)))

    @staticmethod
    def space_key(isp) -> str:
        """A split space's key in the graph tables: its dim's name."""
        return isp.dims[0].name

    def read_tables(self, gd: Dict, g: str, slot: str, name: str) -> Dict:
        """The exchange of split image ``name``'s rows read at ``slot`` of
        graph ``g`` (its bound tables ``gd``): the slot's own
        (``__slot_halo__``) where the image lies on the slot's space, else
        the one built against the image's space (``__split_read__``)."""
        isp = self.image_space[name]
        if isp == self.slot_space[(g, slot)]:
            return gd["__slot_halo__"][slot]
        return gd["__split_read__"][(slot, self.space_key(isp))]

    def edge_bounds(self, E: int) -> list:
        """The edge blocks of a graph of E edges."""
        return split_bounds(E, self.mesh.size)

    def local(self, a, name: str):
        """This rank's part of the global image ``name``: its block on a
        split space, the whole array on a replicated one."""
        if name not in self.split_images:
            return a
        s, e = self.block(self.image_space[name])
        return a[s:e]

    def gather(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The global [N, ...] image ``name`` from every rank's block of it,
        on every rank (one all_gather of blocks padded to the largest)."""
        if name not in self.split_images:
            return x
        bounds = self.space_bounds[self.image_space[name]]
        rows = max(e - s for s, e in bounds)
        pad = x.new_zeros((rows,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = self.mesh.all_gather(pad)
        return torch.cat([p[:e - s] for p, (s, e) in zip(parts, bounds)])

    @staticmethod
    def owned_sum(t: torch.Tensor) -> torch.Tensor:
        """The float64 sum of a rank's own residuals (its edges, its block)."""
        return torch.sum(t, dtype=torch.float64)

    # -- per-edge reads ---------------------------------------------------------
    def edge_values(self, compiled, unknowns, consts, graphs, which="all") -> Dict[tuple, Any]:
        """{(image, graph, slot): [E_d, C]}: every image read at a graph slot,
        at this rank's edges. Split images ride one exchange a (graph, slot,
        the images' vertex space) and dtype (:func:`grouped_slot_halo_gather`,
        through :meth:`read_tables`); replicated ones are a plain take at
        the global ids. ``which``: "unknowns", "consts" or "all" of the
        images."""
        reg = compiled.registry
        want: Dict[tuple, list] = {}
        for s in reg.slots:
            if s.kind != "gimg":
                continue
            decl = reg.images[s.image]
            is_u = decl.kind == "unknown"
            if which == "unknowns" and not is_u or which == "consts" and is_u:
                continue
            lst = want.setdefault((s.graph, s.key[3]), [])
            if s.image not in lst:
                lst.append(s.image)
        out = {}
        for (g, slot), names in want.items():
            gd = graphs[g]
            items = []
            for name in names:
                arr = (unknowns if reg.images[name].kind == "unknown" else consts)[name]
                if name in self.split_images:
                    items.append((name, arr))
                else:
                    out[(name, g, slot)] = torch.index_select(arr, 0, gd[slot])
            by_space: Dict[Any, list] = {}
            for name, arr in items:
                by_space.setdefault(self.image_space[name], []).append((name, arr))
            for part in by_space.values():
                got = grouped_slot_halo_gather(self.mesh, part,
                                               self.read_tables(gd, g, slot, part[0][0]))
                for name, v in got.items():
                    out[(name, g, slot)] = v
        return out

    def const_edge_values(self, compiled, consts, graphs) -> Dict[tuple, Any]:
        """:meth:`edge_values` of the constants, exchanged once for the same
        constant and graph tensors and kept."""
        key = (tuple(sorted((k, id(v)) for k, v in consts.items())),
               tuple(sorted((g, id(d.get("__slot_halo__"))) for g, d in graphs.items())))
        if self._const_cache is None or self._const_cache[0] != key:
            self._const_cache = (key, self.edge_values(compiled, {}, consts, graphs, "consts"),
                                 consts, graphs)
        return self._const_cache[1]
