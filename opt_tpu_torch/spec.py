"""The energy DSL: spec tracing, accessors, and slot recording.

PyTorch counterpart of ``opt_tpu/spec.py``. A user spec is a plain Python
function that is re-executed; accessor calls like ``X(0, 0)`` return real
tensors (zero-padded shifted views) and all arithmetic is ordinary torch
arithmetic, so ``torch.func`` provides the matrix-free JᵀF and JᵀJ·p that
the reference derives symbolically.

The spec function runs under three interchangeable accessor backends:

* ``field`` — accessors return whole-image shifted tensors. Used for cost,
  residuals, JᵀF (vjp) and JᵀJ·p (jvp + vjp).
* ``discover`` — a first pass on the ``meta`` device (shapes only) that
  records declarations and assigns a stable *slot* to every distinct
  (image, offset) access.
* ``slots`` — accessors return entries of a slot-value list. The resulting
  residual function is *pointwise* over the domain, which lets the exact
  Jacobi diagonal and the assembled JᵀJ fields come from one-hot jvp probes.

Spec functions must be deterministic across re-execution (same
declarations, same Energy calls in the same order).

``Select`` keeps the double-``where`` form (lib.py), so the untaken branch
passes neither values nor gradients and ±inf sentinels stay harmless.

Graph accesses ``X(G.v0)`` read per-edge endpoint values with an index
gather (ops/graph_ops.edge_gather). A ``ComputedArray`` is materialized
once per field-mode run; in slot mode its accesses read a stored value slot
plus stored per-unknown gradient slots (compile._computed_bundle), so jvp
probes chain through the stored gradients instead of re-evaluating the
expression. A ``SampledImage`` is sampled bilinearly with the user's
derivative images as its position derivatives (ops/sampling.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .dims import Dim, IndexSpace, as_ispace
from .ops.graph_ops import edge_gather
from .ops.sampling import central_difference_images, sample_with_derivs
from .ops.shift import coordinate_field, in_bounds_mask, shift


class SpecError(Exception):
    pass


UNKNOWN = "unknown"
ARRAY = "array"


@dataclasses.dataclass
class ImageDecl:
    """An image parameter (reference ``ProblemSpec:Image/:Unknown``)."""

    name: str
    channels: int
    ispace: IndexSpace
    kind: str  # UNKNOWN or ARRAY
    # Const view of an unknown: reads the unknown's current values but
    # carries no gradient (Array(..., alias="r")).
    alias: Optional[str] = None


@dataclasses.dataclass
class GraphDecl:
    """A hyperedge set (reference ``ProblemSpec:Graph``)."""

    name: str
    slots: Dict[str, IndexSpace]


@dataclasses.dataclass
class ParamDecl:
    name: str


@dataclasses.dataclass(frozen=True)
class GraphSlotRef:
    graph: str
    slot: str


# Slot keys: ('img', image, offsets) | ('gimg', image, graph, slot) |
# ('bounds', ispace_dims, offsets, expand) |
# ('cimg', computed array, offsets) |
# ('cgrad', computed array, offsets, unknown, relative offset)


def _img_key(name: str, off: Tuple[int, ...]):
    return ("img", name, off)


def _gimg_key(name: str, graph: str, slot: str):
    return ("gimg", name, graph, slot)


def _bounds_key(ispace_key, off, expand):
    return ("bounds", ispace_key, off, expand)


def whole_image_key(name: str) -> str:
    """The constants' key under which a grid mesh binds the whole global
    array of an image that a SampledImage reads (the image's own name holds
    the rank's region of it, which its stencil reads, if any, take)."""
    return "__whole__/" + name


@dataclasses.dataclass
class SlotInfo:
    key: tuple
    image: Optional[str]
    kind: str  # 'img' | 'gimg' | 'bounds' | 'cimg' | 'cgrad'
    ispace: IndexSpace
    graph: Optional[str]
    offset: Optional[Tuple[int, ...]]
    expand: int
    channels: int
    is_unknown: bool
    # True for bounds gates the framework inserted itself (ComputedArray
    # border zeroing); a user InBounds access resets this to False.
    internal: bool = False


@dataclasses.dataclass
class EnergyTerm:
    index: int
    # filled by dependence analysis in compile.py:
    domain: Any = None  # ('centered', IndexSpace) | ('graph', graph_name)
    slot_ids: Tuple[int, ...] = ()
    uses_bounds: bool = False
    bbox: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
    channels: int = 1


@dataclasses.dataclass
class ExcludeTerm:
    index: int
    ispace: Optional[IndexSpace] = None
    slot_ids: Tuple[int, ...] = ()


_BUILDER_STACK: List["SpecBuilder"] = []


def current_builder() -> "SpecBuilder":
    if not _BUILDER_STACK:
        raise SpecError(
            "this DSL function may only be used while a spec function is being traced"
        )
    return _BUILDER_STACK[-1]


def _as_dtype(v, dtype, device):
    if isinstance(v, torch.Tensor):
        return v if v.dtype == dtype else v.to(dtype)
    return torch.tensor(v, dtype=dtype, device=device)


class ImageHandle:
    def __init__(self, builder: "SpecBuilder", decl: ImageDecl):
        self._b = builder
        self.decl = decl

    @property
    def name(self):
        return self.decl.name

    @property
    def channels(self):
        return self.decl.channels

    def __call__(self, *index):
        return self._b._access_image(self.decl, index)


class GraphHandle:
    def __init__(self, decl: GraphDecl):
        self._decl = decl

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if item not in self._decl.slots:
            raise SpecError(f"graph {self._decl.name} has no slot {item!r}")
        return GraphSlotRef(self._decl.name, item)


class ComputedHandle:
    """A precomputed array (reference ``ComputedArray``).

    ``fn`` is a zero-argument closure building the per-element expression
    from accessors. In field mode the array is materialized once per run
    and shifted reads are zero-padded shifts of the materialized field. In
    slot mode the access reads a precomputed value slot plus stored
    per-unknown gradient slots (compile._computed_bundle), the reference's
    ComputedImage value and gradient images. Nested ComputedArrays fall
    back to inlining with composed offsets.
    """

    def __init__(self, b: "SpecBuilder", name: str, ispace: IndexSpace, fn):
        self._b = b
        self.name = name
        self.ispace = ispace
        self.fn = fn

    def __call__(self, *off):
        return self._b._access_computed(self, tuple(int(o) for o in off))


class SampledImageHandle:
    """Bilinear-sampled 2-D image with user derivative images (reference
    ``ad.sampledimage``)."""

    def __init__(self, b: "SpecBuilder", image: ImageHandle, dx: Optional[ImageHandle], dy):
        self._b = b
        self.image = image
        self.dx = dx
        self.dy = dy

    def __call__(self, x, y):
        return self._b._access_sampled(self, x, y)


class SpecBuilder:
    """Executes a user spec function under one of three accessor backends."""

    def __init__(
        self,
        mode: str,
        dim_sizes: Dict[str, int],
        dtype,
        registry: Optional["SpecRegistry"] = None,
        bindings: Optional[Dict[str, Any]] = None,
        slot_values: Optional[Sequence[Any]] = None,
        *,
        device,
    ):
        if mode not in ("discover", "field", "slots"):
            raise ValueError(f"unknown spec backend {mode!r}")
        self.mode = mode
        self.dim_sizes = dim_sizes
        self.dtype = dtype
        self.device = torch.device(device)
        self.registry = registry if registry is not None else SpecRegistry()
        self.bindings = bindings or {}
        self.slot_values = list(slot_values) if slot_values is not None else None
        self.energy_values: List[Any] = []
        self.exclude_values: List[Any] = []
        self._computed_cache: Dict[str, Any] = {}
        self._offset_ctx: List[Tuple[int, ...]] = []
        self._dims_seen: Dict[str, Dim] = {}
        # active while recording a ComputedArray expression's unknown reads
        # (discover mode only): list of (image, composed offset, channels)
        self._recording: Optional[List[tuple]] = None
        self._rec_bailed = False
        # beside it, every grid read of the expression, of any image or
        # bounds gate: list of (composed offset, expansion)
        self._rec_reach: Optional[List[tuple]] = None

    def __enter__(self):
        _BUILDER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _BUILDER_STACK.pop()
        return False

    # -- declarations --------------------------------------------------------
    def Dim(self, name: str, index: Optional[int] = None) -> Dim:
        # `index` accepted for reference-spec portability; binding is by name.
        del index
        d = self._dims_seen.get(name)
        if d is None:
            d = Dim(name)
            self._dims_seen[name] = d
            if name not in self.registry.dim_order:
                self.registry.dim_order.append(name)
            if name not in self.dim_sizes:
                if "*" in self.dim_sizes:
                    self.dim_sizes[name] = int(self.dim_sizes["*"])
                else:
                    raise SpecError(
                        f"no size bound for Dim({name!r}); pass dims={{...}} to plan()"
                    )
        return d

    def Unknown(self, name, channels, dims, index=None) -> ImageHandle:
        return self._declare_image(name, channels, dims, UNKNOWN)

    def Array(self, name, channels, dims, index=None, alias=None) -> ImageHandle:
        return self._declare_image(name, channels, dims, ARRAY, alias=alias)

    Image = Array

    def _declare_image(self, name, channels, dims, kind, alias=None) -> ImageHandle:
        ispace = as_ispace(dims)
        decl = self.registry.declare_image(name, int(channels), ispace, kind, alias)
        return ImageHandle(self, decl)

    def Graph(self, name: str, *slot_pairs, **slot_kwargs) -> GraphHandle:
        """Declare a hyperedge set: ``Graph("G", v0=(N,), v1=(N,))`` or
        reference-style positional pairs ``Graph("G", "v0", (N,), ...)``."""
        slots: Dict[str, IndexSpace] = {}
        items = [a for a in slot_pairs if not isinstance(a, int)]
        for i in range(0, len(items), 2):
            sname = items[i]
            if not isinstance(sname, str):
                raise SpecError(f"expected slot name string, got {sname!r}")
            slots[sname] = as_ispace(items[i + 1])
        for sname, dims in slot_kwargs.items():
            slots[sname] = as_ispace(dims)
        return GraphHandle(self.registry.declare_graph(name, slots))

    def Param(self, name: str, typ=None, index=None):
        """A named scalar parameter (reference ``:Param``)."""
        self.registry.declare_param(name)
        if self.mode == "field" or self.slot_values is not None:
            params = self.bindings.get("params", {})
            if name in params:
                return _as_dtype(params[name], self.dtype, self.device)
        return torch.ones((), dtype=self.dtype, device=self.device)

    def ComputedArray(self, name: str, dims, fn: Callable[[], Any]) -> ComputedHandle:
        self.registry.reads["ComputedArray"] = True
        return ComputedHandle(self, name, as_ispace(dims), fn)

    def SampledImage(self, image: ImageHandle, dx=None, dy=None) -> SampledImageHandle:
        if image.decl.ispace.ndim != 2:
            raise SpecError("sampled images must be 2D (reference o.t:2481)")
        self.registry.reads["SampledImage"] = True
        self.registry.sampled.update(h.decl.name for h in (image, dx, dy) if h is not None)
        return SampledImageHandle(self, image, dx, dy)

    # -- spec-level switches --------------------------------------------------
    def UsePreconditioner(self, flag: bool):
        self.registry.use_preconditioner = bool(flag)

    def Exclude(self, cond):
        """Freeze unknowns where cond holds (reference :Exclude)."""
        if not isinstance(cond, torch.Tensor):
            cond = torch.tensor(cond, device=self.device)
        if cond.dtype != torch.bool:
            cond = cond != 0
        self.exclude_values.append(cond)
        self.registry.note_exclude(len(self.exclude_values) - 1)

    def Energy(self, *terms):
        for t in terms:
            self.energy_values.append(_as_dtype(t, self.dtype, self.device))
            self.registry.note_energy(len(self.energy_values) - 1)

    # -- bounds / coordinates --------------------------------------------------
    def InBounds(self, *off):
        return self._bounds(tuple(int(o) for o in off), expand=0)

    def InBoundsExpanded(self, *args):
        *off, expand = args
        return self._bounds(tuple(int(o) for o in off), expand=int(expand))

    def _bounds(self, off: Tuple[int, ...], expand: int, internal: bool = False):
        """internal=True marks gates the framework inserts itself
        (ComputedArray border zeroing); those must not count as a user
        InBounds, which would disable the automatic bbox mask."""
        off = self._compose(off)
        if self._rec_reach is not None:
            self._rec_reach.append((off, expand))
        ispace = self._grid_ispace_for_ndim(len(off))
        shape = ispace.shape(self.dim_sizes)
        key = _bounds_key(ispace.dims, off, expand)
        # float 0/1 fields in every mode so they ride the slot machinery
        # (jvp probes need inexact inputs)
        if self.mode == "field":
            return in_bounds_mask(shape, off, expand, dtype=self.dtype, device=self.device)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=None, kind="bounds", ispace=ispace, graph=None,
                offset=off, expand=expand, channels=1, is_unknown=False,
                internal=internal,
            ),
        )
        if not internal:
            self.registry.slots[sid].internal = False
        if self.mode == "slots":
            return self.slot_values[sid]
        return torch.ones(shape + (1,), dtype=self.dtype, device=self.device)

    def Index(self, axis: int, dims=None):
        self.registry.reads["Index"] = True
        ispace = as_ispace(dims) if dims is not None else self._grid_ispace_for_ndim(None)
        shape = ispace.shape(self.dim_sizes)
        f = coordinate_field(shape, int(axis), self.dtype, device=self.device)
        origin = self.bindings.get("origin")
        if origin is not None:
            # under a grid mesh the run covers the rank's region: its global
            # coordinates start at the region's origin
            f = f + float(origin[int(axis)])
        if self._offset_ctx:
            # inside an inlined ComputedArray expression the call site's
            # composed offset shifts the coordinates
            f = f + float(self._compose((0,) * len(shape))[int(axis)])
        return f

    # -- access implementation -------------------------------------------------
    def _compose(self, off: Tuple[int, ...]) -> Tuple[int, ...]:
        for ctx in reversed(self._offset_ctx):
            if len(ctx) != len(off):
                raise SpecError("offset rank mismatch inside ComputedArray")
            off = tuple(a + b for a, b in zip(off, ctx))
        return off

    def _grid_ispace_for_ndim(self, ndim: Optional[int]) -> IndexSpace:
        uniq = []
        for d in self.registry.images.values():
            if (ndim is None or d.ispace.ndim == ndim) and d.ispace not in uniq:
                uniq.append(d.ispace)
        if len(uniq) != 1:
            raise SpecError(
                f"cannot infer index space (candidates: {uniq}); pass dims= explicitly"
            )
        return uniq[0]

    def _access_image(self, decl: ImageDecl, index):
        if len(index) == 1 and isinstance(index[0], GraphSlotRef):
            return self._access_image_graph(decl, index[0])
        off = tuple(int(o) for o in index)
        if len(off) != decl.ispace.ndim:
            raise SpecError(
                f"{decl.name}: expected {decl.ispace.ndim} offsets, got {len(off)}"
            )
        off = self._compose(off)
        key = _img_key(decl.name, off)
        shape = decl.ispace.shape(self.dim_sizes) + (decl.channels,)
        plain_unknown = decl.kind == UNKNOWN and decl.alias is None
        if self._recording is not None and plain_unknown:
            self._recording.append((decl.name, off, decl.channels))
        if self._rec_reach is not None:
            self._rec_reach.append((off, 0))
        if self.mode == "field":
            # computed-gradient probing (compile._computed_bundle): unknown
            # reads at substituted offsets come from the probe inputs, so
            # the tangent passes separate the per-offset gradient fields
            subs = self.bindings.get("computed_subs")
            if subs is not None and plain_unknown:
                hit = subs.get((decl.name, off))
                if hit is not None:
                    return hit
            return shift(self._bound_image(decl), off)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=decl.name, kind="img", ispace=decl.ispace, graph=None,
                offset=off, expand=0, channels=decl.channels,
                is_unknown=decl.kind == UNKNOWN,
            ),
        )
        if self.mode == "slots":
            return self.slot_values[sid]
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def _access_image_graph(self, decl: ImageDecl, ref: GraphSlotRef):
        if decl.ispace.ndim != 1:
            raise SpecError("graph-accessed images must live on a 1-D index space")
        if self.mode == "field":
            # on a graph mesh, this rank's edges' reads, exchanged already
            # (parallel/mesh.py: GraphShardingRules.edge_values)
            ev = self.bindings.get("edge_values")
            if ev is not None:
                return ev[(decl.name, ref.graph, ref.slot)]
            return edge_gather(self._bound_image(decl), self._bound_graph_index(ref))
        key = _gimg_key(decl.name, ref.graph, ref.slot)
        sid = self.registry.slot_for(
            key,
            lambda: SlotInfo(
                key=key, image=decl.name, kind="gimg", ispace=decl.ispace,
                graph=ref.graph, offset=None, expand=0, channels=decl.channels,
                is_unknown=decl.kind == UNKNOWN,
            ),
        )
        if self.mode == "slots":
            return self.slot_values[sid]
        E0 = self.registry.dummy_edge_count
        return torch.ones((E0, decl.channels), dtype=self.dtype, device=self.device)

    def _computed_value(self, handle: ComputedHandle) -> torch.Tensor:
        """handle.fn() as [*spatial, channels] in this run's dtype."""
        val = _as_dtype(handle.fn(), self.dtype, self.device)
        return val[..., None] if val.dim() == handle.ispace.ndim else val

    def _access_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        if self.mode == "field":
            if handle.name not in self._computed_cache:
                self._offset_ctx.append((0,) * handle.ispace.ndim)
                try:
                    self._computed_cache[handle.name] = self._computed_value(handle)
                finally:
                    self._offset_ctx.pop()
            return shift(self._computed_cache[handle.name], self._compose(off))
        # slots / discover: the precomputed-field form (value array plus
        # per-unknown gradient arrays, re-made once per nonlinear
        # iteration). The access reads a value slot (a shift of the
        # materialized field, zero-padded at borders) plus a zero-valued
        # linearization term G_t·(x_t − detach(x_t)) per touched unknown
        # offset, so jvp probes chain first derivatives through the stored
        # gradient fields instead of re-differentiating the (possibly
        # large) computed expression per probe.
        raw_off = off
        off = self._compose(off)  # fully composed center of this access
        if self._recording is not None:
            # nested ComputedArray inside a recording: gradients through the
            # inner array would be lost, so the OUTER one is inlined
            self._rec_bailed = True
            return self._inline_computed(handle, raw_off)
        reg = self.registry
        meta = reg.computed_meta.get(handle.name)
        if meta is None and self.mode == "discover" and handle.name not in reg.computed_failed:
            meta = self._record_computed(handle, off)
        if meta is None:
            return self._inline_computed(handle, raw_off)
        cc = meta["channels"]
        key_c = ("cimg", handle.name, off)
        sid_c = reg.slot_for(
            key_c,
            lambda: SlotInfo(
                key=key_c, image=handle.name, kind="cimg", ispace=handle.ispace,
                graph=None, offset=off, expand=0, channels=cc, is_unknown=False,
            ),
        )
        parts = []
        for (uname, t, cu) in meta["touched"]:
            x_off = tuple(a + b for a, b in zip(off, t))
            decl = reg.images[uname]
            key_x = _img_key(uname, x_off)
            sid_x = reg.slot_for(
                key_x,
                lambda: SlotInfo(
                    key=key_x, image=uname, kind="img", ispace=decl.ispace, graph=None,
                    offset=x_off, expand=0, channels=decl.channels, is_unknown=True,
                ),
            )
            key_g = ("cgrad", handle.name, off, uname, t)
            sid_g = reg.slot_for(
                key_g,
                lambda: SlotInfo(
                    key=key_g, image=handle.name, kind="cgrad", ispace=handle.ispace,
                    graph=None, offset=off, expand=0, channels=cc * cu, is_unknown=False,
                ),
            )
            parts.append((sid_x, sid_g, cu))
        if self.mode == "slots":
            val = self.slot_values[sid_c]
            for sid_x, sid_g, cu in parts:
                xs = self.slot_values[sid_x]
                G = self.slot_values[sid_g].reshape(tuple(xs.shape[:-1]) + (cc, cu))
                d = xs - xs.detach()
                val = val + torch.sum(G * d[..., None, :], dim=-1)
            return val
        sp = handle.ispace.shape(self.dim_sizes)
        return torch.ones(sp + (cc,), dtype=self.dtype, device=self.device)  # shapes only

    def _record_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        """Discover pass: run the computed expression once, recording which
        unknowns (at which relative offsets) it reads; registers the
        metadata every later pass looks up."""
        reg = self.registry
        rec: List[tuple] = []
        reach: List[tuple] = []
        prev, prev_bail, prev_reach = self._recording, self._rec_bailed, self._rec_reach
        self._recording, self._rec_bailed, self._rec_reach = rec, False, reach
        saved_ctx = self._offset_ctx
        # replace (not push) the context: ``off`` is already fully composed,
        # so inner reads compose to exactly off + t
        self._offset_ctx = [off]
        try:
            val = self._computed_value(handle)
        finally:
            self._offset_ctx = saved_ctx
            bailed = self._rec_bailed
            self._recording, self._rec_bailed, self._rec_reach = prev, prev_bail, prev_reach
        if bailed:
            reg.computed_failed.add(handle.name)
            return None
        touched, seen = [], set()
        for (uname, comp, cu) in rec:
            t = tuple(a - b for a, b in zip(comp, off))
            if (uname, t) not in seen:
                seen.add((uname, t))
                touched.append((uname, t, cu))
        # the expression's reach about the element it computes: per axis the
        # lowest and highest relative offset of its reads, a gate's
        # widened by its expansion (parallel/mesh.py::grid_reach)
        reg.computed_reach[handle.name] = (
            tuple(min([0] + [c[d] - e - off[d] for c, e in reach]) for d in range(len(off))),
            tuple(max([0] + [c[d] + e - off[d] for c, e in reach]) for d in range(len(off))))
        meta = {"channels": int(val.shape[-1]), "touched": tuple(sorted(touched))}
        reg.computed_meta[handle.name] = meta
        return meta

    def _inline_computed(self, handle: ComputedHandle, off: Tuple[int, ...]):
        """Fallback (nested ComputedArrays): inline with composed offsets.
        A shifted read of the materialized array is zero (and has zero
        derivative) wherever the shift leaves the grid; an internal bounds
        slot gates the inlined value likewise, or the slot form would part
        from the field-mode residuals at the borders. ``off`` is the raw
        (uncomposed) access offset; composition happens through the
        offset-context stack, as for any access."""
        gate = None
        if any(o != 0 for o in off):
            gate = self._bounds(off, expand=0, internal=True)
        self._offset_ctx.append(off)
        try:
            val = self._computed_value(handle)
        finally:
            self._offset_ctx.pop()
        return val if gate is None else val * gate

    def _access_sampled(self, handle: SampledImageHandle, x, y):
        decl = handle.image.decl
        if decl.kind == UNKNOWN:
            raise SpecError("SampledImage over unknowns is not supported")

        # The sampled image and its derivative images are constants; only
        # the positions carry derivatives. Slot-mode runs must see the REAL
        # constant images when they are bound (their jvp probes feed the
        # assembled JᵀJ); only unbound discovery and graph passes take
        # dummies.
        def const_field(d):
            whole = self.bindings.get("consts", {}).get(whole_image_key(d.name))
            if whole is not None:  # under a grid mesh: the global image
                return whole
            if self.mode == "field" or d.name in self.bindings.get("consts", {}):
                return self._bound_image(d)
            shape = d.ispace.shape(self.dim_sizes) + (d.channels,)
            return torch.ones(shape, dtype=self.dtype, device=self.device)

        img = const_field(decl)
        if handle.dx is not None:
            dx, dy = const_field(handle.dx.decl), const_field(handle.dy.decl)
        else:
            dx, dy = central_difference_images(img)
        x = _as_dtype(x, self.dtype, self.device)
        y = _as_dtype(y, self.dtype, self.device)
        if x.dim() == img.dim():  # [*sp, 1] channel-style fields
            x, y = x[..., 0], y[..., 0]
        return sample_with_derivs(img, dx, dy, x, y)

    # -- bindings ---------------------------------------------------------------
    def _bound_image(self, decl: ImageDecl) -> torch.Tensor:
        if decl.alias is not None:
            arr = self.bindings.get("unknowns", {}).get(decl.alias)
            if arr is None:
                raise SpecError(f"alias image {decl.name!r}: no unknown {decl.alias!r}")
            return arr.detach()
        src = "unknowns" if decl.kind == UNKNOWN else "consts"
        d = self.bindings.get(src, {})
        if decl.name not in d:
            raise SpecError(f"no value bound for {decl.kind} image {decl.name!r}")
        arr = d[decl.name]
        if arr.dim() == decl.ispace.ndim:
            arr = arr[..., None]
        return arr

    def _bound_graph_index(self, ref: GraphSlotRef) -> torch.Tensor:
        graphs = self.bindings.get("graphs", {})
        if ref.graph not in graphs:
            raise SpecError(f"no value bound for graph {ref.graph!r}")
        return graphs[ref.graph][ref.slot]


class SpecRegistry:
    """Declarations + slot table shared by all trace passes of one plan."""

    def __init__(self, dummy_edge_count: int = 4):
        self.dim_order: List[str] = []
        self.images: Dict[str, ImageDecl] = {}
        self.graphs: Dict[str, GraphDecl] = {}
        self.params: Dict[str, ParamDecl] = {}
        self.slots: List[SlotInfo] = []
        self._slot_by_key: Dict[tuple, int] = {}
        self.energy_terms: List[EnergyTerm] = []
        self.exclude_terms: List[ExcludeTerm] = []
        self.use_preconditioner = True
        self.dummy_edge_count = dummy_edge_count
        self.frozen = False
        # ComputedArray precompute metadata: handle name -> {channels,
        # touched: ((unknown, relative offset, channels), ...)}; `failed`
        # lists handles that fall back to inlining (nested ComputedArrays)
        self.computed_meta: Dict[str, dict] = {}
        self.computed_failed: set = set()
        # handle name -> (lowest, highest) offset per axis that its
        # expression reads about the element it computes
        self.computed_reach: Dict[str, tuple] = {}
        # which position-dependent constructs the spec reads (a graph mesh
        # cannot take them yet): "Index", "SampledImage", "ComputedArray"
        self.reads: Dict[str, bool] = {}
        # the images a SampledImage reads (the image and its dx, dy): a grid
        # mesh binds them whole (whole_image_key)
        self.sampled: set = set()

    def declare_image(self, name, channels, ispace, kind, alias=None) -> ImageDecl:
        prev = self.images.get(name)
        if prev is not None:
            if prev.channels != channels or prev.ispace != ispace or prev.kind != kind:
                raise SpecError(f"inconsistent re-declaration of image {name!r}")
            return prev
        if self.frozen:
            raise SpecError(f"non-deterministic spec: new image {name!r} on re-trace")
        decl = ImageDecl(name, channels, ispace, kind, alias)
        self.images[name] = decl
        return decl

    def declare_graph(self, name, slots) -> GraphDecl:
        prev = self.graphs.get(name)
        if prev is not None:
            return prev
        if self.frozen:
            raise SpecError(f"non-deterministic spec: new graph {name!r} on re-trace")
        decl = GraphDecl(name, slots)
        self.graphs[name] = decl
        return decl

    def declare_param(self, name):
        if name not in self.params:
            if self.frozen:
                raise SpecError(f"non-deterministic spec: new param {name!r} on re-trace")
            self.params[name] = ParamDecl(name)

    def slot_for(self, key, make_info) -> int:
        sid = self._slot_by_key.get(key)
        if sid is None:
            if self.frozen:
                raise SpecError(f"non-deterministic spec: new access {key} on re-trace")
            sid = len(self.slots)
            self._slot_by_key[key] = sid
            self.slots.append(make_info())
        return sid

    def note_energy(self, idx: int):
        if idx >= len(self.energy_terms):
            if self.frozen:
                raise SpecError("non-deterministic spec: extra Energy() on re-trace")
            self.energy_terms.append(EnergyTerm(index=idx))

    def note_exclude(self, idx: int):
        if idx >= len(self.exclude_terms):
            if self.frozen:
                raise SpecError("non-deterministic spec: extra Exclude() on re-trace")
            self.exclude_terms.append(ExcludeTerm(index=idx))

    @property
    def unknown_names(self) -> List[str]:
        return [n for n, d in self.images.items() if d.kind == UNKNOWN]
