"""Problem compilation: spec tracing, residual classification, masking.

PyTorch counterpart of ``opt_tpu/compile.py``:

* residual classification into centered (stencil) vs graph domains —
  reference ``classifyexpression`` — by backward dependence slicing of a
  ``make_fx`` graph of the slot-form residual function, the same
  conservative "visit every subexpression" rule the reference uses and the
  JAX package applies to its jaxpr;
* automatic zeroing of residuals that read out of bounds (the bbox mask),
  including the rule that any explicit ``InBounds`` use disables it;
* ±inf sentinel clamping, exclusion masks and row masks;
* graph inputs (per-slot edge index tensors and the optional per-edge
  ``valid`` mask) and graph residual evaluation by edge gathers.

Discovery and the dependence graph run on the ``meta`` device: shapes only,
no compute, whatever the problem size.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .dims import IndexSpace
from .ops.graph_ops import edge_gather
from .ops.shift import bbox_mask, in_bounds_mask, shift
from .spec import (
    UNKNOWN,
    EnergyTerm,
    SpecBuilder,
    SpecError,
    SpecRegistry,
    whole_image_key,
)
from .utils.timer import phase

# ---------------------------------------------------------------------------
# FX-graph dependence slicing
# ---------------------------------------------------------------------------

# Ops whose output depends only on an input's shape, never its values. In a
# jaxpr, zeros_like/full_like are literal broadcasts; in an FX graph they take
# the tensor as an argument, and counting that as data dependence would give
# terms spurious slots (wider bbox, other uses_bounds, false "mixes index
# spaces" errors).
_SHAPE_ONLY_OPS = frozenset({
    "zeros_like", "ones_like", "full_like", "empty_like", "rand_like",
    "randn_like", "new_zeros", "new_ones", "new_full", "new_empty",
    "sym_size", "sym_numel", "sym_stride", "size", "numel", "dim",
})


def op_name(node) -> str:
    """Overload-packet name of an FX call_function target ('where', ...)."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def node_inputs(node):
    """FX nodes among a node's (nested) args and kwargs."""
    out = []

    def visit(a):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)
        elif isinstance(a, dict):
            for b in a.values():
                visit(b)

    visit(node.args)
    visit(node.kwargs)
    return out


def graph_outputs(graph) -> list:
    """The flat output list of a make_fx graph (entries may be non-Nodes)."""
    for node in graph.nodes:
        if node.op == "output":
            out = node.args[0]
            return list(out) if isinstance(out, (list, tuple)) else [out]
    return []


def _graph_output_deps(gm) -> List[frozenset]:
    """For each graph output, the set of placeholder indices it
    (syntactically) depends on. Nodes are atomic (any-in -> all-out)."""
    env: Dict[Any, frozenset] = {}
    n_in = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = frozenset([n_in])
            n_in += 1
        elif node.op == "call_function":
            if op_name(node) in _SHAPE_ONLY_OPS:
                env[node] = frozenset()
                continue
            dep = frozenset()
            for a in node_inputs(node):
                dep = dep | env.get(a, frozenset())
            env[node] = dep
        else:  # get_attr constants
            env[node] = frozenset()
    return [
        env.get(o, frozenset()) if isinstance(o, torch.fx.Node) else frozenset()
        for o in graph_outputs(gm.graph)
    ]


# ---------------------------------------------------------------------------
# Compiled problem
# ---------------------------------------------------------------------------


def _first_device(*groups):
    for g in groups:
        for v in (g.values() if isinstance(g, dict) else g):
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


@dataclasses.dataclass
class CompiledProblem:
    spec_fn: Callable
    registry: SpecRegistry
    dim_sizes: Dict[str, int]
    dtype: Any
    # on a graph mesh: the rank's parallel.mesh.GraphShardingRules (a plan's
    # own copy of the cached problem, at the rank's local dims), through
    # which the per-edge reads of other ranks' vertices are exchanged
    graph_rules: Any = None
    # on a grid mesh: the global coordinates of the rank's region's first
    # point along each axis, which Index adds (set on a plan's own copy, as
    # graph_rules is)
    grid_origin: Any = None

    @property
    def use_preconditioner(self) -> bool:
        return self.registry.use_preconditioner

    @property
    def unknown_names(self) -> List[str]:
        return self.registry.unknown_names

    @property
    def terms(self) -> List[EnergyTerm]:
        return self.registry.energy_terms

    def unknown_shape(self, name: str) -> Tuple[int, ...]:
        d = self.registry.images[name]
        return d.ispace.shape(self.dim_sizes) + (d.channels,)

    def normalize_inputs(self, inputs: Dict[str, Any], device, partial=False):
        """Split a flat name->value dict into (unknowns, consts, graphs,
        params), as tensors on ``device`` in the plan dtype. ``partial=True``
        converts only the given subset (no missing-input check, no
        parameter defaulting)."""
        unknowns, consts, graphs, params = {}, {}, {}, {}
        # a sampled image bound whole under a grid mesh: the global shape,
        # which the plan checked (Plan._local_inputs)
        whole = {whole_image_key(n): n for n in self.registry.sampled}
        for name, val in inputs.items():
            if name in self.registry.images or name in whole:
                decl = self.registry.images[whole.get(name, name)]
                if decl.alias is not None:
                    continue  # const views read the unknown's buffer
                arr = torch.as_tensor(np.asarray(val) if not isinstance(val, torch.Tensor) else val)
                arr = arr.to(device)
                if arr.is_floating_point():
                    arr = arr.to(self.dtype)
                if arr.dim() == decl.ispace.ndim:
                    arr = arr[..., None]
                expect = decl.ispace.shape(self.dim_sizes) + (decl.channels,)
                if name not in whole and tuple(arr.shape) != expect:
                    raise SpecError(
                        f"image {name!r}: expected shape {expect}, got {tuple(arr.shape)}"
                    )
                if arr.is_floating_point():
                    # ±inf sentinels become large finite values: every
                    # branch of a Select runs under trace-based AD, and an
                    # inf in an untaken branch turns 0·inf into NaN
                    arr = self._sanitize_sentinels(arr)
                (unknowns if decl.kind == UNKNOWN else consts)[name] = arr.contiguous()
            elif name in self.registry.graphs:
                graphs[name] = self._graph_input(name, val, device)
            elif name in self.registry.params:
                params[name] = torch.as_tensor(val, dtype=self.dtype).to(device)
            else:
                raise SpecError(f"unknown input {name!r}")
        if not partial:
            required = [
                n for n, d in self.registry.images.items() if d.alias is None
            ] + list(self.registry.graphs)
            missing = [n for n in required if n not in inputs]
            if missing:
                raise SpecError(f"missing inputs: {missing}")
            for p in self.registry.params:
                params.setdefault(p, torch.zeros((), dtype=self.dtype, device=device))
        return unknowns, consts, graphs, params

    def _graph_input(self, name, val, device):
        """One graph's slots as int64 index tensors on ``device``, plus the
        optional per-edge 0/1 ``valid`` mask as [E, 1] in the plan dtype (a
        masked edge contributes nothing; a mask change rebuilds no table)."""
        decl = self.registry.graphs[name]
        g = val if isinstance(val, dict) else {s: getattr(val, s) for s in decl.slots}
        gd = {}
        for s, i in g.items():
            t = i if isinstance(i, torch.Tensor) else torch.as_tensor(np.asarray(i))
            if s == "valid":
                t = t.to(device=device, dtype=self.dtype)
                gd[s] = t[:, None] if t.dim() == 1 else t
            else:
                gd[s] = t.to(device=device, dtype=torch.int64)
        missing = [s for s in decl.slots if s not in gd]
        if missing:
            raise SpecError(f"graph {name!r}: missing slots {missing}")
        n_edges = {int(gd[s].shape[0]) for s in decl.slots}
        if len(n_edges) != 1:
            raise SpecError(f"graph {name!r}: slots have different edge counts {sorted(n_edges)}")
        if "valid" in gd and int(gd["valid"].shape[0]) not in n_edges:
            raise SpecError(
                f"graph {name!r}: valid mask has {int(gd['valid'].shape[0])} entries, "
                f"edges have {n_edges.pop()}"
            )
        return gd

    def _sanitize_sentinels(self, arr):
        """Clamp ±inf entries to a large finite sentinel whose magnitude
        stays above every comparison threshold traced from the spec (so
        validity tests keep their truth value) and whose squares stay
        finite in float32 (see opt_tpu.compile._sanitize_sentinels)."""
        s = getattr(self, "_sentinel_mag", None)
        if s is None:
            s = 2.0e6
            thresholds = self._traced_comparison_thresholds()
            if thresholds:
                s = max(s, 8.0 * max(abs(t) for t in thresholds))
            self._sentinel_mag = s
        from .utils.logging import log_solver, verbosity

        if verbosity() >= 1:
            n_inf = int(torch.isinf(arr).sum())
            if n_inf:
                log_solver(
                    "opt_tpu_torch: clamped %d ±inf sentinel value(s) to "
                    "magnitude %g at bind time", n_inf, s,
                )
        big = torch.full_like(arr, s)
        arr = torch.where(arr == float("inf"), big, arr)
        return torch.where(arr == float("-inf"), -big, arr)

    def _traced_comparison_thresholds(self):
        """Scalar comparison-operand literals of the residual graph (shared
        machinery with assembly's threshold-aware probes), traced on meta."""
        cached = getattr(self, "_cmp_thresholds", None)
        if cached is not None:
            return cached
        from .assembly import _comparison_constants

        meta = torch.device("meta")
        zeros_u = {
            n: torch.zeros(self.unknown_shape(n), dtype=self.dtype, device=meta)
            for n in self.unknown_names
        }
        zeros_c = {
            n: torch.zeros(
                d.ispace.shape(self.dim_sizes) + (d.channels,), dtype=self.dtype,
                device=meta,
            )
            for n, d in self.registry.images.items()
            if d.kind != UNKNOWN and d.alias is None
        }
        zeros_g = {
            g: {s: torch.zeros((2,), dtype=torch.int64, device=meta) for s in d.slots}
            for g, d in self.registry.graphs.items()
        }
        zeros_p = {
            p: torch.zeros((), dtype=self.dtype, device=meta)
            for p in self.registry.params
        }
        # traced on meta tensors: never through a graph mesh's exchanges
        plain = self if self.graph_rules is None else dataclasses.replace(self, graph_rules=None)
        out = _comparison_constants(plain, zeros_u, zeros_c, zeros_g, zeros_p)
        self._cmp_thresholds = out
        return out

    # ---- field-mode runs ----------------------------------------------------
    def edge_values(self, unknowns, consts, graphs):
        """On a graph mesh, {(image, graph, slot): [E_d, C]}: the images read
        at this rank's edges (the constants' exchanged once and kept, the
        unknowns' now); None off a mesh. Its exchanges are collectives: a
        caller under a ``torch.func`` transform passes them in instead."""
        rules = self.graph_rules
        if rules is None:
            return None
        ev = dict(rules.const_edge_values(self, consts, graphs))
        ev.update(rules.edge_values(self, unknowns, consts, graphs, "unknowns"))
        return ev

    def _run(self, mode, unknowns, consts, graphs, params, slot_values=None,
             computed_subs=None, edge_values=None):
        if mode == "field" and edge_values is None:
            edge_values = self.edge_values(unknowns, consts, graphs)
        builder = SpecBuilder(
            mode,
            self.dim_sizes,
            self.dtype,
            registry=self.registry,
            bindings={"unknowns": unknowns, "consts": consts, "graphs": graphs,
                      "params": params, "computed_subs": computed_subs,
                      "edge_values": edge_values, "origin": self.grid_origin},
            slot_values=slot_values,
            device=_first_device(unknowns, consts, slot_values or []),
        )
        with builder:
            self.spec_fn(builder)
        return builder

    def _normalize_term(self, val, term: EnergyTerm):
        """Give every residual term an explicit trailing channel axis."""
        nd_sp = self._term_spatial_ndim(term)
        if val.dim() == nd_sp:
            return val[..., None]
        if val.dim() == nd_sp + 1:
            return val
        raise SpecError(
            f"energy term {term.index}: rank {val.dim()} does not match its "
            f"domain {term.domain}"
        )

    def _term_spatial_ndim(self, term: EnergyTerm) -> int:
        kind, dom = term.domain
        return dom.ndim if kind == "centered" else 1

    def _apply_bbox(self, val, term: EnergyTerm):
        """Zero residuals whose accesses leave the grid (reference o.t:1930)."""
        if term.domain[0] != "centered" or term.uses_bounds or term.bbox is None:
            return val
        bmin, bmax = term.bbox
        if all(o == 0 for o in bmin) and all(o == 0 for o in bmax):
            return val
        shape = term.domain[1].shape(self.dim_sizes)
        # multiplicative 0/1 mask, as in the reference package
        return val * bbox_mask(shape, bmin, bmax, dtype=val.dtype, device=val.device)

    def residual_terms(self, unknowns, consts, graphs, params,
                       edge_values=None) -> List[torch.Tensor]:
        """All residual terms (bbox-masked), *not* exclusion-masked: residual
        instances centered at excluded pixels still feed the gradients of
        active unknowns. ``edge_values``: on a graph mesh, the per-edge
        reads (:meth:`edge_values`), exchanged now where not given."""
        b = self._run("field", unknowns, consts, graphs, params, edge_values=edge_values)
        out = []
        for term, val, sc in zip(self.terms, b.energy_values, self.graph_term_scales(graphs)):
            val = self._apply_bbox(self._normalize_term(val, term), term)
            out.append(val if sc is None else val * sc)
        return out

    def graph_term_scales(self, graphs):
        """Per-term residual scale from the optional per-edge ``valid``
        masks ([E, 1], detached), aligned with ``self.terms`` (None where no
        mask applies). Scaling the residual zeroes the edge's rows of J, its
        JᵀF and diagonal contributions and its cost together; slot-form
        evaluations outside :meth:`residual_terms` apply the same scales."""
        out = []
        for term in self.terms:
            sc = None
            if term.domain[0] == "graph":
                g = graphs.get(term.domain[1])
                if g is not None and g.get("valid") is not None:
                    sc = g["valid"].detach()
            out.append(sc)
        return out

    def residual_fn(self, consts, graphs, params):
        """Closure over constants: X -> list of residual term tensors."""
        return lambda unknowns: self.residual_terms(unknowns, consts, graphs, params)

    def exclusion_masks(self, unknowns, consts, graphs, params):
        """Per-ispace 'is excluded' masks [*spatial, 1] in the compute dtype
        (1.0 = excluded, 0.0 = active), or {} if none. Float so the hot path
        masks by multiplication, as the reference package does."""
        if not self.registry.exclude_terms:
            return {}
        b = self._run("field", unknowns, consts, graphs, params)
        masks: Dict[IndexSpace, torch.Tensor] = {}
        for et, val in zip(self.registry.exclude_terms, b.exclude_values):
            if val.dim() == et.ispace.ndim:
                val = val[..., None]
            elif val.dim() == et.ispace.ndim + 1 and val.shape[-1] != 1:
                val = torch.any(val != 0, dim=-1, keepdim=True)
            val = val.to(self.dtype)
            prev = masks.get(et.ispace)
            masks[et.ispace] = val if prev is None else torch.maximum(prev, val)
        return {k: v.detach() for k, v in masks.items()}

    def unknown_row_masks(self, excl_by_ispace):
        """name -> float mask (1.0 = active row, 0.0 = excluded) or None."""
        out = {}
        for name in self.unknown_names:
            m = excl_by_ispace.get(self.registry.images[name].ispace)
            out[name] = None if m is None else (1.0 - m)
        return out

    def term_cost_mask(self, term: EnergyTerm, excl_by_ispace):
        """Residuals centered at excluded pixels do not count toward the cost
        (reference computeCost)."""
        if term.domain[0] != "centered":
            return None
        return excl_by_ispace.get(term.domain[1])

    # ---- slot-mode ----------------------------------------------------------
    def gather_slot_values(self, unknowns, consts, graphs, params=None):
        """Materialize every slot's value field (shift / edge gather /
        bounds mask). ComputedArray slots (cimg/cgrad) materialize the
        computed value and its per-unknown gradient fields once per call
        (:meth:`_computed_bundle`): the reference's per-nonlinear-iteration
        ``precompute`` kernels."""
        device = _first_device(unknowns, consts)
        edge_values = self.edge_values(unknowns, consts, graphs)
        bundle = None
        vals = []
        for s in self.registry.slots:
            if s.kind == "img":
                decl = self.registry.images[s.image]
                if decl.alias is not None:
                    arr = unknowns[decl.alias].detach()
                else:
                    arr = (unknowns if decl.kind == UNKNOWN else consts)[s.image]
                vals.append(shift(arr, s.offset))
            elif s.kind == "bounds":
                shape = s.ispace.shape(self.dim_sizes)
                vals.append(
                    in_bounds_mask(shape, s.offset, s.expand, dtype=self.dtype, device=device)
                )
            elif s.kind in ("cimg", "cgrad"):
                if bundle is None:
                    with phase("computedBundle"):
                        bundle = self._computed_bundle(unknowns, consts, graphs, params or {})
                value, grads = bundle[s.image]  # image holds the handle name
                field = value if s.kind == "cimg" else grads[(s.key[3], s.key[4])]
                vals.append(shift(field, s.offset))
            elif edge_values is not None:  # gimg on a graph mesh: exchanged
                vals.append(edge_values[(s.image, s.graph, s.key[3])])
            else:  # gimg: the image at the slot's edge endpoints
                decl = self.registry.images[s.image]
                if decl.alias is not None:
                    arr = unknowns[decl.alias].detach()
                else:
                    arr = (unknowns if decl.kind == UNKNOWN else consts)[s.image]
                vals.append(edge_gather(arr, graphs[s.graph][s.key[3]]))
        return vals

    def _computed_bundle(self, unknowns, consts, graphs, params):
        """{handle name: (value field [*sp, cc], {(unknown, t): gradient
        field [*sp, cc*cu]})} at the current linearization point.

        One field-mode run of the spec captures every computed value; its
        unknown reads at the touched (unknown, offset) pairs are substituted
        by separate inputs, and one ``vmap`` over ``torch.func.jvp`` with a
        one-hot tangent per (pair, channel) separates the gradient fields:
        the probe analogue of the reference storing gradient images per
        ComputedImage. The fields are constants of the step (detached)."""
        reg = self.registry
        need_g, handles = {}, []
        for s in reg.slots:
            if s.kind == "cimg" and s.image not in handles:
                handles.append(s.image)
            if s.kind == "cgrad":  # only pairs some cgrad slot reads
                need_g.setdefault(s.image, set()).add((s.key[3], s.key[4]))
        sub_keys = sorted({pair for pairs in need_g.values() for pair in pairs})
        unknowns = {k: v.detach() for k, v in unknowns.items()}

        def run(*sub_vals):
            b = self._run("field", unknowns, consts, graphs, params,
                          computed_subs=dict(zip(sub_keys, sub_vals)))
            return tuple(b._computed_cache[h] for h in handles)

        base = [shift(unknowns[uname], t) for (uname, t) in sub_keys]
        probe_of = [(ki, ch) for ki, v in enumerate(base) for ch in range(v.shape[-1])]
        if not probe_of:
            return {h: (v.detach(), {}) for h, v in zip(handles, run())}
        batched = []
        for ki, v in enumerate(base):
            sel = torch.zeros((len(probe_of), v.shape[-1]), dtype=v.dtype, device=v.device)
            for pi, (kj, ch) in enumerate(probe_of):
                if kj == ki:
                    sel[pi, ch] = 1.0
            sel = sel.reshape((len(probe_of),) + (1,) * (v.dim() - 1) + (v.shape[-1],))
            batched.append(sel.expand((len(probe_of),) + tuple(v.shape)))
        prim = run(*base)
        tans = torch.func.vmap(
            lambda *ts: torch.func.jvp(run, tuple(base), tuple(ts))[1]
        )(*batched)  # per handle [n_probes, *sp, cc]
        out = {}
        for hi, hname in enumerate(handles):
            grads = {}
            for pair in sorted(need_g.get(hname, ())):
                ki = sub_keys.index(pair)
                cols = [tans[hi][pi] for pi, (kj, _ch) in enumerate(probe_of) if kj == ki]
                G = torch.stack(cols, dim=-1)  # [*sp, cc, cu]
                grads[pair] = G.reshape(tuple(G.shape[:-2]) + (-1,)).detach()
            out[hname] = (prim[hi].detach(), grads)
        return out

    def local_residual_terms(self, slot_values, params, consts=None) -> List[torch.Tensor]:
        """Residual terms as a pointwise function of slot values (bbox-masked
        identically to :meth:`residual_terms`). ``consts`` must be passed for
        specs using SampledImage: the sampled image and derivative arrays
        are read directly (they are not slots, since sampling coordinates
        are dynamic)."""
        b = self._run("slots", {}, consts or {}, {}, params, slot_values=list(slot_values))
        return [
            self._apply_bbox(self._normalize_term(val, term), term)
            for term, val in zip(self.terms, b.energy_values)
        ]

    def unknown_slot_ids(self) -> List[int]:
        return [i for i, s in enumerate(self.registry.slots) if s.is_unknown]


# ---------------------------------------------------------------------------
# compile_spec
# ---------------------------------------------------------------------------

_COMPILE_CACHE: "OrderedDict" = OrderedDict()
_COMPILE_CACHE_MAX = 128


def compile_spec(spec_fn: Callable, dim_sizes: Dict[str, int], dtype) -> CompiledProblem:
    """Trace a spec function and classify its residual terms, memoized per
    (spec function, dims, dtype) in a bounded LRU: tracing is deterministic
    and CompiledProblem carries no binding state."""
    try:
        key = (spec_fn, tuple(sorted(dim_sizes.items())), str(dtype))
        hit = _COMPILE_CACHE.get(key)
    except TypeError:  # spec_fn not hashable
        key, hit = None, None
    if hit is not None:
        _COMPILE_CACHE.move_to_end(key)
        return hit
    compiled = _compile_spec_uncached(spec_fn, dim_sizes, dtype)
    if key is not None:
        _COMPILE_CACHE[key] = compiled
        while len(_COMPILE_CACHE) > _COMPILE_CACHE_MAX:
            _COMPILE_CACHE.popitem(last=False)
    return compiled


def _compile_spec_uncached(spec_fn, dim_sizes, dtype) -> CompiledProblem:
    registry = SpecRegistry()
    meta = torch.device("meta")

    # Pass 1: discovery on the meta device (no real compute).
    b = SpecBuilder("discover", dim_sizes, dtype, registry=registry, device=meta)
    with b:
        spec_fn(b)
    if not registry.energy_terms:
        raise SpecError("spec defines no Energy terms")
    registry.frozen = True

    # Pass 2: make_fx graph of the slot-form function, for dependence slicing.
    slot_vals = []
    for s in registry.slots:
        if s.kind == "gimg":
            shape = (registry.dummy_edge_count, s.channels)
        elif s.kind in ("img", "cimg", "cgrad"):
            shape = s.ispace.shape(dim_sizes) + (s.channels,)
        else:
            shape = s.ispace.shape(dim_sizes) + (1,)
        slot_vals.append(torch.ones(shape, dtype=dtype, device=meta))

    def _slot_run(*slot_values):
        sb = SpecBuilder(
            "slots", dim_sizes, dtype, registry=registry,
            bindings={"params": {}}, slot_values=list(slot_values), device=meta,
        )
        with sb:
            spec_fn(sb)
        return tuple(sb.energy_values) + tuple(sb.exclude_values)

    deps = _graph_output_deps(make_fx(_slot_run)(*slot_vals))
    outs = _slot_run(*slot_vals)
    n_terms = len(registry.energy_terms)
    term_shapes = [tuple(v.shape) for v in outs[:n_terms]]

    for term, dset, shape in zip(registry.energy_terms, deps[:n_terms], term_shapes):
        slots = [registry.slots[i] for i in sorted(dset)]
        term.slot_ids = tuple(sorted(dset))
        graphs = sorted({s.graph for s in slots if s.kind == "gimg"})
        ispaces = []
        for s in slots:
            if s.kind in ("img", "cimg") and s.ispace not in ispaces:
                ispaces.append(s.ispace)
        term.uses_bounds = any(s.kind == "bounds" and not s.internal for s in slots)
        if graphs:
            if len(graphs) > 1 or ispaces:
                raise SpecError(
                    f"energy term {term.index}: residual contains image reads "
                    f"from multiple domains (reference o.t:1916)"
                )
            term.domain = ("graph", graphs[0])
        else:
            if len(ispaces) != 1:
                if not ispaces:
                    raise SpecError(
                        f"energy term {term.index}: residual must actually use "
                        "some image (reference o.t:1922)"
                    )
                raise SpecError(
                    f"energy term {term.index}: residual mixes index spaces {ispaces}"
                )
            term.domain = ("centered", ispaces[0])
            nd = ispaces[0].ndim
            bmin, bmax = [0] * nd, [0] * nd
            for s in slots:
                if s.kind in ("img", "cimg"):
                    for d in range(nd):
                        bmin[d] = min(bmin[d], s.offset[d])
                        bmax[d] = max(bmax[d], s.offset[d])
            term.bbox = (tuple(bmin), tuple(bmax))
        nd_sp = term.domain[1].ndim if term.domain[0] == "centered" else 1
        term.channels = 1 if len(shape) == nd_sp else int(shape[-1])

    for et, dset in zip(registry.exclude_terms, deps[n_terms:]):
        et.slot_ids = tuple(sorted(dset))
        ispaces = []
        for i in sorted(dset):
            s = registry.slots[i]
            if s.kind in ("img", "bounds") and s.ispace not in ispaces:
                ispaces.append(s.ispace)
        if len(ispaces) != 1:
            raise SpecError(
                f"Exclude() expression must read exactly one grid index space, got {ispaces}"
            )
        et.ispace = ispaces[0]

    return CompiledProblem(spec_fn, registry, dict(dim_sizes), dtype)
