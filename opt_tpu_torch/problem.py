"""User-facing Problem / Plan lifecycle.

PyTorch counterpart of ``opt_tpu/problem.py``, mirroring the reference C API
(Opt_ProblemDefine / Opt_ProblemPlan / Opt_ProblemInit / Opt_ProblemStep /
Opt_ProblemSolve / Opt_ProblemCurrentCost / Opt_SetSolverParameter) as an
object API. Inputs and outputs keep the JAX package's [*dom, C] layout.

The plan runs on the card: ``plan(...)`` places every input and all solver
state on CUDA and raises where CUDA is absent. A caller who wants the CPU
asks for it with ``plan(..., device="cpu")``; the port never falls back to
the CPU by itself.

``plan(..., mesh=make_mesh(...))`` (``parallel/mesh.py``) shards a 2-D grid
problem as spatial tiles over a 2-D mesh of ``torch.distributed`` ranks:
every rank plans, binds the same global inputs and solves together with the
others; each compiles the problem at the dims of its extended region (its
tile plus the stencil's reach), and ``solve`` returns the global unknowns
on every rank. A graph problem on a mesh splits each vertex space of its
graph slots into owner blocks and each graph's edges into edge blocks: a
rank compiles the problem at its blocks' sizes, binds its part of the
global inputs with the exchange tables of the reads it makes of other
ranks' rows (``Plan._augment_mesh``), and ``solve`` returns the global
unknowns on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import sys
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .compile import CompiledProblem, compile_spec
from .ops import fused_cg, graph_ops
from .parallel.mesh import (
    GraphShardingRules,
    ShardingRules,
    build_halo_tables,
    grid_reach,
    map_stacked_rows_device_major,
    owner_edge_order,
)
from .solver.gauss_newton import GaussNewtonSolver
from .solver.params import InitializationParameters, normalize_solver_params
from .spec import UNKNOWN, SpecError, whole_image_key
from .utils.logging import log_debug, log_solver, verbosity
from .utils.timer import SolveTimer, report_solve_timing

_KIND_ALIASES = {
    "gaussnewtongpu": False,
    "gauss_newton": False,
    "gn": False,
    "lmgpu": True,
    "lm": True,
    "levenberg_marquardt": True,
}


def _uses_lambda(kind: str) -> bool:
    k = kind.lower()
    if k not in _KIND_ALIASES:
        raise ValueError(
            f"unknown solver kind {kind!r}; expected gaussNewtonGPU or LMGPU "
            "(reference o.t:122)"
        )
    return _KIND_ALIASES[k]


# DIA coverage a vertex numbering must reach for the graph CG operator to
# take per-offset fields (the JAX package's gate, opt_tpu/problem.py:520)
DIA_MIN_COVERAGE = 0.98
DIA_MAX_OFFSETS = 32
_TABLE_CACHE_MAX = 8
# under dynamic_topology, the topologies whose tables are kept: per-frame
# topologies would otherwise grow the cache without bound
# (opt_tpu/problem.py:757)
_DYNAMIC_TABLE_CACHE_MAX = 32
_DYNAMIC_MIN_EDGES = 8  # the smallest edge bucket (opt_tpu/problem.py:284)
# the numbers of the plan reports that set_verbosity(3) writes in this process
_PLAN_REPORTS = itertools.count()


def graph_group_tables(idxs, names, n: int, device, dtype, max_offsets: int,
                       dynamic: bool = False) -> Dict[str, Any]:
    """The host-built tables of one (graph, vertex-space) group, placed on
    ``device``: the part of the JAX package's ``Plan._augment_incidence``
    (opt_tpu/problem.py:354-762) that a single card needs.

    * ``inc`` [N, D]: the combined incidence table (stacked edge-row ids,
      sentinel m·E), through which JᵀF and the same-vertex blocks S gather;
      under ``dynamic`` (a plan for changing topologies) D is rounded up to
      a power of two, so that the topologies of one edge bucket mostly
      share its shape;
    * ``dia``: [(offset, mask [N, D, m-1])] when the numbering puts at
      least ``DIA_MIN_COVERAGE`` of the cross reads at up to
      ``DIA_MAX_OFFSETS`` vertex-id offsets (grid-class meshes), else [].
      At most ``max_offsets`` of them (what the CG kernel's triple table
      holds) become offsets, the most frequent first; the reads of the
      others join the remainder. Under ``dynamic`` there is no DIA split
      (the JAX package's, whose offsets are topology-specialized): every
      cross read goes to the remainder;
    * ``rem_pos`` [N, Dm, K] and ``rem_cross`` [N, Dm]: the cross reads no
      offset covers (all of them without DIA), duplicate (v, u) reads
      merged (``dedup_reads``), or None when there are none;
    * ``csr``: the remainder as the kernel's destination-sorted CSR
      (rowptr [N+1], col [nnz], src [nnz] flat [N·Dm] positions, row
      [nnz]), and ``partitions``, the graph route's vertex partitions of
      this topology, built at its first launch and kept for every later
      step (``fused_cg.GraphPartitions``);
    * ``empty_csr``, for a group without the remainder (None with it): the
      empty CSR the graph route partitions a remainder-less operator by
      (rowptr [N+1] all zero, col [0]), with its own ``partitions``.
    """
    inc, dia, rem = _group_tables_np(idxs, names, n, max_offsets, dynamic)
    out = {
        "names": list(names), "n": n,
        "inc": torch.as_tensor(inc, dtype=torch.int64).to(device),
        "dia": [],
        "rem_pos": None, "rem_cross": None, "csr": None, "empty_csr": None,
    }
    if dia is not None:
        offsets, masks = dia
        out["dia"] = [
            (int(off), torch.as_tensor(masks[k]).to(device=device, dtype=dtype))
            for k, off in enumerate(offsets)
        ]
    if rem is not None:
        pos_k, cross2 = rem
        rowptr, col, src = graph_ops.ell_to_csr(cross2, n)

        def as_dev(a, dt=torch.int64):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        out["rem_pos"] = as_dev(pos_k)
        out["rem_cross"] = as_dev(cross2)
        out["csr"] = {
            "rowptr": as_dev(rowptr, torch.int32), "col": as_dev(col, torch.int32),
            "src": as_dev(src), "row": as_dev(src // cross2.shape[1]),
            "partitions": fused_cg.GraphPartitions(),
        }
    else:
        out["empty_csr"] = {
            "rowptr": torch.zeros(n + 1, dtype=torch.int32, device=device),
            "col": torch.zeros(0, dtype=torch.int32, device=device),
            "partitions": fused_cg.GraphPartitions(),
        }
    return out


def _group_tables_np(idxs, names, n: int, max_offsets: int, dynamic: bool):
    """The host (numpy) tables of one group, over all its vertices and
    edges: (inc [N, D], dia (offsets, masks [k, N, D, m-1]) or None, rem
    (pos_k [N, Dm, K], cross [N, Dm]) or None), as
    :func:`graph_group_tables` describes them."""
    idx_list = [idxs[k] for k in names]
    inc = graph_ops.combined_incidence_table(idx_list, n)
    if dynamic:
        inc = graph_ops.pad_table_width(inc, graph_ops.bucket_size(inc.shape[1]),
                                        len(names) * int(idx_list[0].shape[0]))
    cross = graph_ops.combined_cross_table(idx_list, n, inc=inc)
    _n, dd, mm1 = cross.shape
    dia, rem = None, None
    if mm1:
        probe = None if dynamic else graph_ops.dia_split(cross, n, max_offsets=DIA_MAX_OFFSETS)
        total = int((cross < n).sum())
        cov = 0.0
        if probe is not None and total:
            cov = 1.0 - int((probe[3] < n).sum()) / total
        if cov >= DIA_MIN_COVERAGE and len(probe[0]) > max_offsets:
            probe = None
            if max_offsets > 0:
                probe = graph_ops.dia_split(cross, n, max_offsets=max_offsets, min_coverage=0.0)
        if cov >= DIA_MIN_COVERAGE and probe is not None:
            dia = probe
            rem = (probe[2][..., None], probe[3])
        else:
            flat_c = cross.reshape(n, dd * mm1)
            flat_p = np.where(
                flat_c < n, np.broadcast_to(np.arange(dd * mm1, dtype=np.int32), flat_c.shape),
                dd * mm1,
            ).astype(np.int32)
            rem = (flat_p[..., None], flat_c)
        ded = graph_ops.dedup_reads(rem[0][:, :, 0], rem[1], n, dd * mm1)
        if ded is not None:
            rem = ded
        if not (rem[1] < n).any():
            rem = None
    return inc, None if dia is None else dia[:2], rem


def mesh_group_tables(idxs, names, n: int, device, dtype, max_offsets: int, rules,
                      isp) -> Dict[str, Any]:
    """A group's tables for this rank of a graph mesh: the single-device
    tables (:func:`_group_tables_np`, built over the whole graph on the
    host) cut to the rank's owner block of vertices, with the exchanges
    that replace their reads of other ranks' rows (the mesh branch of the
    JAX package's ``_augment_incidence``, opt_tpu/problem.py:652-746):

    * ``inc_send`` [ndev, M], ``inc_loc`` [B, D]: the incidence gather of
      the stacked per-edge rows through the rank-major row order
      (``map_stacked_rows_device_major``), for the assembly and JᵀF;
    * ``x_send``, ``x_loc`` [B, n_dia + Dm]: the CG operator's cross reads
      of p, one exchange for all of them: first each DIA offset's read
      v + off (the zero row past the graph's ends), then the remainder's
      ``rem_cross``; None where the group has none;
    * ``dia``: [(offset, mask [B, D, m-1])], ``rem_pos`` [B, Dm, K]: the
      rank's rows of the single-device tables, read locally.
    """
    inc, dia, rem = _group_tables_np(idxs, names, n, max_offsets, False)
    mesh = rules.mesh
    ndev, rank, m = mesh.size, mesh.rank, len(names)
    E = int(idxs[names[0]].shape[0])
    vb = rules.space_bounds[isp]
    v0, v1 = vb[rank]
    eb = rules.edge_bounds(E)
    mapped = map_stacked_rows_device_major(inc, E, m, ndev, eb)
    # a rank's source block: the m stacked rows of each of its edges
    h_inc = build_halo_tables(mapped, m * E, ndev, bounds=([(m * a, m * b) for a, b in eb], vb))

    def dev(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    out = {"names": list(names), "n": v1 - v0, "rows": (v0, v1),
           "inc_send": dev(h_inc["send"][rank]), "inc_loc": dev(h_inc["loc"][v0:v1]),
           "inc_M": h_inc["M"], "dia": [], "rem_pos": None,
           "x_send": None, "x_loc": None, "x_M": None, "n_dia": 0}
    cols = []
    if dia is not None:
        offsets, masks = dia
        v = np.arange(n, dtype=np.int64)
        for k, off in enumerate(offsets):
            u = v + int(off)
            cols.append(np.where((u >= 0) & (u < n), u, n)[:, None])
            out["dia"].append((int(off), dev(masks[k][v0:v1], dtype)))
        out["n_dia"] = len(offsets)
    if rem is not None:
        out["rem_pos"] = dev(rem[0][v0:v1])
        cols.append(rem[1])
    if cols:
        h_x = build_halo_tables(np.concatenate(cols, axis=1), n, ndev, bounds=(vb, vb))
        out.update(x_send=dev(h_x["send"][rank]), x_loc=dev(h_x["loc"][v0:v1]), x_M=h_x["M"])
    return out


def _refuse_graph_mesh(compiled: CompiledProblem, dynamic_topology: bool) -> None:
    """What a graph mesh cannot take yet raises, naming its ROADMAP.md item:
    it splits the 1-D vertex spaces of the graph slots into owner blocks,
    its unknowns on any of them, for one topology."""
    reg = compiled.registry
    if dynamic_topology:
        raise _mesh_not_ported("dynamic_topology=True")
    grids = sorted({repr(d.ispace) for d in reg.images.values() if d.ispace.ndim != 1})
    if grids:
        raise NotImplementedError(
            f"a mesh on a spec with both a grid ({', '.join(grids)}) and a graph is not "
            "ported yet: a rank would need a tile and owner blocks together (ROADMAP.md "
            "queue 1 item 8c)"
        )
    reads = sorted(k for k, v in reg.reads.items() if v)
    if reads:
        raise NotImplementedError(
            f"a mesh on a spec that reads {', '.join(reads)} is not ported yet (ROADMAP.md "
            "queue 1 item 8d)"
        )
    spaces = {isp for g in reg.graphs.values() for isp in g.slots.values()}
    u_spaces = {reg.images[u].ispace for u in reg.unknown_names}
    if not u_spaces <= spaces:
        raise NotImplementedError(
            f"a graph mesh splits the vertex spaces of the graph slots, this spec's unknowns "
            f"are on {sorted(map(repr, u_spaces - spaces))} too, which no slot points into "
            "(ROADMAP.md queue 1 item 8c)"
        )
    for s in reg.slots:
        if s.kind in ("img", "bounds") and any(int(o) for o in s.offset):
            raise NotImplementedError(
                f"a graph mesh reads 1-D images at their own vertex; {s.image or 'InBounds'} "
                f"at offset {s.offset} is a stencil on a vertex space, which is not ported "
                "yet: an owner block has no halo along its space (ROADMAP.md queue 1 "
                "item 8c)"
            )
        if s.kind != "gimg":
            continue
        if reg.images[s.image].alias is not None:
            raise _mesh_not_ported(f"the alias image {s.image!r} read at a graph slot")


def _refuse_under_mesh(compiled: CompiledProblem, dynamic_topology: bool = False) -> None:
    """What a mesh cannot take yet raises, naming its ROADMAP.md item: the
    sharded plan tiles one 2-D or 3-D grid index space along its first two
    axes, or splits a graph's vertex spaces into owner blocks, in float32 or
    float64."""
    reg = compiled.registry
    if reg.graphs:
        _refuse_graph_mesh(compiled, dynamic_topology)
        return
    spaces = {d.ispace for d in reg.images.values()}
    if len(spaces) != 1:
        raise NotImplementedError(
            f"a mesh tiles one grid index space, this spec has {sorted(map(repr, spaces))}: "
            "a grid spec over several index spaces is not ported yet (ROADMAP.md queue 1 "
            "item 8c)"
        )
    (isp,) = spaces
    if isp.ndim not in (2, 3) or len(set(isp.dims)) != isp.ndim:
        raise NotImplementedError(
            f"a mesh tiles a 2-D or 3-D grid of distinct dims, this spec's is {isp!r} "
            "(ROADMAP.md queue 1 item 8c)"
        )


def _mesh_not_ported(what: str):
    return NotImplementedError(f"{what} on a mesh is not ported yet (ROADMAP.md queue 1 item 8e)")


def _port_only_on_mesh(what: str):
    return NotImplementedError(
        f"{what} is a port-only helper of the single-device solve (the JAX package has no "
        "counterpart): it takes no mesh")


def resolve_device(device) -> torch.device:
    """The plan's device: CPU or CUDA, checked, never chosen implicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


@dataclasses.dataclass
class BatchedSolveResult:
    """Results of a batched solve: every field has a leading batch axis."""

    unknowns: Dict[str, torch.Tensor]
    final_costs: np.ndarray  # [B]
    costs: np.ndarray  # [B, nIterations] (NaN-padded past each instance's exit)
    num_iterations: np.ndarray  # [B]
    num_linear_iterations: np.ndarray  # [B]
    wall_time_s: float = 0.0


@dataclasses.dataclass
class SolveResult:
    unknowns: Dict[str, torch.Tensor]
    final_cost: float
    costs: List[float]  # cost after each nonlinear iteration
    num_iterations: int
    wall_time_s: float
    num_linear_iterations: int = 0  # PCG iterations actually executed
    fused_fallback: Optional[str] = None  # Plan.fused_fallback after the solve


class Problem:
    """A problem definition: a spec function (Opt_ProblemDefine analogue)."""

    def __init__(self, spec_fn, kind: str = "gaussNewtonGPU", name: Optional[str] = None):
        self.spec_fn = spec_fn
        self.kind = kind
        self.name = name or getattr(spec_fn, "__name__", "problem")

    def plan(
        self,
        dims: Dict[str, int],
        kind: Optional[str] = None,
        double_precision: bool = False,
        init_params: Optional[InitializationParameters] = None,
        mesh=None,
        dynamic_topology: Optional[bool] = None,
        device="cuda",
        **solver_params,
    ) -> "Plan":
        """Compile for concrete sizes on ``device``, the card unless the
        caller asks for the CPU (Opt_ProblemPlan). ``mesh``
        (``parallel.make_mesh``) of several ranks shards a 2-D grid spec,
        or a graph spec by owner blocks, over them: this rank's plan, on the
        mesh's device, which must be of the kind ``device`` names; a 1x1
        mesh is the single-device plan.
        A mesh on what it cannot take yet raises ``NotImplementedError``
        naming its ROADMAP.md item. ``dynamic_topology=True`` plans for
        graphs whose edges change from solve to solve (a frame's topology
        in nonrigid tracking): see ``Plan._pad_dynamic``."""
        if dynamic_topology is not None:
            init_params = dataclasses.replace(
                init_params or InitializationParameters(),
                dynamic_topology=bool(dynamic_topology),
            )
        dev = resolve_device(device)
        dtype = torch.float64 if double_precision else torch.float32
        compiled = compile_spec(self.spec_fn, dims, dtype)
        rules, plan_on = None, None
        if mesh is not None:
            _refuse_under_mesh(compiled,
                               bool(init_params is not None and init_params.dynamic_topology))
        if mesh is not None and mesh.size > 1:
            if mesh.device.type != dev.type:
                raise ValueError(f"the mesh's device is {mesh.device}, the plan asked for {dev}")
            dev = mesh.device
            if compiled.registry.graphs:
                # the rank's problem at its owner blocks' sizes, its own copy
                # holding the rules; the assembly is planned at the global dims
                rules, plan_on = GraphShardingRules(mesh, compiled), compiled
                compiled = dataclasses.replace(
                    compile_spec(self.spec_fn, dict(dims, **rules.local_dims), dtype),
                    graph_rules=rules)
            else:
                # the rank's problem at its region's sizes, its own copy
                # holding the region's global origin (Index reads it); the
                # assembly is planned on the cached one
                (isp,) = {d.ispace for d in compiled.registry.images.values()}
                rules = ShardingRules(mesh, isp.shape(compiled.dim_sizes), grid_reach(compiled))
                region = {d.name: n for d, n in zip(isp.dims, rules.region_shape)}
                plan_on = compile_spec(self.spec_fn, dict(dims, **region), dtype)
                compiled = dataclasses.replace(plan_on, grid_origin=rules.origin)
        return Plan(self, compiled, kind or self.kind, init_params, solver_params, dev, rules,
                    dims, plan_on)


class Plan:
    def __init__(self, problem, compiled: CompiledProblem, kind, init_params,
                 solver_params, device, rules=None, dims=None, plan_on=None):
        self.problem = problem
        self.compiled = compiled
        # the problem's dims (under a mesh the global grid's; compiled is
        # the region's)
        self.dims = dict(compiled.dim_sizes if dims is None else dims)
        self.kind = kind
        self.device = device
        self.uses_lambda = _uses_lambda(kind)
        # under a mesh: this rank's tile and region (compiled is the region's),
        # or on a graph its owner blocks (compiled is the blocks')
        self.rules = rules
        self.solver = GaussNewtonSolver(compiled, self.uses_lambda, init_params, rules,
                                        plan_on=plan_on)
        self.solver_params = normalize_solver_params(solver_params)
        self.dynamic_topology = bool(self.solver.ip.dynamic_topology)
        self._state = None
        self._bound = None  # (consts, graphs, params)
        self._fused_validated = False
        # the last timed solve's rows ({row: utils.timer.PhaseStat}) and the
        # CG instances it ran ({name: launches}), for report_solve_timing
        self._timing_phases = None
        self._timing_instances = None
        self._plan_reported = False  # set_verbosity(3) wrote this plan's report

    @property
    def fused_fallback(self) -> Optional[str]:
        """None while the fused CG loop runs every step; "validation" after
        _validate_fused dropped this plan to the composed operator;
        "no_kernel" once a float32 step's assembled operator had no form the
        fused kernel takes and the step ran the eager loop."""
        return self.solver.fused_fallback

    def _validate_fused(self, unknowns, consts, graphs, params) -> None:
        """First-bind check of the assembled JᵀJ against the composed
        Jᵀ(J·p) at the real inputs; on mismatch the plan drops to the
        composed operator, says so on stderr whatever the verbosity, and
        sets ``fused_fallback``."""
        if self._fused_validated or self.solver._stencil_plan is None:
            return
        self._fused_validated = True
        if not self.solver.ip.validate_fused_jtj:
            return
        ok = self.solver.validate_assembly(unknowns, consts, graphs, params)
        if self.rules is not None:
            # every rank checks its region; a mesh has no fallback
            if not self.rules.mesh.all_true(ok):
                raise RuntimeError(
                    "opt_tpu_torch: the assembled JtJ failed validation against the composed "
                    "operator on a rank's region; a sharded plan has no fallback"
                )
            return
        if not ok:
            print(
                "opt_tpu_torch: the assembled JtJ failed validation against the "
                "composed operator at the real inputs; this plan falls back to "
                "the composed operator and the eager CG loop (no fused kernel)",
                file=sys.stderr,
            )
            self.solver._stencil_plan = None
            self.solver.fused_fallback = "validation"

    def _note_unknown_sentinels(self, inputs) -> None:
        """Record ±inf invalid-markers in unknown inputs so results can
        restore them (bind time clamps them to finite sentinels; excluded
        rows never update)."""
        memo = self.__dict__.setdefault("_sentinel_memo", {})
        found = {}
        for name in self.compiled.unknown_names:
            v = inputs.get(name)
            if v is None:
                continue
            hit = memo.get(name)
            if hit is not None and hit[0] is v:
                if hit[1] is not None:
                    found[name] = hit[1]
                continue
            a = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            orig = None
            if a.is_floating_point() and bool(torch.isinf(a).any()):
                if a.dim() == self.compiled.registry.images[name].ispace.ndim:
                    a = a[..., None]
                orig = a.to(device=self.device, dtype=self.compiled.dtype)
                found[name] = orig
            memo[name] = (v, orig)
        self._unk_sentinels = found

    def _restore_sentinels(self, X):
        masks = self.__dict__.get("_unk_sentinels") or {}
        if not masks:
            return X
        out = dict(X)
        for name, orig in masks.items():
            out[name] = torch.where(torch.isinf(orig), orig, out[name])
        return out

    def _normalize_and_place(self, inputs):
        """Convert and place inputs on the plan's device, cached PER LEAF by
        object identity: only changed leaves convert again (and only a
        changed graph rebuilds its tables). Callers that mutate an input in
        place must pass a fresh array instead."""
        self._note_unknown_sentinels(inputs)
        cache = self.__dict__.get("_leaf_cache")
        buckets = self.__dict__.get("_leaf_buckets")
        if cache is None or set(cache) != set(inputs):
            unknowns, consts, graphs, params = self.compiled.normalize_inputs(
                self._local_inputs(inputs), device=self.device
            )
            graphs = self._augment_incidence(graphs)
            self._leaf_cache = dict(inputs)
            self._leaf_buckets = (unknowns, consts, graphs, params)
            return (dict(unknowns), dict(consts), dict(graphs), dict(params))
        changed = {k: v for k, v in inputs.items() if cache[k] is not v}
        if changed:
            u, c, g, p = self.compiled.normalize_inputs(
                self._local_inputs(changed), device=self.device, partial=True
            )
            g = self._augment_incidence(g)
            for bucket, new in zip(buckets, (u, c, g, p)):
                bucket.update(new)
            cache.update(changed)
        return tuple(dict(b) for b in buckets)

    def _pad_dynamic(self, graphs):
        """Each graph's edge axis padded to its power-of-two bucket (at
        least 8 edges), as the JAX package pads it (opt_tpu/problem.py:260-315):
        the padded edges take in-bounds vertex ids round-robin, so that no
        vertex's incidence width grows by more than one a lap, and a zero
        in the ``valid`` mask, so that they add nothing to J, JᵀF, the
        diagonal, the assembled blocks or the cost (compile.py's exact
        edge-mask semantics). The mask is always there, the caller's
        (if any) on the first edges, ones else."""
        out = {}
        for gname, slots in graphs.items():
            gdecl = self.compiled.registry.graphs[gname]
            names = sorted(gdecl.slots)
            E = int(slots[names[0]].shape[0])
            Eb = graph_ops.bucket_size(E, minimum=_DYNAMIC_MIN_EDGES)
            gd = {}
            for s in names:
                idx = slots[s]
                if Eb > E:
                    n = int(np.prod(gdecl.slots[s].shape(self.compiled.dim_sizes)))
                    pad = torch.arange(Eb - E, device=idx.device) % n
                    idx = torch.cat([idx, pad.to(idx.dtype)])
                gd[s] = idx
            valid = slots.get("valid")
            if valid is None:
                valid = torch.ones((E, 1), dtype=self.compiled.dtype, device=self.device)
            gd["valid"] = torch.cat([valid, valid.new_zeros((Eb - E, valid.shape[1]))])
            out[gname] = gd
        return out

    def _augment_incidence(self, graphs):
        """Attach each graph's group tables (``graph_group_tables``) under
        ``"__groups__"``: {group key: tables}, and, where its operator couples
        slots of different vertex spaces, their per-slot ELL tables under
        ``"__ell__"`` (``_ell_tables``). The tables depend only on the index
        data: they are cached by a hash of it, both kinds in one entry (a few
        topologies, least recently used first out; 32 under
        ``dynamic_topology``, whose graphs are first padded by
        ``_pad_dynamic``), so a new array with the same edges builds nothing.
        Each cached remainder CSR carries its own ``fused_cg.GraphPartitions``
        with its device tables: they go with its topology's entry."""
        if not graphs:
            return graphs
        if self.dynamic_topology:
            graphs = self._pad_dynamic(graphs)
        if self._graph_mesh:
            return self._augment_mesh(graphs)
        cap = _DYNAMIC_TABLE_CACHE_MAX if self.dynamic_topology else _TABLE_CACHE_MAX
        cache = self.__dict__.setdefault("_inc_cache", OrderedDict())
        dt = self.compiled.dtype
        max_off = DIA_MAX_OFFSETS
        if self.solver._stencil_plan is not None:
            max_off = min(max_off, fused_cg.graph_dia_offset_cap(
                self.compiled, self.solver._stencil_plan))
        out = {}
        for gname, slots in graphs.items():
            gdecl = self.compiled.registry.graphs[gname]
            names = sorted(gdecl.slots)
            idxs = {s: slots[s].detach().cpu().numpy().astype(np.int64) for s in names}
            for s in names:
                n_s = int(np.prod(gdecl.slots[s].shape(self.compiled.dim_sizes)))
                if idxs[s].size and (idxs[s].min() < 0 or idxs[s].max() >= n_s):
                    raise ValueError(f"graph {gname!r}: slot {s!r} indexes outside [0, {n_s})")
            key = (gname, hashlib.sha1(b"".join(idxs[s].tobytes() for s in names)).hexdigest())
            entry = cache.pop(key, None)
            if entry is None:
                sgroups = graph_ops.slot_groups(gdecl, self.compiled.dim_sizes)
                entry = {
                    "groups": {
                        gk: graph_group_tables(idxs, gnames, n, self.device, dt, max_off,
                                               dynamic=self.dynamic_topology)
                        for gk, gnames, n in sgroups
                    },
                    "ell": self._ell_tables(gname, idxs, sgroups),
                }
            cache[key] = entry
            while len(cache) > cap:
                cache.popitem(last=False)
            out[gname] = dict(slots, __groups__=entry["groups"])
            if entry["ell"] is not None:
                out[gname]["__ell__"] = entry["ell"]
        return out

    @property
    def _graph_mesh(self) -> bool:
        return getattr(self.rules, "kind", None) == "graph"

    def _reorder_edges(self, graphs):
        """Each graph's edges (every slot and ``valid``) in the owner order:
        stably sorted by the owner block of their first slot's vertex
        (``parallel.mesh.owner_edge_order``), so that a rank's edge block
        mostly accumulates into the vertices it owns, which shrinks the
        assembly's incidence exchange toward the partition boundary
        (``InitializationParameters(edge_reorder="owner")``, the JAX
        package's ``Plan._reorder_edges``, opt_tpu/problem.py:317-352). The
        energy is a sum over edges: only its float order changes."""
        ndev = self.rules.mesh.size
        out = {}
        for gname, slots in graphs.items():
            gdecl = self.compiled.registry.graphs[gname]
            first = sorted(gdecl.slots)[0]
            n0 = int(np.prod(gdecl.slots[first].shape(self.dims)))
            perm = owner_edge_order(slots[first].detach().cpu().numpy(), n0, ndev)
            idx = torch.as_tensor(perm, device=slots[first].device)
            out[gname] = {k: v[idx] for k, v in slots.items()}
        return out

    def _augment_mesh(self, graphs):
        """:meth:`_augment_incidence` on a graph mesh: each graph becomes
        this rank's edge block of its slots (global vertex ids) and of
        ``valid``, with ``"__groups__"``: {group key: this rank's
        :func:`mesh_group_tables`}, ``"__slot_halo__"``: {slot: {send, loc
        [E_d, 1], M}}, the exchange of the per-edge reads at that slot (the
        JAX package's per-slot ``__halo_send____slot_<s>`` tables),
        ``"__split_read__"``: {(slot, space): the same}, for a split image on
        another vertex space read at that slot, built against the bounds of
        the space whose rows are read, ``"__ell__"`` where the operator couples
        slots of different vertex spaces (:meth:`_mesh_ell_tables`), and
        ``"__edges__"``: the block's [start, stop) of the edge ids. The
        edges are put in the owner order first under
        ``edge_reorder="owner"``. The tables are cached by a hash of the
        (reordered) index data."""
        rules = self.rules
        if self.solver.ip.edge_reorder == "owner":
            graphs = self._reorder_edges(graphs)
        cache = self.__dict__.setdefault("_inc_cache", OrderedDict())
        max_off = DIA_MAX_OFFSETS
        if self.solver._stencil_plan is not None:
            max_off = min(max_off, fused_cg.graph_dia_offset_cap(
                self.compiled, self.solver._stencil_plan))
        rank = rules.mesh.rank
        out = {}
        for gname, slots in graphs.items():
            gdecl = self.compiled.registry.graphs[gname]
            names = sorted(gdecl.slots)
            idxs = {s: slots[s].detach().cpu().numpy().astype(np.int64) for s in names}
            nvert = {s: int(np.prod(gdecl.slots[s].shape(self.dims))) for s in names}
            for s in names:
                if idxs[s].size and (idxs[s].min() < 0 or idxs[s].max() >= nvert[s]):
                    raise ValueError(f"graph {gname!r}: slot {s!r} indexes outside "
                                     f"[0, {nvert[s]})")
            E = int(idxs[names[0]].shape[0])
            key = (gname, hashlib.sha1(b"".join(idxs[s].tobytes() for s in names)).hexdigest())
            entry = cache.pop(key, None)
            if entry is None:
                eb = rules.edge_bounds(E)
                e0, e1 = eb[rank]
                halo = {s: self._rank_tables(idxs[s][:, None], nvert[s],
                                             rules.space_bounds[gdecl.slots[s]], eb)
                        for s in names}
                # a split image read at a slot into another space
                split = {(s, sk): self._rank_tables(idxs[s][:, None], rules.space_size(isp),
                                                    rules.space_bounds[isp], eb)
                         for (s, sk), isp in rules.split_reads.get(gname, {}).items()}
                sgroups = graph_ops.slot_groups(gdecl, self.dims)
                entry = {
                    "groups": {
                        gk: mesh_group_tables(idxs, gnames, n, self.device, self.compiled.dtype,
                                              max_off, rules, gdecl.slots[gnames[0]])
                        for gk, gnames, n in sgroups
                    },
                    "slot_halo": halo, "split_read": split, "edges": (e0, e1),
                    "ell": self._mesh_ell_tables(gname, idxs, sgroups, eb),
                }
            cache[key] = entry
            while len(cache) > _TABLE_CACHE_MAX:
                cache.popitem(last=False)
            e0, e1 = entry["edges"]
            out[gname] = {k: v[e0:e1] for k, v in slots.items()}
            out[gname].update(__groups__=entry["groups"], __slot_halo__=entry["slot_halo"],
                              __split_read__=entry["split_read"], __edges__=entry["edges"])
            if entry["ell"] is not None:
                out[gname]["__ell__"] = entry["ell"]
        return out

    def _coupled_slot_pairs(self, gname, sgroups):
        """The (k_out, k_in) slot pairs of graph ``gname`` whose couplings the
        assembly plan has across vertex spaces (slots of different groups)."""
        plan = self.solver._stencil_plan
        if plan is None:
            return []
        group_of = {k: gk for gk, gnames, _n in sgroups for k in gnames}
        return sorted({(key[2], key[4]) for key in plan.g_spec
                       if key[0] == gname and group_of[key[2]] != group_of[key[4]]})

    def _mesh_ell_tables(self, gname, idxs, sgroups, eb):
        """:meth:`_ell_tables` on a graph mesh, in owner-block form: the
        global ELL tables (``graph_ops.ell_tables``) cut to this rank's block
        of each output slot's space, each with the exchange that replaces
        its reads of other ranks' rows: {"inc": {k_out: {send, loc [B_out,
        D], M}}, the blocks W of k_out's incident edges from the ranks whose
        edge blocks assembled them; "ell": {(k_out, k_in): {send, loc
        [B_out, D], M}}, the in-space's p at each incident edge's k_in
        vertex}, or None where the assembly plan has no such coupling."""
        pairs = self._coupled_slot_pairs(gname, sgroups)
        if not pairs:
            return None
        rules, gdecl = self.rules, self.compiled.registry.graphs[gname]
        slots = sorted({k for pair in pairs for k in pair})
        nvert = {k: rules.space_size(gdecl.slots[k]) for k in slots}
        inc, ell = graph_ops.ell_tables({k: idxs[k] for k in slots}, nvert)
        E = int(idxs[slots[0]].shape[0])
        bounds = {k: rules.space_bounds[gdecl.slots[k]] for k in slots}
        return {"inc": {ko: self._rank_tables(inc[ko], E, eb, bounds[ko])
                        for ko in sorted({ko for ko, _ki in pairs})},
                "ell": {(ko, ki): self._rank_tables(ell[(ko, ki)], nvert[ki], bounds[ki],
                                                    bounds[ko])
                        for ko, ki in pairs}}

    def _rank_tables(self, cross, n: int, src, req) -> Dict[str, Any]:
        """This rank's part of ``build_halo_tables(cross, n, bounds=(src,
        req))`` on the plan's device: its row of send [ndev, M], its block of
        requester rows of loc, and M."""
        rank = self.rules.mesh.rank
        h = build_halo_tables(cross, n, self.rules.mesh.size, bounds=(src, req))
        r0, r1 = req[rank]
        return {"send": torch.as_tensor(h["send"][rank], dtype=torch.int64, device=self.device),
                "loc": torch.as_tensor(h["loc"][r0:r1], dtype=torch.int64, device=self.device),
                "M": h["M"]}

    def _ell_tables(self, gname, idxs, sgroups):
        """The per-slot ELL tables of graph ``gname``'s couplings between
        slots of different vertex spaces (``graph_ops.ell_tables``), placed
        on the plan's device: {"inc": {slot: [N_k, D_k]}, "ell": {(k_out,
        k_in): [N_k_out, D_k_out]}}, or None where the assembly plan has no
        such coupling (the tables are built only for a graph whose operator
        reads them). Under ``dynamic_topology`` the incidence widths are
        bucketed, as the group tables' are."""
        pairs = self._coupled_slot_pairs(gname, sgroups)
        if not pairs:
            return None
        gdecl = self.compiled.registry.graphs[gname]
        slots = sorted({k for pair in pairs for k in pair})
        nvert = {k: int(np.prod(gdecl.slots[k].shape(self.compiled.dim_sizes))) for k in slots}
        inc, ell = graph_ops.ell_tables(
            {k: idxs[k] for k in slots}, nvert,
            width_bucket=graph_ops.bucket_size if self.dynamic_topology else None)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64).to(self.device)

        return {"inc": {ko: dev(inc[ko]) for ko in sorted({ko for ko, _ki in pairs})},
                "ell": {pair: dev(ell[pair]) for pair in pairs}}

    # -- parameters (Opt_SetSolverParameter) -------------------------------------
    def set_solver_parameter(self, name: str, value) -> None:
        self.solver_params = normalize_solver_params({**self.solver_params, name: value})

    def set_solver_parameters(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            self.set_solver_parameter(k, v)

    # -- stepwise API (Opt_ProblemInit / Opt_ProblemStep) ------------------------
    def init(self, inputs: Dict[str, Any]) -> None:
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        self._bound = (consts, graphs, params)
        self._state = self.solver.init(unknowns, consts, graphs, params, self.solver_params)

    def step(self) -> bool:
        """One nonlinear iteration; returns True while solving continues
        (Opt_ProblemStep's 0/1 return)."""
        if self._state is None:
            raise RuntimeError("call init() first")
        consts, graphs, params = self._bound
        before = int(self._state["n_iter"])
        self._state = self.solver.step(self._state, consts, graphs, params, self.solver_params)
        st = self._state
        n = int(st["n_iter"])
        if n != before:
            log_solver("iteration %d, cost=%g", n, float(st["prev_cost"]))
        cont = (not bool(st["done"])) and n < int(self.solver_params["nIterations"])
        return cont and n != before

    def current_cost(self) -> float:
        """Opt_ProblemCurrentCost: the solver's prevCost."""
        if self._state is None:
            raise RuntimeError("call init() first")
        return float(self._state["prev_cost"])

    @property
    def unknowns(self) -> Dict[str, torch.Tensor]:
        """The unknowns (under a mesh the global arrays: every rank must
        read them together)."""
        if self._state is None:
            raise RuntimeError("call init() first")
        return self._global_unknowns(self._state["X"])

    def _global_unknowns(self, X):
        """The unknowns as the caller gave them: under a mesh the tiles (or
        owner blocks) gathered into the global arrays on every rank; ±inf
        markers put back."""
        if self.rules is not None:
            X = {k: self.rules.gather(v, k) for k, v in X.items()}
        return self._restore_sentinels(X)

    def _local_inputs(self, inputs):
        """Under a mesh, the region of every global image input (on a graph
        mesh the rank's owner block of it, or the whole of a replicated
        one); on a grid mesh an image that a SampledImage reads is given
        whole too, under ``spec.whole_image_key``: it is sampled at global
        positions, anywhere in the image."""
        if self.rules is None:
            return inputs
        out = {}
        reg = self.compiled.registry
        for name, v in inputs.items():
            if name in reg.images:
                a = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                dom = reg.images[name].ispace.shape(self.dims)
                if tuple(a.shape[:len(dom)]) != dom:
                    raise SpecError(f"image {name!r}: expected the global {dom} (and "
                                    f"channels), got {tuple(a.shape)}")
                if name in reg.sampled:
                    out[whole_image_key(name)] = a
                v = self.rules.local(a, name)
            out[name] = v
        return out

    def _system_at(self, inputs):
        from .functions import FunctionSet

        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        fs = FunctionSet(self.compiled, consts, graphs, params)
        fs.masks(unknowns)
        return unknowns, consts, graphs, params, fs

    def cg_inputs(self, inputs: Dict[str, Any]):
        """The first step's PCG system at ``inputs`` as the solver hands it
        to the fused CG: (cg_meta, r0 = -JᵀF, pre, keywords of
        ``ops.fused_cg.fused_grid_cg``: pre_blocks, cg_variant and, for LM
        plans, ctc with the initial trust region's damping, reset_period
        and q_tolerance). pre is the row-masked preconditioner (pre_lm
        under LM); cg_meta is None where the operator does not qualify."""
        if self.rules is not None:
            raise _port_only_on_mesh("cg_inputs")
        sp = normalize_solver_params(self.solver_params)
        unknowns, consts, graphs, params, fs = self._system_at(inputs)
        state = self.solver.init(unknowns, consts, graphs, params, sp)
        return self.solver.cg_inputs(unknowns, fs, state, sp)

    def dump_hlo(self, inputs: Dict[str, Any], path: Optional[str] = None,
                 **solver_param_overrides) -> str:
        """The port's plan report, in place of the JAX package's compiled-HLO
        text (the port has no HLO: its CG loop is one hand-written kernel
        launch a step). The report (``utils/plan_report.py``) names the
        engaged path, ``fused_fallback``, the CG instance, its route's plan,
        the fields, triples and remainder, and where the kernel library is
        built the instance's registers and spills. It builds the first
        step's system at ``inputs`` and launches no CG loop; the plan's
        state is left as it was. Written to ``path`` where given; also
        written once a plan by ``solve()`` under ``set_verbosity(3)``. On a
        mesh every rank calls it together."""
        from .utils.plan_report import format_report, plan_summary

        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        txt = format_report(plan_summary(self, inputs, sp))
        if path is not None:
            with open(path, "w") as f:
                f.write(txt)
        return txt

    def dump_jacobian(self, inputs: Dict[str, Any], dense: bool = False):
        """J at ``inputs`` as COO triplets on the host (``jacobian.dump_jacobian``:
        numpy rows, cols, vals, shape, row_offsets), or as a dense numpy
        matrix for small problems: the reference's dumpJ/saveJToCRS
        debugging surface (o.t:2318-2344, solverGPUGaussNewton.t:252-304).
        The fields are probed on the plan's device."""
        from .jacobian import dump_jacobian, dump_jacobian_dense

        if self.rules is not None:
            raise _mesh_not_ported("dump_jacobian")
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        fn = dump_jacobian_dense if dense else dump_jacobian
        return fn(self.compiled, unknowns, consts, graphs, params)

    def free(self) -> None:
        """Release solver state (Opt_PlanFree analogue)."""
        self._state = None
        self._bound = None
        self._leaf_cache = None
        self._leaf_buckets = None
        self.__dict__.pop("_sentinel_memo", None)
        self._unk_sentinels = {}

    # -- batched and scheduled solves --------------------------------------------
    def _normalize_batched(self, inputs: Dict[str, Any]):
        """solve_batched's inputs as tensors on the plan's device, as the JAX
        package takes them (opt_tpu/problem.py:999-1087): the batch size B
        from the first image with a leading batch axis; batched and shared
        leaves keep their own axes (name -> 0 or None), shared unknowns are
        broadcast over the batch; floating images are sanitised, and the
        unknowns' ±inf markers kept for the restore; graphs are shared and
        their tables built once. Returns (unknowns [B, ...], consts, graphs,
        params, const axes, param axes, {unknown: its input with ±inf})."""
        reg = self.compiled.registry
        dt, dev = self.compiled.dtype, self.device

        def tensor(v):
            return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))

        B = None
        for name, val in inputs.items():
            if name in reg.images and reg.images[name].alias is None:
                d = reg.images[name]
                shape = tuple(tensor(val).shape)
                extra = len(shape) - d.ispace.ndim
                if extra == 2 or (extra == 1 and shape[-1] != d.channels):
                    B = int(shape[0])
                    break
        if B is None:
            raise SpecError(
                "solve_batched: could not infer batch size; pass at least one "
                "image with a leading batch axis"
            )
        unknowns, consts, graphs, params = {}, {}, {}, {}
        c_axes, p_axes, restore = {}, {}, {}
        for name, val in inputs.items():
            if name in reg.graphs:
                graphs[name] = self.compiled._graph_input(name, val, dev)
                continue
            if name in reg.params:
                arr = tensor(val).to(device=dev, dtype=dt)
                params[name] = arr
                p_axes[name] = 0 if arr.dim() >= 1 else None
                continue
            if name not in reg.images:
                raise SpecError(f"unknown input {name!r}")
            d = reg.images[name]
            if d.alias is not None:
                continue
            arr = tensor(val).to(dev)
            if arr.is_floating_point():
                arr = arr.to(dt)
            nd = d.ispace.ndim
            batched = arr.dim() == nd + 2 or (arr.dim() == nd + 1 and arr.shape[-1] != d.channels)
            if arr.dim() == nd or (batched and arr.dim() == nd + 1):
                arr = arr[..., None]
            expect = d.ispace.shape(self.compiled.dim_sizes) + (d.channels,)
            got = tuple(arr.shape[1:]) if batched else tuple(arr.shape)
            if got != expect or (batched and arr.shape[0] != B):
                raise SpecError(
                    f"image {name!r}: expected shape {expect} (optionally with a leading "
                    f"batch axis of {B}), got {tuple(arr.shape)}"
                )
            if arr.is_floating_point():
                if d.kind == UNKNOWN and bool(torch.isinf(arr).any()):
                    restore[name] = arr
                arr = self.compiled._sanitize_sentinels(arr)
            if d.kind == UNKNOWN:
                unknowns[name] = (arr if batched else arr.expand((B,) + expect)).contiguous()
            else:
                consts[name] = arr.contiguous()
                c_axes[name] = 0 if batched else None
        missing = [n for n, d in reg.images.items()
                   if d.alias is None and n not in inputs] + [n for n in reg.graphs
                                                              if n not in inputs]
        if missing:
            raise SpecError(f"missing inputs: {missing}")
        for pn in reg.params:
            if pn not in params:
                params[pn] = torch.zeros((), dtype=dt, device=dev)
                p_axes[pn] = None
        return (unknowns, consts, self._augment_incidence(graphs), params, c_axes, p_axes,
                restore)

    def solve_batched(self, inputs: Dict[str, Any], **solver_param_overrides) -> BatchedSolveResult:
        """Solve a batch of problem instances at once (the JAX package's
        one-program batched solve). Image and scalar-parameter inputs carry a
        leading batch axis, or their unbatched shape, in which case they are
        shared; graph index arrays are topology shared by the batch. Each
        nonlinear step assembles every instance's system under
        ``torch.func.vmap`` and runs the CG of all of them as one batched
        fused loop (one kernel launch on the card); each instance exits on
        its own. The assembled operator is validated on instance 0.
        ``collect_per_kernel_timing`` times nothing here: only ``solve``
        reports, as in the JAX package."""
        if self.rules is not None:
            raise _mesh_not_ported("solve_batched")
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        unknowns, consts, graphs, params, c_axes, p_axes, restore = self._normalize_batched(inputs)
        if not self._fused_validated and self.solver._stencil_plan is not None:
            self._validate_fused(
                {k: v[0] for k, v in unknowns.items()},
                {k: (v[0] if c_axes[k] == 0 else v) for k, v in consts.items()},
                graphs,
                {k: (v[0] if p_axes[k] == 0 else v) for k, v in params.items()},
            )
        t0 = time.perf_counter()
        state, costs = self.solver.solve_batched(unknowns, consts, graphs, params, sp,
                                                 c_axes, p_axes)
        B = costs.shape[0]
        # one device->host transfer for every scalar result
        flat = torch.cat([state["n_iter"].double(), state["lin_iters"].double(),
                          state["prev_cost"].double(), costs.double().reshape(-1)]).cpu().numpy()
        wall = time.perf_counter() - t0
        X = dict(state["X"])
        for name, orig in restore.items():
            X[name] = torch.where(torch.isinf(orig), orig, X[name])
        fdt = np.float64 if self.compiled.dtype == torch.float64 else np.float32
        return BatchedSolveResult(
            unknowns=X,
            final_costs=flat[2 * B:3 * B].astype(fdt),
            costs=flat[3 * B:].reshape(B, -1).astype(fdt),
            num_iterations=flat[:B].astype(np.int32),
            num_linear_iterations=flat[B:2 * B].astype(np.int32),
            wall_time_s=wall,
        )

    def batched_cg_inputs(self, inputs: Dict[str, Any]):
        """The first step's PCG systems of a batch as ``solve_batched`` hands
        them to the batched fused CG (``cg_inputs``' batched form): (batched
        meta: ``"batch"`` B and F [B, T, *dom]; r0 and pre with a leading
        batch axis; the keywords of ``ops.fused_cg.fused_grid_cg``). All
        four are None where the batched operator has no fused form."""
        if self.rules is not None:
            raise _port_only_on_mesh("batched_cg_inputs")
        sp = normalize_solver_params(self.solver_params)
        unknowns, consts, graphs, params, c_axes, p_axes, _r = self._normalize_batched(inputs)
        return self.solver.batched_cg_inputs(unknowns, consts, graphs, params, sp, c_axes, p_axes)

    def solve_scheduled(self, inputs: Dict[str, Any], schedule, num_outer: int,
                        **solver_param_overrides) -> SolveResult:
        """Run ``num_outer`` chained solves, the unknowns carried from one to
        the next, with the constants of solve i given by
        ``schedule(consts, i)``: the reference apps' host hooks that swap
        inputs between outer solves (constraint annealing). The JAX package
        runs the whole schedule as one program; here the nonlinear loop is
        host-driven already, so the schedule is a host loop, and the scalar
        results come back in one transfer at the end. ``schedule`` receives
        the bound, sanitised constants (±inf clamped to finite sentinels)
        and ``i`` as a 0-dim int32 tensor on the plan's device, and returns
        constants of the same shapes and dtypes. ``collect_per_kernel_timing``
        times nothing here: only ``solve`` reports, as in the JAX package."""
        if self.rules is not None:
            raise _mesh_not_ported("solve_scheduled")
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        max_iters = int(sp["nIterations"])
        t0 = time.perf_counter()
        X, finals, lin = unknowns, [], []
        for i in range(int(num_outer)):
            c_i = schedule(consts, torch.tensor(i, dtype=torch.int32, device=self.device))
            state, _costs = self.solver.solve(X, c_i, graphs, params, sp)
            X = state["X"]
            finals.append(state["prev_cost"].double())
            lin.append(state["lin_iters"].double())
        scalars = torch.stack(finals + lin).tolist() if finals else []
        wall = time.perf_counter() - t0
        self._state = None
        n = len(finals)
        return SolveResult(
            unknowns=self._restore_sentinels(X),
            final_cost=float(scalars[n - 1]) if n else float("nan"),
            costs=[float(c) for c in scalars[:n]],
            num_iterations=int(num_outer) * max_iters,
            wall_time_s=wall,
            num_linear_iterations=int(sum(scalars[n:])),
        )

    # -- full solve (Opt_ProblemSolve) --------------------------------------------
    def solve(self, inputs: Dict[str, Any], *, stepwise: bool = False,
              **solver_param_overrides) -> SolveResult:
        """Opt_ProblemSolve: a whole solve from ``inputs`` (``stepwise``:
        through init and step, as the stepwise API runs it). With
        ``InitializationParameters(collect_per_kernel_timing=True)`` the
        solve's phases are timed on the real launches (``utils/timer.py``:
        CUDA events on the card, no sync added) and the reference's timing
        table, ``TIMING`` and ``Per-iter times ms`` lines are printed; the
        rows stay on the plan as ``_timing_phases``. On a mesh every rank
        times its own solve and keeps its rows (the loop's kernel launches,
        halo phases and collectives among them), and rank 0 prints them.
        A timed solve computes what the untimed one does, bit for bit.
        Under ``set_verbosity(3)`` the plan
        report (:meth:`dump_hlo`) is written once a plan to
        ``opt_tpu_torch_solve_plan_<n>.txt``."""
        timed = bool(self.solver.ip.collect_per_kernel_timing)
        result = self._solve(inputs, stepwise, timed, solver_param_overrides)
        if timed and (self.rules is None or self.rules.mesh.rank == 0):
            # Opt.h collectPerKernelTimingInfo: per-solve timing table +
            # TIMING / Per-iter lines (util.t:469-508)
            report_solve_timing(self, result)
        if verbosity() >= 3 and not self._plan_reported:
            # the verbosity>=3 generated-code dump of the JAX package, once
            # a plan, numbered so that several plans keep theirs (and, on a
            # mesh, every rank its own)
            self._plan_reported = True
            rank = "" if self.rules is None else f"_rank{self.rules.mesh.rank}"
            path = f"opt_tpu_torch_solve_plan_{next(_PLAN_REPORTS)}{rank}.txt"
            self.dump_hlo(inputs, path=path, **solver_param_overrides)
            log_debug(f"plan report written to {path}")
        return result

    def _solve(self, inputs, stepwise: bool, timed: bool, overrides) -> SolveResult:
        """The solve of :meth:`solve`; ``timed``: time its phases
        (``utils.timer.SolveTimer``) into ``_timing_phases`` and
        ``_timing_instances``, whatever the plan's init parameters."""
        sp = normalize_solver_params({**self.solver_params, **overrides})
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        timer = SolveTimer(self.device) if timed else None
        t0 = time.perf_counter()
        with timer or contextlib.nullcontext():
            if stepwise:
                self._bound = (consts, graphs, params)
                state = self.solver.init(unknowns, consts, graphs, params, sp)
                cost_t = []
                while True:
                    before = int(state["n_iter"])
                    state = self.solver.step(state, consts, graphs, params, sp)
                    if int(state["n_iter"]) == before:
                        break
                    cost_t.append(state["prev_cost"])
                    if bool(state["done"]):
                        break
            else:
                state, cost_t = self.solver.solve(unknowns, consts, graphs, params, sp)
            # one device->host transfer for every scalar result
            scalars = torch.stack(
                [state["prev_cost"].double(), state["n_iter"].double(),
                 state["lin_iters"].double(), *(c.double() for c in cost_t)]
            ).tolist()
        wall = time.perf_counter() - t0
        if timer is not None:  # read once, after the transfer
            self._timing_phases = timer.read()
            self._timing_phases["PCGStep1"].count = int(scalars[2])
            self._timing_instances = dict(timer.instances)
        self._state = state
        self._bound = (consts, graphs, params)
        return SolveResult(
            unknowns=self._global_unknowns(state["X"]),
            final_cost=float(scalars[0]),
            costs=[float(c) for c in scalars[3:]],
            num_iterations=int(scalars[1]),
            wall_time_s=wall,
            num_linear_iterations=int(scalars[2]),
            fused_fallback=self.fused_fallback,
        )
