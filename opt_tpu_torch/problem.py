"""User-facing Problem / Plan lifecycle.

PyTorch counterpart of ``opt_tpu/problem.py``, mirroring the reference C API
(Opt_ProblemDefine / Opt_ProblemPlan / Opt_ProblemInit / Opt_ProblemStep /
Opt_ProblemSolve / Opt_ProblemCurrentCost / Opt_SetSolverParameter) as an
object API. Inputs and outputs keep the JAX package's [*dom, C] layout.

The plan runs on the card: ``plan(...)`` places every input and all solver
state on CUDA and raises where CUDA is absent. A caller who wants the CPU
asks for it with ``plan(..., device="cpu")``; the port never falls back to
the CPU by itself.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .compile import CompiledProblem, compile_spec
from .ops import fused_cg, graph_ops
from .solver.gauss_newton import GaussNewtonSolver
from .solver.params import InitializationParameters, normalize_solver_params
from .utils.logging import log_solver

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


def graph_group_tables(idxs, names, n: int, device, dtype, max_offsets: int) -> Dict[str, Any]:
    """The host-built tables of one (graph, vertex-space) group, placed on
    ``device``: the part of the JAX package's ``Plan._augment_incidence``
    (opt_tpu/problem.py:354-762) that a single card needs.

    * ``inc`` [N, D]: the combined incidence table (stacked edge-row ids,
      sentinel m·E), through which JᵀF and the same-vertex blocks S gather;
    * ``dia``: [(offset, mask [N, D, m-1])] when the numbering puts at
      least ``DIA_MIN_COVERAGE`` of the cross reads at up to
      ``DIA_MAX_OFFSETS`` vertex-id offsets (grid-class meshes), else [].
      At most ``max_offsets`` of them (what the CG kernel's triple table
      holds) become offsets, the most frequent first; the reads of the
      others join the remainder;
    * ``rem_pos`` [N, Dm, K] and ``rem_cross`` [N, Dm]: the cross reads no
      offset covers (all of them without DIA), duplicate (v, u) reads
      merged (``dedup_reads``), or None when there are none;
    * ``csr``: the remainder as the kernel's destination-sorted CSR
      (rowptr [N+1], col [nnz], src [nnz] flat [N·Dm] positions, row
      [nnz]).
    """
    idx_list = [idxs[k] for k in names]
    inc = graph_ops.combined_incidence_table(idx_list, n)
    cross = graph_ops.combined_cross_table(idx_list, n, inc=inc)
    _n, dd, mm1 = cross.shape
    dia, rem = None, None
    if mm1:
        probe = graph_ops.dia_split(cross, n, max_offsets=DIA_MAX_OFFSETS)
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
    out = {
        "names": list(names), "n": n,
        "inc": torch.as_tensor(inc, dtype=torch.int64).to(device),
        "dia": [],
        "rem_pos": None, "rem_cross": None, "csr": None,
    }
    if dia is not None:
        offsets, masks, _rp, _rc = dia
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
        }
    return out


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
class SolveResult:
    unknowns: Dict[str, torch.Tensor]
    final_cost: float
    costs: List[float]  # cost after each nonlinear iteration
    num_iterations: int
    wall_time_s: float
    num_linear_iterations: int = 0  # PCG iterations actually executed


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
        device="cuda",
        **solver_params,
    ) -> "Plan":
        """Compile for concrete sizes on ``device``, the card unless the
        caller asks for the CPU (Opt_ProblemPlan)."""
        dev = resolve_device(device)
        dtype = torch.float64 if double_precision else torch.float32
        compiled = compile_spec(self.spec_fn, dims, dtype)
        return Plan(self, compiled, kind or self.kind, init_params, solver_params, dev)


class Plan:
    def __init__(self, problem, compiled: CompiledProblem, kind, init_params,
                 solver_params, device):
        self.problem = problem
        self.compiled = compiled
        self.kind = kind
        self.device = device
        self.uses_lambda = _uses_lambda(kind)
        self.solver = GaussNewtonSolver(compiled, self.uses_lambda, init_params)
        self.solver_params = normalize_solver_params(solver_params)
        self._state = None
        self._bound = None  # (consts, graphs, params)
        self._fused_validated = False

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
        if not self.solver.validate_assembly(unknowns, consts, graphs, params):
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
                inputs, device=self.device
            )
            graphs = self._augment_incidence(graphs)
            self._leaf_cache = dict(inputs)
            self._leaf_buckets = (unknowns, consts, graphs, params)
            return (dict(unknowns), dict(consts), dict(graphs), dict(params))
        changed = {k: v for k, v in inputs.items() if cache[k] is not v}
        if changed:
            u, c, g, p = self.compiled.normalize_inputs(
                changed, device=self.device, partial=True
            )
            g = self._augment_incidence(g)
            for bucket, new in zip(buckets, (u, c, g, p)):
                bucket.update(new)
            cache.update(changed)
        return tuple(dict(b) for b in buckets)

    def _augment_incidence(self, graphs):
        """Attach each graph's group tables (``graph_group_tables``) under
        ``"__groups__"``: {group key: tables}. The tables depend only on the
        index data: they are cached by a hash of it (a few topologies, least
        recently used first out), so a new array with the same edges builds
        nothing."""
        if not graphs:
            return graphs
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
            groups = cache.pop(key, None)
            if groups is None:
                groups = {
                    gk: graph_group_tables(idxs, gnames, n, self.device, dt, max_off)
                    for gk, gnames, n in graph_ops.slot_groups(gdecl, self.compiled.dim_sizes)
                }
            cache[key] = groups
            while len(cache) > _TABLE_CACHE_MAX:
                cache.popitem(last=False)
            out[gname] = dict(slots, __groups__=groups)
        return out

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
        if self._state is None:
            raise RuntimeError("call init() first")
        return self._restore_sentinels(self._state["X"])

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
        sp = normalize_solver_params(self.solver_params)
        unknowns, consts, graphs, params, fs = self._system_at(inputs)
        state = self.solver.init(unknowns, consts, graphs, params, sp)
        return self.solver.cg_inputs(unknowns, fs, state, sp)

    def free(self) -> None:
        """Release solver state (Opt_PlanFree analogue)."""
        self._state = None
        self._bound = None
        self._leaf_cache = None
        self._leaf_buckets = None
        self.__dict__.pop("_sentinel_memo", None)
        self._unk_sentinels = {}

    # -- full solve (Opt_ProblemSolve) --------------------------------------------
    def solve(self, inputs: Dict[str, Any], *, stepwise: bool = False,
              **solver_param_overrides) -> SolveResult:
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        unknowns, consts, graphs, params = self._normalize_and_place(inputs)
        self._validate_fused(unknowns, consts, graphs, params)
        t0 = time.perf_counter()
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
        self._state = state
        self._bound = (consts, graphs, params)
        return SolveResult(
            unknowns=self._restore_sentinels(state["X"]),
            final_cost=float(scalars[0]),
            costs=[float(c) for c in scalars[3:]],
            num_iterations=int(scalars[1]),
            wall_time_s=wall,
            num_linear_iterations=int(scalars[2]),
        )
