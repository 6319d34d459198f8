"""User-facing Problem / Plan lifecycle.

PyTorch counterpart of ``opt_tpu/problem.py``, mirroring the reference C API
(Opt_ProblemDefine / Opt_ProblemPlan / Opt_ProblemInit / Opt_ProblemStep /
Opt_ProblemSolve / Opt_ProblemCurrentCost / Opt_SetSolverParameter) as an
object API. Inputs and outputs keep the JAX package's [*dom, C] layout.

The device is explicit: ``plan(..., device="cuda")`` places every input and
all solver state on the card, and raises where CUDA is absent; the default
is the CPU. The port never picks a device by itself.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .compile import CompiledProblem, compile_spec
from .spec import GRAPHS_TODO
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
        device="cpu",
        **solver_params,
    ) -> "Plan":
        """Compile for concrete grid sizes on ``device`` (Opt_ProblemPlan)."""
        dev = resolve_device(device)
        dtype = torch.float64 if double_precision else torch.float32
        compiled = compile_spec(self.spec_fn, dims, dtype)
        if any(t.domain[0] == "graph" for t in compiled.terms) or compiled.registry.graphs:
            raise NotImplementedError(GRAPHS_TODO)
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
        # None while the assembled operator is in use; "validation" after
        # _validate_fused dropped this plan to the composed operator
        self.fused_fallback = None

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
            self.fused_fallback = "validation"

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
        object identity: only changed leaves convert again. Callers that
        mutate an input in place must pass a fresh array instead."""
        self._note_unknown_sentinels(inputs)
        cache = self.__dict__.get("_leaf_cache")
        buckets = self.__dict__.get("_leaf_buckets")
        if cache is None or set(cache) != set(inputs):
            unknowns, consts, graphs, params = self.compiled.normalize_inputs(
                inputs, device=self.device
            )
            self._leaf_cache = dict(inputs)
            self._leaf_buckets = (unknowns, consts, graphs, params)
            return (dict(unknowns), dict(consts), dict(graphs), dict(params))
        changed = {k: v for k, v in inputs.items() if cache[k] is not v}
        if changed:
            u, c, g, p = self.compiled.normalize_inputs(
                changed, device=self.device, partial=True
            )
            for bucket, new in zip(buckets, (u, c, g, p)):
                bucket.update(new)
            cache.update(changed)
        return tuple(dict(b) for b in buckets)

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

    def gn_system(self, inputs: Dict[str, Any]):
        """The first GN step's PCG system at ``inputs``: (cg_meta, r0, pre)
        with r0 = -JᵀF and pre the row-masked preconditioner, as the solver
        hands them to the fused CG (cg_meta is None where the operator does
        not qualify)."""
        unknowns, _c, _g, _p, fs = self._system_at(inputs)
        _A, r0, pre, cg_meta = self.solver.gn_system(unknowns, fs)
        return cg_meta, r0, pre

    def lm_system(self, inputs: Dict[str, Any]):
        """The first LM step's PCG system at ``inputs``: (cg_meta, r0,
        pre_lm, ctc), with the damping of the initial trust region, as the
        solver hands them to the fused CG."""
        sp = normalize_solver_params(self.solver_params)
        unknowns, consts, graphs, params, fs = self._system_at(inputs)
        state = self.solver.init(unknowns, consts, graphs, params, sp)
        return self.solver.lm_system(unknowns, fs, state, sp)

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
