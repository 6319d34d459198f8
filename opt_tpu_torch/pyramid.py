"""Coarse-to-fine pyramid solves.

PyTorch counterpart of ``opt_tpu/pyramid.py``. The reference drives a
multi-resolution solve from the host (optical_flow/src/CombinedSolver.h:
22-61): a plan a level, the unknowns upsampled between levels. The JAX
package compiles the whole chain into one program; here the nonlinear loop
is host-driven already, so :class:`PyramidPlan` chains the levels' solves
on the plans' device, the prolongation a tensor function between them, and
brings the scalar results back in one transfer at the end.

On a mesh every level's plan is the rank's (its region of the level's
grid): between levels the unknowns are gathered into the global arrays,
prolonged there, as the JAX package prolongs its global arrays, and the
next level takes its region of them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .problem import Problem, SolveResult
from .solver.params import InitializationParameters, normalize_solver_params


def upsample2x_nearest(arr: torch.Tensor, shape, scale: float = 1.0) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling to `shape` (spatial dims), values
    multiplied by `scale`: the flow-style prolongation (displacements double
    at double resolution)."""
    out = torch.repeat_interleave(torch.repeat_interleave(arr, 2, dim=0), 2, dim=1) * scale
    return out[: shape[0], : shape[1]]


class PyramidPlan:
    """A chain of per-level plans solved coarse to fine.

    Parameters
    ----------
    problem : the Problem (energy spec) shared by all levels
    level_dims : dims dict per level, coarse to fine
    prolong : (unknowns_dict, level_index, next_dims) -> unknowns_dict
        the prolongation, on tensors, from level `i`'s solution to level
        `i+1`'s initial unknowns
    mesh : ``parallel.make_mesh``'s mesh: every level's plan is the rank's,
        the prolongation still sees the global arrays
    device : every level's plan's device (the card unless the caller asks
        for the CPU)
    double_precision : float64 plans at every level

    After a solve, ``level_costs`` holds each level's cost after each of
    its steps and ``level_lin_iters`` each level's CG iterations.
    """

    def __init__(
        self,
        problem: Problem,
        level_dims: List[Dict[str, int]],
        prolong: Callable[[Dict[str, torch.Tensor], int, Dict[str, int]], Dict[str, torch.Tensor]],
        kind: Optional[str] = None,
        init_params: Optional[InitializationParameters] = None,
        mesh=None,
        device="cuda",
        double_precision: bool = False,
        **solver_params,
    ):
        if not level_dims:
            raise ValueError("need at least one pyramid level")
        self.plans = [
            problem.plan(dims=d, kind=kind, init_params=init_params, mesh=mesh, device=device,
                         double_precision=double_precision, **solver_params)
            for d in level_dims
        ]
        self.level_dims = list(level_dims)
        self.prolong = prolong
        self.solver_params = normalize_solver_params(solver_params)
        self.level_costs: List[List[float]] = []
        self.level_lin_iters: List[int] = []

    def solve(self, level_inputs: List[Dict[str, Any]], **solver_param_overrides) -> SolveResult:
        """Solve the full schedule. `level_inputs[0]` must contain the
        coarse level's unknowns; later levels' unknown entries are ignored
        (their initial values come from the prolongation), but ±inf markers
        in the finest level's are restored in the result."""
        sp = normalize_solver_params({**self.solver_params, **solver_param_overrides})
        if len(level_inputs) != len(self.plans):
            raise ValueError(f"expected {len(self.plans)} input dicts, got {len(level_inputs)}")
        bound, X = [], None
        for i, (plan, inputs) in enumerate(zip(self.plans, level_inputs)):
            unknowns, consts, graphs, params = plan._normalize_and_place(inputs)
            plan._validate_fused(unknowns, consts, graphs, params)
            if i == 0:
                X = unknowns
            bound.append((consts, graphs, params))
        t0 = time.perf_counter()
        finals, lin, steps = [], [], []
        for i, (plan, (consts, graphs, params)) in enumerate(zip(self.plans, bound)):
            state, costs = plan.solver.solve(X, consts, graphs, params, sp)
            finals.append(state["prev_cost"].double())
            lin.append(state["lin_iters"].double())
            steps.append([c.double() for c in costs])
            X = state["X"]
            if i + 1 < len(self.plans):
                X = self._prolong(plan, X, i)
        scalars = torch.stack(finals + lin + [c for cs in steps for c in cs]).tolist()
        wall = time.perf_counter() - t0
        n = len(finals)
        self.level_lin_iters = [int(c) for c in scalars[n:2 * n]]
        rest = iter(scalars[2 * n:])
        self.level_costs = [[next(rest) for _c in cs] for cs in steps]
        return SolveResult(
            unknowns=self.plans[-1]._global_unknowns(X),
            final_cost=float(scalars[n - 1]),
            costs=[float(c) for c in scalars[:n]],
            num_iterations=n * int(sp["nIterations"]),
            wall_time_s=wall,
            num_linear_iterations=sum(self.level_lin_iters),
        )

    def _prolong(self, plan, X, i: int) -> Dict[str, torch.Tensor]:
        """Level ``i``'s unknowns ``X`` as level ``i + 1``'s initial ones: on a
        mesh gathered into the global arrays, prolonged, and the next
        level's region of them taken."""
        nxt = self.plans[i + 1]
        if plan.rules is None:
            return self.prolong(X, i, self.level_dims[i + 1])
        X = self.prolong({k: plan.rules.gather(v, k) for k, v in X.items()}, i,
                         self.level_dims[i + 1])
        return nxt.compiled.normalize_inputs(nxt._local_inputs(X), device=nxt.device,
                                             partial=True)[0]
