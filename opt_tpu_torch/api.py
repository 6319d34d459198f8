"""Opt.h-shaped functional API (reference: API/release/include/Opt.h:35-71).

A thin, stateful shim over :mod:`opt_tpu_torch.problem` mirroring the
reference C API one-for-one, so reference client code structure ports
directly:

    Opt_NewState            -> new_state(double_precision=..., verbosity=...)
    Opt_ProblemDefine       -> problem_define(state, spec_fn, kind)
    Opt_ProblemPlan         -> problem_plan(state, problem, dims)
    Opt_SetSolverParameter  -> set_solver_parameter(plan, name, value)
    Opt_ProblemInit         -> problem_init(plan, inputs)
    Opt_ProblemStep         -> problem_step(plan)        (returns 0/1)
    Opt_ProblemSolve        -> problem_solve(plan, inputs)
    Opt_ProblemCurrentCost  -> problem_current_cost(plan)
    Opt_PlanFree            -> plan_free(plan)
    Opt_ProblemDelete       -> problem_delete(state, problem)

Plans run on the state's ``device``: the card unless the caller asks for
the CPU. This is also the surface the C library (``native/``,
:mod:`opt_tpu_torch.native_bridge`) calls into.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .problem import Plan, Problem
from .utils.logging import set_verbosity


@dataclasses.dataclass
class OptState:
    """Opt_NewState (Opt.h:10-33): global configuration.

    The reference's threadsPerBlock has no meaning here (each kernel picks
    its own launch shape); collectPerKernelTimingInfo maps to the timer in
    utils/timer. ``device`` is where the state's plans run.
    """

    double_precision: bool = False
    verbosity: int = 0
    collect_per_kernel_timing: bool = False
    problems: list = dataclasses.field(default_factory=list)
    device: str = "cuda"


def new_state(
    double_precision: bool = False,
    verbosity: int = 0,
    collect_per_kernel_timing: bool = False,
    device: str = "cuda",
) -> OptState:
    """No global switch is flipped for ``double_precision``: each plan of the
    state is made float64 (``Problem.plan(double_precision=True)``)."""
    set_verbosity(verbosity)
    return OptState(double_precision, verbosity, collect_per_kernel_timing, device=device)


def problem_define(state: OptState, spec_fn, kind: str = "gaussNewtonGPU") -> Problem:
    """Opt_ProblemDefine (o.t:2521-2525): registers metadata only; all
    compilation happens at plan time, as in the reference. ``spec_fn`` may be
    a callable or a path to a Python energy file (the reference passes a .t
    filename; o.t:840-853 problemSpecFromFile)."""
    if isinstance(spec_fn, str):
        from .native_bridge import _load_spec_fn

        spec_fn = _load_spec_fn(spec_fn)
    p = Problem(spec_fn, kind=kind)
    state.problems.append(p)
    return p


def problem_plan(state: OptState, problem: Problem, dims: Dict[str, int], **kw) -> Plan:
    """Opt_ProblemPlan (o.t:861-882), on ``state.device`` unless ``device=``
    is passed."""
    if state.collect_per_kernel_timing and "init_params" not in kw:
        from .solver.params import InitializationParameters

        kw["init_params"] = InitializationParameters(collect_per_kernel_timing=True)
    kw.setdefault("device", state.device)
    return problem.plan(dims, double_precision=state.double_precision, **kw)


def set_solver_parameter(plan: Plan, name: str, value) -> None:
    plan.set_solver_parameter(name, value)


def problem_init(plan: Plan, inputs: Dict[str, Any]) -> None:
    plan.init(inputs)


def problem_step(plan: Plan) -> int:
    return 1 if plan.step() else 0


def problem_solve(plan: Plan, inputs: Dict[str, Any], **kw):
    """Opt_ProblemSolve = Init + Step loop (o.t:2548-2551)."""
    return plan.solve(inputs, **kw)


def problem_current_cost(plan: Plan) -> float:
    return plan.current_cost()


def plan_free(plan: Plan) -> None:
    plan.free()


def problem_delete(state: OptState, problem: Problem) -> None:
    if problem in state.problems:
        state.problems.remove(problem)
