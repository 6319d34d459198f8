"""Example-app harness: multi-solver runs, per-iteration records, reports.

PyTorch counterpart of ``opt_tpu/harness.py``, the reference's C++ example
harness (examples/shared/CombinedSolverBase.h, SolverIteration.h,
OptUtils.h):

* :class:`CombinedSolverBase` — template-method runner of N registered
  solvers over the same problem with per-solve / per-iteration hooks
  (CombinedSolverBase.h:22-30 solveAll, :98-119 singleSolve).
* per-outer-iteration (cost, ms) records + CSV output
  (SolverIteration.h:28-67 saveSolverResults).
* a "**Final Costs**" block in the exact greppable format the reference's
  regression scripts parse (SolverIteration.h:69-86 reportFinalCosts,
  scripts/print_all_costs.py).

Each Opt run plans on the subclass's ``device`` (the card unless it says
``"cpu"``); a plan never falls back to the CPU by itself. ``Plan.solve``
ends in the transfer of its scalar results, so a solve's wall time is its
work on the device.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Dict, List

from .problem import Problem


@dataclasses.dataclass
class SolverIteration:
    cost: float
    duration_ms: float


@dataclasses.dataclass
class SolverRun:
    name: str
    iterations: List[SolverIteration] = dataclasses.field(default_factory=list)

    @property
    def final_cost(self) -> float:
        return self.iterations[-1].cost if self.iterations else float("nan")


class ConvergenceAnalysis:
    """Timestamped nonlinear-cost samples -> graph file (the reference's
    examples/shape_from_shading/src/ConvergenceAnalysis.h, used by the SFS
    app): ``save_graph`` writes two tab-separated rows — timestamps then
    costs — and resets, byte-compatible with the reference's saveGraph
    output format."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = 0
        self.samples: List[tuple] = []  # (timestamp, cost)

    def add_sample(self, cost: float):
        self.samples.append((self._t, float(cost)))
        self._t += 1

    def save_graph(self, filename: str):
        with open(filename, "w") as f:
            f.write("\t".join(str(t) for t, _ in self.samples) + "\n")
            f.write("\t".join(repr(c) for _, c in self.samples) + "\n")
        self.reset()


class CombinedSolverBase:
    """Subclass per example; override the hooks you need.

    Hooks mirror the reference exactly: combined_solve_init (bind problem
    parameters), pre/post_nonlinear_solve (pyramid levels, constraint
    annealing — e.g. image_warping CombinedSolver.h:150-152), pre/post_single_solve,
    combined_solve_finalize. Attributes a subclass may set:
    ``device`` (the plans' device, default "cuda"), ``collect_timing``
    (collect_per_kernel_timing: a TIMING table per solve),
    ``double_precision``, ``converged_override`` (run Opt to convergence
    for the scipy comparison) and ``make_device_schedule(num_iter)`` (a
    ``Plan.solve_scheduled`` schedule for the outer loop).
    """

    device = "cuda"

    def __init__(self, spec_fn, dims: Dict[str, int], params: Dict[str, Any]):
        self.spec_fn = spec_fn
        self.dims = dict(dims)
        self.solver_params = dict(params)  # numIter / nonLinearIter / linearIter
        self.problem_inputs: Dict[str, Any] = {}
        self.runs: List[SolverRun] = []
        self._enabled: List[str] = []

    # -- configuration ------------------------------------------------------
    def add_opt_solvers(self, kinds=("gaussNewtonGPU", "LMGPU")):
        """CombinedSolverBase.h:73-80 addOptSolvers."""
        self._enabled.extend(kinds)

    def add_scipy_reference_solver(self, max_nfev: int = 200):
        """Register the independent scipy TRF solver as a comparison run —
        the reference's Ceres-comparison slot (CombinedSolverBase.h:62-65,
        CeresSolverBase.h). Small problems only (dense Jacobian); it runs on
        the host."""
        self._enabled.append(("scipy", max_nfev))

    # -- hooks ---------------------------------------------------------------
    def combined_solve_init(self):
        raise NotImplementedError

    def pre_single_solve(self):
        pass

    def post_single_solve(self):
        pass

    def pre_nonlinear_solve(self, iteration: int):
        pass

    def post_nonlinear_solve(self, iteration: int):
        pass

    def combined_solve_finalize(self):
        pass

    # -- the runs -------------------------------------------------------------
    def solve_all(self) -> List[SolverRun]:
        """CombinedSolverBase.h:22-30."""
        self.combined_solve_init()
        for kind in self._enabled:
            if isinstance(kind, tuple) and kind[0] == "scipy":
                self.runs.append(self._scipy_solve(kind[1]))
            else:
                self.runs.append(self._single_solve(kind))
        self.combined_solve_finalize()
        return self.runs

    def _scipy_solve(self, max_nfev: int) -> SolverRun:
        from .reference_solver import solve_scipy

        run = SolverRun(name="CERES-analogue(scipy)")
        self.pre_single_solve()  # same reset as each Opt run (resetGPU analogue)
        t0 = time.perf_counter()
        cost, _unknowns = solve_scipy(
            self.spec_fn, self.dims, dict(self.problem_inputs), max_nfev=max_nfev
        )
        ms = (time.perf_counter() - t0) * 1e3
        run.iterations.append(SolverIteration(cost, ms))
        self.post_single_solve()
        return run

    def _single_solve(self, kind: str) -> SolverRun:
        """CombinedSolverBase.h:98-119 + OptUtils.h:47-64 launchProfiledSolve."""
        run = SolverRun(name=f"Opt({'GN' if 'gauss' in kind.lower() or kind.lower()=='gn' else 'LM'})")
        num_iter = int(self.solver_params.get("numIter", 1))
        non_linear = int(self.solver_params.get("nonLinearIter", 10))
        linear = int(self.solver_params.get("linearIter", 10))
        if getattr(self, "converged_override", False):
            # oracle mode: run Opt to convergence so the final-cost
            # comparison against the scipy reference is an optimality check,
            # not an iteration-schedule comparison (the reference's Ceres
            # comparisons have the same caveat — CombinedSolverBase.h:62-65)
            non_linear, linear = max(non_linear, 30), max(linear, 200)
        plan_kw = {}
        if getattr(self, "collect_timing", False):
            # collectPerKernelTimingInfo: TIMING lines per solve (Opt.h:21-25)
            from .solver.params import InitializationParameters

            plan_kw["init_params"] = InitializationParameters(
                collect_per_kernel_timing=True
            )
        self.plan = Problem(self.spec_fn).plan(
            dims=self.dims,
            kind=kind,
            double_precision=getattr(self, "double_precision", False),
            device=self.device,
            nIterations=non_linear,
            lIterations=linear,
            **plan_kw,
        )
        self.pre_single_solve()
        maker = getattr(self, "make_device_schedule", None)
        use_sched = (
            maker is not None
            and num_iter > 1
            # the TIMING surface reports per plan.solve; keep the host loop
            # when per-kernel timing was requested
            and not getattr(self, "collect_timing", False)
        )
        schedule = maker(num_iter) if use_sched else None
        if schedule is not None:
            # the whole numIter loop (input annealing included) through
            # Plan.solve_scheduled, its scalar results in one transfer at
            # the end; per-outer-iteration costs come back, wall time is
            # uniformly attributed since the schedule exposes only the total
            res = self.plan.solve_scheduled(
                dict(self.problem_inputs), schedule, num_iter
            )
            ms = res.wall_time_s * 1e3
            for name, arr in res.unknowns.items():
                self.problem_inputs[name] = arr
            for c in res.costs:
                run.iterations.append(SolverIteration(float(c), ms / num_iter))
            self.post_single_solve()
            return run
        for it in range(num_iter):
            self.pre_nonlinear_solve(it)  # hooks may swap self.plan (pyramids)
            t0 = time.perf_counter()
            res = self.plan.solve(dict(self.problem_inputs))
            ms = (time.perf_counter() - t0) * 1e3
            # write the solved unknowns back so hooks can anneal/re-seed
            for name, arr in res.unknowns.items():
                self.problem_inputs[name] = arr
            run.iterations.append(SolverIteration(res.final_cost, ms))
            self.post_nonlinear_solve(it)
        self.post_single_solve()
        return run

    # -- reporting ---------------------------------------------------------------
    def report_final_costs(self) -> str:
        """SolverIteration.h:69-86 — greppable '**Final Costs**' block."""
        lines = ["**Final Costs**"]
        for run in self.runs:
            lines.append(f"{run.name}: {run.final_cost:.8g}")
        text = "\n".join(lines)
        print(text)
        return text

    def save_results_csv(
        self, directory="results", double_precision=None, name=None
    ) -> str:
        """SolverIteration.h:28-67 saveSolverResults. ``name`` (defaulting
        to the spec function's name) keys the file per example — the
        reference writes one results CSV per example directory; a shared
        unnamed file would be overwritten by whichever example ran last."""
        os.makedirs(directory, exist_ok=True)
        if double_precision is None:
            double_precision = getattr(self, "double_precision", False)
        suffix = "double" if double_precision else "float"
        name = name or getattr(self.spec_fn, "__name__", None)
        stem = f"{name}_results_{suffix}" if name else f"results_{suffix}"
        path = os.path.join(directory, f"{stem}.csv")
        n = max((len(r.iterations) for r in self.runs), default=0)
        with open(path, "w") as f:
            header = []
            for r in self.runs:
                header += [f"{r.name} cost", f"{r.name} ms"]
            f.write(",".join(header) + "\n")
            for i in range(n):
                row = []
                for r in self.runs:
                    if i < len(r.iterations):
                        row += [f"{r.iterations[i].cost}", f"{r.iterations[i].duration_ms}"]
                    else:
                        row += ["", ""]
                f.write(",".join(row) + "\n")
        # legacy compatibility: consumers that read the fixed
        # results_<suffix>.csv path get the per-example file mirrored there
        # (it holds whichever example saved last, as the old shared file did)
        if name:
            legacy = os.path.join(directory, f"results_{suffix}.csv")
            shutil.copyfile(path, legacy)
        return path

    def save_convergence_graphs(self, directory="results", name=None):
        """One ConvergenceAnalysis graph file per solver run (the
        reference's SFS app records a FunctionValue per nonlinear
        iteration and saves via saveGraph; here every run's
        SolverIteration costs already hold that series). Returns the
        written paths."""
        os.makedirs(directory, exist_ok=True)
        name = name or getattr(self.spec_fn, "__name__", "problem")
        paths = []
        for run in self.runs:
            ca = ConvergenceAnalysis()
            for it in run.iterations:
                ca.add_sample(it.cost)
            safe = run.name.replace("(", "_").replace(")", "").replace(
                " ", ""
            )
            p = os.path.join(directory, f"{name}_{safe}_convergence.graph")
            ca.save_graph(p)
            paths.append(p)
        return paths
