"""Solver parameters and configuration enums.

The same names, defaults and semantics as ``opt_tpu/solver/params.py`` (and
the reference, solverGPUGaussNewton.t:12-39), so parity tests pass the same
settings to both packages. Fields for variants this port has not reached
yet are accepted and documented where the solver reads them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict


class GuardedInvertType(enum.Enum):
    CERES = "ceres"
    MODIFIED_CERES = "modified_ceres"
    EPSILON_ADD = "epsilon_add"


class JacobiScalingType(enum.Enum):
    NONE = "none"
    ONCE_PER_SOLVE = "once_per_solve"
    EVERY_ITERATION = "every_iteration"


FLOAT_EPSILON = 1e-8  # solverGPUGaussNewton.t:96


@dataclasses.dataclass
class InitializationParameters:
    """Compile-time solver switches (solverGPUGaussNewton.t:19-24)."""

    guarded_invert_type: GuardedInvertType = GuardedInvertType.CERES
    jacobi_scaling: JacobiScalingType = JacobiScalingType.ONCE_PER_SOLVE
    guard_division_by_zero: bool = True  # solverGPUGaussNewton.t:17
    # Assemble the gather-form JᵀJ stencil once per nonlinear iteration and
    # apply it as weighted shifts in the CG loop; otherwise compose Jᵀ(J·p).
    use_fused_jtj: bool = True
    fused_jtj_memory_limit_bytes: int = 1 << 31
    # Compare the assembled operator with the composed Jᵀ(J·p) once per
    # plan, at the first solve's inputs; on mismatch the plan drops to the
    # composed operator and reports it in Plan.fused_fallback.
    validate_fused_jtj: bool = True
    # Whole-loop grid CG (ops/fused_cg.py). "auto" (and True/"on"): the CUDA
    # kernel for CUDA tensors, the plain twin for CPU tensors;
    # "interpret": the plain twin on any device; False/"off": the solver's
    # eager CG loop.
    use_pallas_cg: Any = "auto"
    # Explicit sparse-J path: J and Jᵀ as CSR, JᵀJ·p as two sparse matvecs
    # in the eager CG loop (explicit.py); no assembly plan.
    use_explicit_jtj: bool = False
    # Dynamic graph topology: graphs padded to power-of-two edge buckets
    # with zero-valid edges, no DIA split, the table cache kept to 32
    # topologies (problem.py: Plan._pad_dynamic).
    dynamic_topology: bool = False
    # Opt_InitializationParameters.collectPerKernelTimingInfo (Opt.h:21-25):
    # after each Plan.solve, print the per-phase timing table plus the
    # greppable ``TIMING`` / ``Per-iter times ms (nonlinear, linear)`` lines
    # (util.t:469-508 format; utils/timer.report_solve_timing). On a mesh
    # every rank times its own solve and rank 0 prints.
    collect_per_kernel_timing: bool = False
    # CG inner-loop variant: "standard" (the reference's PCG recurrence) or
    # "chronopoulos_gear" (one reduction per iteration: rᵀu and uᵀAu from the
    # same vectors); "auto" resolves per device count (resolve_auto_policy).
    cg_variant: str = "auto"
    # "jacobi" (the reference's scalar Jacobi) or "block_jacobi" (per-point
    # inverses of the assembled Δ=0 channel blocks); "auto" resolves per
    # device count.
    preconditioner: str = "auto"
    # Bind-time edge renumbering for graph problems on a mesh: False/None,
    # or "owner" (a graph's edges sorted by the owner block of their first
    # slot, problem.py: Plan._reorder_edges; off a mesh it reorders
    # nothing); "auto" resolves per device count (resolve_auto_policy).
    edge_reorder: Any = "auto"
    # Incidence-aligned graph assembly (experimental in the reference
    # package; not to be ported: True raises).
    aligned_graph_assembly: bool = False
    # Narrower storage for the assembled coefficient fields the CG loop
    # reads, e.g. "bfloat16"; products stay in the solve dtype. None = the
    # solve dtype. Plain GN on stiff graph energies can take non-descent
    # steps with it; LM's trust region rejects those.
    coefficient_dtype: Any = None


def resolve_auto_policy(
    ip: "InitializationParameters", n_devices: int, has_graphs: bool
) -> "InitializationParameters":
    """Resolve the "auto" solver-variant flags per execution regime, as the
    reference package does: one device takes "standard" CG, scalar
    "jacobi" and no edge reorder; a mesh of several devices takes
    "chronopoulos_gear", "block_jacobi" and, for graphs, "owner" reorder.
    Explicit values pass through."""
    multi = n_devices > 1
    upd = {}
    if ip.cg_variant == "auto":
        upd["cg_variant"] = "chronopoulos_gear" if multi else "standard"
    if ip.preconditioner == "auto":
        upd["preconditioner"] = "block_jacobi" if multi else "jacobi"
    if ip.edge_reorder == "auto":
        upd["edge_reorder"] = (
            "owner" if (multi and has_graphs and not ip.dynamic_topology) else False
        )
    return dataclasses.replace(ip, **upd) if upd else ip


# Runtime-settable parameters (solverGPUGaussNewton.t:26-39).
SOLVER_PARAMETER_DEFAULTS: Dict[str, Any] = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 1e-4,
    "function_tolerance": 1e-6,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
    "nIterations": 10,
    "lIterations": 10,
    # Extension over the reference parameter set: end the CG inner loop when
    # rᵀz falls below this fraction of its initial value.
    "cg_rz_tolerance": 1e-12,
}

_INT_PARAMS = {"residual_reset_period", "nIterations", "lIterations"}


def normalize_solver_params(overrides: Dict[str, Any]) -> Dict[str, Any]:
    params = dict(SOLVER_PARAMETER_DEFAULTS)
    for k, v in overrides.items():
        if k not in params:
            raise KeyError(
                f"unknown solver parameter {k!r} "
                f"(valid: {sorted(params)}; reference solverGPUGaussNewton.t:26-39)"
            )
        params[k] = int(v) if k in _INT_PARAMS else float(v)
    return params
