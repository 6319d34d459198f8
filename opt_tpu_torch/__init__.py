"""opt_tpu_torch — the PyTorch and CUDA port of opt_tpu.

A nonlinear least-squares DSL and Gauss-Newton solver: users write energy
functions (sums of squared residual terms over image grids and graphs) as
plain Python spec functions; the framework derives a Jacobi-preconditioned
Gauss-Newton solver with ``torch.func``. The whole CG inner loop of a 2-D
or 3-D grid or a graph problem runs as one hand-written CUDA kernel on the
card (ops/fused_cg.py). Plans run on the card; ``plan(..., device="cpu")`` asks
for the CPU.

The JAX package ``opt_tpu`` is the reference this port is held to; the two
share names, layouts and numerics. This package never imports it.

Quick start::

    import opt_tpu_torch as ot

    def laplacian(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.2 * (X(0, 0) - A(0, 0)),
                 X(0, 0) - X(1, 0),
                 X(0, 0) - X(0, 1))

    plan = ot.Problem(laplacian).plan(dims={"W": 512, "H": 512})
    result = plan.solve({"X": x0, "A": target})
"""

from __future__ import annotations

from .dims import Dim, IndexSpace
from .lib import (
    All,
    And,
    Any,
    Dot,
    Dot3,
    Energy,
    Exclude,
    InBounds,
    InBoundsExpanded,
    Index,
    L_2_norm,
    L_p,
    Matrix3x3Mul,
    Not,
    Or,
    Reduce,
    Rotate2D,
    Rotate3D,
    Select,
    Slice,
    Sqrt,
    Stencil,
    UsePreconditioner,
    eq,
    greater,
    greatereq,
    length,
    less,
    lesseq,
    neq,
    normalize,
)
from .problem import BatchedSolveResult, Plan, Problem, SolveResult
from .pyramid import PyramidPlan, upsample2x_nearest
from .solver.params import (
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
    SOLVER_PARAMETER_DEFAULTS,
)
from .spec import SpecError

__version__ = "0.1.0"


def enable_double_precision() -> None:
    """Does nothing: the JAX package needs this global switch (jax x64)
    before ``plan(double_precision=True)``; torch computes in float64
    whenever a plan asks for it. Kept so that scripts written for the
    reference run unchanged."""

__all__ = [
    "Dim",
    "IndexSpace",
    "Problem",
    "Plan",
    "SolveResult",
    "BatchedSolveResult",
    "PyramidPlan",
    "enable_double_precision",
    "SpecError",
    "GuardedInvertType",
    "JacobiScalingType",
    "InitializationParameters",
    "SOLVER_PARAMETER_DEFAULTS",
    "upsample2x_nearest",
    # DSL stdlib
    "All", "And", "Any", "Dot", "Dot3", "Energy", "Exclude", "InBounds",
    "InBoundsExpanded", "Index", "L_2_norm", "L_p", "Matrix3x3Mul", "Not",
    "Or", "Reduce", "Rotate2D", "Rotate3D", "Select", "Slice", "Sqrt", "Stencil",
    "UsePreconditioner", "eq", "greater", "greatereq", "length", "less",
    "lesseq", "neq", "normalize",
]
