from .gauss_newton import GaussNewtonSolver  # noqa: F401
from .params import (  # noqa: F401
    SOLVER_PARAMETER_DEFAULTS,
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
    normalize_solver_params,
)
