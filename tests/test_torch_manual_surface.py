"""docs/MANUAL.md's surface on opt_tpu_torch: tests/test_manual_surface.py's
four cases on the port (the plan's documented methods, ``dump_hlo``
included; the front example on the CPU), and the ten Opt.h functions of
``opt_tpu_torch.api``, so that the port cannot drift from the surface the
JAX package documents."""

import numpy as np

import opt_tpu_torch as ot
import opt_tpu_torch.api as api


def test_documented_module_surface():
    for n in [
        # math / logic helpers (MANUAL "Math operators")
        "eq", "neq", "greater", "greatereq", "less", "lesseq",
        "And", "Or", "Not", "All", "Any",
        "Select", "Rotate2D", "Rotate3D", "Matrix3x3Mul", "Dot3",
        "normalize", "length", "Sqrt", "L_2_norm", "L_p", "Slice",
        "Stencil", "InBounds", "InBoundsExpanded",
        # entry points ("Beyond the reference")
        "Problem", "PyramidPlan", "InitializationParameters",
        "SOLVER_PARAMETER_DEFAULTS", "upsample2x_nearest",
    ]:
        assert hasattr(ot, n), f"MANUAL.md documents ot.{n}"
    # documented access paths
    from opt_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
    import opt_tpu_torch.utils.checkpoint  # noqa: F401

    assert ot.parallel.mesh.make_mesh is make_mesh


def test_documented_plan_surface():
    from opt_tpu_torch.problem import Plan

    for m in [
        "solve", "solve_batched", "solve_scheduled",
        "set_solver_parameter", "dump_jacobian", "dump_hlo",
        "init", "step", "current_cost", "free",
    ]:
        assert hasattr(Plan, m), f"MANUAL.md documents plan.{m}"
    # documented InitializationParameters knobs
    ip = ot.InitializationParameters()
    for f in [
        "use_fused_jtj", "use_pallas_cg", "collect_per_kernel_timing",
        "use_explicit_jtj", "coefficient_dtype", "guarded_invert_type",
        "jacobi_scaling",
    ]:
        assert hasattr(ip, f), f"MANUAL.md documents InitializationParameters.{f}"


def test_documented_solver_parameter_names():
    # MANUAL "Solver parameters" block (solverGPUGaussNewton.t:26-39 names)
    documented = {
        "nIterations", "lIterations", "min_relative_decrease",
        "min_trust_region_radius", "max_trust_region_radius",
        "q_tolerance", "function_tolerance", "trust_region_radius",
        "radius_decrease_factor", "min_lm_diagonal", "max_lm_diagonal",
        "residual_reset_period",
    }
    assert documented <= set(ot.SOLVER_PARAMETER_DEFAULTS)


def test_manual_front_example_runs():
    """The manual's front-page flow: spec -> plan -> solve by name; the same
    solve through the JAX package ends at the same cost."""
    import opt_tpu as jot

    def lap(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        w = S.Param("w")
        S.Energy(w * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0))

    rng = np.random.RandomState(0)
    inputs = {"X": np.zeros((12, 12), np.float32),
              "A": rng.rand(12, 12).astype(np.float32),
              "w": np.float32(0.5)}
    plan = ot.Problem(lap).plan(dims={"W": 12, "H": 12}, device="cpu")
    res = plan.solve(dict(inputs), nIterations=2, lIterations=20)
    assert np.isfinite(res.final_cost)
    ref = jot.Problem(lap).plan(dims={"W": 12, "H": 12}).solve(dict(inputs), nIterations=2,
                                                              lIterations=20)
    np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=1e-5)


def test_opt_h_functions():
    """opt_tpu_torch.api has the ten Opt.h functions of opt_tpu.api (and
    Opt_NewState's state), as the C library's bridge calls them."""
    import opt_tpu.api as jax_api

    names = ["new_state", "problem_define", "problem_plan", "set_solver_parameter",
             "problem_init", "problem_step", "problem_solve", "problem_current_cost",
             "plan_free", "problem_delete"]
    for n in names:
        assert callable(getattr(api, n, None)), f"opt_tpu_torch.api.{n}"
        assert callable(getattr(jax_api, n, None)), f"opt_tpu.api.{n}"
    assert hasattr(api, "OptState")
