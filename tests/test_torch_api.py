"""opt_tpu_torch.api, the Opt.h-shaped functions, against opt_tpu.api: the
lifecycle of tests/test_api_and_tools.py on both packages (the port's plans
on the CPU), its plan create/free cycling on the port, the stepwise loop against
problem_solve, the final costs of both packages on the same inputs, and the
state's device, precision and timing switches."""

import numpy as np
import pytest
import torch

import opt_tpu.api as jax_api
import opt_tpu_torch.api as torch_api
from opt_tpu.models.specs import laplacian as jax_laplacian
from opt_tpu_torch.models.specs import laplacian as torch_laplacian

torch.set_num_threads(2)

PACKAGES = {"jax": (jax_api, jax_laplacian, {}),
            "torch": (torch_api, torch_laplacian, {"device": "cpu"})}


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_opt_h_api_lifecycle(pkg):
    api, laplacian, state_kw = PACKAGES[pkg]
    state = api.new_state(verbosity=0, **state_kw)
    problem = api.problem_define(state, laplacian, "gaussNewtonGPU")
    plan = api.problem_plan(state, problem, {"W": 8, "H": 8})
    api.set_solver_parameter(plan, "nIterations", 2)
    api.set_solver_parameter(plan, "lIterations", 20)
    api.problem_init(plan, _inputs(8))
    steps = 0
    while api.problem_step(plan):
        steps += 1
        c = api.problem_current_cost(plan)
        assert np.isfinite(c)
    assert steps >= 1
    api.plan_free(plan)
    api.problem_delete(state, problem)
    assert not state.problems


def test_create_delete_cycle():
    """Plan create/free cycling (reference tests/create_delete_cycle),
    trimmed as tests/test_api_and_tools.py trims it; the JAX package's side
    is that test itself (about 35 s here: each new plan compiles anew)."""
    api, laplacian, state_kw = PACKAGES["torch"]
    state = api.new_state(verbosity=0, **state_kw)
    inputs = _inputs(8)
    for _ in range(50):
        problem = api.problem_define(state, laplacian, "gaussNewtonGPU")
        plan = api.problem_plan(state, problem, {"W": 8, "H": 8})
        api.problem_init(plan, dict(inputs))
        api.plan_free(plan)
        api.problem_delete(state, problem)
    assert not state.problems


def _torch_plan(n=12, nl=2, li=20, **state_kw):
    state = torch_api.new_state(device="cpu", **state_kw)
    plan = torch_api.problem_plan(state, torch_api.problem_define(state, torch_laplacian),
                                  {"W": n, "H": n})
    torch_api.set_solver_parameter(plan, "nIterations", nl)
    torch_api.set_solver_parameter(plan, "lIterations", li)
    return state, plan


def test_step_loop_equals_problem_solve():
    """Opt_ProblemInit + the Opt_ProblemStep loop is Opt_ProblemSolve: the
    same cost and unknowns, bit for bit."""
    inputs = _inputs(12, seed=1)
    _s, plan = _torch_plan()
    torch_api.problem_init(plan, dict(inputs))
    while torch_api.problem_step(plan):
        pass
    stepped_cost = torch_api.problem_current_cost(plan)
    stepped_x = plan.unknowns["X"].clone()
    res = torch_api.problem_solve(plan, dict(inputs))
    assert res.final_cost == stepped_cost
    assert torch.equal(res.unknowns["X"], stepped_x)


def test_final_costs_match_jax():
    """laplacian 12x12, GN 2x20, stepped through both packages' api."""
    inputs = _inputs(12, seed=2)
    costs = {}
    for pkg, (api, laplacian, state_kw) in PACKAGES.items():
        state = api.new_state(**state_kw)
        plan = api.problem_plan(state, api.problem_define(state, laplacian), {"W": 12, "H": 12})
        api.set_solver_parameter(plan, "nIterations", 2)
        api.set_solver_parameter(plan, "lIterations", 20)
        api.problem_init(plan, dict(inputs))
        while api.problem_step(plan):
            pass
        costs[pkg] = api.problem_current_cost(plan)
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-5)


def test_default_state_plans_on_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = torch_api.new_state()
    assert state.device == "cuda"
    problem = torch_api.problem_define(state, torch_laplacian)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_api.problem_plan(state, problem, {"W": 8, "H": 8})


def test_double_precision_state_makes_float64_plans_and_flips_no_global():
    default = torch.get_default_dtype()
    _s, plan = _torch_plan(double_precision=True)
    assert torch.get_default_dtype() == default
    assert plan.compiled.dtype == torch.float64
    torch_api.problem_init(plan, _inputs(12))
    assert plan.unknowns["X"].dtype == torch.float64
    _s, plan32 = _torch_plan()
    assert plan32.compiled.dtype == torch.float32


def test_collect_per_kernel_timing_reaches_the_plan(capsys):
    _s, plan = _torch_plan(collect_per_kernel_timing=True)
    assert plan.solver.ip.collect_per_kernel_timing is True
    torch_api.problem_solve(plan, _inputs(12))
    assert "TIMING " in capsys.readouterr().out


def test_problem_define_from_an_energy_file(tmp_path):
    path = tmp_path / "energy.py"
    path.write_text("def spec(S):\n"
                    "    W, H = S.Dim('W'), S.Dim('H')\n"
                    "    X = S.Unknown('X', 1, (W, H))\n"
                    "    A = S.Array('A', 1, (W, H))\n"
                    "    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))\n")
    inputs = _inputs(12, seed=3)
    results = []
    for spec in (str(path), torch_laplacian):
        state = torch_api.new_state(device="cpu")
        plan = torch_api.problem_plan(state, torch_api.problem_define(state, spec),
                                      {"W": 12, "H": 12})
        results.append(torch_api.problem_solve(plan, dict(inputs), nIterations=2,
                                               lIterations=10))
    assert results[0].final_cost == results[1].final_cost
