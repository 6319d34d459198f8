"""End-to-end solves of opt_tpu_torch held to opt_tpu: the medium golden
costs through Problem(...).plan(...).solve with the fused loop's twin and
with the eager loop, one GN step from a JAX state carried across, and the
stepwise API against solve."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.utils.convert import inputs_from_numpy, state_from_numpy, state_to_numpy
from tests.test_golden_costs import GOLDEN, _medium_cases

torch.set_num_threads(2)

SPECS = ["laplacian", "poisson_image_editing", "image_warping"]
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
GOLDEN_ATOL = 1e-8  # tests/test_golden_costs.py: near-zero goldens
_CASES = {}


def _case(name):
    if not _CASES:
        _CASES.update(_medium_cases())
    return _CASES[name]


def _ip(mode):
    return ott.InitializationParameters(use_pallas_cg=mode)


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("name", SPECS)
def test_golden_final_cost(name, mode):
    kind, nl, lin, golden = GOLDEN[name]
    dims, inputs = _case(name)
    plan = ott.Problem(getattr(tspecs, name)).plan(device="cpu", dims=dims, kind=kind, init_params=_ip(mode))
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=lin)
    assert plan.fused_fallback is None
    assert res.num_iterations == nl and res.num_linear_iterations > 0
    assert len(res.costs) == nl and res.costs[-1] == res.final_cost
    np.testing.assert_allclose(res.final_cost, golden, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)


def test_auto_mode_engages_the_fused_loop():
    """On CPU tensors "auto" runs the fused loop's twin, not the eager loop:
    the same operator, reached through fused_grid_cg."""
    from opt_tpu_torch.ops import fused_cg

    dims, inputs = _case("poisson_image_editing")
    calls = []
    orig = fused_cg.fused_grid_cg_reference

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    fused_cg.fused_grid_cg_reference = spy
    try:
        ott.Problem(tspecs.poisson_image_editing).plan(device="cpu", dims=dims).solve(
            dict(inputs), nIterations=2, lIterations=30
        )
    finally:
        fused_cg.fused_grid_cg_reference = orig
    assert len(calls) == 2


# image_warping's one-step parity is held in test_torch_lm.py on a warp
# with fit constraints: the medium case has none, so its LM system is near
# singular and 60 f32 CG iterations carry summation-order differences past
# the one-step bar
@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("name", ["laplacian", "poisson_image_editing"])
def test_one_step_from_jax_state(name, mode):
    """Both packages step once from the identical state: X agrees to the
    single-step bar (f32 reductions in another order) and the CG iteration
    counts are equal."""
    kind, _nl, lin, _g = GOLDEN[name]
    dims, inputs = _case(name)
    jp = ot.Problem(getattr(jspecs, name)).plan(dims=dims, kind=kind, nIterations=3, lIterations=lin)
    jp.init(dict(inputs))
    jp.step()  # start from a state the first step already moved
    state = jax.device_get(jp._state)
    jp.step()
    j_after = jax.device_get(jp._state)

    tp = ott.Problem(getattr(tspecs, name)).plan(
        device="cpu", dims=dims, kind=kind, init_params=_ip(mode), nIterations=3, lIterations=lin
    )
    tp.init(inputs_from_numpy(inputs, device="cpu"))
    tp._state = state_from_numpy(state, device="cpu")
    assert tp.step()
    t_after = state_to_numpy(tp._state)
    for k, v in j_after["X"].items():
        np.testing.assert_allclose(t_after["X"][k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max())
    assert int(t_after["lin_iters"]) == int(j_after["lin_iters"])
    assert int(t_after["n_iter"]) == int(j_after["n_iter"]) == 2
    np.testing.assert_allclose(t_after["prev_cost"], j_after["prev_cost"], rtol=1e-5)


@pytest.mark.parametrize("name", SPECS)
def test_stepwise_matches_solve(name):
    kind, nl, lin, _g = GOLDEN[name]
    dims, inputs = _case(name)
    plan = ott.Problem(getattr(tspecs, name)).plan(device="cpu", dims=dims, kind=kind)
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=lin)
    plan.set_solver_parameters({"nIterations": nl, "lIterations": lin})
    plan.init(dict(inputs))
    costs = []
    while plan.step():
        costs.append(plan.current_cost())
    costs.append(plan.current_cost())
    # solve probes the constant fields once, step once per step: same math
    np.testing.assert_allclose(costs[-1], res.final_cost, rtol=1e-6)
    assert len(costs) == nl
    np.testing.assert_allclose(costs, res.costs, rtol=1e-6)
    sw = plan.solve(dict(inputs), stepwise=True, nIterations=nl, lIterations=lin)
    np.testing.assert_allclose(sw.costs, res.costs, rtol=1e-6)
    for u in plan.compiled.unknown_names:
        assert torch.equal(plan.unknowns[u], sw.unknowns[u])
    plan.free()
    with pytest.raises(RuntimeError, match="init"):
        plan.current_cost()


def test_state_round_trip():
    dims, inputs = _case("laplacian")
    plan = ott.Problem(tspecs.laplacian).plan(device="cpu", dims=dims)
    plan.init(dict(inputs))
    st = state_to_numpy(plan._state)
    back = state_from_numpy(st, device="cpu")
    assert sorted(back) == sorted(plan._state)
    for k in ("prev_cost", "n_iter", "lin_iters", "done"):
        assert back[k].dtype == plan._state[k].dtype
        assert torch.equal(back[k], plan._state[k])
    assert torch.equal(back["X"]["X"], plan._state["X"]["X"])


def test_infinite_sentinels_restored():
    """±inf markers in an unknown are clamped for the solve and restored on
    output (excluded rows never update)."""
    dims, inputs = _case("poisson_image_editing")
    x = inputs["X"].copy()
    m = inputs["M"]
    x[m != 0] = -np.inf
    plan = ott.Problem(tspecs.poisson_image_editing).plan(device="cpu", dims=dims)
    res = plan.solve({**inputs, "X": x}, nIterations=1, lIterations=20)
    out = res.unknowns["X"].numpy()
    assert np.isneginf(out[m != 0]).all()
    assert np.isfinite(out[m == 0]).all()


def test_double_precision_solve():
    """float64 plans run the eager loop (the fused loop is float32) and
    reach the float32 golden."""
    kind, nl, lin, golden = GOLDEN["laplacian"]
    dims, inputs = _case("laplacian")
    plan = ott.Problem(tspecs.laplacian).plan(device="cpu", dims=dims, kind=kind, double_precision=True)
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=lin)
    assert res.unknowns["X"].dtype == torch.float64
    assert plan.fused_fallback is None
    np.testing.assert_allclose(res.final_cost, golden, rtol=GOLDEN_RTOL)
