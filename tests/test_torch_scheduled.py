"""Plan.solve_scheduled held to the port's host-driven loop and to the JAX
package's one-program schedule: tests/test_scheduled.py's case (the
reference's per-outer-solve input swapping, CombinedSolver.h:150-152
setConstraintImage)."""

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott

torch.set_num_threads(2)

N, NUM_OUTER, NL, LIN = 16, 5, 3, 15


def _spec(pkg):
    def warp_like_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        C = S.Array("C", 2, (W, H))
        valid = pkg.greatereq(C(0, 0), -999999.9)
        S.Energy(pkg.Select(valid, 2.0 * (X(0, 0) - C(0, 0)), 0.0))
        S.Energy(X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))

    return warp_like_spec


def _data(n=N):
    rng = np.random.RandomState(2)
    x0 = rng.rand(n, n, 2).astype(np.float32)
    c0 = np.full((n, n, 2), -1e6, np.float32)
    c1 = np.full((n, n, 2), -1e6, np.float32)
    for (i, j) in [(2, 3), (n - 3, n - 2), (5, 9)]:
        c0[i, j] = x0[i, j]
        c1[i, j] = x0[i, j] + [0.8, -0.4]
    return x0, c0, c1


_RUNS = {}


def _runs():
    """(the port's host-driven loop, the port's solve_scheduled, the JAX
    package's solve_scheduled)."""
    if _RUNS:
        return _RUNS["v"]
    import jax.numpy as jnp

    x0, c0, c1 = _data()
    plan = ott.Problem(_spec(ott)).plan({"W": N, "H": N}, device="cpu", nIterations=NL,
                                        lIterations=LIN)
    inputs = {"X": x0.copy(), "C": c1}
    host = []
    for i in range(NUM_OUTER):
        a = np.float32((i + 1.0) / NUM_OUTER)
        inputs["C"] = (1 - a) * c0 + a * c1
        res = plan.solve(dict(inputs))
        inputs["X"] = res.unknowns["X"]
        host.append(res)

    C0, C1 = torch.as_tensor(c0), torch.as_tensor(c1)
    seen = []

    def schedule(consts, i):
        seen.append(i)
        a = (i.to(torch.float32) + 1.0) / NUM_OUTER
        return {**consts, "C": (1.0 - a) * C0 + a * C1}

    plan2 = ott.Problem(_spec(ott)).plan({"W": N, "H": N}, device="cpu")
    sched = plan2.solve_scheduled({"X": x0.copy(), "C": c1}, schedule, NUM_OUTER,
                                  nIterations=NL, lIterations=LIN)
    J0, J1 = jnp.asarray(c0), jnp.asarray(c1)

    def jschedule(consts, i):
        a = (i.astype(jnp.float32) + 1.0) / NUM_OUTER
        return {**consts, "C": (1.0 - a) * J0 + a * J1}

    jres = ot.Problem(_spec(ot)).plan({"W": N, "H": N}).solve_scheduled(
        {"X": x0.copy(), "C": c1}, jschedule, NUM_OUTER, nIterations=NL, lIterations=LIN)
    _RUNS["v"] = (host, sched, jres, seen)
    return _RUNS["v"]


def test_scheduled_matches_host_driven_loop():
    host, sched, _jres, seen = _runs()
    assert len(sched.costs) == NUM_OUTER
    np.testing.assert_allclose(sched.costs, [h.final_cost for h in host], rtol=1e-5)
    assert np.isclose(sched.final_cost, host[-1].final_cost, rtol=1e-5)
    np.testing.assert_allclose(sched.unknowns["X"].numpy(), host[-1].unknowns["X"].numpy(),
                               atol=1e-5)
    assert sched.num_linear_iterations == sum(h.num_linear_iterations for h in host) > 0
    assert sched.num_iterations == NUM_OUTER * NL
    # i: a 0-dim int32 tensor on the plan's device, 0 .. num_outer-1
    assert [int(i) for i in seen] == list(range(NUM_OUTER))
    assert all(i.dtype == torch.int32 and i.dim() == 0 and i.device.type == "cpu" for i in seen)


def test_scheduled_matches_jax():
    _host, sched, jres, _seen = _runs()
    np.testing.assert_allclose(sched.costs, jres.costs, rtol=1e-5)
    assert np.isclose(sched.final_cost, jres.final_cost, rtol=1e-5)
    np.testing.assert_allclose(sched.unknowns["X"].numpy(), np.asarray(jres.unknowns["X"]),
                               atol=1e-5)
    assert sched.num_iterations == jres.num_iterations


def test_schedule_sees_sanitised_constants():
    """The schedule receives the bound constants with ±inf clamped to finite
    sentinels, as the reference's does."""
    x0, c0, _c1 = _data()
    c = c0[:8, :8].copy()
    c[0, 0] = -np.inf
    got = []

    def schedule(consts, i):
        got.append(bool(torch.isfinite(consts["C"]).all()))
        return consts

    plan = ott.Problem(_spec(ott)).plan({"W": 8, "H": 8}, device="cpu")
    res = plan.solve_scheduled({"X": x0[:8, :8].copy(), "C": c}, schedule, 2,
                               nIterations=1, lIterations=5)
    assert got == [True, True] and np.isfinite(res.final_cost)


@pytest.mark.parametrize("num_outer", [0, 1])
def test_scheduled_short_schedules(num_outer):
    """No outer solve returns the input unknowns and no cost; one equals a
    plain solve."""
    x0, c0, _c1 = _data()
    inputs = {"X": x0[:8, :8].copy(), "C": c0[:8, :8].copy()}
    plan = ott.Problem(_spec(ott)).plan({"W": 8, "H": 8}, device="cpu")
    res = plan.solve_scheduled(dict(inputs), lambda c, i: c, num_outer, nIterations=2,
                               lIterations=5)
    assert len(res.costs) == num_outer and res.num_iterations == 2 * num_outer
    if num_outer:
        one = plan.solve(dict(inputs), nIterations=2, lIterations=5)
        assert res.final_cost == one.final_cost
    else:
        assert np.array_equal(res.unknowns["X"].numpy(), inputs["X"])
