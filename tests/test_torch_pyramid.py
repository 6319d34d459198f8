"""PyramidPlan held to the port's host-driven per-level sequence and to the
JAX package's one-program PyramidPlan: tests/test_pyramid.py's two cases
(reference schedule: optical_flow/src/CombinedSolver.h:22-61)."""

import numpy as np
import torch

import opt_tpu as ot
import opt_tpu_torch as ott

torch.set_num_threads(2)
N = 16
SP = dict(nIterations=3, lIterations=15)


def _spec(pkg):
    def lap_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.4 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))

    return lap_spec


def _levels(n=N):
    rng = np.random.RandomState(3)
    fine = rng.rand(n, n).astype(np.float32)
    return fine[::2, ::2], fine


def _prolong(pkg):
    def prolong(unknowns, lvl, next_dims):
        return {"X": pkg.upsample2x_nearest(unknowns["X"], (next_dims["W"], next_dims["H"]),
                                            scale=1.0)}

    return prolong


DIMS = [{"W": N // 2, "H": N // 2}, {"W": N, "H": N}]


def test_pyramid_matches_host_driven_sequence_and_jax():
    coarse, fine = _levels()
    prob = ott.Problem(_spec(ott))
    r0 = prob.plan(dims=DIMS[0], device="cpu").solve(
        {"X": np.zeros_like(coarse), "A": coarse}, **SP)
    x_up = ott.upsample2x_nearest(r0.unknowns["X"], (N, N))
    r1 = prob.plan(dims=DIMS[1], device="cpu").solve({"X": x_up, "A": fine}, **SP)
    levels = [{"X": np.zeros_like(coarse), "A": coarse}, {"X": np.zeros_like(fine), "A": fine}]
    pplan = ott.PyramidPlan(ott.Problem(_spec(ott)), DIMS, _prolong(ott), device="cpu", **SP)
    res = pplan.solve([dict(lv) for lv in levels])
    assert all(p.device.type == "cpu" for p in pplan.plans)
    assert np.allclose(res.costs[0], r0.final_cost, rtol=1e-6)
    assert np.allclose(res.final_cost, r1.final_cost, rtol=1e-6)
    assert np.allclose(res.unknowns["X"].numpy(), r1.unknowns["X"].numpy(), atol=1e-6)
    assert res.num_linear_iterations == r0.num_linear_iterations + r1.num_linear_iterations > 0
    assert res.num_iterations == 2 * SP["nIterations"]
    jres = ot.PyramidPlan(ot.Problem(_spec(ot)), DIMS, _prolong(ot), **SP).solve(
        [dict(lv) for lv in levels])
    np.testing.assert_allclose(res.costs, jres.costs, rtol=1e-5)
    np.testing.assert_allclose(res.unknowns["X"].numpy(), np.asarray(jres.unknowns["X"]),
                               atol=1e-5)
    assert res.num_iterations == jres.num_iterations


def test_pyramid_restores_inf_sentinels():
    """±inf markers in the finest level's unknown inputs come back verbatim,
    as from the JAX package's PyramidPlan."""
    coarse, fine = _levels()
    fine_x0 = np.zeros_like(fine)
    fine_x0[0, 0] = -np.inf
    levels = [{"X": np.zeros_like(coarse), "A": coarse}, {"X": fine_x0, "A": fine}]
    kw = dict(nIterations=2, lIterations=8)
    res = ott.PyramidPlan(ott.Problem(_spec(ott)), DIMS, _prolong(ott), device="cpu",
                          **kw).solve([dict(lv) for lv in levels])
    out = res.unknowns["X"].numpy()
    assert np.isneginf(out[0, 0])
    mask = np.ones_like(out, bool)
    mask[0, 0] = False
    assert np.isfinite(out[mask]).all() and np.isfinite(res.final_cost)
    jres = ot.PyramidPlan(ot.Problem(_spec(ot)), DIMS, _prolong(ot), **kw).solve(
        [dict(lv) for lv in levels])
    np.testing.assert_allclose(out[mask], np.asarray(jres.unknowns["X"])[mask], atol=1e-5)
    np.testing.assert_allclose(res.costs, jres.costs, rtol=1e-5)


def test_pyramid_refuses_bad_levels():
    import pytest

    with pytest.raises(ValueError, match="at least one"):
        ott.PyramidPlan(ott.Problem(_spec(ott)), [], _prolong(ott), device="cpu")
    pplan = ott.PyramidPlan(ott.Problem(_spec(ott)), DIMS, _prolong(ott), device="cpu")
    with pytest.raises(ValueError, match="expected 2"):
        pplan.solve([{}])
