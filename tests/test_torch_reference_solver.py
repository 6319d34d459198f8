"""Cross-solver final-cost agreement against the independent scipy solver
(reference_solver.py, the reference's Ceres-comparison oracle), as
tests/test_reference_solver.py holds the JAX package: the port's GN and LM
reach the final energies of scipy.optimize.least_squares on the same
energy definition, and the port's scipy oracle reaches the JAX package's
oracle's cost."""

import numpy as np
import torch

import opt_tpu_torch as ott
from opt_tpu.reference_solver import solve_scipy as j_solve_scipy
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.reference_solver import solve_scipy

torch.set_num_threads(2)


def _curve_inputs(N=64):
    rng = np.random.RandomState(3)
    xs = rng.rand(N) * 0.1
    ys = 100.0 * np.cos(102.0 * xs) + 102.0 * np.sin(100.0 * xs) + rng.randn(N) * 0.1
    return {"funcParams": np.array([[99.6, 102.4]], np.float32),
            "data": np.stack([xs, ys], -1).astype(np.float32),
            "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}}


def test_curve_fitting_agrees_with_scipy():
    N = 64
    inputs = _curve_inputs(N)
    dims = {"N": N, "U": 1}
    scipy_cost, scipy_x = solve_scipy(tspecs.curve_fitting, dims, dict(inputs))
    assert scipy_x["funcParams"].shape == (1, 2) and scipy_x["funcParams"].dtype == np.float32
    for kind in ("gaussNewtonGPU", "LMGPU"):
        res = ott.Problem(tspecs.curve_fitting, kind=kind).plan(dims=dims, device="cpu").solve(
            dict(inputs), nIterations=20, lIterations=40)
        assert np.isclose(res.final_cost, scipy_cost, rtol=1e-3), (kind, res.final_cost,
                                                                  scipy_cost)
    j_cost, _jx = j_solve_scipy(jspecs.curve_fitting, dims, dict(inputs))
    assert np.isclose(scipy_cost, j_cost, rtol=1e-4), (scipy_cost, j_cost)


def test_arap_agrees_with_scipy():
    n_side = 5
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(np.float32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -1e6 * np.ones((N, 3), np.float32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([1.0, 0, 0.5], np.float32)
    inputs = {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), np.float32), "UrShape": pos,
        "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(0.7),
    }
    dims = {"N": N}
    scipy_cost, _ = solve_scipy(tspecs.arap_mesh_deformation, dims, dict(inputs), max_nfev=400)
    res = ott.Problem(tspecs.arap_mesh_deformation, kind="LMGPU").plan(
        dims=dims, device="cpu").solve(dict(inputs), nIterations=30, lIterations=60)
    assert np.isclose(res.final_cost, scipy_cost, rtol=5e-3), (res.final_cost, scipy_cost)


def test_excluded_unknowns_stay_fixed():
    """Excluded unknowns are held at their inputs (poisson's frozen border),
    so scipy optimizes the solver's free variables; its cost is the JAX
    oracle's. (The solvers' own poisson cost is not held here: residuals
    centred on excluded pixels feed their gradients but not their cost,
    as in the reference, so GN stops above the oracle's minimum of the
    cost.)"""
    n = 8
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), np.float32)
    mask[2:-2, 2:-2] = 0.0
    inputs = {"X": rng.rand(n, n, 4).astype(np.float32), "T": rng.rand(n, n, 4).astype(np.float32),
              "M": mask}
    dims = {"W": n, "H": n}
    cost, x = solve_scipy(tspecs.poisson_image_editing, dims, dict(inputs))
    frozen = mask != 0
    np.testing.assert_array_equal(x["X"][frozen], inputs["X"][frozen])
    j_cost, _jx = j_solve_scipy(jspecs.poisson_image_editing, dims, dict(inputs))
    assert np.isclose(cost, j_cost, rtol=1e-4, atol=1e-6), (cost, j_cost)
