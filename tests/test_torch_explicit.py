"""The explicit sparse-J path (explicit.py, ``use_explicit_jtj=True``: J and
Jᵀ as CSR, two ``torch.sparse`` matvecs a CG iteration) held as
tests/test_explicit.py holds the JAX package's: it reproduces the default
path's solves on grid and graph problems, GN and LM, and its J equals the
dense Jacobian export; and one explicit GN step equals the JAX package's
explicit step."""

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.explicit import build_explicit_j, explicit_structure
from opt_tpu_torch.models import specs as tspecs
from tests.test_torch_cross_space import FIXED_RTOL, two_space_inputs, two_space_spec

torch.set_num_threads(2)

EXPLICIT = dict(use_explicit_jtj=True)


def _poisson_inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, n), np.float32)
    mask[n // 4 : -n // 4, n // 4 : -n // 4] = 0.0
    return {"X": rng.rand(n, n, 4).astype(np.float32), "T": rng.rand(n, n, 4).astype(np.float32),
            "M": mask}


def _curve_inputs(N, seed=1):
    rng = np.random.RandomState(seed)
    xs = rng.rand(N) * 0.1
    ys = 100.0 * np.cos(102.0 * xs) + 102.0 * np.sin(100.0 * xs)
    return {"funcParams": np.array([[99.6, 102.4]], np.float32),
            "data": np.stack([xs, ys], -1).astype(np.float32),
            "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}}


def _plan(spec, dims, kind="gaussNewtonGPU", **ip):
    return ott.Problem(spec, kind=kind).plan(dims=dims, device="cpu",
                                             init_params=ott.InitializationParameters(**ip))


def test_explicit_jtj_matches_default_grid():
    n = 24
    inputs = _poisson_inputs(n)
    res_def = _plan(tspecs.poisson_image_editing, {"W": n, "H": n}).solve(
        dict(inputs), nIterations=1, lIterations=80)
    plan = _plan(tspecs.poisson_image_editing, {"W": n, "H": n}, **EXPLICIT)
    res_exp = plan.solve(dict(inputs), nIterations=1, lIterations=80)
    assert plan.solver._stencil_plan is None and res_exp.fused_fallback is None
    assert np.allclose(res_def.final_cost, res_exp.final_cost, rtol=1e-4)
    assert np.allclose(res_def.unknowns["X"].numpy(), res_exp.unknowns["X"].numpy(), atol=2e-3)


def test_explicit_jtj_matches_default_graph_lm():
    N = 128
    inputs = _curve_inputs(N)
    dims = {"N": N, "U": 1}
    res_def = _plan(tspecs.curve_fitting, dims, "LMGPU").solve(
        dict(inputs), nIterations=12, lIterations=30)
    res_exp = _plan(tspecs.curve_fitting, dims, "LMGPU", **EXPLICIT).solve(
        dict(inputs), nIterations=12, lIterations=30)
    got = res_exp.unknowns["funcParams"].numpy()[0]
    assert abs(got[0] - 100.0) < 0.3 and abs(got[1] - 102.0) < 0.3, got
    assert np.allclose(res_def.final_cost, res_exp.final_cost, rtol=1e-3)


@pytest.mark.parametrize("case", ["poisson", "two_space"])
def test_explicit_j_matches_dump_jacobian_dense(case):
    """The CSR J (and Jᵀ) equal the numpy Jacobian export, densified."""
    if case == "poisson":
        n = 8
        rng = np.random.RandomState(2)
        inputs = {"X": rng.rand(n, n, 4).astype(np.float32),
                  "T": rng.rand(n, n, 4).astype(np.float32),
                  "M": (rng.rand(n, n) > 0.5).astype(np.float32)}
        plan = _plan(tspecs.poisson_image_editing, {"W": n, "H": n})
    else:
        dims, inputs = two_space_inputs(16, 4, 40)
        plan = _plan(two_space_spec(ott), dims)
    u, c, g, p = plan._normalize_and_place(dict(inputs))
    J, JT = build_explicit_j(plan.compiled, u, c, g, p, explicit_structure(plan.compiled, g, "cpu"))
    oracle = plan.dump_jacobian(dict(inputs), dense=True)
    np.testing.assert_allclose(J.to_dense().double().numpy(), oracle, atol=1e-5)
    np.testing.assert_allclose(JT.to_dense().double().numpy(), oracle.T, atol=1e-5)


def _deltas(res, inputs, names):
    return np.concatenate([
        ((res.unknowns[k].numpy() if isinstance(res.unknowns[k], torch.Tensor)
          else np.asarray(res.unknowns[k])) - inputs[k]).ravel() for k in names])


@pytest.mark.parametrize("case", ["poisson", "two_space"])
def test_explicit_gn_step_matches_jax(case):
    """One explicit GN step at 10 CG iterations: the JAX package's explicit
    step to 1e-6 of its largest entry (the two-space toy's to its float32
    floor, 3e-6: tests/test_torch_cross_space.py), in as many iterations."""
    if case == "poisson":
        n = 16
        dims, inputs = {"W": n, "H": n}, _poisson_inputs(n)
        jspec, tspec = jspecs.poisson_image_editing, tspecs.poisson_image_editing
    else:
        dims, inputs = two_space_inputs()
        jspec, tspec = two_space_spec(ot), two_space_spec(ott)
    kw = dict(nIterations=1, lIterations=10, cg_rz_tolerance=0.0)
    jr = ot.Problem(jspec).plan(dims=dims, init_params=ot.InitializationParameters(
        **EXPLICIT)).solve(dict(inputs), **kw)
    plan = _plan(tspec, dims, **EXPLICIT)
    tr = plan.solve(dict(inputs), **kw)
    names = list(plan.compiled.unknown_names)
    jd, td = _deltas(jr, inputs, names), _deltas(tr, inputs, names)
    assert tr.num_linear_iterations == jr.num_linear_iterations
    rtol = 1e-6 if case == "poisson" else FIXED_RTOL["two_space"]
    assert float(np.abs(td - jd).max()) <= rtol * float(np.abs(jd).max())


def test_explicit_cross_space_and_batched():
    """A graph coupling two vertex spaces solves on the explicit J as on the
    assembled operator; a two-system ``solve_batched`` steps each instance
    on it (no vmap of the sparse product) as its own solve."""
    dims, inputs = two_space_inputs()
    spec = two_space_spec(ott)
    kw = dict(nIterations=2, lIterations=60)
    ref = _plan(spec, dims).solve(dict(inputs), **kw)
    plan = _plan(spec, dims, **EXPLICIT)
    res = plan.solve(dict(inputs), **kw)
    np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=1e-4)
    X2 = np.stack([inputs["X"], inputs["X"] + 0.25]).astype(np.float32)
    bres = plan.solve_batched(dict(inputs, X=X2), **kw)
    for k in range(2):
        own = _plan(spec, dims, **EXPLICIT).solve(dict(inputs, X=X2[k]), **kw)
        np.testing.assert_allclose(bres.final_costs[k], own.final_cost, rtol=1e-6)
        assert bres.num_linear_iterations[k] == own.num_linear_iterations
