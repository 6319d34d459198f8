"""tests/test_select_sentinel.py through opt_tpu_torch: the double-``where``
Select with ±inf sentinels in the untaken branch, the bind-time clamp of
infinite constants, the bundled ARAP spec on -inf-sentinel data (GN and LM,
assembled and composed operator) against the JAX package's final cost, -inf
markers in the initial unknown (frozen by Exclude, restored in the output),
and the clamp's report at verbosity 1."""

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.compile import compile_spec
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.utils.logging import set_verbosity
from tests.test_select_sentinel import _arap_inputs

torch.set_num_threads(2)

f32 = np.float32


def test_select_double_where_output_isolation():
    """Value and gradient stay finite downstream of a Select whose untaken
    branch carries ±inf; the taken entry's gradient is exact."""
    con = torch.tensor([-np.inf, 2.0, np.inf], dtype=torch.float32)

    def f(x):
        valid = (con >= -999999.9) & (con <= 999999.9)
        r = ott.Select(valid, x - con, 0.0)
        return torch.sum(x * r * r)

    x = torch.ones(3, dtype=torch.float32)
    grad, val = torch.func.grad_and_value(f)(x)
    assert np.isfinite(float(val)) and bool(torch.isfinite(grad).all())
    np.testing.assert_allclose(grad.numpy(), [0.0, -1.0, 0.0], rtol=1e-5)
    _v, tan = torch.func.jvp(f, (x,), (torch.ones_like(x),))  # forward mode, as the probes run
    np.testing.assert_allclose(float(tan), -1.0, rtol=1e-5)


def test_bind_time_sentinel_sanitization():
    """±inf in a bound constant array is clamped to a finite value that
    keeps every traced comparison's outcome."""

    def spec(S):
        N = S.Dim("N")
        X = S.Unknown("X", 1, (N,))
        C = S.Array("C", 1, (N,))
        valid = ott.greatereq(C(0), -999999.9)
        S.Energy(ott.Select(valid, (X(0) - C(0)) * (X(0) - C(0)), 0.0))

    c = compile_spec(spec, {"N": 4}, torch.float32)
    _u, consts, _g, _p = c.normalize_inputs(
        {"X": np.ones(4, f32), "C": np.array([-np.inf, 0.5, np.inf, 1.0], f32)}, device="cpu")
    assert bool(torch.isfinite(consts["C"]).all()), "inf not clamped"
    assert float(consts["C"][0, 0]) < -999999.9
    assert float(consts["C"][2, 0]) > 999999.9


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("fused", [True, False])
def test_arap_inf_sentinels_solve(kind, fused):
    """-inf invalid constraints solve NaN-free, to the finite sentinels'
    final cost (1e-4) and to the JAX package's on the same data (5e-3, the
    golden gate: arap's GN trajectory amplifies rounding)."""
    N = 24
    sp = {"nIterations": 6, "lIterations": 20}
    plan = ott.Problem(tspecs.arap_mesh_deformation, kind=kind).plan(
        dims={"N": N}, device="cpu", init_params=ott.InitializationParameters(use_fused_jtj=fused))
    res_inf = plan.solve(_arap_inputs(N, use_inf=True), **sp)
    assert np.isfinite(res_inf.final_cost), "solve NaN'd on -inf sentinels"
    res_fin = plan.solve(_arap_inputs(N, use_inf=False), **sp)
    np.testing.assert_allclose(res_inf.final_cost, res_fin.final_cost, rtol=1e-4)
    assert res_inf.final_cost < res_inf.costs[0]
    jres = ot.Problem(jspecs.arap_mesh_deformation, kind=kind).plan(
        dims={"N": N}, init_params=ot.InitializationParameters(use_fused_jtj=fused)
    ).solve(_arap_inputs(N, use_inf=True), **sp)
    np.testing.assert_allclose(res_inf.final_cost, jres.final_cost, rtol=5e-3)


def _inf_unknown_spec(pkg):
    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        D = S.Array("D", 1, (W, H))
        valid_c = pkg.greater(D(0, 0), 0.0)
        S.Exclude(pkg.Not(valid_c))
        S.Energy(pkg.Select(valid_c, X(0, 0) - D(0, 0), 0.0))
        both = pkg.And(valid_c, pkg.greater(D(1, 0), 0.0))
        S.Energy(pkg.Select(both, 0.3 * (X(0, 0) - X(1, 0)) * X(1, 0), 0.0))

    return spec


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_inf_sentinels_in_unknowns_solve_and_restore(kind):
    """-inf markers in the initial unknown neither NaN the solve nor leave
    the output: excluded rows are frozen and carry the markers; the costs
    equal the JAX package's to 1e-4."""
    n = 12
    rng = np.random.RandomState(3)
    d = rng.uniform(0.5, 1.5, (n, n)).astype(f32)
    invalid = np.zeros((n, n), bool)
    invalid[:, : n // 3] = True
    d[invalid] = -1.0
    x0 = d + 0.4 * rng.randn(n, n).astype(f32)
    x0[invalid] = -np.inf
    inputs = {"X": x0, "D": d}
    plan = ott.Problem(_inf_unknown_spec(ott), kind=kind).plan(dims={"W": n, "H": n}, device="cpu")
    res = plan.solve(dict(inputs), nIterations=6, lIterations=25)
    assert all(np.isfinite(c) for c in res.costs)
    X = res.unknowns["X"].numpy()[..., 0]
    assert np.isneginf(X[invalid]).all(), "markers must be restored"
    assert np.isfinite(X[~invalid]).all()
    assert res.final_cost < 0.99 * res.costs[0], res.costs
    jres = ot.Problem(_inf_unknown_spec(ot), kind=kind).plan(
        dims={"W": n, "H": n}).solve(dict(inputs), nIterations=6, lIterations=25)
    np.testing.assert_allclose(res.costs, jres.costs, rtol=1e-4)
    assert plan.fused_fallback is None


def test_sentinel_clamp_warning_at_verbosity(capsys):
    """The clamp reports that it fired at verbosity >= 1 and stays silent
    at 0."""
    inputs = _arap_inputs(N=12, use_inf=True)
    plan = ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": 12}, device="cpu")
    try:
        set_verbosity(1)
        plan.compiled.normalize_inputs(dict(inputs), device="cpu")
        err = capsys.readouterr().err
        assert "clamped" in err and "sentinel" in err, err
        set_verbosity(0)
        plan.compiled.normalize_inputs(dict(inputs), device="cpu")
        err = capsys.readouterr().err
        assert "clamped" not in err, err
    finally:
        set_verbosity(0)
