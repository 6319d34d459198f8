"""tests/test_core.py through opt_tpu_torch: the port against dense oracles
(``torch.func.jacfwd`` of the flattened residuals, numpy least squares) on
tiny problems, and against the JAX package on the same inputs: shifts,
laplacian residuals, JᵀF / diag(JᵀJ) / JᵀJ·p, the GN optimum of a linear
problem, exclusion as a row and column projection, graph curve fitting,
LM against GN, LM with excluded rows, a data-gated coupling kept by the
threshold-aware probes, the validation fallback when they are switched
off, the stepwise API and the plan lifecycle."""

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu_torch import assembly as t_asm
from opt_tpu_torch.functions import FunctionSet
from opt_tpu_torch.ops.shift import shift, shift_adjoint

torch.set_num_threads(2)

f32 = np.float32


def laplacian_spec(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))


def _poisson(pkg):
    def poisson_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        T = S.Array("T", 2, (W, H))
        M = S.Array("M", 1, (W, H))
        S.UsePreconditioner(False)
        S.Exclude(pkg.Not(pkg.eq(M(0, 0), 0)))
        for dx, dy in pkg.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
            e = (X(0, 0) - X(dx, dy)) - (T(0, 0) - T(dx, dy))
            S.Energy(pkg.Select(pkg.InBounds(dx, dy), e, 0.0))

    return poisson_spec


poisson_spec = _poisson(ott)
jax_poisson_spec = _poisson(ot)


def tplan(spec, dims, kind="gaussNewtonGPU", **ip):
    return ott.Problem(spec, kind=kind).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))


def dense_system(plan, inputs):
    """(fs, unknowns, x0 flat, dense J at x0, column mask of the
    non-excluded unknowns), the residuals flattened term by term."""
    c = plan.compiled
    unknowns, consts, graphs, params = c.normalize_inputs(inputs, device="cpu")
    fs = FunctionSet(c, consts, graphs, params)
    names = sorted(unknowns)
    shapes = [tuple(unknowns[n].shape) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]

    def unflatten(v):
        out, o = {}, 0
        for n, s, sz in zip(names, shapes, sizes):
            out[n] = v[o : o + sz].reshape(s)
            o += sz
        return out

    def r_flat(v):
        return torch.cat([t.reshape(-1) for t in fs.F(unflatten(v))])

    x0 = torch.cat([unknowns[n].reshape(-1) for n in names])
    J = torch.func.jacfwd(r_flat)(x0)
    _excl, row_masks = fs.masks(unknowns)
    colmask = torch.cat([
        (torch.ones_like(unknowns[n]) if row_masks[n] is None
         else row_masks[n].expand(unknowns[n].shape).to(unknowns[n].dtype)).reshape(-1)
        for n in names])
    return fs, unknowns, x0.numpy(), J.numpy(), colmask.numpy()


def _flat(terms):
    return np.concatenate([t.numpy().ravel() for t in terms])


def test_shift_semantics():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4, 1)
    s = shift(x, (1, 0))
    assert torch.equal(s[:2], x[1:]) and bool((s[2] == 0).all())
    y = x * 0.5 + 1
    lhs = float(torch.sum(shift(x, (1, -2)) * y))
    rhs = float(torch.sum(x * shift_adjoint(y, (1, -2))))
    assert abs(lhs - rhs) < 1e-5


def test_laplacian_residuals_match_numpy():
    n = 6
    rng = np.random.RandomState(0)
    a, x = rng.rand(n, n).astype(f32), rng.rand(n, n).astype(f32)
    plan = tplan(laplacian_spec, {"W": n, "H": n})
    c = plan.compiled
    terms = c.residual_terms(*c.normalize_inputs({"X": x, "A": a}, device="cpu"))
    t0, t1, t2 = (t.numpy()[..., 0] for t in terms)
    np.testing.assert_allclose(t0, 0.2 * (x - a), atol=1e-6)
    expect1 = x - np.roll(x, -1, axis=0)
    expect1[-1, :] = 0.0  # the automatic bbox mask
    np.testing.assert_allclose(t1, expect1, atol=1e-6)
    expect2 = x - np.roll(x, -1, axis=1)
    expect2[:, -1] = 0.0
    np.testing.assert_allclose(t2, expect2, atol=1e-6)


def test_jtf_diag_and_apply_match_dense():
    n = 5
    rng = np.random.RandomState(1)
    inputs = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    plan = tplan(laplacian_spec, {"W": n, "H": n})
    fs, unknowns, _x0, J, _cm = dense_system(plan, inputs)
    r = _flat(fs.F(unknowns))
    np.testing.assert_allclose(fs.jtf(unknowns)["X"].numpy().ravel(), J.T @ r, atol=1e-4)
    np.testing.assert_allclose(fs.jtj_diag(unknowns)["X"].numpy().ravel(), (J * J).sum(0),
                               atol=1e-4)
    p = rng.rand(*unknowns["X"].shape).astype(f32)
    _r, Jop, JT = fs.linearize(unknowns)
    got = JT(Jop({"X": torch.as_tensor(p)}))["X"].numpy().ravel()
    np.testing.assert_allclose(got, J.T @ (J @ p.ravel()), atol=1e-3)
    # the assembled operator the solver runs, against the same dense product
    sp = plan.solver._stencil_plan
    A, diag, _jtf, _meta = fs.assemble_stencil(unknowns, sp, fs.assemble_const(unknowns, sp))
    np.testing.assert_allclose(A({"X": torch.as_tensor(p)})["X"].numpy().ravel(),
                               J.T @ (J @ p.ravel()), atol=1e-3)
    np.testing.assert_allclose(diag["X"].numpy().ravel(), (J * J).sum(0), atol=1e-4)


def test_gauss_newton_reaches_normal_equation_optimum():
    n = 8
    rng = np.random.RandomState(2)
    inputs = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    plan = tplan(laplacian_spec, {"W": n, "H": n})
    fs, unknowns, _x0, J, _cm = dense_system(plan, inputs)
    r0 = _flat(fs.F({k: torch.zeros_like(v) for k, v in unknowns.items()}))
    x_star, *_ = np.linalg.lstsq(J, -r0, rcond=None)
    res = plan.solve(inputs, nIterations=2, lIterations=200)
    np.testing.assert_allclose(res.unknowns["X"].numpy().ravel(), x_star, atol=1e-3)
    cost_star = 0.5 * float(np.sum((J @ x_star + r0) ** 2))
    assert res.final_cost <= cost_star * 1.001 + 1e-6
    assert plan.fused_fallback is None


def test_poisson_exclusion_semantics():
    n = 8
    rng = np.random.RandomState(3)
    m = np.zeros((n, n), f32)
    m[:2, :] = 1.0  # excluded band (frozen pixels)
    inputs = {"X": rng.rand(n, n, 2).astype(f32), "T": rng.rand(n, n, 2).astype(f32), "M": m}
    plan = tplan(poisson_spec, {"W": n, "H": n})
    fs, unknowns, xf, J, colmask = dense_system(plan, inputs)
    r0 = _flat(fs.F({k: torch.zeros_like(v) for k, v in unknowns.items()}))
    r_at_frozen = J @ (xf * (1 - colmask)) + r0
    d_star, *_ = np.linalg.lstsq(J * colmask[None, :], -r_at_frozen, rcond=None)
    x_star = xf * (1 - colmask) + d_star * colmask
    res = plan.solve(inputs, nIterations=2, lIterations=400)
    got = res.unknowns["X"].numpy().ravel()
    np.testing.assert_array_equal(got * (1 - colmask), xf * (1 - colmask))  # frozen: bit for bit
    np.testing.assert_allclose(got, x_star, atol=5e-3)
    jres = ot.Problem(jax_poisson_spec).plan(dims={"W": n, "H": n}).solve(
        inputs, nIterations=2, lIterations=400)
    np.testing.assert_allclose(res.final_cost, jres.final_cost, rtol=1e-4, atol=1e-7)


def test_graph_curve_fitting():
    """y = a cos(bx) + b sin(ax), truth (a, b) = (100, 102), a graph-only
    energy by GN from (99.6, 102.4)."""

    def curve_spec(S):
        N, U = S.Dim("N"), S.Dim("U")
        funcParams = S.Unknown("funcParams", 2, (U,))
        data = S.Image("data", 2, (N,))
        G = S.Graph("G", d=(N,), p=(U,))
        S.UsePreconditioner(True)
        x, y = data(G.d)[..., 0], data(G.d)[..., 1]
        a, b = funcParams(G.p)[..., 0], funcParams(G.p)[..., 1]
        S.Energy(y - (a * torch.cos(b * x) + b * torch.sin(a * x)))

    a_t, b_t, N = 100.0, 102.0, 200
    xs = np.random.RandomState(4).rand(N) * 0.1
    ys = a_t * np.cos(b_t * xs) + b_t * np.sin(a_t * xs)
    inputs = {"funcParams": np.array([[99.6, 102.4]], f32),
              "data": np.stack([xs, ys], axis=-1).astype(f32),
              "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}}
    res = tplan(curve_spec, {"N": N, "U": 1}).solve(inputs, nIterations=20, lIterations=50)
    got = res.unknowns["funcParams"].numpy()[0]
    assert abs(got[0] - a_t) < 0.2 and abs(got[1] - b_t) < 0.2, got
    assert res.final_cost < 1e-2


def test_lm_decreases_cost_nonlinear():
    """LM and GN on a small ARAP warp both reduce the cost strongly and
    agree on the final energy (the cross-solver oracle)."""

    def warp_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        O = S.Unknown("Offset", 2, (W, H))
        Ang = S.Unknown("Angle", 1, (W, H))
        Ur = S.Array("UrShape", 2, (W, H))
        Con = S.Array("Constraints", 2, (W, H))
        wf, wr = S.Param("w_fitSqrt"), S.Param("w_regSqrt")
        for dx, dy in ott.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
            e_reg = wr * ((O(0, 0) - O(dx, dy)) - ott.Rotate2D(Ang(0, 0), Ur(0, 0) - Ur(dx, dy)))
            S.Energy(ott.Select(ott.InBounds(dx, dy), e_reg, 0.0))
        valid = ott.All(ott.greatereq(Con(0, 0), 0))
        S.Energy(wf * ott.Select(valid, O(0, 0) - Con(0, 0), 0.0))

    n = 12
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    con[0, 0] = [1.0, 1.0]
    con[-1, -1] = [n - 2.0, n - 2.0]
    inputs = {"Offset": ur.copy(), "Angle": np.zeros((n, n), f32), "UrShape": ur,
              "Constraints": con, "w_fitSqrt": np.sqrt(10.0), "w_regSqrt": 1.0}
    res_lm = tplan(warp_spec, {"W": n, "H": n}, "LMGPU").solve(
        inputs, nIterations=15, lIterations=30)
    res_gn = tplan(warp_spec, {"W": n, "H": n}).solve(inputs, nIterations=15, lIterations=30)
    assert res_lm.costs[0] > res_lm.final_cost
    assert res_lm.final_cost < 2.0 and res_gn.final_cost < 2.0, (res_lm.costs, res_gn.costs)
    assert abs(res_lm.final_cost - res_gn.final_cost) < 1e-3 * res_gn.final_cost


@pytest.mark.parametrize("fused", [True, False])
def test_lm_with_exclude_solves(fused):
    """LM on an Exclude problem (diag(JᵀJ) = 0 at the frozen rows: a
    multiplicative mask of the damping would give inf·0) decreases the cost
    and agrees with GN."""
    n = 10
    rng = np.random.RandomState(7)
    t = rng.rand(n, n, 2).astype(f32)
    m = np.zeros((n, n, 1), f32)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 1.0
    inputs = {"X": t + 0.3 * rng.rand(n, n, 2).astype(f32) * (1.0 - m), "T": t, "M": m}
    dims = {"W": n, "H": n}
    res_lm = tplan(poisson_spec, dims, "LMGPU", use_fused_jtj=fused).solve(
        inputs, nIterations=12, lIterations=40)
    res_gn = tplan(poisson_spec, dims, use_fused_jtj=fused).solve(
        inputs, nIterations=12, lIterations=40)
    assert np.isfinite(res_lm.final_cost)
    assert res_lm.final_cost < 0.5 * res_lm.costs[0] or res_lm.final_cost < 1e-6
    assert abs(res_lm.final_cost - res_gn.final_cost) <= max(1e-3 * res_gn.final_cost, 1e-6)


def _gated_spec(S):
    """The fit coupling is gated on greater(D, 2.0); the data has D = 3.0
    (gate open), beyond a plain probe distribution's reach."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    D = S.Array("D", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(ott.Select(ott.greater(D(0, 0), 2.0), X(0, 0) - A(0, 0), 0.0))
    S.Energy(0.1 * (X(0, 0) - X(1, 0)))


def _gated_inputs(n):
    rng = np.random.RandomState(11)
    return {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32),
            "D": np.full((n, n), 3.0, f32)}


def test_fused_jtj_data_gated_coupling():
    """The probes straddle the comparison constants traced from the spec,
    so the assembled operator keeps the gated coupling and matches the
    composed one."""
    n = 10
    inputs, dims = _gated_inputs(n), {"W": n, "H": n}
    plan_f = tplan(_gated_spec, dims)
    res_f = plan_f.solve(inputs, nIterations=6, lIterations=30)
    assert plan_f.solver._stencil_plan is not None and plan_f.fused_fallback is None
    res_c = tplan(_gated_spec, dims, use_fused_jtj=False).solve(
        inputs, nIterations=6, lIterations=30)
    assert abs(res_f.final_cost - res_c.final_cost) <= max(1e-4 * res_c.final_cost, 1e-7)


def test_fused_jtj_validation_fallback(monkeypatch, capsys):
    """With the threshold collection switched off the probes miss the gated
    coupling: the first solve's random-vector validation sees it, says so
    and falls back to the composed operator."""
    monkeypatch.setattr(t_asm, "_comparison_constants", lambda *a, **k: [])

    def gated_spec_cold(S):  # a fresh function: plans are memoised per spec function
        _gated_spec(S)

    n = 10
    inputs, dims = _gated_inputs(n), {"W": n, "H": n}
    plan = tplan(gated_spec_cold, dims)
    assert plan.solver._stencil_plan is not None
    res = plan.solve(inputs, nIterations=6, lIterations=30)
    assert plan.solver._stencil_plan is None and plan.fused_fallback == "validation"
    assert "validat" in capsys.readouterr().err
    res_c = tplan(_gated_spec, dims, use_fused_jtj=False).solve(
        inputs, nIterations=6, lIterations=30)
    assert abs(res.final_cost - res_c.final_cost) <= max(1e-4 * res_c.final_cost, 1e-7)


def test_stepwise_api_matches_solve():
    n = 8
    rng = np.random.RandomState(6)
    inputs = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    res = tplan(laplacian_spec, {"W": n, "H": n}).solve(inputs, nIterations=3, lIterations=20)
    step = tplan(laplacian_spec, {"W": n, "H": n}).solve(inputs, nIterations=3, lIterations=20,
                                                        stepwise=True)
    np.testing.assert_allclose(res.final_cost, step.final_cost, rtol=1e-5)
    np.testing.assert_allclose(res.unknowns["X"].numpy(), step.unknowns["X"].numpy(), atol=1e-5)


def test_plan_lifecycle_cycle():
    """1000 plan-create/free cycles, then one real solve."""
    prob = ott.Problem(laplacian_spec)
    for _ in range(1000):
        prob.plan(dims={"W": 4, "H": 4}, device="cpu").free()
    res = prob.plan(dims={"W": 4, "H": 4}, device="cpu").solve(
        {"X": np.zeros((4, 4), f32), "A": np.ones((4, 4), f32)}, nIterations=3, lIterations=10)
    assert np.isfinite(res.final_cost)
