"""image_warping (Opt's 2-D ARAP warp) through opt_tpu_torch, held to
opt_tpu: two unknowns packed into one index space (Offset 2 + Angle 1
channels, with cross-channel couplings), Angle's fields re-probed every
step, the assembled operator validated at the real and a perturbed point,
and whole GN and LM solves through the public API on bench.py's inputs."""

import dataclasses
import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg

torch.set_num_threads(2)

N = 32


def _bench_inputs(n=N, n_con=16):
    """bench.py::bench_image_warping's inputs at n²."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    for _ in range(n_con):
        i, j = rng.randint(0, n, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, n), f32), "UrShape": ur,
        "Constraints": con, "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def _tplan(kind="gaussNewtonGPU", **kw):
    return ott.Problem(tspecs.image_warping, kind=kind).plan(device="cpu", dims={"W": N, "H": N}, **kw)


def test_two_unknowns_pack_into_one_index_space():
    """Offset and Angle share the grid: one fused meta over 3 channels with
    couplings between them, and Angle's Jacobian fields are not constant
    (Rotate2D of the angle), so each step re-probes them."""
    tp = _tplan()
    meta, _r0, _pre, _kw = tp.cg_inputs(_bench_inputs())
    assert tp.fused_fallback is None and meta is not None
    assert meta["u_list"] == ("Offset", "Angle") and meta["ctot"] == 3
    assert meta["offs"] == {"Offset": 0, "Angle": 2}
    cross = {(i, j) for (_d, i, j, _f) in meta["triples"] if i != j}
    assert {(0, 2), (1, 2), (2, 0), (2, 1)} <= cross
    plan = tp.solver._stencil_plan
    slots = tp.compiled.registry.slots
    used = {(t, sid) for v in plan.w_spec.values() for (t, so, si) in v for sid in (so, si)}
    angle = {k for k in used if slots[k[1]].image == "Angle"}
    offset = {k for k in used if slots[k[1]].image == "Offset"}
    assert angle and not angle & plan.const_tsids
    assert offset <= plan.const_tsids
    jp = ot.Problem(jspecs.image_warping).plan(dims={"W": N, "H": N})
    assert jp.solver._stencil_plan.const_tsids == plan.const_tsids


def test_validation_catches_a_stale_angle_field():
    """validate_assembly checks at the real X and at a perturbed X′ with
    the const cache still built at X: it passes as planned, and fails once
    Angle's fields are wrongly marked constant (at X both agree; at X′ the
    stale fields do not)."""
    tp = _tplan()
    # unit weights: with w_fit = 100 the check's scale is the fit term's
    # and a stale w_reg = 0.1 coupling hides under its tolerance
    inputs = dict(_bench_inputs(), w_fitSqrt=np.float32(1.0), w_regSqrt=np.float32(1.0))
    u, c, g, p = tp._normalize_and_place(inputs)
    sv = tp.solver
    assert sv.validate_assembly(u, c, g, p)
    slots = tp.compiled.registry.slots
    plan = sv._stencil_plan
    stale = {(t, sid) for v in plan.w_spec.values() for (t, so, si) in v
             for sid in (so, si) if slots[sid].image == "Angle"}
    sv._stencil_plan = dataclasses.replace(plan, const_tsids=plan.const_tsids | stale)
    assert not sv.validate_assembly(u, c, g, p)


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_solve_matches_jax(kind):
    """bench.py's warp at 32², 4×60, through Problem.plan.solve in both
    packages: the final cost agrees, the port's solve goes through the
    fused loop (its twin on the CPU) once per nonlinear step, and nothing
    falls back to the composed operator."""
    inputs = _bench_inputs()
    jr = ot.Problem(jspecs.image_warping, kind=kind).plan(dims={"W": N, "H": N}).solve(
        dict(inputs), nIterations=4, lIterations=60
    )
    calls = []
    orig = fused_cg.fused_grid_cg_reference

    def spy(*a, **k):
        calls.append("lm" if k.get("ctc") is not None else "gn")
        return orig(*a, **k)

    fused_cg.fused_grid_cg_reference = spy
    try:
        tp = ott.Problem(tspecs.image_warping, kind=kind).plan(device="cpu", dims={"W": N, "H": N})
        tr = tp.solve(dict(inputs), nIterations=4, lIterations=60)
    finally:
        fused_cg.fused_grid_cg_reference = orig
    assert tp.fused_fallback is None
    assert calls == ["lm" if kind == "LMGPU" else "gn"] * tr.num_iterations
    assert tr.num_iterations == jr.num_iterations == 4
    assert tr.unknowns["Offset"].shape == (N, N, 2) and tr.unknowns["Angle"].shape == (N, N, 1)
    assert all(bool(torch.isfinite(v).all()) for v in tr.unknowns.values())
    # the fused loop against the JAX package's XLA loop over four steps:
    # f32 sums in another order, carried through four nonlinear steps
    np.testing.assert_allclose(tr.final_cost, jr.final_cost, rtol=1e-4)
    j_off = np.asarray(jax.device_get(jr.unknowns["Offset"]))
    np.testing.assert_allclose(
        tr.unknowns["Offset"].numpy(), j_off, rtol=0, atol=1e-3 * np.abs(j_off).max()
    )


def test_lm_stepwise_api():
    """init/step/current_cost under LM: the costs never rise (rejected
    steps keep X and the cost) and match solve's."""
    inputs = _bench_inputs()
    tp = _tplan("LMGPU", nIterations=5, lIterations=40)
    res = tp.solve(dict(inputs))
    tp.init(dict(inputs))
    costs = [tp.current_cost()]
    while tp.step():
        costs.append(tp.current_cost())
    costs.append(tp.current_cost())
    assert all(b <= a for a, b in zip(costs, costs[1:]))
    np.testing.assert_allclose(costs[-1], res.final_cost, rtol=1e-6)
