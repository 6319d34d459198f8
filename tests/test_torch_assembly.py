"""opt_tpu_torch assembly held to opt_tpu: the probe-decided structure
(w_spec, scalar_groups, const_tsids), the traced comparison thresholds,
the mask-folded centred fields, apply_fn(p), JᵀF and the Jacobi diagonal,
and validate_assembly — on the same numpy-seeded inputs."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.assembly import _comparison_constants as j_cmp, _probe_inputs as j_probe_inputs
from opt_tpu.compile import compile_spec as j_compile
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.assembly import (
    PROBE_SEED,
    _comparison_constants as t_cmp,
    _probe_inputs as t_probe_inputs,
)
from opt_tpu_torch.compile import compile_spec as t_compile
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.models import specs as tspecs

torch.set_num_threads(2)

SPECS = ["laplacian", "poisson_image_editing", "image_warping"]
N0, N1 = 14, 11
# f32 sums of the same terms taken in another order
RTOL = 1e-5


def _inputs(name, seed=1):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    if name == "laplacian":
        return {"X": rng.rand(N0, N1).astype(f32), "A": rng.rand(N0, N1).astype(f32)}
    if name == "image_warping":
        # nonzero angles (Rotate2D at a general point), a few fit
        # constraints (the All(...) gate) and an excluded block
        con = -np.ones((N0, N1, 2), f32)
        con[::3, ::4] = rng.rand(*con[::3, ::4].shape) * N0
        mask = np.zeros((N0, N1), f32)
        mask[4:7, 3:5] = 1.0
        return {
            "Offset": rng.rand(N0, N1, 2).astype(f32),
            "Angle": (rng.rand(N0, N1) - 0.5).astype(f32),
            "UrShape": rng.rand(N0, N1, 2).astype(f32), "Constraints": con, "Mask": mask,
            "w_fitSqrt": np.float32(np.sqrt(100.0)), "w_regSqrt": np.float32(np.sqrt(0.01)),
        }
    mask = np.ones((N0, N1), f32)
    mask[3:-3, 2:-2] = 0.0
    return {"X": rng.rand(N0, N1, 4).astype(f32), "T": rng.rand(N0, N1, 4).astype(f32), "M": mask}


def _plans(name):
    dims = {"W": N0, "H": N1}
    jp = ot.Problem(getattr(jspecs, name)).plan(dims=dims)
    tp = ott.Problem(getattr(tspecs, name)).plan(device="cpu", dims=dims)
    return jp, tp


def _systems(name):
    """(JAX, torch) tuples of (apply_fn, diag, jtf_fn, meta, X, r_terms)."""
    jp, tp = _plans(name)
    out = []
    for plan, FS, resid in ((jp, JFunctionSet, None), (tp, TFunctionSet, None)):
        u, c, g, p = plan._normalize_and_place(_inputs(name))
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        cc = fs.assemble_const(u, plan.solver._stencil_plan)
        A, diag, jtf_fn, meta = fs.assemble_stencil(u, plan.solver._stencil_plan, cc)
        out.append((A, diag, jtf_fn, meta, u, fs.F(u)))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", SPECS)
def test_plan_structure_matches(name):
    jp, tp = _plans(name)
    a, b = jp.solver._stencil_plan, tp.solver._stencil_plan
    assert a is not None and b is not None
    assert a.w_spec == b.w_spec
    assert a.needed_slots == b.needed_slots
    assert a.scalar_groups == b.scalar_groups
    assert a.const_tsids == b.const_tsids


@pytest.mark.parametrize("name", SPECS)
def test_probe_draws_and_thresholds_match(name):
    """Same seed, same draw order, same thresholds: the probe inputs are
    bit-identical, so the structure decisions are made on the same data."""
    dims = {"W": 8, "H": 8}
    jc = j_compile(getattr(jspecs, name), dims, jax.numpy.float32)
    tc = t_compile(getattr(tspecs, name), dims, torch.float32)
    jr, tr = np.random.RandomState(PROBE_SEED), np.random.RandomState(PROBE_SEED)
    ju, jcs, jg, jpar = j_probe_inputs(jc, jr, 32)
    tu, tcs, tg, tpar = t_probe_inputs(tc, tr, 32)
    for k in ju:
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    for k in jcs:
        np.testing.assert_array_equal(tcs[k].numpy(), np.asarray(jcs[k]))
    assert j_cmp(jc, ju, jcs, jg, jpar) == t_cmp(tc, tu, tcs, tg, tpar)


@pytest.mark.parametrize("name", SPECS)
def test_fused_meta_fields_match(name):
    (_, _, _, jm, _, _), (_, _, _, tm, _, _) = _systems(name)
    assert jm is not None and tm is not None
    assert tuple(jm["triples"]) == tm["triples"]
    assert tuple(jm["u_list"]) == tm["u_list"]
    assert dict(jm["offs"]) == tm["offs"] and jm["ctot"] == tm["ctot"]
    F = np.asarray(jm["F"])
    np.testing.assert_allclose(tm["F"].numpy(), F, rtol=RTOL, atol=RTOL * np.abs(F).max())


@pytest.mark.parametrize("name", SPECS)
def test_apply_jtf_diag_match(name):
    (jA, jd, jjtf, _, ju, jr), (tA, td, tjtf, _, tu, tr) = _systems(name)
    rng = np.random.RandomState(7)
    p = {k: rng.uniform(-1, 1, np.shape(v)).astype(np.float32) for k, v in ju.items()}
    jout = jA({k: jax.numpy.asarray(v) for k, v in p.items()})
    tout = tA({k: torch.as_tensor(v) for k, v in p.items()})
    jg, tg = jjtf(jr), tjtf(tr)
    for k in ju:
        for a, b in ((jout[k], tout[k]), (jg[k], tg[k]), (jd[k], td[k])):
            a, b = _np(a), _np(b)
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("name", SPECS)
def test_composed_operators_match(name):
    """The composed operators (no assembly): cost, JᵀF by vjp, the exact
    Jacobi diagonal by one-hot jvp probes, and Jᵀ(J·p)."""
    jp, tp = _plans(name)
    rng = np.random.RandomState(11)
    v = {
        k: rng.uniform(-1, 1, tp.compiled.unknown_shape(k)).astype(np.float32)
        for k in tp.compiled.unknown_names
    }
    out = []
    for plan, FS, conv in ((jp, JFunctionSet, jax.numpy.asarray), (tp, TFunctionSet, torch.as_tensor)):
        u, c, g, p = plan._normalize_and_place(_inputs(name))
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        _r, J, JT = fs.linearize(u)
        out.append((fs.cost(u), fs.jtf(u), fs.jtj_diag(u), JT(J({k: conv(x) for k, x in v.items()}))))
    (jc, *jrest), (tc, *trest) = out
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=RTOL)
    for a_d, b_d in zip(jrest, trest):
        for k in a_d:
            a, b = _np(a_d[k]), _np(b_d[k])
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("name", SPECS)
def test_validate_assembly_both(name):
    jp, tp = _plans(name)
    for plan in (jp, tp):
        u, c, g, p = plan._normalize_and_place(_inputs(name))
        assert plan.solver.validate_assembly(u, c, g, p)


def test_validation_failure_falls_back_loudly(capsys):
    """A plan whose assembled operator disagrees with the composed one
    drops to the composed operator and says so, whatever the verbosity."""
    tp = ott.Problem(tspecs.laplacian).plan(device="cpu", dims={"W": N0, "H": N1})
    tp.solver.validate_assembly = lambda *a: False
    res = tp.solve(_inputs("laplacian"), nIterations=2, lIterations=20)
    assert tp.fused_fallback == "validation"
    assert tp.solver._stencil_plan is None
    assert "falls back" in capsys.readouterr().err
    ref = ott.Problem(tspecs.laplacian).plan(device="cpu", dims={"W": N0, "H": N1})
    res_ref = ref.solve(_inputs("laplacian"), nIterations=2, lIterations=20)
    # composed Jᵀ(J·p) and the assembled operator: same math, other f32 order
    np.testing.assert_allclose(res.final_cost, res_ref.final_cost, rtol=1e-4)
