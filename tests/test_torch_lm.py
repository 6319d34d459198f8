"""The port's Levenberg-Marquardt path held to opt_tpu: the LM system
(r0, pre_lm, ctc and the fused meta) the JAX package hands its fused kernel,
the LM twin against the Pallas kernel's ``lm`` form and against the
HBM-streaming kernel (both in interpret mode), the explicit model cost and
the select masking, and one LM step from a carried JAX state through the
accept, reject and function-tolerance branches. The CUDA kernel's LM
instance runs on the card in chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import (
    inputs_from_numpy,
    meta_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

torch.set_num_threads(2)

N = 32
RESET = 7  # a reset period that the loops below pass several times
# f32 CG iterates whose dot products are summed in another order
DELTA_RTOL = 1e-5
# f32 sums of the same terms taken in another order
RTOL = 1e-5
SPECS = ["image_warping", "poisson_image_editing"]


def _inputs(name, lattice=None):
    """numpy-seeded inputs at N²: image_warping as bench.py draws it, with
    small angles and an excluded block (inf damping at excluded rows), or
    with a fit constraint at every ``lattice``-th row and column (an
    undamped GN system whose f32 CG iterates do not depend on the order of
    the sums); poisson with a border mask."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    if name == "poisson_image_editing":
        mask = np.ones((N, N), f32)
        mask[N // 4 : -N // 4, N // 4 : -N // 4] = 0.0
        return {"X": rng.rand(N, N, 4).astype(f32), "T": rng.rand(N, N, 4).astype(f32), "M": mask}
    ur = np.stack(np.meshgrid(np.arange(N), np.arange(N), indexing="ij"), -1).astype(f32)
    con = -np.ones((N, N, 2), f32)
    for _ in range(6):
        i, j = rng.randint(0, N, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    if lattice:
        k = lattice
        con[::k, ::k] = (ur[::k, ::k] + rng.randn(*con[::k, ::k].shape) * 2).clip(0)
    mask = np.zeros((N, N), f32)
    mask[20:24, 5:9] = 1.0
    return {
        "Offset": ur + rng.randn(N, N, 2).astype(f32) * 0.1,
        "Angle": (rng.randn(N, N) * 0.05).astype(f32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(100.0).astype(f32),
        "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def _jplan(name, kind="LMGPU", **kw):
    return ot.Problem(getattr(jspecs, name), kind=kind).plan(
        dims={"W": N, "H": N},
        init_params=ot.InitializationParameters(use_pallas_cg="interpret"),
        residual_reset_period=RESET,
        **kw,
    )


_LM = {}


def _jax_lm_system(name):
    """One JAX LM step run eagerly with its fused kernel spied on: the
    (meta, r0, pre_lm, ctc) it hands the kernel, as numpy."""
    if name not in _LM:
        plan = _jplan(name)
        u, c, g, p = plan._normalize_and_place(_inputs(name))
        sv = plan.solver
        sp = sv._traced_sp(plan.solver_params)
        state = sv._init_state(u, c, g, p, sp)
        seen = {}
        real = pcg.fused_grid_cg

        def spy(meta, r0, pre, lits, tol, **kw):
            seen.update(meta=meta, r0=r0, pre=pre, ctc=kw["ctc"])
            return real(meta, r0, pre, lits, tol, **kw)

        pcg.fused_grid_cg = spy
        try:
            sv._lm_step(state, JFunctionSet(plan.compiled, c, g, p), sp)
        finally:
            pcg.fused_grid_cg = real
        _LM[name] = jax.device_get((seen["meta"], seen["r0"], seen["pre"], seen["ctc"]))
    return _LM[name]


def _jax_gn_system(name, lattice=None):
    """The JAX package's first GN system: (meta, r0, pre) as numpy."""
    plan = _jplan(name, kind="gaussNewtonGPU")
    u, c, g, p = plan._normalize_and_place(_inputs(name, lattice))
    sv = plan.solver
    fs = JFunctionSet(plan.compiled, c, g, p)
    fs.masks(u)
    cc = fs.assemble_const(u, sv._stencil_plan)
    _A, diag, jtf_fn, meta = fs.assemble_stencil(u, sv._stencil_plan, cc)
    r_terms = jtf_fn.r_terms if jtf_fn.r_terms is not None else fs.F(u)
    r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
    pre_raw = diag if plan.compiled.use_preconditioner else {
        k: jax.numpy.ones_like(v) for k, v in r0.items()
    }
    return jax.device_get((meta, r0, fs.mask_rows(sv._guarded_invert(pre_raw))))


def _pack(d, meta):
    a = np.concatenate([d[u] for u in meta["u_list"]], axis=-1)
    return np.ascontiguousarray(np.moveaxis(a, -1, 0))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


# -- the LM system -------------------------------------------------------------


@pytest.mark.parametrize("name", SPECS)
def test_lm_system_matches(name):
    """cg_inputs' (meta, r0, pre_lm, ctc) equal what opt_tpu's _lm_step
    hands its fused kernel: same triples, fields, and the damping clamped
    and select-masked the same way (zero, not NaN, at excluded rows)."""
    jmeta, jr0, jpre, jctc = _jax_lm_system(name)
    tp = ott.Problem(getattr(tspecs, name), kind="LMGPU").plan(
        device="cpu", dims={"W": N, "H": N}, residual_reset_period=RESET
    )
    meta, r0, pre, kw = tp.cg_inputs(inputs_from_numpy(_inputs(name), device="cpu"))
    ctc = kw["ctc"]
    assert tp.fused_fallback is None and meta is not None
    assert meta["triples"] == meta_from_numpy(jmeta, device="cpu")["triples"]
    _close(meta["F"].numpy(), np.asarray(jmeta["F"]))
    for got, want in ((r0, jr0), (pre, jpre), (ctc, jctc)):
        for k, v in want.items():
            assert np.isfinite(v).all()
            _close(got[k].numpy(), v)
    if name == "image_warping":  # the excluded block has zero damping rows
        assert (ctc["Offset"].numpy()[20:24, 5:9] == 0).all()
        assert (pre["Angle"].numpy()[20:24, 5:9] == 0).all()


# -- the LM twin against the TPU kernels in interpret mode ----------------------


def _twin(meta, b, pre, lits, tol, **lm):
    d, l = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], torch.as_tensor(b), torch.as_tensor(pre), lits, tol,
        **{k: (torch.as_tensor(v) if k == "ctc" else v) for k, v in lm.items()},
    )
    return d.numpy(), l


# Where the ζ exit is tested, q_tol sits well away from every ζ the loop
# takes: ζ = l·(Q1 − Q0)/Q1 is a difference of two sums over the grid, and
# summing in another order moves it by up to ~1e-5 (several % of 1e-4).
# (spec, reset period, q_tol, exit iteration)
_ZETA_CASES = [("image_warping", 2, 4e-4, 3), ("poisson_image_editing", RESET, 1.1e-3, 10)]


@pytest.mark.parametrize("exit_", ["zeta", "none"])
@pytest.mark.parametrize("name,reset,q_tol,exit_at", _ZETA_CASES)
def test_lm_twin_matches_pallas_interpret(name, reset, q_tol, exit_at, exit_):
    """The twin against the Pallas kernel's lm form: the same count with the
    ζ exit after a residual reset, and with no exit (q_tol = -inf, tol = 0)
    through four resets."""
    jmeta, jr0, jpre, jctc = _jax_lm_system(name)
    lits, tol = (200, 1e-12) if exit_ == "zeta" else (30, 0.0)
    if exit_ == "none":
        reset, q_tol = RESET, -np.inf
    jd, ji = pcg.fused_grid_cg(
        jmeta, jr0, jpre, lits, tol, ctc=jctc, reset_period=reset, q_tolerance=q_tol,
        interpret=True,
    )
    meta = meta_from_numpy(jmeta, device="cpu")
    td, ti = _twin(
        meta, _pack(jr0, meta), _pack(jpre, meta), lits, tol,
        ctc=_pack(jctc, meta), reset_period=reset, q_tolerance=q_tol,
    )
    jd = _pack(jax.device_get(jd), meta)
    assert ti == int(ji) == (exit_at if exit_ == "zeta" else lits)
    np.testing.assert_allclose(td, jd, rtol=0, atol=DELTA_RTOL * np.abs(jd).max())


# (form, lits, tol, reset period, q_tol, iterations run); each exit
# threshold sits well away from the values the loop takes near it
_TILED_CASES = [
    ("gn", 60, 8e-10, None, None, 16),
    ("lm", 200, 1e-12, 2, 4e-4, 3),
    ("lm", 30, 0.0, RESET, -np.inf, 30),
]


@pytest.mark.parametrize("form,lits,tol,reset,q_tol,iters", _TILED_CASES,
                         ids=["gn", "lm_zeta_exit", "lm_no_exit"])
def test_twin_matches_hbm_tiled_interpret(form, lits, tol, reset, q_tol, iters):
    """K6, the HBM-streaming TPU kernel, called directly with four 8-row
    tiles at 32²: the twin that stands in for it on the CPU agrees on the
    iteration count and δ, for image_warping's GN and LM systems."""
    if form == "lm":
        jmeta, jr0, jpre, jctc = _jax_lm_system("image_warping")
    else:
        (jmeta, jr0, jpre), jctc = _jax_gn_system("image_warping", lattice=2), None
    meta = meta_from_numpy(jmeta, device="cpu")
    b, pre = _pack(jr0, meta), _pack(jpre, meta)
    lm = {} if jctc is None else dict(
        ctc=_pack(jctc, meta), reset_period=reset, q_tolerance=np.float32(q_tol)
    )
    jd, ji = pcg._hbm_tiled_cg(
        dict(jmeta, hbm_tiled={"th": 8, "halo": 1}), jax.numpy.asarray(b),
        jax.numpy.asarray(pre), lits, tol, guard_div=True, interpret=True,
        **{k: (jax.numpy.asarray(v) if k == "ctc" else v) for k, v in lm.items()},
    )
    td, ti = _twin(meta, b, pre, lits, tol, **lm)
    jd = _pack(jax.device_get(jd), meta)
    assert ti == int(ji) == iters
    np.testing.assert_allclose(td, jd, rtol=0, atol=DELTA_RTOL * np.abs(jd).max())


def test_run_cg_refuses_reset_period_below_one():
    b = torch.ones(1, 4, 4)
    with pytest.raises(ValueError, match="reset_period"):
        fused_cg._run_cg(b, lambda p: p, lambda r: r, lambda x, y: torch.sum(x * y),
                         5, 0.0, guard_div=True, reset_period=0, q_tol=0.0)


# -- model cost and select masking ---------------------------------------------


def test_model_cost_and_mask_rows_select_match():
    name = "image_warping"
    inputs = _inputs(name)
    rng = np.random.RandomState(3)
    jp = _jplan(name)
    tp = ott.Problem(tspecs.image_warping, kind="LMGPU").plan(device="cpu", dims={"W": N, "H": N})
    shapes = {k: tp.compiled.unknown_shape(k) for k in tp.compiled.unknown_names}
    delta = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    # inf at the excluded rows, as 1/SSq gives there
    excluded = inputs["Mask"][..., None] != 0
    vals = {k: np.where(excluded, np.inf, rng.rand(*s)).astype(np.float32) for k, s in shapes.items()}
    out = []
    for plan, FS, conv in ((jp, JFunctionSet, jax.numpy.asarray), (tp, TFunctionSet, torch.as_tensor)):
        u, c, g, p = plan._normalize_and_place(inputs)
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        r_terms, J, _JT = fs.linearize(u)
        mc = fs.model_cost(u, r_terms, J, {k: conv(v) for k, v in delta.items()})
        sel = fs.mask_rows_select({k: conv(v) for k, v in vals.items()})
        out.append((float(mc), {k: np.asarray(v) for k, v in sel.items()}))
    (jmc, jsel), (tmc, tsel) = out
    np.testing.assert_allclose(tmc, jmc, rtol=RTOL)
    assert tmc > 0
    for k in jsel:
        assert np.isfinite(tsel[k]).all()
        np.testing.assert_array_equal(tsel[k], jsel[k])
        assert (tsel[k][20:24, 5:9] == 0).all()


# -- one LM step from a carried JAX state ---------------------------------------

# (spec, variant, jacobi scaling): "reject" lowers the carried prev_cost so
# the step's cost rises; "func_tol" accepts with function_tolerance = 1.
# image_warping steps from a lattice of constraints: with only a few, the
# undamped-like second step's f32 CG iterates depend on the order of sums.
STEP_LATTICE = 2
_STEP_CASES = [
    ("image_warping", "accept", "once_per_solve"),
    ("image_warping", "reject", "once_per_solve"),
    ("image_warping", "func_tol", "once_per_solve"),
    ("image_warping", "accept", "every_iteration"),
    ("image_warping", "accept", "none"),
    ("poisson_image_editing", "accept", "once_per_solve"),
]
_STEPS = {}


def _jax_step(name, variant, scaling):
    key = (name, variant, scaling)
    if key not in _STEPS:
        sp = {"function_tolerance": 1.0} if variant == "func_tol" else {}
        jp = ot.Problem(getattr(jspecs, name), kind="LMGPU").plan(
            dims={"W": N, "H": N},
            init_params=ot.InitializationParameters(
                jacobi_scaling=ot.JacobiScalingType(scaling)
            ),
            nIterations=4, lIterations=60, **sp,
        )
        jp.init(dict(_inputs(name, STEP_LATTICE)))
        jp.step()  # start from a state the first step already moved
        state = jax.device_get(jp._state)
        if variant == "reject":
            state = dict(state, prev_cost=np.float32(state["prev_cost"] * 0.5))
            jp._state = jax.device_put(state)
        jp.step()
        _STEPS[key] = (state, jax.device_get(jp._state), sp)
    return _STEPS[key]


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("name,variant,scaling", _STEP_CASES)
def test_one_lm_step_from_jax_state(name, variant, scaling, mode):
    state, j_after, sp = _jax_step(name, variant, scaling)
    tp = ott.Problem(getattr(tspecs, name), kind="LMGPU").plan(
        device="cpu", dims={"W": N, "H": N},
        init_params=ott.InitializationParameters(
            use_pallas_cg=mode, jacobi_scaling=ott.JacobiScalingType(scaling)
        ),
        nIterations=4, lIterations=60, **sp,
    )
    tp.init(inputs_from_numpy(_inputs(name, STEP_LATTICE), device="cpu"))
    tp._state = state_from_numpy(state, device="cpu")
    cont = tp.step()
    t_after = state_to_numpy(tp._state)
    assert cont == (not bool(j_after["done"]))
    for k, v in j_after["X"].items():
        np.testing.assert_allclose(t_after["X"][k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max())
    for k, v in j_after["SSq"].items():
        np.testing.assert_array_equal(t_after["SSq"][k], v)
    for k in ("lin_iters", "n_iter", "done", "radius_decrease_factor"):
        assert t_after[k] == j_after[k], k
    # the radius grows by a factor of the ratio of two f32 cost changes
    # that each package computes in its own order
    for k in ("trust_region_radius", "prev_cost"):
        np.testing.assert_allclose(t_after[k], j_after[k], rtol=1e-5)
    if variant == "reject":
        assert j_after["radius_decrease_factor"] == 2 * state["radius_decrease_factor"]
        for k, v in state["X"].items():
            np.testing.assert_array_equal(t_after["X"][k], v)
    if variant == "func_tol":
        assert bool(j_after["done"])
        assert j_after["trust_region_radius"] == state["trust_region_radius"]


def test_first_lm_step_freezes_ssq():
    """Under ONCE_PER_SOLVE the first step stores its guarded-inverted
    diagonal in SSq, and the second leaves it as it was."""
    tp = ott.Problem(tspecs.image_warping, kind="LMGPU").plan(
        device="cpu", dims={"W": N, "H": N}, nIterations=3, lIterations=30
    )
    tp.init(inputs_from_numpy(_inputs("image_warping"), device="cpu"))
    ones = {k: v.clone() for k, v in tp._state["SSq"].items()}
    tp.step()
    first = {k: v.clone() for k, v in tp._state["SSq"].items()}
    tp.step()
    for k in ones:
        assert torch.equal(ones[k], torch.ones_like(ones[k]))
        assert not torch.equal(first[k], ones[k])
        assert torch.equal(tp._state["SSq"][k], first[k])


def test_jvp_takes_tangents_in_any_key_order():
    """J·v at X does not depend on the order in which a dict lists the
    unknowns: the fused loop's δ follows the packed channels (Offset,
    Angle), a carried JAX state lists them sorted (Angle, Offset), and the
    LM model cost takes J·δ across the two."""
    tp = ott.Problem(tspecs.image_warping, kind="LMGPU").plan(device="cpu", dims={"W": N, "H": N})
    u, c, g, p = tp._normalize_and_place(inputs_from_numpy(_inputs("image_warping"), device="cpu"))
    rng = np.random.RandomState(4)
    v = {k: torch.as_tensor(rng.rand(*tp.compiled.unknown_shape(k)).astype(np.float32))
         for k in tp.compiled.unknown_names}
    outs = []
    for X, tangent in ((u, v), (u, dict(reversed(v.items()))),
                       (dict(reversed(u.items())), v)):
        fs = TFunctionSet(tp.compiled, c, g, p)
        fs.masks(X)
        _r, J, _JT = fs.linearize(X)
        outs.append(J(tangent))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
