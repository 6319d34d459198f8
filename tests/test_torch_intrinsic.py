"""intrinsic_image_decomposition through opt_tpu_torch, held to opt_tpu on
the CPU: ``L_p`` (its weight carries no tangent), the ``alias="r"`` constant
view of the unknown, the assembly plan (the L_p terms' fields change with
the unknown every step and are not hoisted as constants), the fused
descriptor over the two unknowns packed into four channels, the fused
loop's twin against the Pallas kernel in interpret mode, whole steps and
the medium golden."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu import assembly as j_asm
from opt_tpu.compile import compile_spec as j_compile
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch import assembly as t_asm
from opt_tpu_torch.compile import compile_spec as t_compile
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy
from tests.test_golden_costs import GOLDEN, _medium_cases
from tests.test_torch_cg_variants import count_fused, jax_cg_call, twin_vs_pallas

torch.set_num_threads(2)

f32 = np.float32
N = 24
DIMS = {"W": N, "H": N}
INTR = "intrinsic_image_decomposition"


def intrinsic_inputs(n=N):
    """bench.py::bench_intrinsic's inputs at n²: a random image's log,
    log-space albedo and shading guesses, the 0.8-norm."""
    rng = np.random.RandomState(0)
    im = rng.rand(n, n, 3).astype(f32) * 0.8 + 0.1
    return {"r": np.log(im * 0.5 + 0.25).astype(f32), "i": np.log(im).astype(f32),
            "s": np.log(im.mean(-1) + 0.25).astype(f32), "w_fitSqrt": 3.0,
            "w_regSqrtAlbedo": 1.0, "w_regSqrtShading": 1.0, "pNorm": 0.8}


INPUTS = intrinsic_inputs()


def jplan(kind="gaussNewtonGPU", **ip):
    return ot.Problem(jspecs.intrinsic_image_decomposition, kind=kind).plan(
        dims=DIMS, init_params=ot.InitializationParameters(**ip))


def tplan(kind="gaussNewtonGPU", **ip):
    return ott.Problem(tspecs.intrinsic_image_decomposition, kind=kind).plan(
        dims=DIMS, device="cpu", init_params=ott.InitializationParameters(**ip))


def test_l_p_value_and_zero_tangent_through_the_weight():
    """L_p(val, val_const, p) = sqrt((‖val_const‖ + eps)^(p − 2))·val: equal
    to the JAX package's to 1e-6; the tangent through ``val`` is the weight,
    the tangent through ``val_const`` is zero."""
    rng = np.random.RandomState(1)
    val = rng.randn(5, 4, 3).astype(f32)
    vc = rng.randn(5, 4, 3).astype(f32)
    got = ott.L_p(torch.as_tensor(val), torch.as_tensor(vc), 0.8)
    want = np.asarray(ot.L_p(jnp.asarray(val), jnp.asarray(vc), 0.8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    w = np.sqrt((np.sqrt((vc * vc).sum(-1, keepdims=True)) + 1e-7) ** (0.8 - 2.0))
    np.testing.assert_allclose(got.numpy(), w * val, rtol=1e-5)
    tv, tc = torch.as_tensor(val), torch.as_tensor(vc)
    _v, t_val = torch.func.jvp(lambda a: ott.L_p(a, tc, 0.8), (tv,), (torch.ones_like(tv),))
    np.testing.assert_allclose(t_val.numpy(), np.broadcast_to(w, val.shape), rtol=1e-5)
    _v, t_const = torch.func.jvp(lambda c: ott.L_p(tv, c, 0.8), (tc,), (torch.ones_like(tc),))
    assert float(t_const.abs().max()) == 0.0
    # a difference of the unknown with itself as val_const: only val's tangent
    _v, t_both = torch.func.jvp(lambda a: ott.L_p(a, a, 0.8), (tv,), (torch.ones_like(tv),))
    w_self = np.sqrt((np.sqrt((val * val).sum(-1, keepdims=True)) + 1e-7) ** (0.8 - 2.0))
    np.testing.assert_allclose(t_both.numpy(), np.broadcast_to(w_self, val.shape), rtol=1e-5)


def _slot_sig(s):
    return (str(s.key), s.kind, s.image, s.offset, s.channels, s.is_unknown, s.internal)


def test_alias_reads_equal_jax():
    """``r_const`` is a constant view of the unknown ``r``: its slots are
    not unknown slots, they read r's current value, and no input binds it;
    the registry equals the JAX package's."""
    jc, tc = jplan().compiled, tplan().compiled
    assert [_slot_sig(s) for s in tc.registry.slots] == [_slot_sig(s) for s in jc.registry.slots]
    alias = [s for s in tc.registry.slots if s.image == "r_const"]
    assert alias and not any(s.is_unknown for s in alias)
    assert tc.registry.images["r_const"].alias == "r"
    tp = tplan()
    tu, tcn, tg, tpar = tp._normalize_and_place(dict(INPUTS))
    assert "r_const" not in tcn
    sv = tc.gather_slot_values(tu, tcn, tg, tpar)
    by_key = {s.key: v for s, v in zip(tc.registry.slots, sv)}
    assert torch.equal(by_key[("img", "r_const", (0, 0))], by_key[("img", "r", (0, 0))])
    assert torch.equal(by_key[("img", "r_const", (1, 0))], by_key[("img", "r", (1, 0))])


def test_residuals_jtf_and_diagonal_match_jax():
    jp, tp = jplan(), tplan()
    ju, jc, jg, jpar = jp._normalize_and_place(dict(INPUTS))
    tu, tc, tg, tpar = tp._normalize_and_place(dict(INPUTS))
    jfs, tfs = JFunctionSet(jp.compiled, jc, jg, jpar), TFunctionSet(tp.compiled, tc, tg, tpar)
    for a, b in zip(tfs.F(tu), jax.device_get(jfs.F(ju))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1.0))
    for got, want in ((tfs.jtf(tu), jfs.jtf(ju)), (tfs.jtj_diag(tu), jfs.jtj_diag(ju))):
        for u in ("r", "s"):
            w = np.asarray(jax.device_get(want[u]))
            np.testing.assert_allclose(got[u].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_plan_equals_jax_and_weights_are_not_hoisted():
    """The L_p weights depend on the unknown through the alias although they
    carry no gradient: the four albedo terms (0-3) have no constant
    (term, slot) entry, the shading and fitting terms (4-8) are constant;
    ``w_spec``, ``scalar_groups`` and ``const_tsids`` equal the JAX
    package's, and so do the comparison constants and the tainted set."""
    pj = j_compile(jspecs.intrinsic_image_decomposition, {"W": 8, "H": 8}, jnp.float32)
    pt = t_compile(tspecs.intrinsic_image_decomposition, {"W": 8, "H": 8}, torch.float32)
    a = j_asm._probe_inputs(pj, np.random.RandomState(1), 32)
    b = t_asm._probe_inputs(pt, np.random.RandomState(1), 32)
    assert t_asm._comparison_constants(pt, *b) == j_asm._comparison_constants(pj, *a)
    assert t_asm._terms_with_traced_gates(pt, *b) == j_asm._terms_with_traced_gates(pj, *a)
    sj, st = jplan().solver._stencil_plan, tplan().solver._stencil_plan
    assert st.w_spec == sj.w_spec
    assert st.scalar_groups == sj.scalar_groups
    assert st.const_tsids == sj.const_tsids
    assert {t for (t, _sid) in st.const_tsids} == {4, 5, 6, 7, 8}


def test_fields_follow_the_unknown():
    """The albedo couplings are re-made from the current r: another r,
    other fields (a hoisted weight would leave them as they were)."""
    tp = tplan()
    meta0 = tp.cg_inputs(inputs_from_numpy(INPUTS, device="cpu"))[0]
    moved = dict(INPUTS, r=INPUTS["r"] * 1.5)
    meta1 = tp.cg_inputs(inputs_from_numpy(moved, device="cpu"))[0]
    assert meta0["triples"] == meta1["triples"]
    assert not torch.equal(meta0["F"], meta1["F"])


def test_fused_descriptor_equals_jax():
    """r (3 channels) and s (1) packed into C = 4, coupled by the fitting
    term: 16 fields and 26 triples, equal to the JAX package's; fields to
    1e-5 of their scale; no per-channel split (cross-channel triples)."""
    want = meta_from_numpy(jax_cg_call(INTR, DIMS, INPUTS)[0], device="cpu")
    tp = tplan()
    meta, _r0, _pre, _kw = tp.cg_inputs(inputs_from_numpy(INPUTS, device="cpu"))
    assert tp.fused_fallback is None and meta is not None
    assert meta["u_list"] == want["u_list"] and meta["offs"] == want["offs"]
    assert meta["ctot"] == 4 and not meta["chan_grid"]
    assert meta["triples"] == want["triples"] and len(meta["triples"]) == 26
    assert tuple(meta["F"].shape) == (16, N, N)
    np.testing.assert_allclose(meta["F"].numpy(), want["F"].numpy(), rtol=0,
                               atol=1e-5 * float(want["F"].abs().max()))


@pytest.mark.parametrize("lits", [10, 30])
def test_twin_matches_pallas_interpret(lits):
    """The twin against ``pallas_cg.fused_grid_cg(..., interpret=True)`` on
    the system the JAX step hands its kernel, at 10 and at the path's 30
    iterations: equal counts, δ to 1e-5 of its scale (6e-7 read)."""
    jd, ji, td, ti = twin_vs_pallas(jax_cg_call(INTR, DIMS, INPUTS), lits, 1e-12)
    assert ti == ji == lits
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5 * np.abs(jd).max())


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_steps_match_jax_through_the_fused_loop(monkeypatch, kind):
    """One step to 1e-5 (cost and unknowns), three steps' costs to 1e-5,
    the fused loop once a step on both sides with equal counts."""
    calls = count_fused(monkeypatch)
    tp, jp = tplan(kind), jplan(kind, use_pallas_cg="interpret")
    t1 = tp.solve(dict(INPUTS), nIterations=1, lIterations=30)
    j1 = jp.solve(dict(INPUTS), nIterations=1, lIterations=30)
    np.testing.assert_allclose(t1.final_cost, j1.final_cost, rtol=1e-5)
    for u in ("r", "s"):
        np.testing.assert_allclose(t1.unknowns[u].numpy(), np.asarray(j1.unknowns[u]),
                                   rtol=0, atol=1e-5)
    del calls[:]
    t3 = tp.solve(dict(INPUTS), nIterations=3, lIterations=30)
    j3 = jp.solve(dict(INPUTS), nIterations=3, lIterations=30)
    np.testing.assert_allclose(t3.costs, j3.costs, rtol=1e-5)
    assert t3.num_linear_iterations == j3.num_linear_iterations
    assert len(calls) == t3.num_iterations == 3
    assert tp.fused_fallback is None and jp.fused_fallback is None


def test_medium_golden():
    """tests/test_golden_costs.py's intrinsic pin (GN 6x30 at 32²) within its
    5e-3."""
    kind, nl, li, golden = GOLDEN[INTR]
    dims, inputs = _medium_cases()[INTR]
    tp = ott.Problem(tspecs.intrinsic_image_decomposition, kind=kind).plan(dims=dims, device="cpu")
    res = tp.solve(dict(inputs), nIterations=nl, lIterations=li)
    assert tp.fused_fallback is None
    np.testing.assert_allclose(res.final_cost, golden, rtol=5e-3)
