"""The three graph specs that came last to the port: cotangent_mesh_smoothing
(C = 3, four-slot hyperedges whose cot weights depend on the unknowns
through two Selects), embedded_mesh_deformation (C = 12) and
robust_nonrigid_alignment (C = 7, its graph group covering Offset and
Angle but not RobustWeights), held to the JAX package on the same numpy
inputs (tests/test_specs.py's and tests/test_golden_costs.py's medium
ones).

The structure decisions (w_spec, scalar_groups, const_tsids) are the JAX
package's; the port's fused operator (its triples and remainder CSR,
applied by the plain twin) is the JAX package's assembled and composed
JᵀJ; one LM step agrees, with equal CG counts; the medium solves reach
their goldens. The JAX package's CPU planner hands none of these a fused
meta (no one-hot tile plan off the TPU; robust_nonrigid's group does not
span the kernel state, opt_tpu/ops/pallas_cg.py:746-747), so the port's
triples are held through the operator they apply, not one by one.

cotangent's CG amplifies rounding about tenfold an iteration beyond the
eighth or tenth (in float64 too: both packages agree to 1e-15 at ten
iterations and part by 2e-4 at twenty on the small mesh), so its LM step
is held in float64 at ten iterations, against the JAX package's float64
values recorded below."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
import tests.test_golden_costs as tg
from tests.float32_limits import U32, jax_float64
import tests.test_specs as ts

torch.set_num_threads(2)

SPECS = ["cotangent_mesh_smoothing", "embedded_mesh_deformation", "robust_nonrigid_alignment"]
SIZES = ["small", "medium"]
CHANNELS = {"cotangent_mesh_smoothing": 3, "embedded_mesh_deformation": 12,
            "robust_nonrigid_alignment": 7}
STEP_RTOL = 1e-6
# cotangent's initial cost and its first LM step of 10 CG iterations in
# float64 through the JAX package on the CPU, at each size's inputs:
#   JAX_PLATFORMS=cpu python -c "import opt_tpu as ot; ot.enable_double_precision();
#   from opt_tpu.models.specs import cotangent_mesh_smoothing as s; DIMS, INPUTS
#   p=ot.Problem(s,kind='LMGPU').plan(dims=DIMS,double_precision=True); p.init(INPUTS)
#   print(p.current_cost(), ot.Problem(s,kind='LMGPU').plan(dims=DIMS,
#     double_precision=True).solve(INPUTS,nIterations=1,lIterations=10).costs)"
# (scripts/graph_spec_numerics.py prints the step at 10 to 40 iterations)
JAX_CPU_COTANGENT_F64 = {"small": (1.4264694969618605, 0.822226308510613),
                         "medium": (7.004152863680135, 4.193470099571853)}
_CASES = {}


def _case(name, size):
    if size not in _CASES:
        _CASES[size] = ts._cases() if size == "small" else tg._medium_cases()
    return _CASES[size][name]


def _plans(name, size, kind="LMGPU", **kw):
    dims, _inputs = _case(name, size)
    jp = ot.Problem(getattr(jspecs, name), kind=kind).plan(dims=dims, **kw)
    tp = ott.Problem(getattr(tspecs, name), kind=kind).plan(dims=dims, device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", SPECS)
def test_plan_structure_matches(name, size):
    jp, tp = _plans(name, size)
    a, b = jp.solver._stencil_plan, tp.solver._stencil_plan
    assert a is not None and b is not None
    assert a.w_spec == b.w_spec
    assert a.needed_slots == b.needed_slots
    assert a.scalar_groups == b.scalar_groups
    assert a.const_tsids == b.const_tsids


def _operators(name, size):
    """The port's first LM system's meta and, on the same random p, its
    twin apply and the JAX package's assembled and composed JᵀJ·p (both
    packed as the meta packs)."""
    _dims, inputs = _case(name, size)
    jp, tp = _plans(name, size)
    meta, _r0, _pre, _kw = tp.cg_inputs(dict(inputs))
    assert tp.fused_fallback is None and meta is not None
    u, c, g, p = jp._normalize_and_place(dict(inputs))
    fs = JFunctionSet(jp.compiled, c, g, p)
    fs.masks(u)
    jA = fs.assemble_stencil(u, jp.solver._stencil_plan)[0]
    composed = fs.make_jtj_apply(u)[3]
    v = _probe(u)
    jv = {k: jax.numpy.asarray(x) for k, x in v.items()}
    def pack(d):
        return fused_cg.pack({k: torch.as_tensor(np.array(x)) for k, x in d.items()}, meta)

    got = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"], pack(v))
    return meta, got.numpy(), pack(jA(jv)).numpy(), pack(composed(jv)).numpy()


_JAX_F64 = {}


def _probe(u):
    rng = np.random.RandomState(7)
    return {k: rng.uniform(-1, 1, np.shape(x)).astype(np.float32) for k, x in u.items()}


def jax_float64_cotangent():
    """The JAX package's float64 assembled and composed JᵀJ·p of cotangent
    at each size (run by tests/float32_limits.py::jax_float64 in a process
    with x64 on), on :func:`_probe`'s p."""
    out = {}
    for size in SIZES:
        _dims, inputs = _case("cotangent_mesh_smoothing", size)
        jp = _plans("cotangent_mesh_smoothing", size, double_precision=True)[0]
        u, c, g, p = jp._normalize_and_place(dict(inputs))
        fs = JFunctionSet(jp.compiled, c, g, p)
        fs.masks(u)
        v = {k: jax.numpy.asarray(x.astype(np.float64)) for k, x in _probe(u).items()}
        out[f"{size}_assembled"] = fs.assemble_stencil(u, jp.solver._stencil_plan)[0](v)["X"]
        out[f"{size}_composed"] = fs.make_jtj_apply(u)[3](v)["X"]
    return out


def _cotangent_float64(size, meta):
    """cotangent's operator in float64 at ``size``'s inputs: the port's
    fused operator (the twin's apply of a float64 plan's meta, with
    ``fused_cg.LOOP_DTYPES`` widened to float64 by the caller) and the JAX
    package's assembled and composed JᵀJ·p, all packed as ``meta`` packs;
    and the float32 reach of an apply, derived from the inputs.

    The reach: a residual's weight is w = √(½(cot + cot)), each cot a·b/√disc
    with disc = |a|²|b|² − (a·b)² for the unit edge vectors a, b, which
    cancels near collinear edges: disc's float32 rounding is up to
    2u/(1 − c²) of it (c = a·b), u = 2⁻²⁴. J's entries carry w or ∂w/∂X
    ∝ disc^(-3/2): up to 3u/(1 − c²); a field of JᵀJ is a product of two:
    6u/(1 − c²); the apply's sums add at most 16u more. So each output is
    within (6/min(1 − c²) + 16)·u of the float64 one, relative to the same
    sum over |F|·|p|, which bounds the largest output."""
    dims, inputs = _case("cotangent_mesh_smoothing", size)
    if not _JAX_F64:
        _JAX_F64.update(jax_float64("tests.test_torch_graph_specs", "jax_float64_cotangent"))
    tp = ott.Problem(tspecs.cotangent_mesh_smoothing, kind="LMGPU").plan(
        dims=dims, device="cpu", double_precision=True)
    m64 = tp.cg_inputs(dict(inputs))[0]
    assert tp.fused_fallback is None and m64["F"].dtype == torch.float64
    assert m64["triples"] == meta["triples"]
    u = tp._normalize_and_place(dict(inputs))[0]
    p64 = fused_cg.pack({k: torch.as_tensor(x.astype(np.float64))
                         for k, x in _probe(u).items()}, m64)
    port = fused_cg._operator_apply(m64["F"], m64["triples"], m64["rem"], p64).numpy()
    jax64 = {k: fused_cg.pack({"X": torch.as_tensor(_JAX_F64[f"{size}_{k}"])}, meta).numpy()
             for k in ("assembled", "composed")}
    x, gi = inputs["X"].astype(np.float64), inputs["G"]
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    cos = [(unit(x[gi[a]] - x[gi[o]]) * unit(x[gi[b]] - x[gi[o]])).sum(-1)
           for a, b, o in (("v0", "v1", "v2"), ("v0", "v1", "v3"))]
    reach = (6.0 / float(min((1.0 - c * c).min() for c in cos)) + 16.0) * U32
    rem = meta["rem"]
    rem_abs = None if rem is None else dict(rem, blk=rem["blk"].double().abs())
    scale = fused_cg._operator_apply(meta["F"].double().abs(), meta["triples"], rem_abs,
                                     p64.abs())
    return port, jax64, reach * float(scale.abs().max())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", SPECS)
def test_fused_operator_matches_jax(name, size, monkeypatch):
    """The port's fused operator (the twin's apply of the meta), against the
    JAX package's on the same random p: its assembled (default stencil)
    operator and its composed Jᵀ(J·p) at 1e-6 of the largest entry: for
    robust_nonrigid through the partial group's meta, RobustWeights' channel
    keeping only its centred triples (at offset 0, coupled to Offset by the
    fit term) and no remainder entry.

    cotangent's fields round in float32 by up to 6u/(1 − c²) for its most
    collinear edges (:func:`_cotangent_float64`: 3.9e-5 and 1.3e-4 of the
    apply at the two sizes), and the two packages' float32 applies part by
    6.9e-6 and 1.5e-5 of the largest entry on some hosts: so its operators
    are held at 1e-6 in float64, the port's fused operator built and applied
    in float64 against the JAX package's assembled and composed applies
    (measured 5.9e-16 to 1.0e-15), and in float32 the twin's apply and the JAX
    package's are held to the float64 one by that reach."""
    meta, got, assembled, composed = _operators(name, size)
    C = CHANNELS[name]
    assert meta["ctot"] == C and len(meta["triples"]) <= fused_cg.MAX_TRIPLES
    if name == "cotangent_mesh_smoothing":
        monkeypatch.setattr(fused_cg, "LOOP_DTYPES", (torch.float32, torch.float64))
        port, jax64, reach = _cotangent_float64(size, meta)
        for want in jax64.values():
            np.testing.assert_allclose(port, want, rtol=0, atol=STEP_RTOL * np.abs(want).max())
        for f32 in (got, assembled, composed):
            np.testing.assert_allclose(f32, port, rtol=0, atol=reach)
    else:
        for want in (assembled, composed):
            np.testing.assert_allclose(got, want, rtol=0, atol=STEP_RTOL * np.abs(want).max())
    if name == "robust_nonrigid_alignment":
        w = meta["offs"]["RobustWeights"]
        assert {d for (d, i, j, _f) in meta["triples"] if w in (i, j)} == {(0, 0)}
        if meta["rem"] is not None:
            blk = meta["rem"]["blk"]
            assert not bool(blk[:, w].any()) and not bool(blk[:, :, w].any())


@pytest.mark.parametrize("size", SIZES)
def test_cotangent_gates_keep_their_couplings(size):
    """cotangent's two unknown-dependent Selects (the cot discriminant's
    and the weight's) gate couplings whose branch the real inputs take:
    the port's fused operator equals JᵀJ of the dense Jacobian
    (torch.func.jacfwd) at those inputs, so no gated coupling was pruned
    (tests/test_fuzz_operator.py:312's check)."""
    dims, inputs = _case("cotangent_mesh_smoothing", size)
    tp = ott.Problem(tspecs.cotangent_mesh_smoothing, kind="LMGPU").plan(dims=dims, device="cpu")
    meta, _r0, _pre, _kw = tp.cg_inputs(dict(inputs))
    u, c, g, p = tp._normalize_and_place(dict(inputs))
    fs = TFunctionSet(tp.compiled, c, g, p)
    (X,) = u.values()
    J = torch.func.jacfwd(lambda x: torch.cat([t.reshape(-1) for t in fs.F({"X": x})]))(X)
    J = J.reshape(J.shape[0], -1).double()
    # the weight's Select takes both branches at these inputs
    x, gi = inputs["X"].astype(np.float64), inputs["G"]
    nrm = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    cot = lambda a, b: (a * b).sum(-1) / np.sqrt(1.0 - (a * b).sum(-1) ** 2)  # noqa: E731
    w = 0.5 * (cot(nrm(x[gi["v0"]] - x[gi["v2"]]), nrm(x[gi["v1"]] - x[gi["v2"]]))
               + cot(nrm(x[gi["v0"]] - x[gi["v3"]]), nrm(x[gi["v1"]] - x[gi["v3"]])))
    assert bool((w > 0).any()) and bool((w <= 0).any())
    v = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, tuple(X.shape)),
                        dtype=torch.float32)
    want = (J.T @ (J @ v.double().reshape(-1))).reshape(X.shape)
    got = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"],
                                   fused_cg.pack({"X": v}, meta))
    want = fused_cg.pack({"X": want.float()}, meta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=STEP_RTOL * float(want.abs().max()))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", SPECS)
def test_one_lm_step_matches_jax(name, size):
    """One LM step of the golden's CG budget in both packages: the cost at
    1e-6, equal CG counts, no fallback. cotangent's step (see the module
    docstring) in float64 at ten CG iterations, against the recorded JAX
    values, and in float32 by its CG count."""
    dims, inputs = _case(name, size)
    _kind, _nl, li, _golden = tg.GOLDEN[name]
    if name == "cotangent_mesh_smoothing":
        tp = ott.Problem(tspecs.cotangent_mesh_smoothing, kind="LMGPU").plan(
            dims=dims, device="cpu", double_precision=True)
        tp.init(dict(inputs))
        c0, c1 = JAX_CPU_COTANGENT_F64[size]
        np.testing.assert_allclose(tp.current_cost(), c0, rtol=1e-12)
        r = tp.solve(dict(inputs), nIterations=1, lIterations=10)
        assert r.num_linear_iterations == 10
        np.testing.assert_allclose(r.costs[0], c1, rtol=STEP_RTOL)
    jp, tp = _plans(name, size)
    jr = jp.solve(dict(inputs), nIterations=1, lIterations=li)
    tr = tp.solve(dict(inputs), nIterations=1, lIterations=li)
    assert tp.fused_fallback is None and tr.num_linear_iterations == jr.num_linear_iterations
    if name != "cotangent_mesh_smoothing":
        np.testing.assert_allclose(tr.costs[0], jr.costs[0], rtol=STEP_RTOL)


@pytest.mark.parametrize("name", SPECS)
def test_golden_final_cost(name):
    """tests/test_golden_costs.py's medium solve through the port on the
    CPU: the golden final cost at rtol 5e-3, the fused loop every step."""
    kind, nl, li, golden = tg.GOLDEN[name]
    dims, inputs = _case(name, "medium")
    tp = ott.Problem(getattr(tspecs, name), kind=kind).plan(dims=dims, device="cpu")
    r = tp.solve(dict(inputs), nIterations=nl, lIterations=li)
    assert tp.fused_fallback is None and np.isfinite(r.final_cost)
    np.testing.assert_allclose(r.final_cost, golden, rtol=5e-3, atol=1e-8)
