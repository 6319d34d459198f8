"""Plan.solve_batched and the CG kernel's batch axis (K1 (h)) held to the
JAX package: the four cases of tests/test_batched.py through both packages,
the batched twin against the Pallas kernel under ``jax.vmap`` (the
tests/test_pallas.py:196 case, called directly) and against its own
single-system form, the per-instance exits of the while_loop batching
rule, and a batched operator with a remainder, which the batch forms take
(tests/test_torch_batched_graph.py holds those forms to the JAX package)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu.ops.pallas_cg import fused_grid_cg as j_fused
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.solver.gauss_newton import GaussNewtonSolver
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.float32_limits import cg_bound, jacobi_condition

torch.set_num_threads(2)
f32 = np.float32


# -- tests/test_batched.py's cases through both packages ---------------------------


def _curve_inputs(N=64, B=5, seed=0):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, N)
    truths = rng.uniform(80, 120, (B, 2))
    data = np.stack(
        [np.stack([x, a * np.cos(b * x) + b * np.sin(a * x)], -1) for a, b in truths]
    ).astype(f32)
    init = truths + rng.randn(B, 2) * 0.05
    graphs = {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}
    return truths, {"funcParams": init[:, None, :].astype(f32), "data": data, "G": graphs}


def _curve_plans(N):
    jp = ot.Problem(jspecs.curve_fitting, kind="LMGPU").plan(dims={"N": N, "U": 1})
    tp = ott.Problem(tspecs.curve_fitting, kind="LMGPU").plan(dims={"N": N, "U": 1},
                                                              device="cpu")
    return jp, tp


def test_batched_curve_fitting_matches_jax_and_single():
    """B = 5 LM 12x20 curve fits: the fitted parameters within 1e-5 of the
    JAX package's batched solve, the same step count per instance, and each
    instance within 1e-5 of this port's own single solve."""
    N, sp = 64, dict(nIterations=12, lIterations=20)
    truths, inputs = _curve_inputs(N)
    jp, tp = _curve_plans(N)
    tr = tp.solve_batched(dict(inputs), **sp)
    jr = jp.solve_batched(dict(inputs), **sp)
    fitted = tr.unknowns["funcParams"].numpy()[:, 0, :]
    np.testing.assert_allclose(fitted, truths, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(fitted, np.asarray(jr.unknowns["funcParams"])[:, 0, :],
                               rtol=1e-5, atol=1e-5)
    assert tr.num_iterations.tolist() == np.asarray(jr.num_iterations).tolist()
    assert tr.costs.shape == (5, 12) and tr.final_costs.shape == (5,)
    assert tp.fused_fallback is None
    for i in range(5):
        single = tp.solve({"funcParams": inputs["funcParams"][i], "data": inputs["data"][i],
                           "G": inputs["G"]}, **sp)
        np.testing.assert_allclose(fitted[i], single.unknowns["funcParams"].numpy()[0],
                                   rtol=1e-5, atol=1e-5)
        assert tr.num_iterations[i] == single.num_iterations


def test_batched_poisson_broadcast_consts():
    """B = 3 poisson solves at 16x16 with the target and mask shared: final
    costs within rtol 1e-4 of the JAX package's and of this port's single
    solves."""
    n, B = 16, 3
    rng = np.random.RandomState(1)
    mask = np.zeros((n, n), f32)
    T = rng.rand(n, n, 4).astype(f32)
    X0 = rng.rand(B, n, n, 4).astype(f32)
    sp = dict(nIterations=1, lIterations=200)
    tp = ott.Problem(tspecs.poisson_image_editing).plan(dims={"W": n, "H": n}, device="cpu")
    jp = ot.Problem(jspecs.poisson_image_editing).plan(dims={"W": n, "H": n})
    tr = tp.solve_batched({"X": X0, "T": T, "M": mask}, **sp)
    jr = jp.solve_batched({"X": X0, "T": T, "M": mask}, **sp)
    assert tr.final_costs.shape == (B,)
    np.testing.assert_allclose(tr.final_costs, np.asarray(jr.final_costs), rtol=1e-4, atol=1e-8)
    for i in range(B):
        single = tp.solve({"X": X0[i], "T": T, "M": mask}, **sp)
        np.testing.assert_allclose(tr.final_costs[i], single.final_cost, rtol=1e-4, atol=1e-8)


def _computed_spec(pkg):
    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        C = S.ComputedArray("C", (W, H), lambda: X(0, 0) * X(0, 0) - A(0, 0))
        S.Energy(C(0, 0) - C(1, 0), 0.5 * (X(0, 0) - 1.0))

    return spec


def test_batched_computed_array_matches_jax_and_single():
    """The ComputedArray bundle (itself a vmap over jvp) under the batch's
    vmap: B = 3 at 12x12, GN 5x15, final costs within rtol 1e-5 of the JAX
    package's and of this port's single solves."""
    B, n = 3, 12
    rng = np.random.RandomState(0)
    a = rng.rand(B, n, n).astype(f32)
    x0 = np.ones((B, n, n), f32) + 0.1 * rng.randn(B, n, n).astype(f32)
    sp = dict(nIterations=5, lIterations=15)
    tp = ott.Problem(_computed_spec(ott)).plan({"W": n, "H": n}, device="cpu")
    tr = tp.solve_batched({"X": x0, "A": a}, **sp)
    jr = ot.Problem(_computed_spec(ot)).plan({"W": n, "H": n}).solve_batched(
        {"X": x0, "A": a}, **sp)
    np.testing.assert_allclose(tr.final_costs, np.asarray(jr.final_costs), rtol=1e-5)
    assert tr.num_linear_iterations.tolist() == np.asarray(jr.num_linear_iterations).tolist()
    for i in range(B):
        r = tp.solve({"X": x0[i], "A": a[i]}, **sp)
        assert np.isclose(r.final_cost, tr.final_costs[i], rtol=1e-5), (i, r.final_cost)


@pytest.mark.parametrize("case", ["unbatched", "missing", "shape"])
def test_batched_input_errors(case):
    """No batched input, a missing input or a mis-shaped one: SpecError."""
    n = 8
    plan = ott.Problem(tspecs.poisson_image_editing).plan(dims={"W": n, "H": n}, device="cpu")
    inputs = {"X": np.zeros((n, n, 4), f32), "T": np.zeros((n, n, 4), f32),
              "M": np.zeros((n, n), f32)}
    if case == "missing":
        inputs = {"X": np.zeros((2, n, n, 4), f32), "T": np.zeros((n, n, 4), f32)}
    elif case == "shape":
        inputs["X"] = np.zeros((2, n, n + 1, 4), f32)
    with pytest.raises(ott.SpecError):
        plan.solve_batched(inputs)


# -- K1 (h): the batched twin against the Pallas kernel under jax.vmap ---------------

LAP_N, LAP_B = 16, 4


def _lap_batch_systems():
    """The first GN systems of 4 laplacian 16x16 instances through the JAX
    package (numpy), each instance's fields scaled by its own factor so
    that F differs per instance: (meta with F [B, T, H, W], r0 [B, H, W,
    1], pre [B, H, W, 1], per-instance LM damping ctc)."""
    rng = np.random.RandomState(0)
    X = rng.rand(LAP_B, LAP_N, LAP_N).astype(f32)
    A = rng.rand(LAP_B, LAP_N, LAP_N).astype(f32)
    plan = ot.Problem(jspecs.laplacian).plan(dims={"W": LAP_N, "H": LAP_N})
    sv = plan.solver
    metas, r0s, pres = [], [], []
    for b in range(LAP_B):
        u, c, g, p = plan._normalize_and_place({"X": X[b], "A": A[b]})
        fs = JFunctionSet(plan.compiled, c, g, p)
        fs.masks(u)
        cc = fs.assemble_const(u, sv._stencil_plan)
        _A, diag, jtf_fn, meta = fs.assemble_stencil(u, sv._stencil_plan, cc)
        r_terms = jtf_fn.r_terms if jtf_fn.r_terms is not None else fs.F(u)
        r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
        pre = fs.mask_rows(sv._guarded_invert(diag))
        meta, r0, pre = jax.device_get((meta, r0, pre))
        metas.append(meta)
        r0s.append(r0["X"])
        pres.append(pre["X"])
    scale = (1.0 + 0.25 * np.arange(LAP_B, dtype=f32))[:, None, None, None]
    meta = dict(metas[0], F=(np.stack([np.asarray(m["F"]) for m in metas]) * scale).astype(f32))
    ctc = (0.05 + 0.1 * rng.rand(LAP_B, LAP_N, LAP_N, 1)).astype(f32)
    return meta, np.stack(r0s), np.stack(pres), ctc


_LAP = {}


def _lap():
    if not _LAP:
        _LAP["v"] = _lap_batch_systems()
    return _LAP["v"]


def _jax_vmapped(meta, r0, pre, lits, tol, ctc=None, **lm):
    """The Pallas kernel (interpret mode) under jax.vmap over the batch."""
    def one(F, r, p, c):
        kw = {} if c is None else dict(ctc={"X": c}, **lm)
        return j_fused(dict(meta, F=F), {"X": r}, {"X": p}, lits, tol, interpret=True, **kw)

    d, it = jax.vmap(one, in_axes=(0, 0, 0, None if ctc is None else 0))(
        jnp.asarray(meta["F"]), jnp.asarray(r0), jnp.asarray(pre),
        None if ctc is None else jnp.asarray(ctc))
    d, it = jax.device_get((d, it))
    return np.moveaxis(np.asarray(d["X"]), -1, 1), np.asarray(it).reshape(-1).tolist()


def _twin(meta_np, r0, pre, lits, tol, ctc=None, **lm):
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    assert meta["batch"] == LAP_B and tuple(meta["F"].shape[:1]) == (LAP_B,)
    pack = lambda a: torch.as_tensor(np.moveaxis(a, -1, 1).copy())  # noqa: E731
    kw = {} if ctc is None else dict(ctc=pack(ctc), **lm)
    counts = []
    d, total = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], pack(r0), pack(pre), lits, tol, n_sys=LAP_B,
        counts=counts, batched=True, **kw)
    assert total == sum(counts)
    return meta, d, counts


# a threshold's margin: the float32 rounding of these exit quantities is
# far below 30% while they are above 1e-5
MARGIN = 1.3


def _wide_margin_tol(meta_np, r0, pre, ctc=None):
    """An exit threshold that every instance's loop crosses by a wide
    margin: up to the exit, no value of the exit quantity within a factor
    MARGIN of it (GN:
    rᵀz / rᵀz₀ against tol; LM: ζ against q_tol, a difference of two
    float32 sums, ROADMAP queue 3), where the exits in the last bits would
    part the twin's count from the Pallas kernel's."""
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    pack = lambda a: torch.as_tensor(np.moveaxis(a, -1, 1).copy())  # noqa: E731
    seqs = []
    for b in range(LAP_B):
        trace = []
        kw = {} if ctc is None else dict(ctc=pack(ctc)[b], reset_period=10,
                                         q_tolerance=float("-inf"))
        fused_cg.fused_grid_cg_reference(meta["F"][b], meta["triples"], pack(r0)[b],
                                         pack(pre)[b], 60, 0.0, trace=trace, **kw)
        rz0 = float((pack(r0)[b] * pack(pre)[b] * pack(r0)[b]).sum())
        seqs.append([float(z) if ctc is not None else float(rz) / rz0
                     for (_l, rz, _fl, z) in trace])
    return clear_threshold(seqs)


def clear_threshold(seqs):
    """The largest threshold q in 1e-1 ... 1e-5 that every sequence of exit
    quantities crosses by a wide margin: its first value under q is under
    q/MARGIN, and every value before it over MARGIN·q."""
    def clear(vs, q):
        first = next((i for i, v in enumerate(vs) if v < q), None)
        return (first is not None and vs[first] < q / MARGIN
                and all(v > MARGIN * q for v in vs[:first]))

    for q in 10.0 ** -np.arange(1.0, 5.0, 0.05):
        if all(clear(vs, q) for vs in seqs):
            return float(q)
    raise AssertionError(f"no threshold with a wide margin: {seqs}")


@pytest.mark.parametrize("form", ["gn", "lm"])
def test_k1h_twin_matches_pallas_under_vmap(form):
    """4 x laplacian 16x16 with per-instance F and b: the batched twin's δ
    within 1e-6 of the Pallas kernel's under jax.vmap, the counts equal
    instance by instance, with the real exits (GN: the rᵀz floor; LM: the ζ
    exit), each threshold where the loop crosses it by a wide margin."""
    meta_np, r0, pre, ctc = _lap()
    lits = 60
    if form == "gn":
        tol, lm, c = _wide_margin_tol(meta_np, r0, pre), {}, None
    else:
        tol, c = 1e-12, ctc
        lm = dict(reset_period=10, q_tolerance=_wide_margin_tol(meta_np, r0, pre, ctc))
    jd, jcounts = _jax_vmapped(meta_np, r0, pre, lits, tol, c, **lm)
    _m, td, tcounts = _twin(meta_np, r0, pre, lits, tol, c, **lm)
    assert tcounts == jcounts and len(set(jcounts)) >= 1 and max(jcounts) < lits
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["gn", "lm"])
def test_batched_twin_equals_single_systems(form):
    """The batched twin, system by system, is bitwise the single-system twin
    on that system's fields and vectors, with the same count."""
    meta_np, r0, pre, ctc = _lap()
    lm = {} if form == "gn" else dict(reset_period=7, q_tolerance=1e-3)
    meta, d, counts = _twin(meta_np, r0, pre, 40, 1e-12, None if form == "gn" else ctc, **lm)
    pack = lambda a: torch.as_tensor(np.moveaxis(a, -1, 1).copy())  # noqa: E731
    for b in range(LAP_B):
        kw = {} if form == "gn" else dict(ctc=pack(ctc)[b], **lm)
        db, lb = fused_cg.fused_grid_cg_reference(meta["F"][b], meta["triples"], pack(r0)[b],
                                                  pack(pre)[b], 40, 1e-12, **kw)
        assert torch.equal(d[b], db) and counts[b] == lb


def test_batched_wrapper_packs_and_counts_per_instance():
    """``fused_grid_cg`` on a batched meta: δ with a leading batch axis and
    one int32 count per instance, equal to the twin's."""
    meta_np, r0, pre, _ctc = _lap()
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    delta, iters = fused_cg.fused_grid_cg(meta, {"X": torch.as_tensor(r0)},
                                          {"X": torch.as_tensor(pre)}, 60, 1e-12)
    _m, d, counts = _twin(meta_np, r0, pre, 60, 1e-12)
    assert iters.dtype == torch.int32 and iters.tolist() == counts
    assert tuple(delta["X"].shape) == (LAP_B, LAP_N, LAP_N, 1)
    assert torch.equal(delta["X"], torch.movedim(d, 1, -1))
    assert fused_cg.batched_kernel_form(meta) == "batch"
    big = dict(meta, F=torch.zeros((LAP_B, 5, 512, 512)))
    assert fused_cg.batched_kernel_form(big) == "multi"


def test_batched_instance_names():
    """Every flag combination in each form: 32 one-system, 32 multi-system
    and 32 batch instances, the remainder and block-Jacobi ones among
    them."""
    names = [fused_cg.instance_name(*f) for f in fused_cg.INSTANCES]
    assert len(names) == len(set(names)) == 96
    assert sum(n.endswith("_batch") for n in names) == 32
    assert sum(n.endswith("_multi") for n in names) == 32
    assert "lm_batch" in names and "gn_cs_bf16_batch" in names
    assert {"gn_rem_batch", "lm_bj_batch", "gn_rem_multi", "lm_bj_multi",
            "lm_cs_bj_bf16_rem_batch", "gn_bj_rem_multi"} <= set(names)


# -- a batched operator with a remainder ----------------------------------------------


def _random_mesh(N=60, seed=3):
    """A ring with random chords under a random numbering (the remainder
    form), as tests/test_torch_graph.py::random_mesh."""
    rng = np.random.RandomState(seed)
    ring0 = np.arange(N)
    a = rng.randint(0, N, N // 2)
    b = (a + rng.randint(2, N - 1, N // 2)) % N
    v0 = np.concatenate([ring0, a])
    v1 = np.concatenate([(ring0 + 1) % N, b])
    perm = rng.permutation(N)
    v0, v1 = perm[v0], perm[v1]
    pos = rng.rand(N, 3).astype(f32)
    con = -np.ones((N, 3), f32)
    pinned = rng.choice(N, 4, replace=False)
    con[pinned] = pos[pinned] + rng.rand(4, 3).astype(f32)
    offs = np.stack([pos, pos + 0.05 * rng.rand(N, 3).astype(f32)])
    return N, {
        "Offset": offs, "Angle": np.zeros((N, 3), f32), "UrShape": pos, "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": f32(1.0), "w_regSqrt": f32(np.sqrt(0.5)),
    }


def test_batched_remainder_reports_no_kernel(monkeypatch, capsys):
    """A batched graph operator with a remainder no longer reports
    "no_kernel": it has a batch form ("multi" for this mesh's 6 channels
    and remainder blocks), the batch runs one batched fused-loop call a step
    (the twin here, on CPU tensors; the kernel of that form on the card),
    never an instance's step by itself, ``fused_fallback`` stays None and
    stderr is silent; the results are the per-instance solves through the
    eager loop.

    The final costs are held at rtol 1e-6 to the per-instance solves
    with equal CG counts, in float64 through the same batched twin
    (``fused_cg.LOOP_DTYPES`` widened to float64: one batched call a step,
    as in float32). In float32 the batched and the eager costs part by up
    to 1.0e-6 by their sum orders alone (24.226686 against 24.226711): one
    GN step to the rz floor (47 CG iterations) on an operator of
    Jacobi-scaled condition number 84 reaches k·κ·u = 2.4e-4 in float32
    (tests/float32_limits.py), each cost 2.2e-5 from the float64 one. So in
    float32 each cost is held to the float64 cost by k·κ·u, with equal CG
    counts."""
    N, inputs = _random_mesh()
    sp = dict(nIterations=1, lIterations=50, cg_rz_tolerance=1e-8)
    plan = ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": N}, device="cpu")
    meta = plan.cg_inputs({**inputs, "Offset": inputs["Offset"][0]})[0]
    assert meta["rem"] is not None
    assert fused_cg.batched_kernel_form(dict(meta, batch=2)) == "multi"
    calls = []
    twin = fused_cg.fused_grid_cg_reference

    def spy(F, triples, b, *a, **k):  # the batched call, and each system's within it
        calls.append((k.get("batched", False), k.get("n_sys", 1), b.dtype))
        return twin(F, triples, b, *a, **k)

    monkeypatch.setattr(fused_cg, "fused_grid_cg_reference", spy)
    monkeypatch.setattr(GaussNewtonSolver, "_step_each", lambda *a, **k: 1 / 0)
    res = {}
    for dp, dt in ((False, torch.float32), (True, torch.float64)):
        if dp:
            monkeypatch.setattr(fused_cg, "LOOP_DTYPES", (torch.float32, torch.float64))
        bp = ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": N}, device="cpu",
                                                            double_precision=dp)
        res[dp] = bp.solve_batched(dict(inputs), **sp)
        assert bp.fused_fallback is None
        assert calls == [(True, 2, dt)] + [(False, 1, dt)] * 2
        calls.clear()
    assert "no form the fused CG kernel takes" not in capsys.readouterr().err
    for k in range(2):
        one = {**inputs, "Offset": inputs["Offset"][k]}
        single = {}
        for dp in (False, True):
            eager = ott.Problem(tspecs.arap_mesh_deformation).plan(
                dims={"N": N}, device="cpu", double_precision=dp,
                init_params=ott.InitializationParameters(use_pallas_cg="off"))
            single[dp] = eager.solve(dict(one), **sp)
            assert res[dp].num_linear_iterations[k] == single[dp].num_linear_iterations > 0
        np.testing.assert_allclose(res[True].final_costs[k], single[True].final_cost,
                                   rtol=1e-6)
        bound = cg_bound(single[False].num_linear_iterations,
                         jacobi_condition(eager.dump_jacobian(dict(one), dense=True)))
        for cost in (res[False].final_costs[k], single[False].final_cost):
            np.testing.assert_allclose(cost, single[True].final_cost, rtol=bound)
    assert not calls


# -- per-instance exits ----------------------------------------------------------------


def test_per_instance_exits_freeze():
    """One LM instance starts at the exact solution of its data (parameters
    0, data 0: a zero residual), so its first step is rejected and, with the
    minimum radius at half the initial one, sets its ``done``. Its state,
    cost history (NaN-padded) and counts freeze while the others go on, as
    the JAX package's while_loop batching rule freezes them."""
    N = 64
    _truths, inputs = _curve_inputs(N, B=4, seed=2)
    inputs["funcParams"][1] = 0.0
    inputs["data"][1, :, 1] = 0.0
    sp = dict(nIterations=8, lIterations=20, min_trust_region_radius=5e3)
    jp, tp = _curve_plans(N)
    tr = tp.solve_batched(dict(inputs), **sp)
    jr = jp.solve_batched(dict(inputs), **sp)
    assert tr.num_iterations[1] == 1 and max(tr.num_iterations) > 2
    assert tr.num_iterations.tolist() == np.asarray(jr.num_iterations).tolist()
    assert tr.num_linear_iterations[1] == np.asarray(jr.num_linear_iterations)[1]
    assert np.array_equal(np.isnan(tr.costs), np.isnan(np.asarray(jr.costs)))
    assert tr.costs[1, 0] == 0.0 and np.isnan(tr.costs[1, 1:]).all()
    assert torch.equal(tr.unknowns["funcParams"][1], torch.zeros((1, 2)))
    fitted = tr.unknowns["funcParams"].numpy()
    np.testing.assert_allclose(fitted, np.asarray(jr.unknowns["funcParams"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_batched_cg_inputs_stack_the_single_systems(kind):
    """The batch's first-step systems, built under vmap, are the instances'
    own systems stacked: the same triples, and F, r0, pre (and LM's ctc)
    within float32 rounding of each instance's ``cg_inputs``."""
    N = 64
    _truths, inputs = _curve_inputs(N, B=3)
    tp = ott.Problem(tspecs.curve_fitting, kind=kind).plan(dims={"N": N, "U": 1}, device="cpu")
    meta, r0, pre, kw = tp.batched_cg_inputs(dict(inputs))
    assert meta["batch"] == 3 and tuple(meta["F"].shape) == (3, 4, 1, 1)
    for k in range(3):
        m1, r1, p1, kw1 = tp.cg_inputs({"funcParams": inputs["funcParams"][k],
                                        "data": inputs["data"][k], "G": inputs["G"]})
        assert meta["triples"] == m1["triples"] and meta["u_list"] == m1["u_list"]
        pairs = [(meta["F"][k], m1["F"]), (r0["funcParams"][k], r1["funcParams"]),
                 (pre["funcParams"][k], p1["funcParams"])]
        if kind == "LMGPU":
            pairs.append((kw["ctc"]["funcParams"][k], kw1["ctc"]["funcParams"]))
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
