"""Graph couplings across vertex spaces held to opt_tpu on the CPU: a graph
whose slots point into two index spaces, with unknowns on both, so that
its assembled JᵀJ carries per-pair ELL blocks (one slot's incident edges
per output vertex, the other space's p gathered per edge).

Two specs. "two_space": X (2 channels) on N, Y (1 channel) on U, the
energy (X(a0) − X(a1)) − Y(b)·(T(a0) − T(a1)) over G(a0, a1, b) and a fit
of X. "cluster": chip_smoke.py's ARAP with rotation clusters at 16² with
4×4 clusters (Offset on N, one Angle a cluster, G(v0, v1, r)). Neither
package has a CG kernel form for such an operator: both planners refuse it
and each step runs the eager loop (the JAX package's XLA loop).

One step is held to the JAX package's twice. At a fixed 10 CG iterations
(no exit): the cluster spec's step at 1e-6 of its largest entry (measured
2.6e-7, GN and LM), the toy's at 3e-6 (measured 1.6e-6 GN, 1.9e-6 LM; the
JAX package's own default and composed operators part by 1.1e-6 and
1.2e-6 there). To the CG's rz floor: the same CG count, and the step at
1e-5 (measured up to 5.2e-6 on the toy, 1.3e-6 on the cluster spec), and
in float64 at 1e-5; the toy's GN step, whose float32 steps part by 1.1e-5
by their sum orders, holds each float32 step to the float64 one by the
float32 reach k·κ·u instead (tests/float32_limits.py)"""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from chip_smoke import cluster_arap_inputs, cluster_arap_spec
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.ops import graph_ops as jgo
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.ops import graph_ops as tgo
from opt_tpu_torch.solver.params import FLOAT_EPSILON
from tests.float32_limits import cg_bound, jacobi_condition, jax_float64

torch.set_num_threads(2)

f32 = np.float32
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
FIXED_RTOL = {"two_space": 3e-6, "cluster": 1e-6}
CONVERGED_RTOL = 1e-5
# one step of a fixed 10 CG iterations, and one to the CG's rz floor; LM's
# zeta exit sits in float32 noise, so it is off (q_tolerance -inf,
# ROADMAP.md queue 3)
FIXED_KW = dict(nIterations=1, lIterations=10, cg_rz_tolerance=0.0, q_tolerance=float("-inf"))
STEP_KW = dict(FIXED_KW, lIterations=1000, cg_rz_tolerance=1e-10)


def two_space_spec(dsl):
    def two_space(S):
        N, U = S.Dim("N"), S.Dim("U")
        X = S.Unknown("X", 2, (N,))
        Y = S.Unknown("Y", 1, (U,))
        T = S.Array("T", 2, (N,))
        A = S.Array("A", 2, (N,))
        G = S.Graph("G", a0=(N,), a1=(N,), b=(U,))
        S.Energy(0.5 * (X(0) - A(0)))
        S.Energy((X(G.a0) - X(G.a1)) - Y(G.b) * (T(G.a0) - T(G.a1)))

    return two_space


def two_space_inputs(N=64, U=8, E=160, seed=0):
    """Random edges between distinct vertices of N (no self-loop, whose
    cross term the per-slot diagonal leaves out by definition), each with a
    random vertex of U."""
    rng = np.random.RandomState(seed)
    a0 = rng.randint(0, N, E)
    return {"N": N, "U": U}, {
        "X": rng.rand(N, 2).astype(f32), "Y": (1.0 + 0.1 * rng.rand(U, 1)).astype(f32),
        "T": rng.rand(N, 2).astype(f32), "A": rng.rand(N, 2).astype(f32),
        "G": {"a0": a0.astype(np.int32), "a1": ((a0 + rng.randint(1, N, E)) % N).astype(np.int32),
              "b": rng.randint(0, U, E).astype(np.int32)}}


SPECS = {
    "two_space": (two_space_spec, two_space_inputs),
    "cluster": (cluster_arap_spec, lambda: cluster_arap_inputs(16, 4)),
}
_CACHE = {}


def case(name):
    if name not in _CACHE:
        make_spec, make_inputs = SPECS[name]
        dims, inputs = make_inputs()
        _CACHE[name] = (make_spec(ot), make_spec(ott), dims, inputs)
    return _CACHE[name]


def tplan(name, kind="gaussNewtonGPU", **kw):
    _js, ts, dims, _inputs = case(name)
    ip = kw.pop("init_params", {})
    return ott.Problem(ts, kind=kind).plan(dims=dims, device="cpu",
                                           init_params=ott.InitializationParameters(**ip), **kw)


def jplan(name, kind="gaussNewtonGPU", **ip):
    js, _ts, dims, _inputs = case(name)
    return ot.Problem(js, kind=kind).plan(dims=dims, init_params=ot.InitializationParameters(**ip))


_SYSTEMS = {}


def systems(name, **ip):
    """Both packages' assembled systems at the spec's inputs: (plan,
    unknowns, FunctionSet, (A, diag, jtf, meta)) each, built once."""
    key = (name, tuple(sorted(ip.items())))
    if key not in _SYSTEMS:
        _SYSTEMS[key] = _systems(name, **ip)
    return _SYSTEMS[key]


def _systems(name, **ip):
    inputs = case(name)[3]
    out = []
    for plan, FS in ((jplan(name, **ip), JFunctionSet),
                     (tplan(name, init_params=ip), TFunctionSet)):
        u, c, g, p = plan._normalize_and_place(dict(inputs))
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        out.append((plan, u, fs, fs.assemble_stencil(u, plan.solver._stencil_plan)))
    return out


def _close(t, j, rtol):
    j = np.asarray(j, np.float64)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(t - j).max()) <= rtol * scale, (float(np.abs(t - j).max()), scale)


def _draw(unknowns, seed=7, dtype=f32):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, tuple(x.shape)).astype(dtype) for k, x in unknowns.items()}


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_ell_tables_match_jax(name):
    """The per-slot incidence and per-pair ELL tables the port binds are the
    JAX package's (it binds every ordered pair; the port the pairs across
    vertex spaces its operator reads), and so is the builder under a width
    bucket."""
    _js, _ts, dims, inputs = case(name)
    jg = jplan(name)._normalize_and_place(dict(inputs))[2]["G"]
    tg = tplan(name)._normalize_and_place(dict(inputs))[2]["G"]
    ell = tg["__ell__"]
    assert ell["ell"] and all(ko != ki for ko, ki in ell["ell"])
    for s, t in ell["inc"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jg[f"__ell_inc_{s}"]))
    for (ko, ki), t in ell["ell"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jg[f"__ell_{ko}__{ki}"]))
    g = inputs["G"]
    idx = {k: np.asarray(v) for k, v in g.items()}
    nv = {k: dims["U"] if k == "b" else dims["P"] if k == "r" else dims["N"] for k in idx}
    for wb in (None, tgo.bucket_size):
        ti, te = tgo.ell_tables(idx, nv, width_bucket=wb)
        ji, je = jgo.ell_tables(idx, nv, width_bucket=None if wb is None else jgo.bucket_size)
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k])
        assert set(te) == set(je)
        for k in je:
            np.testing.assert_array_equal(te[k], je[k])


def test_no_ell_tables_without_cross_space():
    """A graph whose couplings all stay in one vertex space (arap on a grid
    mesh) binds no ELL table, and its cached entry holds none."""
    from chip_smoke import arap_grid_inputs
    from opt_tpu_torch.models import specs as tspecs

    dims, inputs = arap_grid_inputs(6)
    plan = ott.Problem(tspecs.arap_mesh_deformation).plan(dims=dims, device="cpu")
    g = plan._normalize_and_place(dict(inputs))[2]["G"]
    assert "__ell__" not in g
    assert all(entry["ell"] is None for entry in plan._inc_cache.values())


# ---------------------------------------------------------------------------
# the assembled operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_assembled_apply_matches_jax(name):
    (_jp, ju, _jfs, (jA, *_j)), (_tp, tu, _tfs, (tA, *_t)) = systems(name)
    v = _draw(tu)
    ja = jA({k: jax.numpy.asarray(x) for k, x in v.items()})
    ta = tA({k: torch.as_tensor(x) for k, x in v.items()})
    for k in v:
        _close(ta[k], ja[k], 1e-6)


def _f64_system(name):
    plan = tplan(name, double_precision=True)
    u, c, g, p = plan._normalize_and_place(dict(case(name)[3]))
    fs = TFunctionSet(plan.compiled, c, g, p)
    fs.masks(u)
    return plan, u, fs, fs.assemble_stencil(u, plan.solver._stencil_plan)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_assembled_apply_matches_composed_float64(name):
    """The assembled operator, per-pair ELL blocks included, is Jᵀ(J·p) to
    1e-10 in float64."""
    _plan, u, fs, (A, *_rest) = _f64_system(name)
    v = {k: torch.as_tensor(x) for k, x in _draw(u, dtype=np.float64).items()}
    _r, J, JT = fs.linearize(u)
    composed, got = JT(J(v)), A(v)
    for k in v:
        _close(got[k], composed[k].numpy(), 1e-10)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_diagonal_and_blocks_equal_composed(name):
    """Couplings across vertex spaces lie off the diagonal: the Jacobi
    diagonal and the block-Jacobi blocks are the composed operator's (the
    dense JᵀJ's diagonal and its same-point blocks, in float64), so the
    per-pair ELL blocks change neither."""
    plan, u, fs, (A, diag, _jtf, _meta) = _f64_system(name)
    c = plan.compiled
    names = list(c.unknown_names)
    sizes = [u[k].numel() for k in names]

    def r_flat(x):
        parts, o = {}, 0
        for k, n in zip(names, sizes):
            parts[k] = x[o : o + n].reshape(u[k].shape)
            o += n
        return torch.cat([t.reshape(-1) for t in fs.F(parts)])

    x0 = torch.cat([u[k].reshape(-1) for k in names])
    Jd = torch.func.jacfwd(r_flat)(x0).numpy()
    H = Jd.T @ Jd
    offs = np.cumsum([0] + sizes)
    exact = fs.jtj_diag(u)
    for k, o, n in zip(names, offs, sizes):
        _close(diag[k], np.diag(H)[o : o + n].reshape(u[k].shape), 1e-12)
        _close(diag[k], exact[k].numpy(), 1e-12)
    pre = A.block_pre()
    for isp, inv in pre.inv.items():
        u_list, _offs, ct = pre.layouts[isp]
        npts = inv.shape[0]
        # the dense same-point block of each point of this space, packed
        idx = np.stack([offs[names.index(k)] + np.arange(npts)[:, None] * c.unknown_shape(k)[-1]
                        + np.arange(c.unknown_shape(k)[-1])[None, :] for k in u_list], 1)
        idx = idx.reshape(npts, ct)
        B = H[idx[:, :, None], idx[:, None, :]]
        d = np.diagonal(B, axis1=1, axis2=2)
        Breg = B + (1e-5 * d + FLOAT_EPSILON)[:, :, None] * np.eye(ct)
        Minv = np.linalg.inv(Breg)
        _close(inv, 0.5 * (Minv + np.swapaxes(Minv, 1, 2)), 1e-9)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cost_and_jtf_match_jax(name):
    (_jp, ju, jfs, (_jA, jdiag, jjtf, _jm)), (_tp, tu, tfs, (_tA, tdiag, tjtf, _tm)) = systems(name)
    np.testing.assert_allclose(float(tfs.cost(tu)), float(jfs.cost(ju)), rtol=1e-6)
    jg, tg = jjtf(jfs.F(ju)), tjtf(tfs.F(tu))
    for k in jg:
        _close(tg[k], jg[k], 1e-6)
        _close(tdiag[k], jdiag[k], 1e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_planners_refuse_and_the_step_runs_the_eager_loop(name):
    """Neither package's CG kernel has a form for couplings across vertex
    spaces: the JAX package's planner returns None (its step runs XLA's
    loop), the port's ``plan_fused_graph_cg`` returns None for the
    assembly's per-pair blocks, and the port's step runs the eager loop,
    saying so in ``fused_fallback``; it never builds a kernel meta without
    them."""
    (_jp, _ju, _jfs, (*_j, jmeta)), (tp, tu, _tfs, (*_t, tmeta)) = systems(name)
    assert jmeta is None and tmeta is None
    assert fused_cg.plan_fused_graph_cg(tp.compiled, tp.solver._stencil_plan, {}, {"g": {}},
                                        pair_exec={"pair": {}}) is None
    meta, _r0, _pre, _kw = tp.cg_inputs(dict(case(name)[3]))
    assert meta is None
    calls = []
    orig = fused_cg.fused_grid_cg_reference
    fused_cg.fused_grid_cg_reference = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        res = tp.solve(dict(case(name)[3]), nIterations=1, lIterations=20)
    finally:
        fused_cg.fused_grid_cg_reference = orig
    assert not calls and tp.fused_fallback == "no_kernel" and res.fused_fallback == "no_kernel"
    assert res.num_linear_iterations > 0 and np.isfinite(res.final_cost)


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------


def _step_pair(name, kind, ip=None, **kw):
    ip = ip or {}
    inputs = case(name)[3]
    jr = jplan(name, kind, **ip).solve(dict(inputs), **kw)
    tp = tplan(name, kind, init_params=ip)
    tr = tp.solve(dict(inputs), **kw)
    return jr, tr, tp


def _deltas(res, inputs, names):
    return np.concatenate([
        ((res.unknowns[k].numpy() if isinstance(res.unknowns[k], torch.Tensor)
          else np.asarray(res.unknowns[k])) - inputs[k]).ravel() for k in names])


_JAX_F64 = {}


def jax_float64_steps():
    """The JAX package's float64 step to the rz floor of each spec and kind
    (run by tests/float32_limits.py::jax_float64 in a process with x64 on)."""
    out = {}
    for name in SPECS:
        js, _ts, dims, inputs = case(name)
        for kind in ("gaussNewtonGPU", "LMGPU"):
            jr = ot.Problem(js, kind=kind).plan(dims=dims, double_precision=True).solve(
                dict(inputs), **STEP_KW)
            names = [k for k in ("X", "Y", "Offset", "Angle") if k in jr.unknowns]
            out[f"{name}_{kind}_delta"] = _deltas(jr, inputs, names)
            out[f"{name}_{kind}_iters"] = np.asarray(jr.num_linear_iterations)
    return out


# the converged steps whose two float32 steps part past CONVERGED_RTOL by
# their sum orders (see test_one_step_matches_jax): there each float32 step
# is held to the float64 one by the float32 reach
_F32_BOUNDED = {("two_space", "gaussNewtonGPU")}


@pytest.mark.parametrize("kw", ["fixed", "converged"])
@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_one_step_matches_jax(name, kind, kw):
    """One GN and one LM step from the inputs, as the JAX package's: at 10
    CG iterations, and to the rz floor in as many CG iterations (the module
    docstring gives the tolerances); to the rz floor also in float64, where
    the packages agree to 2.4e-14 with equal CG counts.

    To the rz floor the toy's GN step (24 CG iterations) is where float32
    cannot hold the step to 1e-5: the toy's Jacobi-scaled condition number
    is 92, so the float32 reach is k·κ·u = 1.3e-4 of the step's largest
    entry (tests/float32_limits.py), and its two float32 steps part by
    1.1e-5, each 0.5–1e-5 from the float64 step. There each package's
    float32 step is held to the float64 one by k·κ·u, with equal CG counts;
    the other converged steps keep the float32 pair at 1e-5."""
    fixed = kw == "fixed"
    jr, tr, tp = _step_pair(name, kind, **(FIXED_KW if fixed else STEP_KW))
    names = list(tp.compiled.unknown_names)
    inputs = case(name)[3]
    jd, td = _deltas(jr, inputs, names), _deltas(tr, inputs, names)
    assert tp.fused_fallback == "no_kernel"
    if fixed:
        assert tr.num_linear_iterations == jr.num_linear_iterations == FIXED_KW["lIterations"]
        assert float(np.abs(td - jd).max()) <= FIXED_RTOL[name] * float(np.abs(jd).max())
        return
    assert tr.num_linear_iterations == jr.num_linear_iterations < STEP_KW["lIterations"]
    bounded = (name, kind) in _F32_BOUNDED
    if not bounded:
        assert float(np.abs(td - jd).max()) <= CONVERGED_RTOL * float(np.abs(jd).max())
    if not _JAX_F64:
        _JAX_F64.update(jax_float64("tests.test_torch_cross_space", "jax_float64_steps"))
    t64 = tplan(name, kind, double_precision=True)
    r64 = t64.solve(dict(inputs), **STEP_KW)
    d64 = _deltas(r64, inputs, names)
    assert r64.num_linear_iterations == int(_JAX_F64[f"{name}_{kind}_iters"])
    want = _JAX_F64[f"{name}_{kind}_delta"]
    assert float(np.abs(d64 - want).max()) <= CONVERGED_RTOL * float(np.abs(want).max())
    if not bounded:
        return
    bound = cg_bound(tr.num_linear_iterations,
                     jacobi_condition(t64.dump_jacobian(dict(inputs), dense=True)))
    for d32 in (td, jd):
        assert float(np.abs(d32 - d64).max()) <= bound * float(np.abs(d64).max())


@pytest.mark.parametrize("name,kind,nl", [("two_space", "LMGPU", 6),
                                          ("cluster", "gaussNewtonGPU", 4)])
def test_final_cost_matches_jax(name, kind, nl):
    jr, tr, _tp = _step_pair(name, kind, nIterations=nl, lIterations=100)
    assert abs(tr.final_cost - jr.final_cost) <= GOLDEN_RTOL * abs(jr.final_cost), (
        tr.costs, jr.costs)
    assert tr.final_cost < tr.costs[0] or name == "cluster"


def test_bfloat16_coefficients_step_matches_jax():
    """coefficient_dtype="bfloat16" narrows the per-pair ELL blocks as the
    JAX package does: one step equal to its bf16 step."""
    (_jp, ju, _jfs, (jA, *_j)), (_tp, tu, _tfs, (tA, *_t)) = systems(
        "two_space", coefficient_dtype="bfloat16")
    v = _draw(tu)
    ja = jA({k: jax.numpy.asarray(x) for k, x in v.items()})
    ta = tA({k: torch.as_tensor(x) for k, x in v.items()})
    for k in v:
        _close(ta[k], ja[k], 1e-6)
    jr, tr, tp = _step_pair("two_space", "gaussNewtonGPU", {"coefficient_dtype": "bfloat16"},
                            **FIXED_KW)
    names = list(tp.compiled.unknown_names)
    jd, td = _deltas(jr, case("two_space")[3], names), _deltas(tr, case("two_space")[3], names)
    assert tr.num_linear_iterations == jr.num_linear_iterations
    assert float(np.abs(td - jd).max()) <= FIXED_RTOL["two_space"] * float(np.abs(jd).max())


def test_dynamic_topology_equals_the_exact_topology():
    """dynamic_topology=True pads the edges and buckets the per-slot
    incidence widths of the ELL tables too: its solve equals the exact
    topology's to 2e-3."""
    inputs = case("cluster")[3]
    kw = dict(nIterations=2, lIterations=100)
    dplan = tplan("cluster", dynamic_topology=True)
    g = dplan._normalize_and_place(dict(inputs))[2]["G"]
    E = inputs["G"]["v0"].shape[0]
    assert g["v0"].shape[0] == tgo.bucket_size(E)
    for t in g["__ell__"]["inc"].values():
        assert t.shape[1] == tgo.bucket_size(t.shape[1])
    dres = dplan.solve(dict(inputs), **kw)
    eres = tplan("cluster").solve(dict(inputs), **kw)
    np.testing.assert_allclose(dres.costs, eres.costs, rtol=2e-3)
    for k in ("Offset", "Angle"):
        _close(dres.unknowns[k], eres.unknowns[k].numpy(), 2e-3)


def test_solve_batched_two_systems():
    """A two-system ``solve_batched``: each instance as its own solve (the
    batch has no kernel form either, so its instances step in turn)."""
    dims, inputs = case("two_space")[2:]
    X2 = np.stack([inputs["X"], inputs["X"] + 0.25]).astype(f32)
    kw = dict(nIterations=2, lIterations=60)
    plan = tplan("two_space")
    bres = plan.solve_batched(dict(inputs, X=X2), **kw)
    for k in range(2):
        own = tplan("two_space").solve(dict(inputs, X=X2[k]), **kw)
        np.testing.assert_allclose(bres.final_costs[k], own.final_cost, rtol=1e-6)
        assert bres.num_linear_iterations[k] == own.num_linear_iterations
        _close(bres.unknowns["X"][k], own.unknowns["X"].numpy(), 1e-6)
