"""opt_tpu_torch's graph domains held to opt_tpu on the CPU: the host tables
of the graph operator, cost, JᵀF, the Jacobi diagonal and the assembled
JᵀJ·p, one GN step's CG, the plain twins of the graph CG kernel (the DIA
form and the remainder) against the composed operator, the JAX package's
graph CG descriptors carried across, and the medium goldens of
arap_mesh_deformation and curve_fitting.

Two meshes: a 16x16 grid mesh numbered row-major, whose cross-vertex reads
all sit at four vertex-id offsets (the DIA structure), and a ring with
random chords under a random numbering, whose reads sit nowhere in
particular (the remainder structure). Two more cases hold what the kernel's
capacity forces: a grid mesh with fourteen offsets, one more than the
kernel's triple table holds, and two graphs whose remainders share one
CSR."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu.ops import graph_ops as jgo
from opt_tpu.ops.pallas_cg import fused_grid_cg as j_fused_grid_cg
from opt_tpu.utils import reorder as jreorder
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.functions import tree_dot
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.ops import graph_ops as tgo
from opt_tpu_torch.utils import reorder as treorder
from opt_tpu_torch.utils.convert import (
    inputs_from_numpy,
    meta_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from tests.float32_limits import cg_bound, jacobi_condition, jax_float64
from tests.test_golden_costs import GOLDEN, _medium_cases

torch.set_num_threads(2)

f32 = np.float32
ARAP = "arap_mesh_deformation"
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py


def grid_mesh(n_side=16):
    """bench.py::bench_arap_graph's inputs at a small side: both edge
    directions, one corner pinned, the opposite corner pulled."""
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -np.ones((N, 3), f32)
    con[0] = pos[0]
    con[-1] = pos[-1] + np.array([3.0, 0.0, 2.0], f32)
    return N, _arap_inputs(pos, con, np.concatenate([v0, v1]), np.concatenate([v1, v0]))


def random_mesh(N=160, seed=3):
    """A ring with random chords, both edge directions, under a random
    vertex numbering: no vertex-id offset covers its reads."""
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
    return N, _arap_inputs(pos, con, np.concatenate([v0, v1]), np.concatenate([v1, v0]))


def _arap_inputs(pos, con, v0, v1):
    N = pos.shape[0]
    return {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32), "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0.astype(np.int32), "v1": v1.astype(np.int32)},
        "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(np.sqrt(0.5)),
    }


def dense_grid_mesh(n_side=16):
    """A 16x16 grid mesh numbered row-major with seven edge directions,
    both ways: its reads sit at fourteen vertex-id offsets (±1, ±2, ±15,
    ±16, ±17, ±32, ±33), one more than the kernel's triple table holds at
    six channels."""
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0, v1 = [], []
    for a, b in ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0), (2, 1)):
        ok = (ii + a < n_side) & (jj + b >= 0) & (jj + b < n_side)
        v0.append(vid[ii[ok], jj[ok]])
        v1.append(vid[ii[ok] + a, jj[ok] + b])
    v0, v1 = np.concatenate(v0), np.concatenate(v1)
    con = -np.ones((N, 3), f32)
    con[0] = pos[0]
    con[-1] = pos[-1] + np.array([3.0, 0.0, 2.0], f32)
    return N, _arap_inputs(pos, con, np.concatenate([v0, v1]), np.concatenate([v1, v0]))


MESHES = {"grid": grid_mesh, "random": random_mesh}
_MESH_CACHE = {}


def _mesh(name):
    if name not in _MESH_CACHE:
        _MESH_CACHE[name] = (MESHES.get(name) or dense_grid_mesh)()
    return _MESH_CACHE[name]


def _plans(mesh, kind="gaussNewtonGPU", jax_mode="auto", **kw):
    N, _inputs = _mesh(mesh)
    jp = ot.Problem(jspecs.arap_mesh_deformation, kind=kind).plan(
        dims={"N": N}, init_params=ot.InitializationParameters(use_pallas_cg=jax_mode), **kw
    )
    tp = ott.Problem(tspecs.arap_mesh_deformation, kind=kind).plan(
        dims={"N": N}, device="cpu", **kw
    )
    return jp, tp


def _systems(mesh):
    """Both packages' assembled systems at the mesh's inputs."""
    _N, inputs = _mesh(mesh)
    jp, tp = _plans(mesh)
    out = []
    for plan, FS in ((jp, JFunctionSet), (tp, TFunctionSet)):
        u, c, g, p = plan._normalize_and_place(dict(inputs))
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        out.append((plan, u, fs, fs.assemble_stencil(u, plan.solver._stencil_plan)))
    return out


def _close(t, j, rtol):
    j = np.asarray(j)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(t - j).max()) <= rtol * scale, (float(np.abs(t - j).max()), scale)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_table_builders_match(mesh):
    N, inputs = _mesh(mesh)
    v0, v1 = inputs["G"]["v0"], inputs["G"]["v1"]
    np.testing.assert_array_equal(tgo.incidence_table(v0, N), jgo.incidence_table(v0, N))
    inc = tgo.combined_incidence_table([v0, v1], N)
    np.testing.assert_array_equal(inc, jgo.combined_incidence_table([v0, v1], N))
    cross = tgo.combined_cross_table([v0, v1], N, inc=inc)
    np.testing.assert_array_equal(cross, jgo.combined_cross_table([v0, v1], N))
    td = tgo.dia_split(cross, N, max_offsets=32, min_coverage=0.0)
    jd = jgo.dia_split(cross, N, max_offsets=32, min_coverage=0.0)
    assert td[0] == jd[0]
    for a, b in zip(td[1:], jd[1:]):
        np.testing.assert_array_equal(a, b)
    flat_p = np.where(cross.reshape(N, -1) < N, np.arange(cross[0].size), cross[0].size)
    for a, b in zip(tgo.dedup_reads(flat_p, cross.reshape(N, -1), N, cross[0].size),
                    jgo.dedup_reads(flat_p, cross.reshape(N, -1), N, cross[0].size)):
        np.testing.assert_array_equal(a, b)
    assert tgo.bucket_size(37) == jgo.bucket_size(37) == 64


def test_reorders_match(monkeypatch):
    """The port's reorders are the JAX package's. grid_embed_order's
    eigensolver starts from a seeded vector in the port (the same numbering
    in every process); the JAX package's copy is given the same start."""
    import scipy.sparse.linalg as sla

    _N, inputs = _mesh("random")
    v0, v1 = inputs["G"]["v0"], inputs["G"]["v1"]
    N = inputs["Offset"].shape[0]
    np.testing.assert_array_equal(treorder.rcm_order(v0, v1, N), jreorder.rcm_order(v0, v1, N))
    tperm = treorder.grid_embed_order(v0, v1, N, width=16)
    np.testing.assert_array_equal(tperm, treorder.grid_embed_order(v0, v1, N, width=16))
    eigsh = sla.eigsh
    monkeypatch.setattr(sla, "eigsh", lambda A, **k: eigsh(
        A, **dict(k, v0=np.random.RandomState(0).rand(A.shape[0]))))
    np.testing.assert_array_equal(tperm, jreorder.grid_embed_order(v0, v1, N, width=16))
    tv = treorder.remap_edges(tperm, v0, v1)
    for a, b in zip(tv, jreorder.remap_edges(tperm, v0, v1)):
        np.testing.assert_array_equal(a, b)
    assert treorder.dia_coverage(*tv, N) == jreorder.dia_coverage(*tv, N)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plan_tables_match(mesh):
    """The port's tables equal the JAX package's bound tables: the
    incidence table, the DIA masks (grid) and the deduplicated remainder
    (random), and the kernel's CSR lists the remainder's reads."""
    N, inputs = _mesh(mesh)
    jp, tp = _plans(mesh)
    jg = jp._normalize_and_place(dict(inputs))[2]["G"]
    (gk, tabs), = tp._normalize_and_place(dict(inputs))[2]["G"]["__groups__"].items()
    suffix = gk[len("__inc__"):]
    np.testing.assert_array_equal(tabs["inc"].numpy(), np.asarray(jg[gk]))
    j_offsets = sorted(int(k.rsplit("__", 1)[1]) for k in jg if k.startswith("__diamask__"))
    assert sorted(off for off, _m in tabs["dia"]) == j_offsets
    for off, m in tabs["dia"]:
        np.testing.assert_array_equal(m.numpy(), np.asarray(jg[f"__diamask__{suffix}__{off}"]))
    if mesh == "grid":
        assert j_offsets == [-16, -1, 1, 16] and tabs["csr"] is None
        assert np.asarray(jg[f"__diarem__{suffix}"]).shape[1] == 0
        return
    assert not j_offsets
    np.testing.assert_array_equal(tabs["rem_pos"].numpy(), np.asarray(jg[f"__diarem__{suffix}"]))
    cross2 = np.asarray(jg[f"__diaremcross__{suffix}"])
    np.testing.assert_array_equal(tabs["rem_cross"].numpy(), cross2)
    csr = tabs["csr"]
    rowptr, col = csr["rowptr"].numpy(), csr["col"].numpy()
    for v in (0, N // 2, N - 1):
        row = cross2[v]
        np.testing.assert_array_equal(col[rowptr[v] : rowptr[v + 1]], row[row < N])


# ---------------------------------------------------------------------------
# the assembled operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cost_jtf_and_diagonal_match(mesh):
    (jp, ju, jfs, (_jA, jdiag, jjtf, _jm)), (tp, tu, tfs, (_tA, tdiag, tjtf, _tm)) = _systems(mesh)
    np.testing.assert_allclose(float(tfs.cost(tu)), float(jfs.cost(ju)), rtol=1e-6)
    jg, tg = jjtf(jfs.F(ju)), tjtf(tfs.F(tu))
    for k in jg:
        _close(tg[k], jg[k], 1e-6)
        _close(tdiag[k], jdiag[k], 1e-6)
    # the assembled diagonal is the exact one
    for k, v in tfs.jtj_diag(tu).items():
        _close(tdiag[k], v.numpy(), 1e-6)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_assembled_apply_matches(mesh):
    (_jp, ju, _jfs, (jA, *_j)), (_tp, tu, tfs, (tA, *_t)) = _systems(mesh)
    rng = np.random.RandomState(7)
    v = {k: rng.uniform(-1, 1, tuple(x.shape)).astype(f32) for k, x in tu.items()}
    ja = jA({k: jax.numpy.asarray(x) for k, x in v.items()})
    ta = tA({k: torch.as_tensor(x) for k, x in v.items()})
    _r, J, JT = tfs.linearize(tu)
    composed = JT(J({k: torch.as_tensor(x) for k, x in v.items()}))
    for k in v:
        _close(ta[k], ja[k], 1e-6)
        _close(ta[k], composed[k].numpy(), 1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_meta_structure(mesh):
    """The loop's descriptor: grid-class meshes give DIA triples at flat
    offsets (0, ±1) and (0, ±16) and no remainder; the random mesh gives
    same-vertex triples only, with the remainder's reads as the CSR."""
    N, inputs = _mesh(mesh)
    _jp, tp = _plans(mesh)
    meta, _r0, _pre, _kw = tp.cg_inputs(dict(inputs))
    assert tp.fused_fallback is None and meta is not None
    assert meta["u_list"] == ("Offset", "Angle") and meta["ctot"] == 6
    assert tuple(meta["F"].shape[1:]) == (1, N)
    offsets = sorted({d for (d, _i, _j, _f) in meta["triples"]})
    if mesh == "grid":
        assert offsets == [(0, -16), (0, -1), (0, 0), (0, 1), (0, 16)]
        assert meta["rem"] is None
    else:
        assert offsets == [(0, 0)]
        rem = meta["rem"]
        nnz = int(rem["col"].shape[0])
        assert tuple(rem["blk"].shape) == (nnz, 6, 6) and int(rem["rowptr"][-1]) == nnz


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _twin_solve(tp, inputs):
    """``tp.solve(inputs)`` with a spy on the port's twin: returns the
    result and, for each call of the twin, (its vectors' dtype, whether it
    had a remainder)."""
    calls = []
    orig = fused_cg.fused_grid_cg_reference

    def spy(F, triples, b, *a, **k):
        calls.append((b.dtype, k.get("rem") is not None))
        return orig(F, triples, b, *a, **k)

    fused_cg.fused_grid_cg_reference = spy
    try:
        return tp.solve(dict(inputs)), calls
    finally:
        fused_cg.fused_grid_cg_reference = orig


def _one_gn_step_pair(jp, tp, inputs, f32_bound=False):
    """One GN step from ``inputs`` in both packages (the JAX plan on its XLA
    loop): the same δ to 1e-5 and the same CG iteration count, the rz floor
    crossed well inside the budget. With ``f32_bound`` the float32 δ are
    held instead to the float64 step (see :func:`test_one_gn_step_matches_jax`).
    Returns, for each call of the port's twin, whether it had a remainder,
    and both results."""
    tr, twin = _twin_solve(tp, inputs)
    calls = [rem for dt, rem in twin if dt == torch.float32]
    assert len(calls) == len(twin)
    jr = jp.solve(dict(inputs))
    assert jp.solver._pallas_mode is None and jp.fused_fallback is None
    assert tp.fused_fallback is None
    assert tr.num_linear_iterations == jr.num_linear_iterations < 400
    for k in ("Offset", "Angle") if not f32_bound else ():
        jd = np.asarray(jr.unknowns[k]) - inputs[k]
        td = tr.unknowns[k].numpy() - inputs[k]
        _close(td, jd, 1e-5)
    return calls, tr, jr


_STEP_KW = dict(nIterations=1, lIterations=400, cg_rz_tolerance=1e-8)
# the meshes whose two float32 steps part past 1e-5 by their sum orders
# (see test_one_gn_step_matches_jax): there the float32 steps are held to
# the float64 one by the float32 reach
_F32_BOUNDED = {"random"}
_JAX_F64 = {}


def jax_float64_steps():
    """The JAX package's float64 GN step on each mesh (run by
    tests/float32_limits.py::jax_float64 in a process with x64 on)."""
    out = {}
    for mesh in MESHES:
        N, inputs = _mesh(mesh)
        jp = ot.Problem(jspecs.arap_mesh_deformation).plan(
            dims={"N": N}, double_precision=True,
            init_params=ot.InitializationParameters(use_pallas_cg="off"), **_STEP_KW)
        jr = jp.solve(dict(inputs))
        for k in ("Offset", "Angle"):
            out[f"{mesh}_{k}"] = np.asarray(jr.unknowns[k]) - inputs[k]
        out[f"{mesh}_iters"] = np.asarray(jr.num_linear_iterations)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_one_gn_step_matches_jax(mesh, monkeypatch):
    """One GN step from the inputs: the port's fused loop (its twin, on the
    CPU) and JAX's XLA loop on its assembled operator give the same δ and
    the same CG iteration count, in float32 and, through the same twin
    (``fused_cg.LOOP_DTYPES`` widened to float64), in float64: δ at 1e-5 of
    the largest entry (the packages agree to 2.2e-11 in float64).

    On the grid mesh the float32 pair holds at 1e-5 too. On the random mesh
    the step runs CG to an rz floor of 1e-8 in 82 iterations, past the point
    where float32's rounding stays below 1e-5 of the step: its
    Jacobi-scaled condition number is 1039, so the float32 reach is
    k·κ·u = 5.1e-3 of the largest entry (tests/float32_limits.py), and the
    two packages' float32 steps part by up to 4.8e-5 by their sum orders
    alone, each 8–9e-4 from the float64 step. There each package's float32
    δ is held to the float64 step by k·κ·u, with equal CG counts."""
    N, inputs = _mesh(mesh)
    jp, tp = _plans(mesh, jax_mode="off", **_STEP_KW)
    bounded = mesh in _F32_BOUNDED
    calls, tr, jr = _one_gn_step_pair(jp, tp, inputs, f32_bound=bounded)
    assert calls == [mesh == "random"]
    if not _JAX_F64:
        _JAX_F64.update(jax_float64("tests.test_torch_graph", "jax_float64_steps"))
    monkeypatch.setattr(fused_cg, "LOOP_DTYPES", (torch.float32, torch.float64))
    t64 = ott.Problem(tspecs.arap_mesh_deformation).plan(
        dims={"N": N}, device="cpu", double_precision=True, **_STEP_KW)
    r64, twin = _twin_solve(t64, inputs)
    assert twin == [(torch.float64, mesh == "random")] and t64.fused_fallback is None
    assert r64.num_linear_iterations == int(_JAX_F64[f"{mesh}_iters"]) < 400
    d64 = {k: r64.unknowns[k].numpy() - inputs[k] for k in ("Offset", "Angle")}
    for k in ("Offset", "Angle"):
        _close(d64[k], _JAX_F64[f"{mesh}_{k}"], 1e-5)
    if not bounded:
        return
    bound = cg_bound(tr.num_linear_iterations,
                     jacobi_condition(t64.dump_jacobian(dict(inputs), dense=True)))
    for k in ("Offset", "Angle"):
        for res in (tr, jr):
            d32 = np.asarray(res.unknowns[k]).astype(np.float64) - inputs[k]
            _close(d32, d64[k], bound)


def test_offsets_beyond_the_kernel_table_join_the_remainder():
    """Fourteen DIA offsets at six channels need 3 + 36 + 14·36 = 543
    triples, more than the kernel's 512: the port keeps the thirteen most
    frequent as offsets and sends the reads of the fourteenth to the
    remainder CSR, where the JAX package keeps all fourteen. The fused loop
    runs (no fallback), with the remainder, and one GN step equals the JAX
    package's."""
    N, inputs = _mesh("dense_grid")
    jp, tp = _plans("dense_grid", jax_mode="off", **_STEP_KW)
    assert fused_cg.graph_dia_offset_cap(tp.compiled, tp.solver._stencil_plan) == 13
    jg = jp._normalize_and_place(dict(inputs))[2]["G"]
    assert sum(k.startswith("__diamask__") for k in jg) == 14
    (tabs,) = tp._normalize_and_place(dict(inputs))[2]["G"]["__groups__"].values()
    assert len(tabs["dia"]) == 13 and tabs["csr"] is not None
    meta, _r0, _pre, _kw = tp.cg_inputs(dict(inputs))
    assert meta is not None and meta["rem"] is not None
    assert len(meta["triples"]) <= fused_cg.MAX_TRIPLES
    assert len({d for (d, _i, _j, _f) in meta["triples"]}) == 14  # 13 offsets and (0, 0)
    assert _one_gn_step_pair(jp, tp, inputs)[0] == [True]


def test_no_kernel_form_is_reported(monkeypatch, capsys):
    """A float32 operator the kernel cannot take (here: a triple table cut
    to 10 entries, below the 39 the remainder form needs) runs the eager
    loop, never the twin, and says so: ``fused_fallback`` is "no_kernel" and
    stderr names it."""
    _N, inputs = _mesh("random")
    monkeypatch.setattr(fused_cg, "MAX_TRIPLES", 10)
    _jp, tp = _plans("random", **_STEP_KW)
    calls = []
    monkeypatch.setattr(fused_cg, "fused_grid_cg_reference", lambda *a, **k: calls.append(1))
    res = tp.solve(dict(inputs))
    assert tp.fused_fallback == "no_kernel" and not calls and res.num_linear_iterations > 0
    assert "no form the fused CG kernel takes" in capsys.readouterr().err


def _arap_two_graphs(pkg):
    """arap_mesh_deformation over two graphs on one vertex space, written
    against ``pkg``: two groups, each with a remainder."""

    def spec(S):
        N = S.Dim("N")
        w_fitSqrt, w_regSqrt = S.Param("w_fitSqrt"), S.Param("w_regSqrt")
        Offset, Angle = S.Unknown("Offset", 3, (N,)), S.Unknown("Angle", 3, (N,))
        UrShape, Constraints = S.Array("UrShape", 3, (N,)), S.Array("Constraints", 3, (N,))
        valid = pkg.greatereq(Constraints(0)[..., 0:1], -999999.9)
        S.Energy(pkg.Select(valid, w_fitSqrt * (Offset(0) - Constraints(0)), 0.0))
        for name in ("G", "H"):
            g = S.Graph(name, v0=(N,), v1=(N,))
            arap = (Offset(g.v0) - Offset(g.v1)) - pkg.Rotate3D(
                Angle(g.v0), UrShape(g.v0) - UrShape(g.v1)
            )
            S.Energy(w_regSqrt * arap)

    return spec


def test_two_graphs_share_one_remainder():
    """Two graphs on one vertex space under random numberings: both groups'
    remainders merge into the one CSR the kernel takes (each row's entries
    group by group), the twin applies the assembled operator, and one GN
    step equals the JAX package's."""
    N, inputs = _mesh("random")
    _n, other = random_mesh(N, seed=5)
    inputs = dict(inputs, H=other["G"])
    jp = ot.Problem(_arap_two_graphs(ot)).plan(
        dims={"N": N}, init_params=ot.InitializationParameters(use_pallas_cg="off"), **_STEP_KW
    )
    tp = ott.Problem(_arap_two_graphs(ott)).plan(dims={"N": N}, device="cpu", **_STEP_KW)
    u, c, g, p = tp._normalize_and_place(dict(inputs))
    fs = TFunctionSet(tp.compiled, c, g, p)
    fs.masks(u)
    tA, _diag, _jtf, meta = fs.assemble_stencil(u, tp.solver._stencil_plan)
    nnz = [int(g[k]["__groups__"][gk]["csr"]["col"].shape[0])
           for k in ("G", "H") for gk in g[k]["__groups__"]]
    assert meta is not None and int(meta["rem"]["col"].shape[0]) == sum(nnz)
    assert int(meta["rem"]["rowptr"][-1]) == sum(nnz)
    rng = np.random.RandomState(9)
    v = {k: torch.as_tensor(rng.uniform(-1, 1, tuple(x.shape)).astype(f32)) for k, x in u.items()}
    got = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"], fused_cg.pack(v, meta))
    _close(got, fused_cg.pack(tA(v), meta).numpy(), 1e-5)
    assert _one_gn_step_pair(jp, tp, inputs)[0] == [True]


def _twin_system(mesh, lm):
    _N, inputs = _mesh(mesh)
    _jp, tp = _plans(mesh, kind="LMGPU" if lm else "gaussNewtonGPU")
    if lm:
        meta, r0, pre, kw = tp.cg_inputs(dict(inputs))
        ctc = kw["ctc"]
    else:
        (meta, r0, pre, _kw), ctc = tp.cg_inputs(dict(inputs)), None
    u, c, g, p = tp._normalize_and_place(dict(inputs))
    fs = TFunctionSet(tp.compiled, c, g, p)
    fs.masks(u)
    _r, J, JT = fs.linearize(u)
    return meta, r0, pre, ctc, (lambda v: JT(J(v)))


@pytest.mark.parametrize("form", ["gn", "lm"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_twin_matches_composed_operator(mesh, form):
    """The GN and LM twins on the packed kernel inputs (stencil triples on
    [1, N], the remainder CSR) against the loop on the composed Jᵀ(J·p)
    (+ CtC·p): one apply to 1e-5, and 12 iterations with no exit to 1e-4
    (f32 sums in another order, carried through CG's recurrences)."""
    lm = form == "lm"
    meta, r0, pre, ctc, composed = _twin_system(mesh, lm)
    b, prem = fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)
    ctcm = fused_cg.pack(ctc, meta) if lm else None
    rng = np.random.RandomState(5)
    v = {k: torch.as_tensor(rng.uniform(-1, 1, tuple(x.shape)).astype(f32)) for k, x in r0.items()}
    ref = composed(v)
    if lm:
        ref = {k: ref[k] + ctc[k] * v[k] for k in ref}
    got = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"], fused_cg.pack(v, meta))
    if lm:
        got = got + ctcm * fused_cg.pack(v, meta)
    _close(got, fused_cg.pack(ref, meta).numpy(), 1e-5)

    lm_kw = dict(ctc=ctcm, reset_period=4, q_tolerance=float("-inf")) if lm else {}
    dt, it = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, prem, 12, 0.0, rem=meta["rem"], **lm_kw
    )

    def apply(p):
        out = composed(p)
        return {k: out[k] + ctc[k] * p[k] for k in out} if lm else out

    dc, ic = fused_cg._run_cg(
        r0, apply, lambda r: {k: pre[k] * r[k] for k in r}, tree_dot, 12, 0.0,
        guard_div=True, reset_period=4 if lm else None,
        q_tol=float("-inf") if lm else None,
    )
    assert it == ic == 12
    _close(dt, fused_cg.pack(dc, meta).numpy(), 1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jax_graph_meta_runs_in_the_twin(mesh):
    """The JAX package's fused graph CG descriptor (its [R, L] fold, and
    for the random mesh its one-hot remainder tiles), carried across with
    meta_from_numpy, runs in the port's twin as the Pallas kernel runs in
    interpret mode: after 20 iterations with no exit δ agrees to 1e-5 (the
    two loops sum their dots and the remainder in another order, and CG
    carries that difference up about tenfold by the 20th iteration), and
    at the real tolerance both stop at the same iteration."""
    _N, inputs = _mesh(mesh)
    jp, _tp = _plans(mesh, jax_mode="interpret")
    u, c, g, p = jp._normalize_and_place(dict(inputs))
    fs = JFunctionSet(jp.compiled, c, g, p)
    fs.masks(u)
    _A, diag, jtf_fn, jmeta = fs.assemble_stencil(u, jp.solver._stencil_plan)
    r_terms = jtf_fn.r_terms if jtf_fn.r_terms is not None else fs.F(u)
    r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
    pre = fs.mask_rows(jp.solver._guarded_invert(diag))
    assert jmeta is not None and (jmeta.get("rem") is not None) == (mesh == "random")
    meta = meta_from_numpy(jax.device_get(jmeta), device="cpu")
    tr0 = {k: torch.as_tensor(np.array(v)) for k, v in r0.items()}
    tpre = {k: torch.as_tensor(np.array(v)) for k, v in pre.items()}
    jd, jit = j_fused_grid_cg(jmeta, r0, pre, 20, 0.0, interpret=True)
    td, tit = fused_cg.fused_grid_cg(meta, tr0, tpre, 20, 0.0)
    assert int(tit) == int(jit) == 20
    for k in jd:
        _close(td[k], jd[k], 1e-5)
    _jd, jit = j_fused_grid_cg(jmeta, r0, pre, 200, 1e-8, interpret=True)
    _td, tit = fused_cg.fused_grid_cg(meta, tr0, tpre, 200, 1e-8)
    assert int(tit) == int(jit) < 200


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

_GOLDEN_CASES = {}


def _golden_case(name):
    if not _GOLDEN_CASES:
        _GOLDEN_CASES.update(_medium_cases())
    return _GOLDEN_CASES[name]


def test_curve_fitting_lm_golden():
    kind, nl, lin, golden = GOLDEN["curve_fitting"]
    dims, inputs = _golden_case("curve_fitting")
    plan = ott.Problem(tspecs.curve_fitting, kind=kind).plan(dims=dims, device="cpu")
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=lin)
    assert plan.fused_fallback is None and res.num_iterations == nl
    np.testing.assert_allclose(res.final_cost, golden, rtol=GOLDEN_RTOL)


def test_arap_gn_golden():
    """The arap GN 10x60 medium golden, held step by step. This solve does
    not settle: with 60 CG iterations per step the cost rises and falls
    (47.5, 45.3, 44.2, 43.8, 46.8, ...), and from the third step on each
    step multiplies a float32 rounding difference about tenfold, so two
    correct solvers with other summation orders end 2-4% apart after ten
    steps (the JAX package's own composed operator ends at 44.94, its
    float64 solve at 45.25). So the port takes each of the golden run's ten
    steps from the JAX state before it: each step's cost to 1e-5 and its
    CG iteration count exactly, and the last one to the golden."""
    kind, nl, lin, golden = GOLDEN[ARAP]
    dims, inputs = _golden_case(ARAP)
    jp = ot.Problem(jspecs.arap_mesh_deformation, kind=kind).plan(
        dims=dims, nIterations=nl, lIterations=lin
    )
    tp = ott.Problem(tspecs.arap_mesh_deformation, kind=kind).plan(
        dims=dims, device="cpu", nIterations=nl, lIterations=lin
    )
    jp.init(dict(inputs))
    tp.init(inputs_from_numpy(inputs, device="cpu"))
    costs = []
    for _step in range(nl):
        before = jax.device_get(jp._state)
        jp.step()
        after = jax.device_get(jp._state)
        tp._state = state_from_numpy(before, device="cpu")
        tp.step()
        got = state_to_numpy(tp._state)
        np.testing.assert_allclose(got["prev_cost"], after["prev_cost"], rtol=1e-5)
        assert int(got["lin_iters"]) == int(after["lin_iters"])
        costs.append(float(got["prev_cost"]))
    assert tp.fused_fallback is None
    np.testing.assert_allclose(costs[-1], golden, rtol=GOLDEN_RTOL)


def test_valid_mask_matches():
    """The optional per-edge ``valid`` mask drops edges from cost and JᵀF
    in both packages alike."""
    N, inputs = _mesh("random")
    rng = np.random.RandomState(2)
    g = dict(inputs["G"], valid=(rng.rand(inputs["G"]["v0"].shape[0]) > 0.3).astype(f32))
    masked = dict(inputs, G=g)
    jp, tp = _plans("random")
    out = []
    for plan, FS in ((jp, JFunctionSet), (tp, TFunctionSet)):
        u, c, gg, p = plan._normalize_and_place(masked)
        fs = FS(plan.compiled, c, gg, p)
        fs.masks(u)
        out.append((u, fs, fs.assemble_stencil(u, plan.solver._stencil_plan)))
    (ju, jfs, (_ja, jdiag, jjtf, _jm)), (tu, tfs, (_ta, tdiag, tjtf, _tm)) = out
    np.testing.assert_allclose(float(tfs.cost(tu)), float(jfs.cost(ju)), rtol=1e-6)
    jg, tg = jjtf(jfs.F(ju)), tjtf(tfs.F(tu))
    for k in jg:
        _close(tg[k], jg[k], 1e-6)
        _close(tdiag[k], jdiag[k], 1e-6)


def _arap_with_frozen(pkg):
    """arap_mesh_deformation with an Exclude on the vertices where Frozen
    is set, written against ``pkg``: the graph group's row mask is folded
    into the loop's fields and the remainder's blocks on both sides."""

    def spec(S):
        N = S.Dim("N")
        w_fitSqrt, w_regSqrt = S.Param("w_fitSqrt"), S.Param("w_regSqrt")
        Offset, Angle = S.Unknown("Offset", 3, (N,)), S.Unknown("Angle", 3, (N,))
        UrShape, Constraints = S.Array("UrShape", 3, (N,)), S.Array("Constraints", 3, (N,))
        Frozen = S.Array("Frozen", 1, (N,))
        G = S.Graph("G", v0=(N,), v1=(N,))
        S.Exclude(pkg.Not(pkg.eq(Frozen(0), 0)))
        valid = pkg.greatereq(Constraints(0)[..., 0:1], -999999.9)
        S.Energy(pkg.Select(valid, w_fitSqrt * (Offset(0) - Constraints(0)), 0.0))
        arap = (Offset(G.v0) - Offset(G.v1)) - pkg.Rotate3D(
            Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
        )
        S.Energy(w_regSqrt * arap)

    return spec


def test_excluded_vertices_match():
    """Excluded vertices on a graph: the masked operator, diagonal and JᵀF
    equal the JAX package's, the loop's descriptor (masks folded into the
    S fields and the remainder blocks) applies the same operator as the
    assembled apply, and a solve leaves the excluded vertices where they
    were, as the JAX package's does."""
    N, inputs = _mesh("random")
    rng = np.random.RandomState(4)
    frozen = (rng.rand(N) < 0.2).astype(f32)
    masked = dict(inputs, Frozen=frozen)
    jp = ot.Problem(_arap_with_frozen(ot)).plan(dims={"N": N})
    tp = ott.Problem(_arap_with_frozen(ott)).plan(dims={"N": N}, device="cpu")
    out = []
    for plan, FS in ((jp, JFunctionSet), (tp, TFunctionSet)):
        u, c, g, p = plan._normalize_and_place(dict(masked))
        fs = FS(plan.compiled, c, g, p)
        fs.masks(u)
        out.append((u, fs, fs.assemble_stencil(u, plan.solver._stencil_plan)))
    (ju, jfs, (jA, jdiag, jjtf, _jm)), (tu, tfs, (tA, tdiag, tjtf, meta)) = out
    v = {k: rng.uniform(-1, 1, tuple(x.shape)).astype(f32) for k, x in tu.items()}
    ja = jA({k: jax.numpy.asarray(x) for k, x in v.items()})
    ta = tA({k: torch.as_tensor(x) for k, x in v.items()})
    jg, tg = jjtf(jfs.F(ju)), tjtf(tfs.F(tu))
    for k in v:
        _close(ta[k], ja[k], 1e-6)
        _close(tdiag[k], jdiag[k], 1e-6)
        _close(tg[k], jg[k], 1e-6)
    assert meta is not None and meta["rem"] is not None
    pv = fused_cg.pack({k: torch.as_tensor(x) for k, x in v.items()}, meta)
    got = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"], pv)
    _close(got, fused_cg.pack(ta, meta).numpy(), 1e-5)
    jr = jp.solve(dict(masked), nIterations=2, lIterations=20)
    tr = tp.solve(dict(masked), nIterations=2, lIterations=20)
    np.testing.assert_allclose(tr.final_cost, jr.final_cost, rtol=1e-4)
    keep = frozen != 0
    for k in ("Offset", "Angle"):
        np.testing.assert_array_equal(tr.unknowns[k].numpy()[keep], np.asarray(inputs[k])[keep])
