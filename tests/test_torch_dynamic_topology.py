"""``dynamic_topology=True`` in the port: graphs whose edges change from
solve to solve (tests/test_dynamic_topology.py's single-device cases).

The plan pads every graph to a power-of-two edge bucket with zero-``valid``
edges (round-robin in-bounds ids), rounds the incidence table's width up
to a power of two and skips the DIA split, so that every cross read goes
to the remainder CSR and the graph route takes ``gn_rem_tiled`` (or
``lm_rem_tiled``) on the card; its table cache keeps 32 topologies. The
JAX package's "shares one trace" has no counterpart in a host-driven loop:
here the topologies of one bucket share their padded edge count and their
tables' shapes, and each solve agrees with the exact topology's. Padded
edges add nothing: JᵀJ from the port's ``torch.func.jacfwd`` oracle over
the padded graph equals the exact graph's in float64."""

import gc
import weakref

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott
from opt_tpu_torch.functions import FunctionSet
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg

torch.set_num_threads(2)

f32 = np.float32
SP = dict(nIterations=3, lIterations=15)
SP2 = dict(nIterations=2, lIterations=15)


def _arap_edges(n_side):
    """tests/test_edge_mask.py's grid mesh: row-major, both directions, one
    corner pinned and the other pulled."""
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    v0, v1 = np.concatenate([v0, v1]).astype(np.int32), np.concatenate([v1, v0]).astype(np.int32)
    con = -np.ones((N, 3), f32)
    con[0] = pos[0]
    con[-1] = pos[-1] + [2, 0, 1]
    return N, pos, v0, v1, con


def _inputs(pos, con, g):
    return {"Offset": pos.copy(), "Angle": np.zeros_like(pos), "UrShape": pos,
            "Constraints": con, "G": g, "w_fitSqrt": f32(1.0), "w_regSqrt": f32(np.sqrt(0.5))}


def _subset(v0, v1, seed, frac):
    keep = np.random.RandomState(seed).rand(len(v0)) > frac
    return v0[keep], v1[keep]


def _plan(N, kind="gaussNewtonGPU", **kw):
    return ott.Problem(tspecs.arap_mesh_deformation, kind=kind).plan(dims={"N": N}, device="cpu",
                                                                     **kw)


def _dense_jacobian(plan, inputs):
    """J at the inputs, the residuals flattened term by term, over the
    graphs as the plan binds them (padded under dynamic_topology)."""
    unknowns, consts, graphs, params = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, consts, graphs, params)
    names = sorted(unknowns)
    shapes = [tuple(unknowns[n].shape) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]

    def r_flat(v):
        parts, o = {}, 0
        for n, s, sz in zip(names, shapes, sizes):
            parts[n] = v[o:o + sz].reshape(s)
            o += sz
        return torch.cat([t.reshape(-1) for t in fs.F(parts)])

    x0 = torch.cat([unknowns[n].reshape(-1) for n in names])
    return torch.func.jacfwd(r_flat)(x0).numpy()


def test_operator_matches_exact_topology():
    """Padded edges contribute exactly nothing: in float64 JᵀJ over the
    padded graph equals the exact graph's, and every extra row of J is
    zero; in float32 the dynamic plan's fused operator (all remainder, no
    DIA offset) applies the exact graph's JᵀJ."""
    N, pos, v0, v1, con = _arap_edges(6)
    v0s, v1s = _subset(v0, v1, 0, 0.25)
    inp = _inputs(pos, con, {"v0": v0s, "v1": v1s})
    Jd = _dense_jacobian(_plan(N, double_precision=True, dynamic_topology=True), inp)
    Jr = _dense_jacobian(_plan(N, double_precision=True), inp)
    assert Jd.shape[0] > Jr.shape[0]
    np.testing.assert_allclose(Jd.T @ Jd, Jr.T @ Jr, rtol=1e-6, atol=1e-9)
    assert int((~Jd.any(axis=1)).sum()) >= Jd.shape[0] - Jr.shape[0]

    plan = _plan(N, dynamic_topology=True)
    meta, _r0, _pre, _kw = plan.cg_inputs(dict(inp))
    assert plan.fused_fallback is None and meta["rem"] is not None
    assert {d[1] for (d, _i, _j, _f) in meta["triples"]} == {0}  # no DIA offset
    pt = torch.as_tensor(np.random.RandomState(1).randn(6, 1, N), dtype=torch.float32)
    out = fused_cg._operator_apply(meta["F"], meta["triples"], meta["rem"], pt)

    def flat(x):  # packed [C, 1, N] as the oracle's columns: each unknown [N, 3], by name
        return np.concatenate([x[meta["offs"][u]:meta["offs"][u] + 3, 0].T.numpy().ravel()
                               for u in sorted(meta["offs"])])

    want = (Jr.T @ Jr) @ flat(pt).astype(np.float64)
    np.testing.assert_allclose(flat(out), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_same_bucket_topologies_share_their_tables_shapes(kind):
    """Three topologies of one edge bucket through one dynamic plan: the
    same padded edge count and incidence shape, each solve on the graph
    route's remainder instance with no fallback, and each result equal to
    the exact-topology plan's at rtol 2e-3 (the exact plan runs the DIA
    form, another summation order), each step's cost at 1e-4. Two steps:
    arap's GN solve does not settle (its cost rises and falls), and a third
    step parts the two plans' float32 costs by up to 2.0e-3 here and 5e-4
    in the JAX package, from first steps equal to 1e-7."""
    N, pos, v0, v1, con = _arap_edges(8)
    plan = _plan(N, kind, dynamic_topology=True)
    topos = [(v0, v1), _subset(v0, v1, 0, 0.25), _subset(v0, v1, 1, 0.35)]
    shapes = set()
    name = "lm_rem_tiled" if kind == "LMGPU" else "gn_rem_tiled"
    for va, vb in topos:
        inp = _inputs(pos, con, {"v0": va, "v1": vb})
        res = plan.solve(dict(inp), **SP2)
        assert plan.fused_fallback is None
        g = plan._normalize_and_place(dict(inp))[2]["G"]
        (tabs,) = g["__groups__"].values()
        shapes.add((tuple(g["v0"].shape), tuple(g["valid"].shape), tuple(tabs["inc"].shape)))
        assert tabs["dia"] == [] and tabs["csr"] is not None
        meta, r0, _pre, _kw = plan.cg_inputs(dict(inp))
        assert fused_cg.launch_instance(meta, fused_cg.pack(r0, meta),
                                        lm=kind == "LMGPU") == name
        ref = _plan(N, kind).solve(dict(inp), **SP2)
        np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=2e-3)
        np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-4)
    assert len(shapes) == 1, shapes


def test_user_valid_mask_composes_with_padding():
    """A user's 0/1 mask on a dynamic plan equals the exact kept-subset
    solve on a plain plan (the mask and the padding's zeros merged)."""
    N, pos, v0, v1, con = _arap_edges(8)
    keep = np.random.RandomState(2).rand(len(v0)) > 0.3
    plan = _plan(N, dynamic_topology=True)
    r_dyn = plan.solve(_inputs(pos, con, {"v0": v0, "v1": v1, "valid": keep.astype(f32)}),
                       **SP)
    valid = plan._normalize_and_place(
        _inputs(pos, con, {"v0": v0, "v1": v1, "valid": keep.astype(f32)}))[2]["G"]["valid"]
    assert valid.shape[0] == 256 and torch.equal(valid[:len(v0), 0], torch.as_tensor(
        keep.astype(f32))) and not bool(valid[len(v0):].any())
    r_ref = _plan(N).solve(_inputs(pos, con, {"v0": v0[keep], "v1": v1[keep]}), **SP)
    np.testing.assert_allclose(r_dyn.final_cost, r_ref.final_cost, rtol=2e-3)


def test_composed_path_and_bucket_crossing():
    """use_fused_jtj=False takes the composed Jᵀ(J·p) under the padding; a
    topology in another bucket plans its own tables and stays right."""
    N, pos, v0, v1, con = _arap_edges(8)
    sp = dict(nIterations=2, lIterations=10)
    ip = ott.InitializationParameters(use_fused_jtj=False, dynamic_topology=True)
    plan = _plan(N, init_params=ip)
    plan.solve(_inputs(pos, con, {"v0": v0, "v1": v1}), **sp)
    v0t, v1t = v0[:20], v1[:20]  # 20 edges: the bucket of 32, far below 224's of 256
    inp = _inputs(pos, con, {"v0": v0t, "v1": v1t})
    r_dyn = plan.solve(dict(inp), **sp)
    assert plan._normalize_and_place(dict(inp))[2]["G"]["v0"].shape[0] == 32
    r_ref = _plan(N, init_params=ott.InitializationParameters(use_fused_jtj=False)).solve(
        dict(inp), **sp)
    np.testing.assert_allclose(r_dyn.final_cost, r_ref.final_cost, rtol=2e-3)


def test_table_cache_is_bounded():
    """Per-frame topologies do not grow the host table cache past 32, and a
    topology dropped from it takes its remainder CSR's GraphPartitions
    (with their device tables) along."""
    N, pos, v0, v1, con = _arap_edges(5)
    plan = _plan(N, dynamic_topology=True)
    sp = dict(nIterations=1, lIterations=2)
    first = None
    for seed in range(36):
        va, vb = _subset(v0, v1, seed, 0.2)
        inp = _inputs(pos, con, {"v0": va, "v1": vb})
        plan.solve(dict(inp), **sp)
        if first is None:
            meta, r0, _pre, _kw = plan.cg_inputs(dict(inp))
            assert fused_cg.route_plan(meta, fused_cg.pack(r0, meta), lm=False) is not None
            parts = meta["rem"]["partitions"]
            assert parts.partitions  # built by the route's plan
            first = weakref.ref(parts)
            del meta, r0, parts
    assert len(plan._inc_cache) <= 32
    gc.collect()
    assert first() is None
