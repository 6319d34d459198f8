"""The graph kernel's route and partition (csrc/tiled_graph_cg.cu:
``gn_rem_tiled``, ``lm_rem_tiled``, and ``gn_rem_multi_tiled``,
``lm_rem_multi_tiled`` for a batch of systems in turn) on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin there). Here: which launches ``graph_tile_plan`` takes and how it cuts
the vertices (on the random ring mesh and the dense grid mesh of
tests/test_torch_graph.py, and on the armadillo at its full size); an
emulation in plain PyTorch that follows the kernel block by block (each
vertex range's own r, δ and Ap, p and pre over its frame, only r's border
exchanged through an array that holds NaN everywhere else, p formed over
the halo from it, under LM δ kept on the halo by the owner's arithmetic and
read by a reset iteration's apply) held bitwise to the twin
``fused_grid_cg_reference`` and to the JAX package's Pallas kernel in
interpret mode; and the wrapper's host-side contract. The emulation takes
each dot over the whole graph as the twin does: the kernel's own partition
of a dot (each thread's doubles, a shuffle tree, then the blocks' records
in one fixed order) is held only on the card, by chip_smoke.py's bitwise
checks."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import _build, fused_cg
from opt_tpu_torch.problem import graph_group_tables
from opt_tpu_torch.utils.convert import meta_from_numpy
from opt_tpu_torch.utils.reorder import grid_embed_order, remap_edges
from tests.test_torch_batched_graph import _jax_calls, _jax_vmapped, _port, _stack
from tests.test_torch_cg_variants import _pack, jax_cg_call
from tests.test_torch_graph import _mesh, random_mesh
from chip_smoke import cotangent_inputs, robust_inputs

torch.set_num_threads(2)

SMS, SMEM = fused_cg.SM90_LIMITS  # the H100 SXM's SMs and opt-in shared memory a block
RESET = 3
JAX_RTOL = 1e-5  # δ against the Pallas kernel, whose remainder sums by one-hot matmuls
KINDS = {"GN": "gaussNewtonGPU", "LM": "LMGPU"}


# -- systems --------------------------------------------------------------------------


def _tplan(mesh, kind="GN"):
    N, _inputs = _mesh(mesh)
    return ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N}, device="cpu", residual_reset_period=RESET)


_SYSTEMS = {}


def _system(mesh, kind="GN"):
    """The port's first system on a mesh of tests/test_torch_graph.py, as
    the solver hands it to the kernel: (meta, b, pre, ctc or None)."""
    if (mesh, kind) not in _SYSTEMS:
        _N, inputs = _mesh(mesh)
        meta, r0, pre, kw = _tplan(mesh, kind).cg_inputs(dict(inputs))
        ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
        _SYSTEMS[(mesh, kind)] = (meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), ctc)
    return _SYSTEMS[(mesh, kind)]


def _partition(meta, n_blocks):
    """The kernel's partition of the meta's CSR into ``n_blocks`` ranges
    (graph_tile_plan chooses its own count)."""
    rem = meta["rem"]
    C = int(meta["ctot"]) if "ctot" in meta else int(rem["blk"].shape[-1])
    T = int(meta["F"].shape[-3])
    offs = [int(d[1]) for (d, _i, _j, _f) in meta["triples"]]
    return fused_cg.graph_partition(
        rem["rowptr"].numpy(), rem["col"].numpy(), n_blocks, vertex_bytes=4 * (T + 3 * C),
        entry_bytes=4 * (C * C + 1), dlo=max(0, -min(offs)), dhi=max(0, max(offs)))


def _lm_kw(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


# -- the emulation ---------------------------------------------------------------------


def emulate(F, triples, rem, b, pre, lits, tol, part, *, ctc=None, reset_period=None,
            q_tolerance=None, guard_div=True):
    """The graph kernel's loop in plain PyTorch, block by block, on packed
    [C, 1, N] vectors and F [T, 1, N]: each vertex range keeps r and Ap of
    its vertices, and p, pre (staged once) and δ over its frame (the range
    and its halo, sorted by vertex id); the apply of output (v, i) sums from
    +0 the triples of channel i in their order, a DIA offset read skipped
    where it leaves [0, N), then the CSR row's entries ascending and j
    ascending, p read at each entry's frame place; after the update only r
    at the border vertices goes to a global array (NaN elsewhere, so a read
    off the border shows), from which each range forms p = pre·r + β·p
    over its halo. Under LM each range adds α·p to δ on its halo too (NaN
    there under GN), and a reset iteration applies A to δ's frame. Dots are
    taken over the whole graph as the twin's ``_dot`` takes them, not in
    the kernel's partition (its threads' doubles, a shuffle tree, the
    blocks' records in a fixed order), which only the card's bitwise check
    holds; the scalar steps are the twin's. Returns (δ [C, 1, N],
    iterations)."""
    C, _one, N = (int(s) for s in b.shape)
    F = F.float()[:, 0]
    b2, pre2 = b[:, 0], pre[:, 0]
    lm = ctc is not None
    ctc2 = ctc[:, 0] if lm else None
    rowptr, blk = rem["rowptr"].long(), rem["blk"].float()
    lcol = torch.as_tensor(part["lcol"]).long()
    border = torch.as_tensor(part["border"]).bool()
    by_chan = [[t for t in triples if t[1] == c] for c in range(C)]
    ranges = []
    for v0, v1, own_at, hoff, nh in part["blocks"].tolist():
        halo = torch.as_tensor(part["halo"][hoff:hoff + nh]).long()
        frame = torch.cat([halo[:own_at], torch.arange(v0, v1), halo[own_at:]])
        hplace = torch.cat([torch.arange(own_at), torch.arange(own_at, nh) + (v1 - v0)])
        ranges.append((v0, v1, own_at, frame, halo, hplace))

    def apply(k, src):
        """A range's outputs [C, nv] of A applied to a frame array [C, nf]."""
        v0, v1, own_at, _frame, _halo, _hp = ranges[k]
        nv = v1 - v0
        v = torch.arange(v0, v1)
        out = []
        for c in range(C):
            a = torch.zeros(nv)
            for (_z, d), _i, j, fid in by_chan[c]:
                ok = (v + d >= 0) & (v + d < N)
                place = (own_at + torch.arange(nv) + d).clamp(0, src.shape[1] - 1)
                a = torch.where(ok, a + F[fid, v0:v1] * src[j, place], a)
            out.append(a)
        out = torch.stack(out)
        start, count = rowptr[v0:v1], rowptr[v0 + 1:v1 + 1] - rowptr[v0:v1]
        for m in range(int(count.max()) if nv else 0):
            live = m < count
            e = torch.where(live, start + m, 0)
            B = blk[e]  # [nv, C, C]
            pu = src[:, lcol[e]]  # [C, nv]
            for j in range(C):
                out = torch.where(live, out + B[:, :, j].T * pu[j], out)
        return out

    def whole(parts):
        return torch.cat(parts, dim=1)

    own = lambda k, x: x[:, ranges[k][2]:ranges[k][2] + ranges[k][1] - ranges[k][0]]  # noqa: E731
    pre_f = [pre2[:, fr] for (_v0, _v1, _o, fr, _h, _hp) in ranges]
    r = [b2[:, v0:v1].clone() for (v0, v1, *_rest) in ranges]
    p = [pf * b2[:, fr] for pf, (_v0, _v1, _o, fr, _h, _hp) in zip(pre_f, ranges)]
    d = []
    for k, (v0, v1, own_at, fr, halo, hp) in enumerate(ranges):
        dk = torch.zeros(C, fr.shape[0])
        if not lm:
            dk[:, hp] = float("nan")  # the GN kernel keeps no δ on the halo
        d.append(dk)
    rz = fused_cg._dot(b2, whole([own(k, pk) for k, pk in enumerate(p)]))
    floor = tol * rz
    Q0 = torch.zeros_like(rz)
    l = 0
    while l < lits:
        Ap = []
        for k in range(len(ranges)):
            a = apply(k, p[k])
            if lm:
                v0, v1 = ranges[k][:2]
                a = a + ctc2[:, v0:v1] * own(k, p[k])
            Ap.append(a)
        den = fused_cg._dot(whole([own(k, pk) for k, pk in enumerate(p)]), whole(Ap))
        alpha = fused_cg.safe_div(rz, den, guard_div)
        reset = lm and (l + 1) % reset_period == 0
        for k, (v0, v1, own_at, _fr, _halo, hp) in enumerate(ranges):
            sl = slice(own_at, own_at + v1 - v0)
            d[k][:, sl] = d[k][:, sl] + alpha * p[k][:, sl]
            if lm:
                d[k][:, hp] = d[k][:, hp] + alpha * p[k][:, hp]
        if reset:
            r = []
            for k, (v0, v1, *_rest) in enumerate(ranges):
                r.append(b2[:, v0:v1] - (apply(k, d[k]) + ctc2[:, v0:v1] * own(k, d[k])))
        else:
            r = [rk - alpha * ak for rk, ak in zip(r, Ap)]
        z = [own(k, pre_f[k]) * rk for k, rk in enumerate(r)]
        rz_new = fused_cg._dot(whole(z), whole(r))
        if lm:
            q = fused_cg._dot(whole([own(k, dk) for k, dk in enumerate(d)]), b2 + whole(r))
        beta = fused_cg.safe_div(rz_new, rz, guard_div)
        ring = torch.full((C, N), float("nan"))
        for k, (v0, v1, *_rest) in enumerate(ranges):
            mine = border[v0:v1]
            ring[:, v0:v1][:, mine] = r[k][:, mine]
        for k, (v0, v1, own_at, _fr, halo, hp) in enumerate(ranges):
            new = p[k].clone()
            sl = slice(own_at, own_at + v1 - v0)
            new[:, sl] = z[k] + beta * p[k][:, sl]
            new[:, hp] = pre_f[k][:, hp] * ring[:, halo] + beta * p[k][:, hp]
            p[k] = new
        rz = rz_new
        l += 1
        if lm:
            Q1 = 0.5 * q
            zeta = (l * (Q1 - Q0)) / Q1
            stop = (zeta < q_tolerance) | (rz_new <= floor)
            Q0 = Q1
        else:
            stop = (rz_new <= floor) | (den <= 0)
        if bool(stop):
            break
    return whole([own(k, dk) for k, dk in enumerate(d)])[:, None, :], l


def emulate_batch(meta, b, pre, lits, tol, part, *, ctc=None, **kw):
    """A batched meta's systems in turn, each emulated on its own fields and
    blocks over the one partition, as the multi-system kernel solves them:
    (δ [B, C, 1, N], counts)."""
    rem = meta["rem"]
    out, counts = [], []
    for k in range(int(meta["batch"])):
        dk, lk = emulate(meta["F"][k], meta["triples"], dict(rem, blk=rem["blk"][k]), b[k],
                         pre[k], lits, tol, part, ctc=None if ctc is None else ctc[k], **kw)
        out.append(dk)
        counts.append(lk)
    return torch.stack(out), counts


# -- the partition ---------------------------------------------------------------------


def _check_partition(part, rowptr, col, N, dlo=0, dhi=0):
    """The invariants: the ranges cover [0, N) once, in order; each halo is
    exactly the off-range reads (the entries' columns and the DIA window);
    each local column maps back to its column; the border flags are the
    union of the halos."""
    rowptr, col = np.asarray(rowptr, np.int64), np.asarray(col, np.int64)
    blocks = part["blocks"]
    assert blocks[0, 0] == 0 and blocks[-1, 1] == N
    assert (blocks[1:, 0] == blocks[:-1, 1]).all() and (blocks[:, 1] > blocks[:, 0]).all()
    union = np.zeros(N, bool)
    for v0, v1, own_at, hoff, nh in blocks.tolist():
        halo = part["halo"][hoff:hoff + nh]
        c = col[rowptr[v0]:rowptr[v1]]
        reads = np.concatenate([c, np.arange(max(0, v0 - dlo), min(N, v1 + dhi))])
        assert np.array_equal(halo, np.unique(reads[(reads < v0) | (reads >= v1)]))
        assert own_at == int((halo < v0).sum())
        frame = np.concatenate([halo[:own_at], np.arange(v0, v1), halo[own_at:]])
        assert (np.diff(frame) > 0).all()
        assert np.array_equal(frame[part["lcol"][rowptr[v0]:rowptr[v1]]], c)
        union[halo] = True
    assert np.array_equal(part["border"].astype(bool), union)
    assert part["max_range"] == int((blocks[:, 1] - blocks[:, 0]).max())
    assert part["max_halo"] == int(blocks[:, 4].max())
    assert part["max_frame"] == int((blocks[:, 1] - blocks[:, 0] + blocks[:, 4]).max())
    assert part["max_entries"] == int((rowptr[blocks[:, 1]] - rowptr[blocks[:, 0]]).max())


@pytest.mark.parametrize("mesh,n_blocks", [("random", 1), ("random", 5), ("random", 17),
                                           ("dense_grid", 3), ("dense_grid", 8)])
def test_partition_invariants(mesh, n_blocks):
    meta, *_ = _system(mesh)
    rem = meta["rem"]
    N = int(rem["rowptr"].shape[0]) - 1
    offs = [int(d[1]) for (d, _i, _j, _f) in meta["triples"]]
    dlo, dhi = max(0, -min(offs)), max(0, max(offs))
    assert (dlo > 0) == (mesh == "dense_grid")  # the grid mesh keeps DIA offsets
    part = _partition(meta, n_blocks)
    assert part["blocks"].shape[0] == n_blocks
    _check_partition(part, rem["rowptr"].numpy(), rem["col"].numpy(), N, dlo, dhi)


def test_partition_balances_the_bytes():
    """Ranges of about equal bytes (a vertex's fields and state, its
    entries' blocks): within one vertex's and one row's weight of the mean."""
    meta, *_ = _system("random")
    rem = meta["rem"]
    rowptr = rem["rowptr"].numpy().astype(np.int64)
    part = _partition(meta, 6)
    T, C = int(meta["F"].shape[0]), 6
    w = 4 * (T + 3 * C) + 4 * (C * C + 1) * np.diff(rowptr)
    per = [int(w[v0:v1].sum()) for v0, v1, *_r in part["blocks"].tolist()]
    assert max(per) - min(per) <= 2 * int(w.max())


def test_plan_at_the_armadillos_full_size():
    """The armadillo (benchdata/armadillo31k.npz, renumbered as the bench
    renumbers it) through the port's host tables only: the GN and LM plans
    of its six channels and 37 fields fit 232,448 B at 132 ranges, every
    vertex in one range, every read vertex in its block's frame."""
    d = np.load("benchdata/armadillo31k.npz")
    v0, v1 = d["v0"].astype(np.int32), d["v1"].astype(np.int32)
    N = int(d["verts"].shape[0])
    v0r, v1r = remap_edges(grid_embed_order(v0, v1, N), v0, v1)
    tabs = graph_group_tables({"v0": v0r.astype(np.int64), "v1": v1r.astype(np.int64)},
                              ["v0", "v1"], N, "cpu", torch.float32, 32)
    assert not tabs["dia"]
    csr = tabs["csr"]
    nnz = int(csr["col"].shape[0])
    meta = {"F": torch.empty((37, 1, N)), "chan_grid": False,
            "triples": tuple(((0, 0), i, i, i) for i in range(6)) + tuple(
                ((0, 0), i, j, 6 + k) for k, (i, j) in enumerate(
                    [(i, j) for i in range(6) for j in range(6) if i != j][:31])),
            "rem": {"rowptr": csr["rowptr"], "col": csr["col"],
                    "blk": torch.empty((nnz, 6, 6)), "partitions": csr["partitions"]}}
    for lm in (False, True):
        plan = fused_cg.graph_tile_plan(meta, 6, N, lm=lm, sm_count=SMS, smem_per_block=SMEM)
        assert plan is not None and plan["blocks"] == SMS and plan["threads"] == 512
        assert plan["smem_bytes"] <= SMEM
        part = plan["partition"]
        _check_partition(part, csr["rowptr"].numpy(), csr["col"].numpy(), N)
        assert plan["smem_bytes"] == fused_cg.tiled_graph_smem_bytes(
            lm, 6, 37, part["max_range"], part["max_frame"], part["max_halo"],
            part["max_entries"], len(meta["triples"]))
    # GN and LM share the partition; it was built once
    assert len(csr["partitions"].partitions) == 1


# -- plan and route --------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["random", "dense_grid"])
@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_plan_takes_gn_and_lm_remainder_metas(mesh, kind):
    meta, b, _pre, ctc = _system(mesh, kind)
    lm = ctc is not None
    plan = fused_cg.route_plan(meta, b, lm=lm)
    assert plan is not None and plan == fused_cg.graph_tile_plan(
        meta, 6, b.shape[-1], lm=lm, sm_count=SMS, smem_per_block=SMEM)
    N = b.shape[-1]
    assert 1 <= plan["blocks"] <= SMS and plan["blocks"] >= -(-6 * N // 512)
    assert plan["smem_bytes"] <= SMEM
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm_rem_tiled" if lm else "gn_rem_tiled")


def _odd_channels(meta, b):
    """The random mesh's system cut to its first five channels: a graph
    system with an odd channel count."""
    triples = tuple(t for t in meta["triples"] if t[1] < 5 and t[2] < 5)
    rem = dict(meta["rem"], blk=meta["rem"]["blk"][:, :5, :5].contiguous())
    return dict(meta, triples=triples, rem=rem), b[:5].contiguous()


@pytest.mark.parametrize("case", ["cs", "bf16", "block_jacobi", "batch", "dia_only",
                                  "overflow", "merged", "no_partitions", "odd_channels"])
def test_plan_refuses_other_forms(case, monkeypatch):
    """The forms the graph kernel does not take keep the template: CS,
    bfloat16, block-Jacobi, the block-per-system batch form, a DIA-only
    meta without its empty CSR, a frame beyond the shared memory, and a
    remainder without its topology's partitions (several groups' CSR merged
    anew every step). An odd number of channels is not among them: it
    takes the resident plan."""
    meta, b, _pre, _ctc = _system("random")
    N = int(b.shape[-1])
    kw = dict(lm=False, sm_count=SMS, smem_per_block=SMEM)
    C, name = 6, "gn_rem"
    if case == "cs":
        kw["cs"] = True
        name = "gn_cs_rem"
    elif case == "bf16":
        meta = dict(meta, F=meta["F"].to(torch.bfloat16),
                    rem=dict(meta["rem"], blk=meta["rem"]["blk"].to(torch.bfloat16)))
        name = "gn_bf16_rem"
    elif case == "block_jacobi":
        kw["block"] = True
        name = "gn_bj_rem"
    elif case == "batch":
        meta = dict(meta, batch=2, F=meta["F"][None].expand(2, -1, -1, -1).contiguous(),
                    rem=dict(meta["rem"], blk=meta["rem"]["blk"][None].expand(
                        2, -1, -1, -1).contiguous()))
        b = b[None].expand(2, -1, -1, -1).contiguous()
        assert fused_cg.batched_kernel_form(meta) == "multi"
        assert fused_cg.graph_tile_plan(meta, 6, N, **kw) is not None
        monkeypatch.setattr(fused_cg, "BATCH_BLOCK_ELEMS", 10**9)
        name = "gn_rem_batch"
    elif case == "dia_only":
        # without its empty CSR (a meta carried across from the JAX package;
        # the port's own takes the stream layout, tests/test_torch_tiled_dia.py)
        meta, b, _pre, _ctc = _system("grid")
        assert meta["rem"] is None and meta["empty_csr"] is not None
        meta = {k: v for k, v in meta.items() if k != "empty_csr"}
        N = int(b.shape[-1])
        name = "gn"
    elif case == "overflow":
        plan = fused_cg.graph_tile_plan(meta, 6, N, **kw)
        # below the records' and the triples' bytes: no partition fits
        kw["smem_per_block"] = 16 * 17 + 4 * 3 * len(meta["triples"])
        assert plan["smem_bytes"] > kw["smem_per_block"]
        monkeypatch.setattr(fused_cg, "SM90_LIMITS", (SMS, kw["smem_per_block"]))
    elif case == "merged":
        meta = dict(meta, rem={k: v for k, v in meta["rem"].items() if k != "partitions"})
    elif case == "odd_channels":
        meta, b = _odd_channels(meta, b)
        plan = fused_cg.graph_tile_plan(meta, 5, N, **kw)
        assert plan is not None and plan["layout"] == "resident"
        assert fused_cg.route_plan(meta, b, lm=False) == plan
        assert fused_cg.launch_instance(meta, b) == "gn_rem_tiled"
        return
    else:  # a meta carried across from the JAX package
        meta = dict(meta, rem=dict(meta["rem"], partitions={}))
    assert fused_cg.graph_tile_plan(meta, C, N, **kw) is None
    if case in ("cs", "block_jacobi"):
        return  # the route's own keywords, below
    assert fused_cg.route_plan(meta, b, lm=False) is None
    assert fused_cg.launch_instance(meta, b) == name


def test_route_names_the_other_remainder_forms():
    meta, b, _pre, ctc = _system("random", "LM")
    pb = torch.zeros((36,) + tuple(b.shape[1:]))
    assert fused_cg.route_plan(meta, b, lm=True, cs=True) is None
    assert fused_cg.launch_instance(meta, b, lm=True, cs=True) == "lm_cs_rem"
    assert fused_cg.route_plan(meta, b, lm=True, pre_blocks=pb) is None
    assert fused_cg.launch_instance(meta, b, lm=True, pre_blocks=pb) == "lm_bj_rem"


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_route_takes_the_multi_form_of_a_batch(kind):
    """A batch of the random mesh (tests/test_torch_batched_graph.py's, two
    instances) takes the graph kernel's multi form through the solver's
    batched meta, with its systems' own blocks over the shared CSR."""
    from tests.test_torch_batched_graph import INPUTS, N_MESH

    plan = ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N_MESH}, device="cpu")
    meta, r0, _pre, _kw = plan.batched_cg_inputs(dict(INPUTS))
    b = fused_cg.pack(r0, meta)
    assert meta["batch"] == 2 and fused_cg.batched_kernel_form(meta) == "multi"
    assert isinstance(meta["rem"]["partitions"], fused_cg.GraphPartitions)
    lm = kind == "LM"
    assert fused_cg.route_plan(meta, b, lm=lm) is not None
    assert fused_cg.launch_instance(meta, b, lm=lm) == (
        "lm_rem_multi_tiled" if lm else "gn_rem_multi_tiled")


def test_the_second_gn_step_reuses_the_partition(monkeypatch):
    """The partition is built once per topology: a later step's meta (new
    unknowns, the same graph) finds the plan and partition the first built,
    and builds nothing."""
    N, inputs = _mesh("random")
    tp = _tplan("random")
    meta1, r1, _p1, _k1 = tp.cg_inputs(dict(inputs))
    plan1 = fused_cg.route_plan(meta1, fused_cg.pack(r1, meta1), lm=False)
    built = []
    real = fused_cg.graph_partition
    monkeypatch.setattr(fused_cg, "graph_partition",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    moved = dict(inputs, Angle=inputs["Angle"] + np.float32(0.1))
    meta2, r2, _p2, _k2 = tp.cg_inputs(moved)
    assert not torch.equal(meta2["rem"]["blk"], meta1["rem"]["blk"])
    assert meta2["rem"]["partitions"] is meta1["rem"]["partitions"]
    plan2 = fused_cg.route_plan(meta2, fused_cg.pack(r2, meta2), lm=False)
    assert plan2 == plan1 and plan2["partition"] is plan1["partition"] and not built


def test_instance_names_and_launch_counts():
    names = [fused_cg.instance_name(*f) for f in fused_cg.TILED_INSTANCES[6:10]]
    assert names == ["gn_rem_tiled", "lm_rem_tiled", "gn_rem_multi_tiled", "lm_rem_multi_tiled"]
    fused_cg.fused_grid_cg_kernel.launches["gn_rem_tiled"] = 3
    fused_cg.reset_launch_counts()
    assert all(fused_cg.fused_grid_cg_kernel.launches[n] == 0 for n in names)


def test_build_compiles_the_graph_unit_and_reads_its_registers():
    assert "tiled_graph_cg.cu" in _build.UNITS and "tiled_cg.cuh" in _build.SOURCES
    assert (_build.CSRC / "tiled_graph_cg.cu").exists()
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z21tiled_graph_cg_kernelILb0ELb0EEvPKfS1_' "
        "for 'sm_90a'",
        "ptxas info    : Used 72 registers, used 1 barriers, 480 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z21tiled_graph_cg_kernelILb1ELb0EEvPKfS1_' "
        "for 'sm_90a'",
        "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 480 bytes cmem[0]",
    ])
    regs = _build.instance_registers(log)
    want = {(False, True, False, False, False, m, False, True): (72, 0, 0) for m in (0, 1)}
    want.update({(True, True, False, False, False, m, False, True): (80, 8, 8) for m in (0, 1)})
    assert regs == {tuple(bool(x) for x in k): v for k, v in want.items()}
    assert set(regs) == set(fused_cg.TILED_INSTANCES[6:10])


# -- the emulation against the twin, bitwise ------------------------------------------


def _twin(meta, b, pre, lits, tol, ctc=None, q_tol=None):
    return fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                            rem=meta["rem"], **_lm_kw(ctc, q_tol))


# (mesh, kind, ranges, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM),
# and the real exits; one range and several
_EMULATION_CASES = [
    ("random", "GN", 5, 30, 0.0, None),
    ("random", "GN", 5, 400, 1e-8, None),
    ("random", "GN", 1, 30, 0.0, None),
    ("random", "LM", 5, 30, 0.0, -np.inf),
    ("random", "LM", 5, 400, 1e-8, 1e-4),
    ("random", "LM", 17, 30, 0.0, -np.inf),
    ("dense_grid", "GN", 4, 30, 0.0, None),
    ("dense_grid", "GN", 4, 400, 1e-8, None),
    ("dense_grid", "LM", 4, 30, 0.0, -np.inf),
]


@pytest.mark.parametrize("mesh,kind,n_blocks,lits,tol,q_tol", _EMULATION_CASES)
def test_emulation_is_bitwise_the_twin(mesh, kind, n_blocks, lits, tol, q_tol):
    meta, b, pre, ctc = _system(mesh, kind)
    part = _partition(meta, n_blocks)
    de, le = emulate(meta["F"], meta["triples"], meta["rem"], b, pre, lits, tol, part,
                     **_lm_kw(ctc, q_tol))
    dt, lt = _twin(meta, b, pre, lits, tol, ctc, q_tol)
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())
    if ctc is not None and tol == 0.0:
        assert le > 3 * RESET  # resets occurred


def _cotangent_quads(n_side=10):
    """cotangent_mesh_smoothing on the edges of a grid's quads, each edge's
    opposite vertices the quad's other two: every read at a vertex-id
    offset (±1, ±n-1, ±n, ±n+1), no remainder."""
    vid = np.arange(n_side * n_side).reshape(n_side, n_side)
    a, b, c, d = vid[:-1, :-1], vid[:-1, 1:], vid[1:, :-1], vid[1:, 1:]
    v0, v1 = np.concatenate([a, a]).ravel(), np.concatenate([b, c]).ravel()
    v2, v3 = np.concatenate([c, b]).ravel(), np.concatenate([d, d]).ravel()
    dims, inputs = cotangent_inputs(n_side)
    g = {k: v.astype(np.int32) for k, v in dict(v0=v0, v1=v1, v2=v2, v3=v3).items()}
    return dims, dict(inputs, G=g)


def _robust_random(N=60):
    """robust_nonrigid_alignment on tests/test_torch_graph.py's random ring
    mesh: every read in the remainder, 7 channels of which the graph group
    covers 6."""
    _N, arap = random_mesh(N)
    rng = np.random.RandomState(5)
    normals = rng.randn(N, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return {"N": N}, dict(arap, RobustWeights=np.ones((N,), np.float32),
                          ConstraintNormals=normals, w_fitSqrt=np.float32(np.sqrt(10.0)))


# name -> (spec, inputs, channels, layout): odd channel counts in both layouts
_ODD_SYSTEMS = {
    "cotangent_grid": (tspecs.cotangent_mesh_smoothing, lambda: cotangent_inputs(12), 3,
                       "resident"),
    "cotangent_quads": (tspecs.cotangent_mesh_smoothing, _cotangent_quads, 3, "stream"),
    "robust_random": (tspecs.robust_nonrigid_alignment, _robust_random, 7, "resident"),
    "robust_grid": (tspecs.robust_nonrigid_alignment, lambda: robust_inputs(12), 7, "stream"),
}


def _odd_system(name, kind):
    """The port's first system of an _ODD_SYSTEMS case: (meta, b, pre, ctc
    or None, the CSR the emulation reads)."""
    if (name, kind) not in _SYSTEMS:
        spec, make, _C, _layout = _ODD_SYSTEMS[name]
        dims, inputs = make()
        plan = ott.Problem(spec, kind=KINDS[kind]).plan(dims=dims, device="cpu",
                                                       residual_reset_period=RESET)
        meta, r0, pre, kw = plan.cg_inputs(dict(inputs))
        ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
        b = fused_cg.pack(r0, meta)
        C = int(b.shape[0])
        csr = meta["rem"] if meta["rem"] is not None else dict(
            meta["empty_csr"], blk=torch.empty((0, C, C)))
        _SYSTEMS[(name, kind)] = (meta, b, fused_cg.pack(pre, meta), ctc, csr)
    return _SYSTEMS[(name, kind)]


# (system, kind, ranges, lits, tol, q_tol): no exit and the real exits
_ODD_CASES = [
    (name, kind, n_blocks, lits, tol, q_tol)
    for name in sorted(_ODD_SYSTEMS)
    for kind, q_none, q_exit in (("GN", None, None), ("LM", -np.inf, 1e-4))
    for n_blocks, lits, tol, q_tol in ((5, 30, 0.0, q_none), (3, 400, 1e-8, q_exit))
]


@pytest.mark.parametrize("name,kind,n_blocks,lits,tol,q_tol", _ODD_CASES)
def test_odd_channel_emulation_is_bitwise_the_twin(name, kind, n_blocks, lits, tol, q_tol):
    """Odd channel counts, C = 3 (cotangent) and C = 7 (robust_nonrigid,
    whose graph group leaves RobustWeights out), in both layouts the route
    gives them: the emulation on several ranges bitwise the twin, equal
    counts."""
    meta, b, pre, ctc, csr = _odd_system(name, kind)
    _spec, _make, C, layout = _ODD_SYSTEMS[name]
    assert int(b.shape[0]) == C and C % 2 == 1
    plan = fused_cg.route_plan(meta, b, lm=ctc is not None)
    assert plan["layout"] == layout and (meta["rem"] is None) == (layout == "stream")
    part = _partition(dict(meta, rem=csr), n_blocks)
    assert part["blocks"].shape[0] == n_blocks
    de, le = emulate(meta["F"], meta["triples"], csr, b, pre, lits, tol, part,
                     **_lm_kw(ctc, q_tol))
    dt, lt = _twin(meta, b, pre, lits, tol, ctc, q_tol)
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_batch_emulation_is_bitwise_its_systems_and_the_batched_twin(kind):
    """A batch of the random mesh in the multi form: each system of the
    emulated launch bitwise its own one-system emulation and the batched
    twin's, count for count."""
    from tests.test_torch_batched_graph import INPUTS, N_MESH

    lm = kind == "LM"
    plan = ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N_MESH}, device="cpu", residual_reset_period=RESET)
    meta, r0, pre, kw = plan.batched_cg_inputs(dict(INPUTS))
    b, prem = fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)
    ctc = fused_cg.pack(kw["ctc"], meta) if lm else None
    q_tol = -np.inf if lm else None
    part = _partition(meta, 3)
    de, counts = emulate_batch(meta, b, prem, 30, 0.0, part, **_lm_kw(ctc, q_tol))
    twin_counts = []
    dt, _l = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, prem, 30, 0.0, rem=meta["rem"], n_sys=2, batched=True,
        counts=twin_counts, **_lm_kw(ctc, q_tol))
    assert counts == twin_counts == [30, 30]
    assert torch.equal(de, dt)
    rem = meta["rem"]
    for k in range(2):
        d1, l1 = emulate(meta["F"][k], meta["triples"], dict(rem, blk=rem["blk"][k]), b[k],
                         prem[k], 30, 0.0, part, **_lm_kw(None if ctc is None else ctc[k], q_tol))
        assert l1 == counts[k] and torch.equal(d1, de[k])
    assert not torch.equal(de[0], de[1])


# -- the emulation against the Pallas kernel in interpret mode -------------------------


@pytest.mark.parametrize("kind,lits,tol,q_tol", [("GN", 20, 0.0, None), ("GN", 200, 1e-8, None),
                                                 ("LM", 20, 0.0, -np.inf)])
def test_emulation_matches_pallas_interpret(kind, lits, tol, q_tol):
    """The random mesh's first system as the JAX package hands its fused
    kernel (one-hot remainder tiles, carried across to the port's CSR),
    through the Pallas kernel in interpret mode and through the emulation
    on 5 ranges: equal counts, and after 20 iterations with no exit δ within
    JAX_RTOL · max|δ|. At the real exit only the counts are held, as
    tests/test_torch_graph.py::test_jax_graph_meta_runs_in_the_twin holds
    the twin: the two sum the remainder and the dots in another order, and
    CG carries that to 1.4e-4 of max|δ| by the exit at its 82nd
    iteration."""
    _N, inputs = _mesh("random")
    jmeta, r0, jpre, kw = jax_cg_call("arap_mesh_deformation", {"N": _N}, inputs, KINDS[kind])
    meta = meta_from_numpy(jmeta, device="cpu")
    lm = {} if "ctc" not in kw else dict(ctc=kw["ctc"], reset_period=kw["reset_period"],
                                         q_tolerance=q_tol)
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, **lm)
    jd = _pack(jax.device_get(jd), meta)
    b, pre = _pack(r0, meta), _pack(jpre, meta)
    tkw = {} if not lm else dict(ctc=_pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                                 q_tolerance=q_tol)
    de, le = emulate(meta["F"], meta["triples"], meta["rem"], b, pre, lits, tol,
                     _partition(dict(meta, ctot=6), 5), **tkw)
    assert le == int(ji)
    if tol != 0.0:
        assert le < lits
        return
    assert le == lits
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0,
                               atol=JAX_RTOL * float(jd.abs().max()))


def test_batch_emulation_matches_pallas_under_vmap():
    """The random mesh's batch of two (tests/test_torch_batched_graph.py)
    through the Pallas kernel under jax.vmap in interpret mode and through
    the emulated multi-system launch: equal counts, δ within JAX_RTOL ·
    max|δ|."""
    batch = _stack(_jax_calls("gn", "jacobi"))
    meta, r0, pre, _kw = _port(batch)
    jd, jcounts = _jax_vmapped(batch, 20, 0.0, None)
    b, prem = fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)
    de, counts = emulate_batch(meta, b, prem, 20, 0.0, _partition(dict(meta, ctot=6), 3))
    assert counts == jcounts == [20, 20]
    want = fused_cg.pack({u: torch.as_tensor(v) for u, v in jd.items()}, meta)
    np.testing.assert_allclose(de.numpy(), want.numpy(), rtol=0,
                               atol=JAX_RTOL * float(want.abs().max()))


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_kernel_wrapper_refuses_cpu_tensors_on_the_graph_route(kind):
    """Every launch the graph route takes (one system, a batch in the multi
    form) reaches the graph wrapper, whose device check raises for CPU
    tensors: nothing gives way to the template or to the twin."""
    meta, b, pre, ctc = _system("random", kind)
    lm = _lm_kw(ctc, 1e-4)
    with pytest.raises(ValueError, match="tiled_graph_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **lm)
    B = 2
    rep = lambda t: t[None].expand(B, *t.shape).contiguous()  # noqa: E731
    batched = dict(meta, F=rep(meta["F"]), batch=B, rem=dict(meta["rem"], blk=rep(
        meta["rem"]["blk"])))
    lmb = {k: rep(v) if k == "ctc" else v for k, v in lm.items()}
    assert fused_cg.launch_instance(batched, rep(b), lm=bool(lm)).endswith("_rem_multi_tiled")
    with pytest.raises(ValueError, match="tiled_graph_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(batched, rep(b), rep(pre), 10, 0.0, **lmb)


def test_graph_wrapper_checks_operands_first():
    meta, b, pre, _ctc = _system("random")
    plan = fused_cg.route_plan(meta, b, lm=False)
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_graph_cg_kernel(meta, b, pre[:, :, :-1], 10, 0.0, plan)
    bad = dict(meta, rem=dict(meta["rem"], blk=meta["rem"]["blk"][:-1]))
    with pytest.raises(ValueError, match="blk has shape"):
        fused_cg.tiled_graph_cg_kernel(bad, b, pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="reset_period"):
        fused_cg.tiled_graph_cg_kernel(meta, b, pre, 10, 0.0, plan, ctc=pre)
    with pytest.raises(ValueError, match="float32 fields"):
        fused_cg.tiled_graph_cg_kernel(dict(meta, F=meta["F"].to(torch.bfloat16)), b, pre, 10,
                                       0.0, plan)
    with pytest.raises(ValueError, match="graph remainder"):
        fused_cg.tiled_graph_cg_kernel(dict(meta, rem=None), b, pre, 10, 0.0, plan)
    # an odd channel count passes the operand checks (the device check
    # raises last, on the CPU)
    odd, b5 = _odd_channels(meta, b)
    oplan = fused_cg.route_plan(odd, b5, lm=False)
    with pytest.raises(ValueError, match="tiled_graph_cg_kernel needs CUDA"):
        fused_cg.tiled_graph_cg_kernel(odd, b5, pre[:5].contiguous(), 10, 0.0, oplan)
