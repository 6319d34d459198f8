"""K1 (h)'s batch of small systems on the batch kernel
(ops/csrc/tiled_batch_cg.cu: gn_batch_tiled, lm_batch_tiled), as its
teams run it: a model of the team loop in plain PyTorch (:func:`emulate`),
held bitwise to the plain twin (``fused_cg._systems_reference``, the twin
of a batched meta) and to the JAX package's Pallas kernel under
``jax.vmap`` in interpret mode; and the planner's choices
(``fused_cg.batch_team_plan``, reached from ``route_plan``), which take the
batched metas in the "batch" form under the standard loop, the Jacobi
preconditioner and float32 fields, without the remainder, and leave the
rest to the template's ``_batch`` instances.

The model runs ``fused_cg._run_cg``, the loop of the twin and the kernel,
with the kernel's dot: a team of ``lanes`` lanes a system, lane l summing
in float64 the float32 products of its elements l, l + lanes, ... in
order, then the lanes' partials summed by the butterfly of
``__shfl_xor_sync`` over distances 1, 2, 4, ... (each lane adds its
partner's partial to its own). The stencil and the vector updates are
elementwise, in the twin's order, so only the dots' order differs from
the twin's ``torch.sum``. The CUDA kernel itself runs only on the card
(``chip_smoke.py::batch_checks``)."""

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.test_torch_batched import LAP_B, _jax_vmapped, _lap, _wide_margin_tol

torch.set_num_threads(2)
f32 = np.float32


def team_dot(lanes):
    """The kernel's ⟨x, y⟩ for a system run by ``lanes`` lanes."""
    idx = torch.arange(lanes)

    def dot(x, y):
        prod = (x * y).reshape(-1).double()  # the float32 products, widened
        n = int(prod.numel())
        part = torch.zeros(lanes, dtype=torch.float64)
        for r in range(-(-n // lanes)):  # lane l's elements in order
            row = prod[r * lanes:(r + 1) * lanes]
            part[:row.numel()] = part[:row.numel()] + row
        o = 1
        while o < lanes:  # the butterfly: every lane ends with the same sum
            part = part + part[idx ^ o]
            o <<= 1
        return part[0].to(x.dtype)

    return dot


def stencil_pairs(F, triples, C, dom):
    """The kernel's (field value, source place) pairs of one system:
    element e = c·plane + q's pairs start at s_start[c]·plane + q·count_c
    and follow its channel's triples in table order; a read off the domain
    points at the zero place n. Returns (values, places, first, count), the
    last two an element each."""
    dom3 = (1,) * (3 - len(dom)) + tuple(int(d) for d in dom)
    N0, N1, N2 = dom3
    plane = N0 * N1 * N2
    n = C * plane
    rows = sorted(triples, key=lambda t: t[1])
    starts = [sum(1 for t in rows if t[1] < c) for c in range(C + 1)]
    vals = torch.full((plane * len(rows),), float("nan"))
    places = torch.full((plane * len(rows),), -1, dtype=torch.int64)
    Ff = F.float().reshape(-1, plane)
    first, count = [], []
    for e in range(n):
        c, q = divmod(e, plane)
        x, yz = divmod(q, N1 * N2)
        y, z = divmod(yz, N2)
        k0, cnt = starts[c], starts[c + 1] - starts[c]
        f0 = k0 * plane + q * cnt
        for t, (d, _i, j, fid) in enumerate(rows[k0:k0 + cnt]):
            d3 = (0,) * (3 - len(d)) + tuple(d)
            xx, yy, zz = x + d3[0], y + d3[1], z + d3[2]
            inside = 0 <= xx < N0 and 0 <= yy < N1 and 0 <= zz < N2
            vals[f0 + t] = Ff[fid, q]
            places[f0 + t] = j * plane + (xx * N1 + yy) * N2 + zz if inside else n
        first.append(f0)
        count.append(cnt)
    return vals, places, first, count


def pairs_apply(pairs, p):
    """The kernel's apply of one system by its pairs, from 0 in each
    element's order, reading the zero place past the vector."""
    vals, places, first, count = pairs
    flat = torch.cat([p.reshape(-1), p.new_zeros(1)])
    out = torch.zeros(p.numel())
    for e, (f0, cnt) in enumerate(zip(first, count)):
        a = torch.zeros(())
        for t in range(f0, f0 + cnt):
            a = a + vals[t] * flat[places[t]]
        out[e] = a
    return out.reshape(p.shape)


def emulate(meta, b, pre, lits, tol, ctc=None, reset_period=None, q_tolerance=None,
            pairs=False):
    """The batch kernel's result on packed [B, C, *dom] tensors, each
    system by its team as :func:`fused_cg.batch_team_plan` lays it out at
    the H100's limits: (delta [B, C, *dom], per-system counts). With
    ``pairs`` the apply walks the kernel's stencil pairs
    (:func:`stencil_pairs`) element by element; else it is the twin's
    ``_stencil_apply``, elementwise in the same order."""
    lm = ctc is not None
    C, dom = int(b.shape[1]), tuple(b.shape[2:])
    plan = fused_cg.batch_team_plan(meta, C, dom, lm=lm,
                                    smem_per_block=fused_cg.SM90_LIMITS[1])
    assert plan is not None and plan["layout"] == "batch"
    assert plan["lanes"] * plan["per_block"] <= fused_cg.BATCH_TEAM_LANES
    dot = team_dot(plan["lanes"])
    deltas, counts = [], []
    for k in range(int(meta["batch"])):
        F = meta["F"][k].float()
        if pairs:
            tab = stencil_pairs(F, meta["triples"], C, dom)
            stencil = lambda p, tab=tab: pairs_apply(tab, p)  # noqa: E731
        else:
            stencil = lambda p, F=F: fused_cg._stencil_apply(F, meta["triples"], p)  # noqa: E731
        if lm:
            apply = lambda p, k=k, st=stencil: st(p) + ctc[k] * p  # noqa: E731
        else:
            apply = stencil
        d, l = fused_cg._run_cg(b[k], apply, lambda r, k=k: pre[k] * r, dot, lits, tol,
                                guard_div=True, reset_period=reset_period if lm else None,
                                q_tol=q_tolerance if lm else None)
        deltas.append(d)
        counts.append(l)
    return torch.stack(deltas), counts


def twin(meta, b, pre, lits, tol, ctc=None, reset_period=None, q_tolerance=None):
    counts = []
    d, _total = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, pre, lits, tol, n_sys=int(meta["batch"]),
        batched=True, counts=counts, ctc=ctc, reset_period=reset_period,
        q_tolerance=q_tolerance)
    return d, counts


def _curve_inputs(B, N=64, seed=0):  # tests/test_torch_batched.py::_curve_inputs
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, N)
    truths = rng.uniform(80, 120, (B, 2))
    data = np.stack(
        [np.stack([x, a * np.cos(b * x) + b * np.sin(a * x)], -1) for a, b in truths]
    ).astype(f32)
    init = truths + rng.randn(B, 2) * 0.05
    graphs = {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}
    return {"funcParams": init[:, None, :].astype(f32), "data": data, "G": graphs}


def _laplacian_inputs(n, B, seed=1):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(B, n, n).astype(f32), "A": rng.rand(B, n, n).astype(f32)}


def _system(case, kind, **ip):
    """(meta, b, pre, the LM keywords: ctc packed, reset_period,
    q_tolerance; {} under GN) of the first step of a batch."""
    if case == "curve":
        plan = ott.Problem(tspecs.curve_fitting, kind=kind).plan(
            dims={"N": 64, "U": 1}, device="cpu", init_params=ott.InitializationParameters(**ip))
        meta, r0, pre, kw = plan.batched_cg_inputs(_curve_inputs(16))
    else:
        plan = ott.Problem(tspecs.laplacian, kind=kind).plan(
            dims={"W": 8, "H": 8}, device="cpu", init_params=ott.InitializationParameters(**ip))
        meta, r0, pre, kw = plan.batched_cg_inputs(_laplacian_inputs(8, 4))
    lm = {}
    if kw.get("ctc") is not None:
        lm = dict(ctc=fused_cg.pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                  q_tolerance=kw["q_tolerance"])
    pb = kw.get("pre_blocks")
    return (meta, fused_cg.pack(r0, meta),
            None if pre is None else fused_cg.pack(pre, meta), lm,
            dict(pre_blocks=None if pb is None else fused_cg.pack_pre_blocks(pb, meta),
                 cs=kw.get("cg_variant") == "chronopoulos_gear"))


@pytest.mark.parametrize("case", ["curve", "laplacian"])
def test_stencil_pairs_tile_the_table_and_apply_as_the_twin(case):
    """Each element's pairs are its own run of the table, the runs cover
    the plane · n_triples pairs exactly once, every place is inside the
    system or the zero place, and the walk of pairs equals the twin's
    apply bitwise on a random p."""
    meta, b, _pre, _lm, _v = _system(case, "gaussNewtonGPU")
    C, dom = int(b.shape[1]), tuple(b.shape[2:])
    n, plane = int(b[0].numel()), int(np.prod(dom))
    for k in (0, int(meta["batch"]) - 1):
        tab = stencil_pairs(meta["F"][k], meta["triples"], C, dom)
        vals, places, first, count = tab
        seen = torch.zeros(vals.numel(), dtype=torch.int32)
        for f0, cnt in zip(first, count):
            seen[f0:f0 + cnt] += 1
        assert bool((seen == 1).all()) and vals.numel() == plane * len(meta["triples"])
        assert bool(((places >= 0) & (places <= n)).all()) and bool(torch.isfinite(vals).all())
        p = torch.as_tensor(np.random.RandomState(k).randn(*b[0].shape).astype(f32))
        assert torch.equal(pairs_apply(tab, p),
                           fused_cg._stencil_apply(meta["F"][k].float(), meta["triples"], p))


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("case", ["curve", "laplacian"])
def test_team_loop_equals_twin(case, kind):
    """curve_fitting x16 (2 elements a system, a team of 2 lanes, 16
    systems a warp) and laplacian 8x8 x4 (64 elements, a team of 32 lanes,
    2 elements a lane): the team loop is bitwise the twin, system by
    system, with no exit for 30 iterations and with the real exits (the
    solver's own tolerances), counts equal."""
    meta, b, pre, lm, _v = _system(case, kind)
    C, dom = int(b.shape[1]), tuple(b.shape[2:])
    plan = fused_cg.batch_team_plan(meta, C, dom, lm=bool(lm),
                                    smem_per_block=fused_cg.SM90_LIMITS[1])
    assert (plan["lanes"], plan["per_block"]) == ((2, 16) if case == "curve" else (32, 1))
    no_exit = dict(lm, q_tolerance=float("-inf")) if lm else {}
    for lits, tol, kw in ((30, 0.0, no_exit), (60, 1e-12, lm)):
        de, ce = emulate(meta, b, pre, lits, tol, pairs=case == "curve", **kw)
        dt, ct = twin(meta, b, pre, lits, tol, **kw)
        assert ce == ct
        assert torch.equal(de, dt)
        assert bool(torch.isfinite(de).all())


def _pack(a):
    return torch.as_tensor(np.moveaxis(a, -1, 1).copy())


@pytest.mark.parametrize("form", ["gn", "lm"])
def test_team_loop_matches_pallas_under_vmap(form):
    """4 x laplacian 16x16 with per-instance F and b (a team of a warp, 8
    elements a lane): the team loop's δ within 1e-6 of the Pallas kernel's
    under jax.vmap in interpret mode, the counts equal instance by
    instance, with the real exits where every loop crosses its threshold
    by a wide margin: the tolerance and the case of
    tests/test_torch_batched.py::test_k1h_twin_matches_pallas_under_vmap."""
    meta_np, r0, pre, ctc = _lap()
    lits = 60
    if form == "gn":
        tol, lm, c = _wide_margin_tol(meta_np, r0, pre), {}, None
    else:
        tol, c = 1e-12, ctc
        lm = dict(reset_period=10, q_tolerance=_wide_margin_tol(meta_np, r0, pre, ctc))
    jd, jcounts = _jax_vmapped(meta_np, r0, pre, lits, tol, c, **lm)
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    kw = {} if c is None else dict(ctc=_pack(c), **lm)
    assert fused_cg.launch_instance(meta, _pack(r0), lm=c is not None) == f"{form}_batch_tiled"
    d, counts = emulate(meta, _pack(r0), _pack(pre), lits, tol, **kw)
    assert counts == jcounts and max(counts) < lits and len(counts) == LAP_B
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind, ip, name", [
    ("gaussNewtonGPU", {}, "gn_batch_tiled"),
    ("LMGPU", {}, "lm_batch_tiled"),
    ("gaussNewtonGPU", {"cg_variant": "chronopoulos_gear"}, "gn_cs_batch"),
    ("LMGPU", {"cg_variant": "chronopoulos_gear"}, "lm_cs_batch"),
    ("gaussNewtonGPU", {"coefficient_dtype": "bfloat16"}, "gn_bf16_batch"),
    ("LMGPU", {"preconditioner": "block_jacobi"}, "lm_bj_batch"),
])
@pytest.mark.parametrize("case", ["curve", "laplacian"])
def test_route_of_batched_metas(case, kind, ip, name):
    """Off the card, at the H100's limits: the curve fits' batched meta (a
    graph meta with an empty CSR, one vertex) and laplacian 8x8 x4 take
    the batch kernel under the standard loop, Jacobi and float32 fields;
    Chronopoulos–Gear, bfloat16 fields and block-Jacobi keep the
    template's batch instances."""
    meta, b, _pre, lm, var = _system(case, kind, **ip)
    if case == "curve":
        assert meta.get("empty_csr") is not None and meta.get("rem") is None
    assert fused_cg.batched_kernel_form(meta, var["pre_blocks"]) == "batch"
    got = fused_cg.launch_instance(meta, b, lm=bool(lm), cs=var["cs"],
                                   pre_blocks=var["pre_blocks"])
    assert got == name
    plan = fused_cg.route_plan(meta, b, lm=bool(lm), cs=var["cs"], pre_blocks=var["pre_blocks"])
    assert (plan is not None) == name.endswith("_tiled")


def _synthetic_batch(B, dom, T, C=1, rem=False):
    """A batched meta of B systems, C channels on ``dom``, T fields each
    read by one triple (offsets walking a 5x5 window)."""
    offs = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)]
    triples = tuple((offs[t % len(offs)], t % C, (t // len(offs)) % C, t) for t in range(T))
    meta = {"batch": B, "F": torch.zeros((B, T) + dom), "triples": triples, "ctot": C,
            "rem": None, "chan_grid": False}
    if rem:
        N = int(np.prod(dom))
        meta["rem"] = {"rowptr": torch.zeros(N + 1, dtype=torch.int32),
                       "col": torch.zeros(0, dtype=torch.int32),
                       "blk": torch.zeros((B, 0, C, C))}
    return meta, torch.zeros((B, C) + dom)


def test_route_keeps_the_remainder_and_systems_over_the_cap_on_the_template():
    """A batch with the remainder keeps gn_rem_batch; a system whose slice
    (its stencil pairs, fields and vectors) exceeds the block's shared
    memory keeps gn_batch: 64 fields, each read by one triple, on 24x32
    points (24 elements a lane, within the lane cap); at 21 (the largest count
    that fits at 24x32: 215,048 bytes against 221,948) it takes the batch
    kernel, one system a block."""
    meta, b = _synthetic_batch(4, (8, 8), 5, rem=True)
    assert fused_cg.batched_kernel_form(meta) == "batch"
    assert fused_cg.launch_instance(meta, b) == "gn_rem_batch"
    room = fused_cg.SM90_LIMITS[1] - fused_cg.BATCH_TEAM_STATIC_SMEM
    for T, name in ((64, "gn_batch"), (22, "gn_batch"), (21, "gn_batch_tiled")):
        meta, b = _synthetic_batch(3, (24, 32), T)
        assert fused_cg.batched_kernel_form(meta) == "batch"
        one = fused_cg.tiled_batch_smem_bytes(False, 1, T, T, 24 * 32)
        assert (one <= room) == name.endswith("_tiled")
        assert fused_cg.launch_instance(meta, b) == name
    plan = fused_cg.route_plan(meta, b, lm=False)
    assert (plan["lanes"], plan["per_block"], plan["blocks"]) == (32, 1, 3)
    assert plan["smem_bytes"] == 215048
    # fewer systems a block where their slices are short of room: a 4x4
    # system of 5 triples takes 1,480 bytes under LM, a team of 16 lanes
    meta, b = _synthetic_batch(40, (4, 4), 5)
    one = fused_cg.tiled_batch_smem_bytes(True, 1, 5, 5, 16)
    assert one == 1480
    for room, per_block in ((one, 1), (2 * one + 100, 2), (40 * one, 2)):
        plan = fused_cg.batch_team_plan(meta, 1, (4, 4), lm=True,
                                        smem_per_block=fused_cg.BATCH_TEAM_STATIC_SMEM + room)
        assert (plan["lanes"], plan["per_block"]) == (16, per_block)
        assert plan["blocks"] == -(-40 // per_block) and plan["smem_bytes"] == per_block * one
    assert fused_cg.batch_team_plan(meta, 1, (4, 4), lm=True, smem_per_block=(
        fused_cg.BATCH_TEAM_STATIC_SMEM + one - 1)) is None


@pytest.mark.parametrize("dom, C, name", [
    ((30, 30), 1, "gn_batch_tiled"),  # 900 elements, 29 a lane
    ((31, 32), 1, "gn_batch_tiled"),  # 992, 31 a lane: the cap
    ((31, 33), 1, "gn_batch"),  # 1,023, 32 a lane
    ((32, 32), 1, "gn_batch"),  # 1,024, 32 a lane
    ((45, 45), 1, "gn_batch"),  # 2,025: the largest "batch" form of one channel
    ((16, 31), 2, "gn_batch_tiled"),  # 992 over two channels
    ((16, 32), 2, "gn_batch"),  # 1,024 over two channels
])
def test_route_keeps_systems_over_the_lane_cap_on_the_template(dom, C, name):
    """A system whose lanes would each walk more than
    BATCH_TEAM_LANE_ELEMS of its C·plane elements keeps the template's
    block a system, which was faster there (chip_smoke.py::form_sweep),
    though its slice fits the shared memory."""
    assert fused_cg.BATCH_TEAM_LANE_ELEMS == 31
    meta, b = _synthetic_batch(4, dom, 5, C=C)
    assert fused_cg.batched_kernel_form(meta) == "batch"
    n = C * dom[0] * dom[1]
    assert fused_cg.tiled_batch_smem_bytes(False, C, 5, 5, dom[0] * dom[1]) <= (
        fused_cg.SM90_LIMITS[1] - fused_cg.BATCH_TEAM_STATIC_SMEM)
    assert fused_cg.launch_instance(meta, b) == name
    assert (-(-n // 32) <= 31) == name.endswith("_tiled")


def test_instance_names_and_launch_counts_know_the_batch_kernel():
    assert fused_cg.instance_name(False, False, batch=True, tiled=True) == "gn_batch_tiled"
    assert fused_cg.instance_name(True, False, batch=True, tiled=True) == "lm_batch_tiled"
    names = [fused_cg.instance_name(*f) for f in fused_cg.TILED_INSTANCES]
    assert len(names) == len(set(names)) == 24 and names[-2:] == ["gn_batch_tiled",
                                                                  "lm_batch_tiled"]
    fused_cg.fused_grid_cg_kernel.launches["lm_batch_tiled"] = 3
    fused_cg.reset_launch_counts()
    assert fused_cg.fused_grid_cg_kernel.launches["gn_batch_tiled"] == 0
    assert fused_cg.fused_grid_cg_kernel.launches["lm_batch_tiled"] == 0


def test_wrapper_refuses_cpu_tensors_after_its_checks():
    """The batch kernel's wrapper checks its operands, then raises on CPU
    tensors: nothing falls back to the twin or the template."""
    meta, b, pre, lm, _v = _system("curve", "LMGPU")
    plan = fused_cg.route_plan(meta, b, lm=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_cg.tiled_batch_cg_kernel(meta, b, pre, 20, 1e-12, plan, **lm)
    with pytest.raises(ValueError, match="ctc"):
        fused_cg.tiled_batch_cg_kernel(meta, b, pre, 20, 1e-12, plan,
                                       **dict(lm, ctc=lm["ctc"][:1]))
