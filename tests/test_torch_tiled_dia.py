"""The graph kernel's stream layout for a graph without the remainder (the
DIA-only form: csrc/tiled_graph_cg.cu, ``gn_dia_tiled`` and
``lm_dia_tiled``) on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template there). Here: the home of a remainder-less graph's
partition (``graph_group_tables``' empty CSR, carried on the meta under
``"empty_csr"``); which launches ``graph_tile_plan`` takes in the stream
layout and how it cuts the vertices, at arap36k's full size from the host
tables alone; the route's names for the forms that keep the template; the
block emulation of tests/test_torch_tiled_graph.py with an empty CSR (each
range's p and pre over its frame, only r's border exchanged, NaN
everywhere else) held bitwise to the twin on arap grid meshes whose halo
is larger than a range (chip_smoke.py's inputs, bench.py::bench_arap_graph's
on other sides) and on curve_fitting's one vertex of two channels, and to
the JAX package's ``flat1d`` Pallas kernel in interpret mode; and the
wrapper's host-side contract."""

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
from chip_smoke import arap_grid_inputs, instance_system, medium_inputs
from tests.test_torch_cg_variants import _pack, jax_cg_call
from tests.test_torch_tiled_graph import _check_partition, emulate

torch.set_num_threads(2)

f32 = np.float32
SMS, SMEM = fused_cg.SM90_LIMITS  # the H100 SXM's SMs and opt-in shared memory a block
RESET = 3
# δ against the Pallas kernel after 20 iterations with no exit, as a
# fraction of max|δ|: the tolerance of the remainder's emulation
# (tests/test_torch_tiled_graph.py::JAX_RTOL); the two sum the dots in
# other orders
JAX_RTOL = 1e-5
KINDS = {"GN": "gaussNewtonGPU", "LM": "LMGPU"}
ARAP_SIDE = 192  # bench.py::bench_arap_graph: 36,864 vertices


# -- systems --------------------------------------------------------------------------


# mesh -> (rows, cols, the plan's ranges, the largest halo): 16 x 16 (three
# ranges of up to 86 vertices), 64 x 64 (48 ranges of up to 86, a halo of
# 128), 37 x 50 (22 ranges of up to 85 that end inside rows, a halo of
# 100), 8 x 8 (one range): on the second and third the halo is larger than
# the range. "curve" is curve_fitting's medium system (chip_smoke.py's
# medium golden): one vertex of two channels, offset 0 only, one range.
MESHES = {"grid16": (16, 16, 3, 32), "grid64": (64, 64, 48, 128),
          "ragged37x50": (37, 50, 22, 100), "one8": (8, 8, 1, 0)}
PLANS = {**{m: v[2:] for m, v in MESHES.items()}, "curve": (1, 0)}
_MESHES, _SYSTEMS = {}, {}


def _mesh(mesh):
    """(spec, dims, inputs) of a grid mesh or of "curve"."""
    if mesh not in _MESHES:
        if mesh == "curve":
            _MESHES[mesh] = (tspecs.curve_fitting, *medium_inputs()["curve_fitting"])
        else:
            _MESHES[mesh] = (tspecs.arap_mesh_deformation,
                             *arap_grid_inputs(*MESHES[mesh][:2]))
    return _MESHES[mesh]


def _system(mesh, kind="GN"):
    """The port's first system on a grid mesh (or "curve"), as the solver
    hands it to the kernel: (meta, b, pre, ctc or None)."""
    if (mesh, kind) not in _SYSTEMS:
        spec, dims, inputs = _mesh(mesh)
        plan = ott.Problem(spec, kind=KINDS[kind]).plan(dims=dims, device="cpu",
                                                        residual_reset_period=RESET)
        meta, r0, pre, kw = plan.cg_inputs(dict(inputs))
        ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
        _SYSTEMS[(mesh, kind)] = (meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), ctc)
    return _SYSTEMS[(mesh, kind)]


def _lm_kw(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


def _empty(meta, b):
    """The meta's empty CSR as the emulation reads a remainder: no entries."""
    C = int(b.shape[0])
    return dict(meta["empty_csr"], blk=torch.empty((0, C, C)))


# -- the partition's home ---------------------------------------------------------------


def test_group_tables_give_a_remainder_less_group_an_empty_csr():
    """A DIA-only group gets an all-zero rowptr [N+1], an empty col and its
    own GraphPartitions; a group with the remainder gets none (its CSR
    carries the partitions)."""
    _spec, dims, inputs = _mesh("grid16")
    N = dims["N"]
    g = {k: v.astype(np.int64) for k, v in inputs["G"].items()}
    tabs = graph_group_tables(g, ["v0", "v1"], N, "cpu", torch.float32, 13)
    assert tabs["csr"] is None and sorted(off for off, _m in tabs["dia"]) == [-16, -1, 1, 16]
    empty = tabs["empty_csr"]
    assert empty["rowptr"].dtype == torch.int32 and empty["col"].dtype == torch.int32
    assert torch.equal(empty["rowptr"], torch.zeros(N + 1, dtype=torch.int32))
    assert tuple(empty["col"].shape) == (0,)
    assert isinstance(empty["partitions"], fused_cg.GraphPartitions)
    ring = {"v0": np.arange(N, dtype=np.int64), "v1": np.random.RandomState(0).permutation(N)}
    rtabs = graph_group_tables(ring, ["v0", "v1"], N, "cpu", torch.float32, 13)
    assert rtabs["csr"] is not None and rtabs["empty_csr"] is None


def test_the_meta_carries_the_groups_empty_csr_across_steps(monkeypatch):
    """The meta's "empty_csr" is the group's empty CSR, the same object
    every GN step: a later step's plan finds the partition the first built
    and builds nothing; "rem" stays None, so the twin and the template read
    the meta as before."""
    _spec, dims, inputs = _mesh("grid16")
    tp = ott.Problem(tspecs.arap_mesh_deformation).plan(dims=dims, device="cpu")
    meta1, r1, _p1, _k1 = tp.cg_inputs(dict(inputs))
    assert meta1["rem"] is None and meta1["empty_csr"] is not None
    plan1 = fused_cg.route_plan(meta1, fused_cg.pack(r1, meta1), lm=False)
    built = []
    real = fused_cg.graph_partition
    monkeypatch.setattr(fused_cg, "graph_partition",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    moved = dict(inputs, Angle=inputs["Angle"] + f32(0.1))
    meta2, r2, _p2, _k2 = tp.cg_inputs(moved)
    assert not torch.equal(meta2["F"], meta1["F"])
    assert meta2["empty_csr"] is meta1["empty_csr"]
    plan2 = fused_cg.route_plan(meta2, fused_cg.pack(r2, meta2), lm=False)
    assert plan2 == plan1 and plan2["partition"] is plan1["partition"] and not built


def test_plan_at_arap36ks_full_size():
    """arap36k (bench.py::bench_arap_graph: the 192 x 192 grid mesh) through
    the port's host tables only, with the operator's 181 fields and 183
    triples (those of the 16 x 16 mesh, their offsets ±16 read as ±192):
    the GN and LM plans take 132 ranges of up to 280 vertices, halos of
    384, in the stream layout at 67,416 B and 80,856 B a block (the state
    66,684 B and 80,124 B, and the triples 16 B each), within the 232,448
    B; the resident layout, its fields staged, would need 270,128 B and
    283,568 B. GN and LM share one partition, built once; 36,689 of the
    36,864 vertices lie in some block's halo."""
    dims, inputs = arap_grid_inputs(ARAP_SIDE)
    N = dims["N"]
    g = {k: v.astype(np.int64) for k, v in inputs["G"].items()}
    tabs = graph_group_tables(g, ["v0", "v1"], N, "cpu", torch.float32, 13)
    assert tabs["csr"] is None and sorted(off for off, _m in tabs["dia"]) == [-192, -1, 1, 192]
    small, *_rest = _system("grid16")
    scale = {-16: -ARAP_SIDE, 16: ARAP_SIDE}
    triples = tuple(((0, scale.get(d[1], d[1])), i, j, f) for (d, i, j, f) in small["triples"])
    assert len(triples) == 183 and int(small["F"].shape[0]) == 181
    meta = {"F": torch.empty((181, 1, N)), "chan_grid": False, "triples": triples, "rem": None,
            "empty_csr": tabs["empty_csr"]}
    empty = tabs["empty_csr"]
    for lm, smem, staged in ((False, 67416, 270128), (True, 80856, 283568)):
        plan = fused_cg.graph_tile_plan(meta, 6, N, lm=lm, sm_count=SMS, smem_per_block=SMEM)
        assert plan is not None and plan["layout"] == "stream"
        assert (plan["blocks"], plan["max_range"], plan["max_halo"], plan["max_frame"],
                plan["max_entries"]) == (SMS, 280, 384, 664, 0)
        assert plan["smem_bytes"] == smem <= SMEM
        part = plan["partition"]
        assert smem == fused_cg.tiled_graph_smem_bytes(
            lm, 6, 181, part["max_range"], part["max_frame"], part["max_halo"], 0, 183,
            stream=True)
        assert fused_cg.tiled_graph_smem_bytes(
            lm, 6, 181, part["max_range"], part["max_frame"], part["max_halo"], 0, 183) == (
                staged) > SMEM
        _check_partition(part, empty["rowptr"].numpy(), empty["col"].numpy(), N, ARAP_SIDE,
                         ARAP_SIDE)
        assert int(part["border"].sum()) == 36689
    assert len(empty["partitions"].partitions) == 1


# -- plan and route --------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(PLANS))
@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_route_takes_the_stream_layout(mesh, kind):
    meta, b, _pre, ctc = _system(mesh, kind)
    lm = ctc is not None
    assert meta["rem"] is None
    plan = fused_cg.route_plan(meta, b, lm=lm)
    assert plan == fused_cg.graph_tile_plan(meta, int(b.shape[0]), b.shape[-1], lm=lm,
                                            sm_count=SMS, smem_per_block=SMEM)
    assert (plan["layout"], plan["blocks"], plan["max_halo"]) == ("stream",) + PLANS[mesh]
    assert plan["max_entries"] == 0 and plan["smem_bytes"] <= SMEM
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm_dia_tiled" if lm else "gn_dia_tiled")


def _batched(kind):
    """The 16 x 16 mesh's batch of two instances (Offset and Angle differ)
    through the solver's batched meta."""
    _spec, dims, inputs = _mesh("grid16")
    N = dims["N"]
    rng = np.random.RandomState(5)
    binp = dict(inputs, Offset=np.stack([inputs["Offset"], inputs["Offset"] + f32(0.05)]),
                Angle=(0.2 * rng.randn(2, N, 3)).astype(f32))
    plan = ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N}, device="cpu")
    meta, r0, _pre, _kw = plan.batched_cg_inputs(binp)
    assert meta["batch"] == 2
    return meta, fused_cg.pack(r0, meta)


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_a_batch_instance_takes_the_stream_layout(kind):
    """One system cut from a batched remainder-less meta, as
    chip_smoke.py::instance_system cuts it to time the systems one launch
    each, takes the one-system stream plan: its empty CSR is that
    instance's, not the batch's."""
    meta, b = _batched(kind)
    lm = kind == "LM"
    one, b1, _p1, _lm1, _v = instance_system(meta, b, b, None, {}, 1)
    assert tuple(one["empty_csr"]["rowptr"].shape) == (int(b.shape[-1]) + 1,)
    single, *_rest = _system("grid16", kind)
    got, want = fused_cg.route_plan(one, b1, lm=lm), fused_cg.route_plan(single, b1, lm=lm)
    assert {k: v for k, v in got.items() if k != "partition"} == {
        k: v for k, v in want.items() if k != "partition"}
    for key in ("blocks", "halo", "border"):
        assert np.array_equal(got["partition"][key], want["partition"][key])
    assert fused_cg.launch_instance(one, b1, lm=lm) == ("lm_dia_tiled" if lm else "gn_dia_tiled")


def _odd_channels(meta, b):
    """The 16 x 16 mesh's system cut to its first five channels."""
    triples = tuple(t for t in meta["triples"] if t[1] < 5 and t[2] < 5)
    return dict(meta, triples=triples), b[:5].contiguous()


@pytest.mark.parametrize("case", ["batch", "batch_multi", "cs", "bf16", "block_jacobi",
                                  "odd_channels", "jax_meta"])
@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_other_dia_forms_keep_the_template(case, kind, monkeypatch):
    """A batched remainder-less meta (either batch form), Chronopoulos–Gear,
    bfloat16 fields, block-Jacobi and a meta without its empty CSR (the JAX
    package's, carried across) keep the template's instance; an odd channel
    count takes the stream layout."""
    meta, b, _pre, ctc = _system("grid16", kind)
    lm = ctc is not None
    kw, name = {}, "lm" if lm else "gn"
    if case.startswith("batch"):
        meta, b = _batched(kind)
        if case == "batch_multi":
            monkeypatch.setattr(fused_cg, "BATCH_BLOCK_ELEMS", 0)
        name += "_multi" if case == "batch_multi" else "_batch"
    elif case == "cs":
        kw["cs"] = True
        name += "_cs"
    elif case == "bf16":
        meta = dict(meta, F=meta["F"].to(torch.bfloat16))
        name += "_bf16"
    elif case == "block_jacobi":
        kw["pre_blocks"] = torch.zeros((36,) + tuple(b.shape[1:]))
        name += "_bj"
    elif case == "odd_channels":
        meta, b = _odd_channels(meta, b)
        assert fused_cg.route_plan(meta, b, lm=lm)["layout"] == "stream"
        assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_dia_tiled"
        return
    else:
        meta = {k: v for k, v in meta.items() if k != "empty_csr"}
    assert fused_cg.route_plan(meta, b, lm=lm, **kw) is None
    assert fused_cg.launch_instance(meta, b, lm=lm, **kw) == name


@pytest.mark.parametrize("mesh", ["random", "dense_grid"])
@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_remainder_metas_keep_their_plans(mesh, kind):
    """A meta with the remainder keeps its resident plan (its fields staged:
    the shared memory of tiled_graph_smem_bytes with the fields) and its
    names, and carries no empty CSR."""
    from tests.test_torch_tiled_graph import _system as rem_system

    meta, b, _pre, ctc = rem_system(mesh, kind)
    lm = ctc is not None
    assert meta["rem"] is not None and meta["empty_csr"] is None
    plan = fused_cg.route_plan(meta, b, lm=lm)
    assert plan["layout"] == "resident"
    assert plan["smem_bytes"] == fused_cg.tiled_graph_smem_bytes(
        lm, 6, int(meta["F"].shape[0]), plan["max_range"], plan["max_frame"], plan["max_halo"],
        plan["max_entries"], len(meta["triples"]))
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm_rem_tiled" if lm else "gn_rem_tiled")


def test_instance_names_and_launch_counts():
    names = [fused_cg.instance_name(*f) for f in fused_cg.TILED_INSTANCES[18:20]]
    assert names == ["gn_dia_tiled", "lm_dia_tiled"]
    assert fused_cg.instance_name(True, False, dia=True) == "lm_dia"
    fused_cg.fused_grid_cg_kernel.launches["gn_dia_tiled"] = 2
    fused_cg.reset_launch_counts()
    assert all(fused_cg.fused_grid_cg_kernel.launches[n] == 0 for n in names)


def test_registers_of_the_stream_instances():
    """ptxas's lines for tiled_graph_cg_kernel<LM, STREAM>: the stream
    instances under the dia launch names, the resident ones under the
    remainder's."""
    lines = []
    for lm, stream, regs in ((0, 0, 120), (1, 0, 122), (0, 1, 96), (1, 1, 104)):
        lines.append("ptxas info    : Compiling entry function "
                     f"'_Z21tiled_graph_cg_kernelILb{lm}ELb{stream}EEvPKfS1_' for 'sm_90a'")
        if stream and lm:
            lines.append("    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")
        lines.append(f"ptxas info    : Used {regs} registers, used 1 barriers, 480 bytes cmem[0]")
    got = _build.instance_registers("\n".join(lines))
    named = {fused_cg.instance_name(*k): v for k, v in got.items()}
    assert named == {"gn_rem_tiled": (120, 0, 0), "gn_rem_multi_tiled": (120, 0, 0),
                     "lm_rem_tiled": (122, 0, 0), "lm_rem_multi_tiled": (122, 0, 0),
                     "gn_dia_tiled": (96, 0, 0), "lm_dia_tiled": (104, 8, 8)}
    assert set(got) == set(fused_cg.TILED_INSTANCES[6:10] + fused_cg.TILED_INSTANCES[18:20])


# -- the emulation against the twin, bitwise ------------------------------------------


# (mesh, kind, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM) and the
# real exits, on meshes whose halo is larger than a range, and on one range
_EMULATION_CASES = [
    (mesh, kind, lits, tol, q_tol)
    for mesh in ("grid64", "ragged37x50", "one8")
    for kind, q_none, q_exit in (("GN", None, None), ("LM", -np.inf, 1e-4))
    for lits, tol, q_tol in ((20, 0.0, q_none), (400, 1e-8, q_exit))
]


@pytest.mark.parametrize("mesh,kind,lits,tol,q_tol", _EMULATION_CASES)
def test_emulation_is_bitwise_the_twin(mesh, kind, lits, tol, q_tol):
    """The graph kernel's loop range by range (the plan's partition, an
    empty CSR) against the twin: equal counts and δ bitwise equal."""
    meta, b, pre, ctc = _system(mesh, kind)
    plan = fused_cg.route_plan(meta, b, lm=ctc is not None)
    de, le = emulate(meta["F"], meta["triples"], _empty(meta, b), b, pre, lits, tol,
                     plan["partition"], **_lm_kw(ctc, q_tol))
    dt, lt = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                              rem=meta["rem"], **_lm_kw(ctc, q_tol))
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())
    if ctc is not None and tol == 0.0:
        assert le > 3 * RESET  # resets occurred


@pytest.mark.parametrize("kind,lits,tol,q_tol", [("GN", 50, 0.0, None), ("GN", 60, 1e-8, None),
                                                 ("LM", 50, 0.0, -np.inf),
                                                 ("LM", 60, 1e-8, 1e-4)])
def test_emulation_on_one_vertex_is_bitwise_the_twin(kind, lits, tol, q_tol):
    """curve_fitting's medium system, one vertex of two channels and offset
    0 only: one range without a halo, the kernel's two channels on two
    live lanes. Equal counts and δ bitwise equal; with no exit the GN loop
    still stops before ``lits``, at an exact zero residual (the LM loop,
    its residual reset every RESET iterations, runs on), as on the card,
    where chip_smoke.py holds the count to the twin's."""
    meta, b, pre, ctc = _system("curve", kind)
    assert tuple(b.shape) == (2, 1, 1)
    assert {d for (d, _i, _j, _f) in meta["triples"]} == {(0, 0)}
    plan = fused_cg.route_plan(meta, b, lm=ctc is not None)
    de, le = emulate(meta["F"], meta["triples"], _empty(meta, b), b, pre, lits, tol,
                     plan["partition"], **_lm_kw(ctc, q_tol))
    dt, lt = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                              rem=meta["rem"], **_lm_kw(ctc, q_tol))
    assert le == lt and 2 <= le <= lits
    if tol == 0.0 and ctc is None:
        assert le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())


# -- the emulation against the Pallas kernel in interpret mode -------------------------


@pytest.mark.parametrize("kind,lits,tol,q_tol", [("GN", 20, 0.0, None), ("GN", 200, 1e-8, None),
                                                 ("LM", 20, 0.0, -np.inf)])
def test_emulation_matches_pallas_interpret(kind, lits, tol, q_tol):
    """The 16 x 16 mesh's first system as the JAX package hands its fused
    kernel (the flat1d form, its [R, L] fold carried across), through the
    Pallas kernel in interpret mode and through the emulation on the port's
    three ranges: equal counts, and after 20 iterations with no exit δ
    within JAX_RTOL · max|δ|. At the real exit only the counts are held,
    as tests/test_torch_graph.py::test_jax_graph_meta_runs_in_the_twin
    holds the twin."""
    _spec, dims, inputs = _mesh("grid16")
    jmeta, r0, jpre, kw = jax_cg_call("arap_mesh_deformation", dims, inputs, KINDS[kind])
    assert jmeta.get("rem") is None
    meta = meta_from_numpy(jmeta, device="cpu")
    lm = {} if "ctc" not in kw else dict(ctc=kw["ctc"], reset_period=kw["reset_period"],
                                         q_tolerance=q_tol)
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, **lm)
    jd = _pack(jax.device_get(jd), meta)
    b, pre = _pack(r0, meta), _pack(jpre, meta)
    tkw = {} if not lm else dict(ctc=_pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                                 q_tolerance=q_tol)
    port, *_rest = _system("grid16", kind)
    part = fused_cg.route_plan(port, b, lm=bool(lm))["partition"]
    assert part["blocks"].shape[0] == 3
    de, le = emulate(meta["F"], meta["triples"], _empty(port, b), b, pre, lits, tol, part, **tkw)
    assert le == int(ji)
    if tol != 0.0:
        assert le < lits
        return
    assert le == lits
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0,
                               atol=JAX_RTOL * float(jd.abs().max()))


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_kernel_wrapper_refuses_cpu_tensors(kind):
    """A remainder-less launch the route takes reaches the graph wrapper,
    whose device check raises for CPU tensors: nothing gives way to the
    template or to the twin."""
    meta, b, pre, ctc = _system("grid16", kind)
    with pytest.raises(ValueError, match="tiled_graph_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **_lm_kw(ctc, 1e-4))


def test_wrapper_checks_the_stream_operands_first():
    meta, b, pre, _ctc = _system("grid16")
    plan = fused_cg.route_plan(meta, b, lm=False)
    call = fused_cg.tiled_graph_cg_kernel
    with pytest.raises(ValueError, match="pre has shape"):
        call(meta, b, pre[:, :, :-1], 10, 0.0, plan)
    empty = meta["empty_csr"]
    with pytest.raises(ValueError, match="rowptr has shape"):
        call(dict(meta, empty_csr=dict(empty, rowptr=empty["rowptr"][:-1])), b, pre, 10, 0.0,
             plan)
    with pytest.raises(ValueError, match="rowptr has dtype"):
        call(dict(meta, empty_csr=dict(empty, rowptr=empty["rowptr"].long())), b, pre, 10, 0.0,
             plan)
    with pytest.raises(ValueError, match="col has shape"):  # the empty CSR has no entries
        call(dict(meta, empty_csr=dict(empty, col=torch.zeros(3, dtype=torch.int32))), b, pre,
             10, 0.0, plan)
    with pytest.raises(ValueError, match="columns"):  # a partition with entries
        bad = dict(plan, partition=dict(plan["partition"], lcol=np.zeros(4, np.int32)))
        call(meta, b, pre, 10, 0.0, bad)
    with pytest.raises(ValueError, match="graph remainder"):
        call(dict(meta, empty_csr=None), b, pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="graph remainder"):  # a remainder meta, a stream plan
        rem = {"rowptr": empty["rowptr"], "col": empty["col"], "blk": torch.empty((0, 6, 6))}
        call(dict(meta, rem=rem), b, pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="one system"):
        call(dict(meta, batch=2), b[None].expand(2, -1, -1, -1), pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="reset_period"):
        call(meta, b, pre, 10, 0.0, plan, ctc=pre)
    # an odd channel count passes the operand checks (the device check
    # raises last, on the CPU)
    odd, b5 = _odd_channels(meta, b)
    with pytest.raises(ValueError, match="tiled_graph_cg_kernel needs CUDA"):
        call(odd, b5, pre[:5].contiguous(), 10, 0.0, fused_cg.route_plan(odd, b5, lm=False))
