"""The batch axis of the remainder and block-Jacobi forms of the CG kernel
(K1 (h) × K4 and K1 (h) × K1 (d)) held to the JAX package on the CPU: the
batched twin against the Pallas kernel under ``jax.vmap`` in interpret mode
on an irregular mesh's arap systems (a remainder; C = 6) with per-instance
blocks, ``solve_batched`` of both packages on that mesh, the batch's route
to one kernel call a step, and the operand checks of a batched launch. The
CUDA instances run on the card in chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu.ops.pallas_cg import fused_grid_cg as j_fused
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import _build, fused_cg
from opt_tpu_torch.solver import gauss_newton
from opt_tpu_torch.solver.gauss_newton import GaussNewtonSolver
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.test_torch_batched import _random_mesh, clear_threshold
from tests.test_torch_cg_variants import jax_cg_call

torch.set_num_threads(2)
f32 = np.float32
KINDS = {"gn": "gaussNewtonGPU", "lm": "LMGPU"}
PRES = {"jacobi": {}, "block_jacobi": {"preconditioner": "block_jacobi"}}
B = 2


def _mesh_batch():
    """tests/test_torch_batched.py's random mesh (N = 60, a ring with chords
    under a random numbering: its operator has a remainder) with two
    instances whose Offset and Angle differ, so that each instance's
    remainder and preconditioner blocks are its own from the first step."""
    N, inputs = _random_mesh()
    rng = np.random.RandomState(7)
    inputs["Angle"] = (0.2 * rng.randn(B, N, 3)).astype(f32)
    return N, inputs


N_MESH, INPUTS = _mesh_batch()
INSTANCES = [{**INPUTS, "Offset": INPUTS["Offset"][k], "Angle": INPUTS["Angle"][k]}
             for k in range(B)]


def _jax_calls(kind, pre):
    """What the JAX package's first step hands its fused kernel, instance by
    instance (numpy: meta, r0, pre, keywords)."""
    return [jax_cg_call("arap_mesh_deformation", {"N": N_MESH}, inst, KINDS[kind], **PRES[pre])
            for inst in INSTANCES]


def _stack(calls):
    """The instances' calls as one batch: (the JAX meta with F and the
    remainder's blocks batched, r0, pre, pre_blocks or None, ctc or None,
    reset_period), each batched on axis 0."""
    meta0 = calls[0][0]
    rem0 = meta0["rem"]
    for meta, *_ in calls[1:]:  # one structure: the shared CSR's tiles
        assert meta["triples"] == meta0["triples"]
        assert np.array_equal(meta["rem"]["table"], rem0["table"])
        assert np.array_equal(meta["rem"]["rows"], rem0["rows"])
    stack = lambda key: {u: np.stack([c[key][u] for c in calls]) for u in calls[0][key]}  # noqa: E731
    meta = dict(meta0, F=np.stack([c[0]["F"] for c in calls]),
                rem=dict(rem0, blocks=np.stack([c[0]["rem"]["blocks"] for c in calls])))
    kw0 = calls[0][3]
    pb = (np.stack([c[3]["pre_blocks"] for c in calls])
          if kw0.get("pre_blocks") is not None else None)
    ctc = ({u: np.stack([c[3]["ctc"][u] for c in calls]) for u in kw0["ctc"]}
           if "ctc" in kw0 else None)
    return meta, stack(1), stack(2), pb, ctc, kw0.get("reset_period")


def _jax_vmapped(batch, lits, tol, q_tol):
    """The Pallas kernel (interpret mode) under jax.vmap over the instances:
    (δ by unknown [B, N, C_u], counts)."""
    meta, r0, pre, pb, ctc, rp = batch

    def one(F, blocks, r, p, pbk, c):
        kw = {} if c is None else dict(ctc=c, reset_period=rp, q_tolerance=q_tol)
        if pbk is not None:
            kw["pre_blocks"] = pbk
        m = dict(meta, F=F, rem=dict(meta["rem"], blocks=blocks))
        return j_fused(m, r, p, lits, tol, interpret=True, **kw)

    d, it = jax.vmap(one)(meta["F"], meta["rem"]["blocks"], r0, pre, pb, ctc)
    d, it = jax.device_get((d, it))
    return {u: np.asarray(v) for u, v in d.items()}, np.asarray(it).reshape(-1).tolist()


def _port(batch):
    """The batch on the port's side: (batched meta, r0, pre, keywords of
    ``fused_grid_cg``: pre_blocks, ctc, reset_period)."""
    meta_np, r0, pre, pb, ctc, rp = batch
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    t = lambda d: None if d is None else {u: torch.as_tensor(v) for u, v in d.items()}  # noqa: E731
    kw = dict(pre_blocks=None if pb is None else torch.as_tensor(pb))
    if ctc is not None:
        kw.update(ctc=t(ctc), reset_period=int(rp))
    return meta, t(r0), t(pre), kw


def _exit_quantities(port, lits):
    """Each system's exit quantity after each iteration of a loop with no
    exit, from the single-system twin: GN rᵀz / rᵀz₀, LM ζ."""
    meta, r0, pre, kw = port
    b = fused_cg.pack(r0, meta)
    prem = fused_cg.pack(pre, meta)
    pbm = None if kw["pre_blocks"] is None else fused_cg.pack_pre_blocks(kw["pre_blocks"], meta)
    ctcm = None if kw.get("ctc") is None else fused_cg.pack(kw["ctc"], meta)
    rem = meta["rem"]
    seqs = []
    for k in range(B):
        prec = (fused_cg._block_prec(pbm[k]) if pbm is not None
                else (lambda r, k=k: prem[k] * r))
        lm = {} if ctcm is None else dict(ctc=ctcm[k], reset_period=kw["reset_period"],
                                          q_tolerance=float("-inf"))
        trace = []
        fused_cg.fused_grid_cg_reference(
            meta["F"][k], meta["triples"], b[k], prem[k], lits, 0.0, trace=trace,
            rem=dict(rem, blk=rem["blk"][k]), pre_blocks=None if pbm is None else pbm[k], **lm)
        rz0 = float(fused_cg._dot(b[k], prec(b[k])))
        seqs.append([float(z) if ctcm is not None else float(rz) / rz0
                     for (_l, rz, _fl, z) in trace])
    return seqs


@pytest.mark.parametrize("pre", sorted(PRES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_graph_twin_matches_pallas_under_vmap(kind, pre):
    """Two instances of the irregular mesh's arap system (the remainder,
    C = 6), each with its own F, remainder blocks, b and (block-)Jacobi
    preconditioner: the counts equal instance by instance, with the real
    exits (GN the rᵀz floor, LM the ζ exit) at a threshold that every
    instance's loop crosses by a wide margin, and the batched twin's δ
    within 1e-5 · max|δ| of the Pallas kernel's under jax.vmap. The two sum
    the remainder, the block apply and the dots in other orders (the JAX
    package by one-hot matmuls): 3.6e-7 to 2.6e-6 · max|δ| apart here, as
    tests/test_torch_graph.py holds the one-system remainder form at 1e-5."""
    batch = _stack(_jax_calls(kind, pre))
    port = _port(batch)
    lits = 60
    q = clear_threshold(_exit_quantities(port, lits))
    tol, q_tol = (q, None) if kind == "gn" else (1e-12, q)
    blocks = port[0]["rem"]["blk"]
    assert tuple(blocks.shape[:1]) == (B,) and not torch.equal(blocks[0], blocks[1])
    jd, jcounts = _jax_vmapped(batch, lits, tol, q_tol)
    meta, r0, prev, kw = port
    if kind == "lm":
        kw = dict(kw, q_tolerance=q_tol)
    td, tcounts = fused_cg.fused_grid_cg(meta, r0, prev, lits, tol, **kw)
    assert tcounts.tolist() == jcounts and max(jcounts) < lits
    scale = max(float(np.abs(v).max()) for v in jd.values())
    for u in jd:
        np.testing.assert_allclose(td[u].numpy(), jd[u], rtol=0, atol=1e-5 * scale)


SOLVE_SP = dict(nIterations=1, lIterations=50, cg_rz_tolerance=1e-8)


@pytest.mark.parametrize("pre", sorted(PRES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_graph_solve_matches_jax(kind, pre):
    """``solve_batched`` of the two mesh instances, one step of up to 50 CG
    iterations: the port's costs within 1e-5 of the JAX package's (its
    Pallas kernel in interpret mode under vmap), the CG counts equal, no
    fallback on either side. (A second step parts the two packages by up to
    2% under GN block-Jacobi: arap GN does not settle, ROADMAP queue 3.)"""
    jp = ot.Problem(jspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N_MESH},
        init_params=ot.InitializationParameters(use_pallas_cg="interpret", **PRES[pre]))
    tp = ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N_MESH}, device="cpu", init_params=ott.InitializationParameters(**PRES[pre]))
    jr = jp.solve_batched(dict(INPUTS), **SOLVE_SP)
    tr = tp.solve_batched(dict(INPUTS), **SOLVE_SP)
    np.testing.assert_allclose(tr.costs, np.asarray(jr.costs), rtol=1e-5)
    assert tr.num_linear_iterations.tolist() == np.asarray(jr.num_linear_iterations).tolist()
    assert tr.num_iterations.tolist() == np.asarray(jr.num_iterations).tolist() == [1] * B
    assert tp.fused_fallback is None and jp.fused_fallback is None


@pytest.mark.parametrize("form", ["multi", "batch"])
@pytest.mark.parametrize("pre", sorted(PRES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_graph_takes_one_kernel_call_a_step(monkeypatch, kind, pre, form):
    """The batch of mesh instances takes one batched fused-loop call a step,
    never the instance-by-instance path: the form ``batched_kernel_form``
    names for it (``BATCH_BLOCK_ELEMS`` moved to send it to the batch form),
    the instance with the remainder (and the block preconditioner), and each
    instance's cost that of its own solve."""
    if form == "batch":
        monkeypatch.setattr(fused_cg, "BATCH_BLOCK_ELEMS", 10**9)
    calls = []
    real = gauss_newton.fused_grid_cg

    def spy(meta, r0, pre_, lits, tol, **kw):
        pb = kw.get("pre_blocks")
        got = fused_cg.batched_kernel_form(meta, pb)
        calls.append(fused_cg.instance_name(kw.get("ctc") is not None, meta["rem"] is not None,
                                            False, pb is not None, False, got == "multi",
                                            got == "batch"))
        return real(meta, r0, pre_, lits, tol, **kw)

    def no_step_each(*a, **k):
        raise AssertionError("the batch went instance by instance")

    monkeypatch.setattr(gauss_newton, "fused_grid_cg", spy)
    monkeypatch.setattr(GaussNewtonSolver, "_step_each", no_step_each)
    tp = ott.Problem(tspecs.arap_mesh_deformation, kind=KINDS[kind]).plan(
        dims={"N": N_MESH}, device="cpu", init_params=ott.InitializationParameters(**PRES[pre]))
    sp = dict(SOLVE_SP, nIterations=2)
    res = tp.solve_batched(dict(INPUTS), **sp)
    want = kind + ("_bj" if pre == "block_jacobi" else "") + "_rem_" + form
    assert calls == [want] * 2 and tp.fused_fallback is None
    for k in range(B):
        single = tp.solve(dict(INSTANCES[k]), **sp)
        np.testing.assert_allclose(res.costs[k], single.costs, rtol=1e-5)


def _operands(bad):
    """A batched launch's operands on the CPU (the mesh's first GN step
    under block-Jacobi), with one of them of the wrong shape."""
    plan = ott.Problem(tspecs.arap_mesh_deformation).plan(
        dims={"N": N_MESH}, device="cpu", init_params=ott.InitializationParameters(
            preconditioner="block_jacobi"))
    meta, r0, pre, kw = plan.batched_cg_inputs(dict(INPUTS))
    b, prem = fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)
    pbm = fused_cg.pack_pre_blocks(kw["pre_blocks"], meta)
    if bad == "blk":  # one system's blocks where the batch's are due
        meta = dict(meta, rem=dict(meta["rem"], blk=meta["rem"]["blk"][0].contiguous()))
    elif bad == "pre_blocks":
        pbm = pbm[0].contiguous()
    return meta, b, prem, pbm


@pytest.mark.parametrize("bad", ["blk", "pre_blocks", "none"])
def test_batched_operands_are_checked_before_any_launch(monkeypatch, bad):
    """A batched launch whose remainder blocks or block-Jacobi planes lack
    the batch axis raises naming the operand before the library is loaded;
    well-formed operands pass every check and stop only at the device
    (these are CPU tensors)."""
    def no_library(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load_library", no_library)
    meta, b, prem, pbm = _operands(bad)
    assert meta["batch"] == B
    match = {"blk": r"blk has shape \(\d+, 6, 6\), expected \(2, \d+, 6, 6\)",
             "pre_blocks": "pre_blocks has shape", "none": "needs CUDA tensors"}[bad]
    with pytest.raises(ValueError, match=match):
        fused_cg.fused_grid_cg_kernel(meta, b, prem, 10, 1e-8, pre_blocks=pbm)


def test_batched_kernel_form_counts_blocks(monkeypatch):
    """The form a batch takes counts a system's values: its elements, its
    remainder's nnz·C·C block values and its C·C preconditioner planes; a
    form exists for every operator."""
    meta, b, _prem, pbm = _operands("none")
    C, points = int(meta["ctot"]), N_MESH
    nnz = int(meta["rem"]["col"].shape[0])
    values = C * points + nnz * C * C
    for blocks, extra in ((None, 0), (pbm, C * C * points)):
        for limit, want in ((values + extra, "batch"), (values + extra - 1, "multi")):
            monkeypatch.setattr(fused_cg, "BATCH_BLOCK_ELEMS", limit)
            assert fused_cg.batched_kernel_form(meta, blocks) == want
