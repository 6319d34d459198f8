"""The tiled CG kernel's Jacobi instances over several systems in turn
(csrc/tiled_grid_cg.cu: ``gn_multi_tiled``, ``lm_multi_tiled``) on the CPU:
the per-channel split, whose C channels are C one-channel systems over the
shared fields, and a batch in the multi form, whose B systems have their
own fields.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template's ``gn_multi``/``lm_multi`` there). Here: which
launches the route takes and at what plan; the emulation of the systems
in turn (tests/test_torch_tiled_cg.py::emulate a system at a time, on the
same tiles, with the shared F for the split and each system's own F for
the batch) held bitwise to the twin ``fused_grid_cg_reference`` with
``n_sys`` = C and with ``batched=True``, to the JAX package's Pallas kernel
with ``chan_grid=True`` in interpret mode (1e-6, 1e-5 at a ζ exit) and to
the Pallas kernel under ``jax.vmap``; and the wrapper's host-side contract
on the CPU."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.test_torch_batched import _jax_vmapped, _lap, _wide_margin_tol
from tests.test_torch_cg_variants import jax_cg_call, poisson_inputs
from tests.test_torch_chan_split import DIMS, _pallas_split, lowered  # noqa: F401
from tests.test_torch_chan_split import N as SPLIT_N
from tests.test_torch_tiled_cg import (
    N,
    RESET,
    SMEM,
    SMS,
    _forced_plan,
    _iw_inputs,
    _pack,
    _synthetic_meta,
    emulate,
)
from tests.test_torch_tiled_bj import VMAP_RTOL, _moved

torch.set_num_threads(2)

SPLIT_ATOL = 1e-6  # tests/test_torch_chan_split.py: δ against Pallas chan_grid (max|δ| is 1)
SPLIT_Q_ATOL = 1e-5  # the same at a ζ exit (test_lm_q_exit_is_each_channels_own)
LAP_ATOL = 1e-6  # tests/test_torch_batched.py::test_k1h_twin_matches_pallas_under_vmap
BATCH = 3
KINDS = {"GN": "gaussNewtonGPU", "LM": "LMGPU"}
# poisson 48²×4 as tests/test_torch_chan_split.py draws it, an object of this
# file's (jax_cg_call caches a system by its inputs' identity, and this one
# is only ever drawn under the lowered split criterion)
POISSON = poisson_inputs(SPLIT_N)


# -- systems --------------------------------------------------------------------------


def radius2_rgb_spec(S):
    """A three-channel second-neighbour stencil with channel-identical
    fields and the Jacobi preconditioner: it splits under a lowered
    criterion, each system with a halo of two."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 3, (W, H))
    A = S.Array("A", 3, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ott.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ott.Select(ott.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def radius2_spec(S):
    """tests/test_torch_tiled_cg.py::radius2_spec with a spatially varying
    fit weight, so that a batch's instances differ in their fields."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    Wt = S.Array("Wt", 1, (W, H))
    S.Energy(Wt(0, 0) * (X(0, 0) - A(0, 0)))
    for dx, dy in ott.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ott.Select(ott.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def _lm(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


def _poisson_split(kind):
    """poisson 48²×4's first system through the JAX package under the lowered
    criterion (its chan_grid form: five one-channel triples over the shared
    fields), as (the JAX call, meta, b [4, N, N], pre, ctc or None)."""
    call = jax_cg_call("poisson_image_editing", DIMS, POISSON, KINDS[kind])
    jmeta, r0, pre, kw = call
    meta = meta_from_numpy(jmeta, device="cpu")
    assert meta["chan_grid"] and meta["ctot"] == 4 and len(meta["triples"]) == 5
    ctc = _pack(kw["ctc"], meta) if "ctc" in kw else None
    return call, meta, _pack(r0, meta), _pack(pre, meta), ctc


def _radius2_split(kind, w=23, h=19):
    """The three-channel radius-2 stencil on a ragged 23×19, split by the
    port's own planner under a lowered criterion: (meta, b [3, w, h], pre,
    ctc or None)."""
    rng = np.random.RandomState(7)
    inputs = {"X": rng.rand(w, h, 3).astype(np.float32),
              "A": rng.rand(w, h, 3).astype(np.float32)}
    saved = fused_cg.SPLIT_WORKING_SET_BYTES
    # 20 planes: the joint loop's 7·3 + T are beyond it, one channel's 7 + T not
    fused_cg.SPLIT_WORKING_SET_BYTES = 4 * w * h * 20
    try:
        plan = ott.Problem(radius2_rgb_spec, kind=KINDS[kind]).plan(dims={"W": w, "H": h},
                                                                    device="cpu")
        meta, r0, pre, kw = plan.cg_inputs(inputs)
    finally:
        fused_cg.SPLIT_WORKING_SET_BYTES = saved
    assert meta["chan_grid"] and meta["ctot"] == 3
    assert all(i == j == 0 for (_d, i, j, _f) in meta["triples"])
    ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), ctc


def _iw_batch(kind, lattice=False):
    """image_warping 24²'s first systems over BATCH instances (the fit
    constraints moved, tests/test_torch_tiled_bj.py::_moved) through the JAX
    package, Jacobi: (the JAX calls, batched meta F [B, T, N, N], b, pre,
    ctc or None)."""
    calls = [jax_cg_call("image_warping", {"W": N, "H": N}, inp, KINDS[kind])
             for inp in _iw_batch_inputs(lattice)]
    metas = [meta_from_numpy(c[0], device="cpu") for c in calls]
    for m in metas[1:]:
        assert m["triples"] == metas[0]["triples"]
    meta = dict(metas[0], F=torch.stack([m["F"] for m in metas]), batch=BATCH)
    b = torch.stack([_pack(c[1], m) for c, m in zip(calls, metas)])
    pre = torch.stack([_pack(c[2], m) for c, m in zip(calls, metas)])
    ctc = (torch.stack([_pack(c[3]["ctc"], m) for c, m in zip(calls, metas)])
           if kind == "LM" else None)
    return calls, meta, b, pre, ctc


_IW_BATCH_INPUTS = {}


def _iw_batch_inputs(lattice):
    """The batch's inputs, bench-like or lattice (kept, so that
    jax_cg_call's cache by identity holds)."""
    if lattice not in _IW_BATCH_INPUTS:
        base = _iw_inputs(lattice)
        _IW_BATCH_INPUTS[lattice] = [_moved(base, k) for k in range(BATCH)]
    return _IW_BATCH_INPUTS[lattice]


def _lap_batch(kind):
    """4 × laplacian 16² with per-instance fields and damping
    (tests/test_torch_batched.py::_lap), in the port's batched layout."""
    meta_np, r0, pre, ctc = _lap()
    meta = meta_from_numpy(meta_np, device="cpu", batch=True)
    pack = lambda a: torch.as_tensor(np.moveaxis(a, -1, 1).copy())  # noqa: E731
    return meta, pack(r0), pack(pre), pack(ctc) if kind == "LM" else None


def _radius2_batch(kind, w=23, h=19):
    """BATCH instances of the radius-2 stencil on a ragged 23×19, each with
    its own data and fit weights, by the port's batched assembly: (batched
    meta, b [B, 1, w, h], pre, ctc or None)."""
    rng = np.random.RandomState(9)
    inputs = {k: rng.rand(BATCH, w, h).astype(np.float32) for k in ("X", "A")}
    inputs["Wt"] = (0.2 + rng.rand(BATCH, w, h)).astype(np.float32)
    plan = ott.Problem(radius2_spec, kind=KINDS[kind]).plan(dims={"W": w, "H": h}, device="cpu")
    meta, r0, pre, kw = plan.batched_cg_inputs(inputs)
    assert meta["batch"] == BATCH
    ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), ctc


def emulate_systems(meta, b, pre, lits, tol, plan, ctc=None, **lm):
    """The multi-system instances' loop: the launch's systems in turn on the
    same tiles, each with its own exit and count (the kernel's loop over
    n_sys). The split's system s is channel s over the shared F; a batch's
    system k is instance k with its own F. Returns (δ as b, counts)."""
    out, counts = [], []
    for s in range(int(b.shape[0])):
        if meta.get("batch"):
            F, bs, ps, cs = meta["F"][s], b[s], pre[s], None if ctc is None else ctc[s]
        else:
            sl = slice(s, s + 1)
            F, bs, ps, cs = meta["F"], b[sl], pre[sl], None if ctc is None else ctc[sl]
        d, l = emulate(F, meta["triples"], bs, ps, lits, tol, plan, ctc=cs, **lm)
        out.append(d)
        counts.append(l)
    return (torch.stack(out) if meta.get("batch") else torch.cat(out)), counts


def _twin_systems(meta, b, pre, lits, tol, ctc=None, **lm):
    """The twin over the launch's systems: (δ, counts, summed count)."""
    counts = []
    batch = int(meta.get("batch") or 0)
    d, total = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, pre, lits, tol, n_sys=batch or int(b.shape[0]),
        batched=bool(batch), counts=counts, ctc=ctc, **lm)
    assert total == sum(counts)
    return d, counts


def _halo(meta, b, lm):
    return fused_cg.route_plan(meta, b, lm=lm)["halo"]


@pytest.fixture
def multi_form(monkeypatch):
    """The batch tests' small systems (24²×3, 16², 23×19) sent to the multi
    form, which the route takes, as a batch of larger systems would be:
    BATCH_BLOCK_ELEMS lowered below their sizes."""
    monkeypatch.setattr(fused_cg, "BATCH_BLOCK_ELEMS", 64)


# -- plan and route --------------------------------------------------------------------


def _split_meta(n):
    """poisson n²×4 as the split plans it: the five one-channel triples over
    five shared fields (uninitialised: only their shape is read)."""
    triples = [(d, 0, 0, k) for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]
    meta = _synthetic_meta((1, 1), triples, chan_grid=True, ctot=4)
    meta["F"] = torch.empty((5, n, n))
    return meta, torch.empty((4, n, n))


@pytest.mark.parametrize("lm,smem", [(False, 131120), (True, 132576)])
def test_plan_takes_a_one_channel_split_at_1024(lm, smem):
    """One channel of poisson 1024²: 12×11 tiles of 86×94 and 131,120 B a
    block under GN, 132,576 B under LM (Ap haloed), within the H100's
    232,448 B; the route plans the split at one channel and names the
    multi-system instance."""
    meta, b = _split_meta(1024)
    plan = fused_cg.route_plan(meta, b, lm=lm)
    assert plan is not None and plan["tiles"] == (12, 11) and plan["tile"] == (86, 94)
    assert plan["halo"] == 1 and plan["smem_bytes"] == smem
    assert plan == fused_cg.tiled_grid_plan(meta, 1, (1024, 1024), lm=lm, sm_count=SMS,
                                            smem_per_block=SMEM)
    assert smem == fused_cg.tiled_smem_bytes(lm, 1, 86, 94, 1, 5)
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm" if lm else "gn") + "_multi_tiled"


@pytest.mark.parametrize("lm", [False, True])
def test_plan_refuses_a_2048_split(lm):
    """One channel of 2048² needs 514,832 B a block under GN: the split
    keeps the template's multi-system instance."""
    meta, b = _split_meta(2048)
    assert fused_cg.tiled_smem_bytes(False, 1, 171, 187, 1, 5) == 514832
    assert fused_cg.route_plan(meta, b, lm=lm) is None
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm" if lm else "gn") + "_multi"


@pytest.mark.parametrize("lm", [False, True])
def test_plan_takes_a_batch_at_the_one_system_plan(lm):
    """4 × poisson 512²×4 (20 triples, 5 fields a system), Jacobi: the multi
    form at each system's own plan, gn_tiled's 12×11 tiles of 43×47 and
    132,740 B under GN."""
    n, B = 512, 4
    triples = [(d, c, c, k) for c in range(4)
               for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]
    one = _synthetic_meta((1, 1), triples, ctot=4)
    one["F"] = torch.empty((5, n, n))
    meta = dict(one, F=torch.empty((B, 5, n, n)), batch=B)
    b = torch.empty((B, 4, n, n))
    assert fused_cg.batched_kernel_form(meta) == "multi"
    plan = fused_cg.route_plan(meta, b, lm=lm)
    assert plan == fused_cg.route_plan(one, b[0], lm=lm) == fused_cg.tiled_grid_plan(
        one, 4, (n, n), lm=lm, sm_count=SMS, smem_per_block=SMEM)
    assert plan["tiles"] == (12, 11) and plan["tile"] == (43, 47)
    if not lm:
        assert plan["smem_bytes"] == 132740
    name = "lm" if lm else "gn"
    assert fused_cg.launch_instance(one, b[0], lm=lm) == name + "_tiled"
    assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_multi_tiled"


def _multi_metas(form):
    """A split (poisson 64²×4) or a Jacobi batch in the multi form (4 ×
    64²×2): (meta, b)."""
    if form == "split":
        return _split_meta(64)
    meta = _synthetic_meta((1, 1), [(d, c, c, k) for c in range(2) for k, d in enumerate(
        ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))], batch=4, ctot=2)
    meta["F"] = torch.zeros((4, 5, 64, 64))
    return meta, torch.zeros((4, 2, 64, 64))


@pytest.mark.parametrize("form", ["split", "batch"])
@pytest.mark.parametrize("lm", [False, True])
def test_route_keeps_cs_and_bf16_systems_in_turn_on_the_template(form, lm):
    """Chronopoulos–Gear and bfloat16 fields over several systems keep the
    template's gn_cs_multi, gn_bf16_multi (and LM's); the standard float32
    loop takes the tiled one."""
    meta, b = _multi_metas(form)
    name = "lm" if lm else "gn"
    assert fused_cg.route_plan(meta, b, lm=lm) is not None
    assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_multi_tiled"
    assert fused_cg.route_plan(meta, b, lm=lm, cs=True) is None
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == name + "_cs_multi"
    bf = dict(meta, F=meta["F"].to(torch.bfloat16))
    assert fused_cg.route_plan(bf, b, lm=lm) is None
    assert fused_cg.launch_instance(bf, b, lm=lm) == name + "_bf16_multi"
    assert fused_cg.tiled_grid_plan(bf, 1, (64, 64), lm=lm, sm_count=SMS,
                                    smem_per_block=SMEM) is None


def test_route_keeps_the_split_under_block_jacobi_and_the_batch_form_on_the_template():
    """The split with the block preconditioner (which the template refuses
    too) is not taken, and a batch of small systems is not taken by the
    tiled grid kernel: it goes to the batch kernel (gn_batch_tiled, a team
    of lanes a system, tests/test_torch_tiled_batch.py), and under
    Chronopoulos–Gear to the template's one block a system."""
    meta, _b = _split_meta(64)
    assert fused_cg.tiled_grid_plan(meta, 1, (64, 64), lm=False, block=True, sm_count=SMS,
                                    smem_per_block=SMEM) is None
    small = _synthetic_meta((1, 1), [((0, 0), 0, 0, 0), ((1, 0), 0, 0, 1)], batch=4, ctot=1)
    small["F"] = torch.zeros((4, 2, 16, 16))
    b = torch.zeros((4, 1, 16, 16))
    assert fused_cg.batched_kernel_form(small) == "batch"
    assert fused_cg.route_plan(small, b, lm=False)["layout"] == "batch"
    assert fused_cg.launch_instance(small, b) == "gn_batch_tiled"
    assert fused_cg.route_plan(small, b, lm=False, cs=True) is None
    assert fused_cg.launch_instance(small, b, cs=True) == "gn_cs_batch"


@pytest.mark.parametrize("form", ["split", "batch"])
@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_kernel_wrapper_refuses_cpu_tensors_on_the_routed_multi_form(multi_form, form, kind):
    """A routed split or Jacobi batch reaches the tiled wrapper, whose device
    check raises for CPU tensors: nothing gives way to the template or to
    the twin."""
    if form == "split":
        _call, meta, b, pre, ctc = _poisson_split_lowered(kind)
    else:
        _calls, meta, b, pre, ctc = _iw_batch(kind)
    assert fused_cg.launch_instance(meta, b, lm=ctc is not None) == (
        kind.lower() + "_multi_tiled")
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **_lm(ctc, 1e-4))


def _poisson_split_lowered(kind):
    """_poisson_split under the lowered criteria, for tests without the
    fixture."""
    saved = pcg.VMEM_BUDGET_BYTES, fused_cg.SPLIT_WORKING_SET_BYTES
    pcg.VMEM_BUDGET_BYTES = 30 * pcg.padded_spatial_elems((SPLIT_N, SPLIT_N)) * 4
    fused_cg.SPLIT_WORKING_SET_BYTES = 30 * 4 * SPLIT_N * SPLIT_N
    try:
        return _poisson_split(kind)
    finally:
        pcg.VMEM_BUDGET_BYTES, fused_cg.SPLIT_WORKING_SET_BYTES = saved


def test_wrapper_checks_the_systems_operands():
    """The split's and the batch's operands against their forms: a split's
    pre a channel short, a batch's pre without its batch axis, a split's
    triple on a second channel, the split with the block preconditioner."""
    _call, meta, b, pre, _ctc = _poisson_split_lowered("GN")
    plan = _forced_plan(SPLIT_N, SPLIT_N, 3, 2, 1)
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre[:3], 10, 0.0, plan)
    two = dict(meta, triples=meta["triples"] + (((0, 0), 1, 1, 0),))
    with pytest.raises(ValueError, match="out of range"):
        fused_cg.tiled_grid_cg_kernel(two, b, pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="split with the block preconditioner"):
        fused_cg.tiled_grid_cg_kernel(meta, b, None, 10, 0.0, plan,
                                      pre_blocks=torch.zeros((16, SPLIT_N, SPLIT_N)))
    _calls, bmeta, bb, bpre, _c = _iw_batch("GN")
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_grid_cg_kernel(bmeta, bb, bpre[0], 10, 0.0, _forced_plan(N, N, 3, 2, 1))


# -- the emulation against the twin, bitwise ------------------------------------------

# (system, tiles, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM), the
# real exits (each channel its own count), LM's ζ exit; 3×2 tiles, tiles left
# ragged by the split (5×4 of 48², 3×2 of 23×19), one tile
_SPLIT_CASES = [
    ("poisson GN", (3, 2), 40, 0.0, None),
    ("poisson GN", (3, 2), 400, 1e-12, None),
    ("poisson GN", (5, 4), 40, 0.0, None),
    ("poisson GN", (1, 1), 40, 0.0, None),
    ("poisson LM", (3, 2), 40, 0.0, -np.inf),
    ("poisson LM", (5, 4), 400, 1e-12, -np.inf),
    ("poisson LM", (3, 2), 400, 1e-12, 1e-2),
    ("radius2 GN", (3, 2), 40, 0.0, None),
    ("radius2 GN", (3, 2), 400, 1e-12, None),
    ("radius2 LM", (3, 2), 40, 0.0, -np.inf),
    ("radius2 LM", (3, 2), 400, 1e-12, 1e-4),
]


@pytest.mark.parametrize("name,tiles,lits,tol,q_tol", _SPLIT_CASES)
def test_split_emulation_is_bitwise_the_twin(lowered, name, tiles, lits, tol, q_tol):  # noqa: F811
    """The split's channels in turn, each a one-channel system over the
    shared fields with its own exit and count, against the twin with n_sys
    = C: δ bitwise, count for count."""
    system, kind = name.split()
    if system == "poisson":
        _call, meta, b, pre, ctc = _poisson_split(kind)
    else:
        meta, b, pre, ctc = _radius2_split(kind)
    C, N1, N2 = b.shape
    h = _halo(meta, b, ctc is not None)
    assert h == (2 if system == "radius2" else 1)
    plan = _forced_plan(N1, N2, *tiles, h)
    lm = {} if ctc is None else dict(reset_period=RESET, q_tolerance=q_tol)
    de, counts = emulate_systems(meta, b, pre, lits, tol, plan, ctc, **lm)
    dt, twin_counts = _twin_systems(meta, b, pre, lits, tol, ctc, **lm)
    assert counts == twin_counts and len(counts) == C
    if tol == 0.0:
        assert counts == [lits] * C
    else:
        assert all(2 < c < lits for c in counts)
    if system == "poisson" and tol != 0.0 and q_tol != 1e-2:
        assert len(set(counts)) > 1  # the channels leave at their own iterations
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())
    if ctc is not None and tol == 0.0:
        assert lits > 3 * RESET  # resets occurred in every system


_BATCH_CASES = [
    ("image_warping GN", (3, 2), 30, 0.0, None),
    ("image_warping GN", (3, 2), 400, 1e-12, None),
    ("image_warping GN", (5, 4), 30, 0.0, None),
    ("image_warping LM", (5, 4), 30, 0.0, -np.inf),
    ("image_warping LM", (3, 2), 400, 1e-12, 1e-4),
    ("laplacian GN", (3, 2), 40, 0.0, None),
    ("laplacian LM", (2, 2), 60, 1e-12, 1e-3),
    ("radius2 GN", (3, 2), 40, 0.0, None),
    ("radius2 GN", (3, 2), 400, 1e-12, None),
    ("radius2 LM", (3, 2), 40, 0.0, -np.inf),
]


def _batch_system(name):
    system, kind = name.split()
    if system == "image_warping":
        return _iw_batch(kind)[1:]
    if system == "laplacian":
        return _lap_batch(kind)
    return _radius2_batch(kind)


@pytest.mark.parametrize("name,tiles,lits,tol,q_tol", _BATCH_CASES)
def test_batch_emulation_is_bitwise_the_batched_twin(multi_form, name, tiles, lits, tol, q_tol):
    """A batch's systems in turn, each with its own fields, exit and count,
    against the batched twin (n_sys = B, batched=True): δ bitwise, count
    for count."""
    meta, b, pre, ctc = _batch_system(name)
    B, _C, N1, N2 = b.shape
    h = _halo(meta, b, ctc is not None)
    assert h == (2 if name.startswith("radius2") else 1)
    assert fused_cg.launch_instance(meta, b, lm=ctc is not None) == (
        ("lm" if ctc is not None else "gn") + "_multi_tiled")
    plan = _forced_plan(N1, N2, *tiles, h)
    lm = {} if ctc is None else dict(reset_period=RESET, q_tolerance=q_tol)
    de, counts = emulate_systems(meta, b, pre, lits, tol, plan, ctc, **lm)
    dt, twin_counts = _twin_systems(meta, b, pre, lits, tol, ctc, **lm)
    assert counts == twin_counts and len(counts) == B
    if tol == 0.0:
        assert counts == [lits] * B
    else:
        assert all(2 < c < lits for c in counts)
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())


# -- the emulation against the JAX package ---------------------------------------------


@pytest.mark.parametrize("kind", ["GN", "LM"])
@pytest.mark.parametrize("exit_", ["none", "real"])
def test_split_emulation_matches_pallas_chan_grid(lowered, kind, exit_):  # noqa: F811
    """The split's channels in turn on 3×2 tiles against the Pallas kernel
    with chan_grid=True in interpret mode (tests/test_torch_chan_split.py's
    comparison): with no exit after 40 iterations a channel, and with the
    real exits (LM's ζ exit off): each channel's count equal, δ within
    SPLIT_ATOL (max|δ| is 1)."""
    call, meta, b, pre, ctc = _poisson_split(kind)
    over = dict(q_tolerance=-np.inf) if kind == "LM" else {}
    lits, tol = (40, 0.0) if exit_ == "none" else (400, 1e-12)
    jd, jtotal, jcounts = _pallas_split(call, lits, tol, **over)
    lm = {} if ctc is None else dict(reset_period=int(call[3]["reset_period"]),
                                     q_tolerance=-np.inf)
    de, counts = emulate_systems(meta, b, pre, lits, tol, _forced_plan(SPLIT_N, SPLIT_N, 3, 2, 1),
                                 ctc, **lm)
    assert counts == jcounts and sum(counts) == jtotal
    if exit_ == "none":
        assert counts == [40] * 4
    else:
        assert all(5 < c < 400 for c in counts) and len(set(counts)) > 1
    np.testing.assert_allclose(de.numpy(), jd, rtol=0, atol=SPLIT_ATOL)


def test_split_lm_q_exit_matches_pallas_chan_grid(lowered):  # noqa: F811
    """With a loose q_tolerance each channel leaves by its own ζ exit, at
    the Pallas kernel's counts; δ within SPLIT_Q_ATOL."""
    call, meta, b, pre, ctc = _poisson_split("LM")
    jd, jtotal, jcounts = _pallas_split(call, 400, 1e-12, q_tolerance=1e-2)
    de, counts = emulate_systems(meta, b, pre, 400, 1e-12,
                                 _forced_plan(SPLIT_N, SPLIT_N, 5, 4, 1), ctc,
                                 reset_period=int(call[3]["reset_period"]), q_tolerance=1e-2)
    assert counts == jcounts and sum(counts) == jtotal and max(counts) < 100
    np.testing.assert_allclose(de.numpy(), jd, rtol=0, atol=SPLIT_Q_ATOL)


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_batch_emulation_matches_pallas_under_vmap_laplacian(kind):
    """4 × laplacian 16² with per-instance fields: the systems in turn on
    3×2 tiles against the Pallas kernel under jax.vmap (interpret mode), with
    the real exits where every instance crosses its threshold by a wide
    margin (tests/test_torch_batched.py::test_k1h_twin_matches_pallas_under_vmap):
    counts equal instance by instance, δ within LAP_ATOL."""
    meta_np, r0, pre_np, ctc_np = _lap()
    meta, b, pre, ctc = _lap_batch(kind)
    lits = 60
    if kind == "GN":
        tol, lm, c = _wide_margin_tol(meta_np, r0, pre_np), {}, None
    else:
        tol, c = 1e-12, ctc_np
        lm = dict(reset_period=10, q_tolerance=_wide_margin_tol(meta_np, r0, pre_np, ctc_np))
    jd, jcounts = _jax_vmapped(meta_np, r0, pre_np, lits, tol, c, **lm)
    de, counts = emulate_systems(meta, b, pre, lits, tol, _forced_plan(16, 16, 3, 2, 1), ctc, **lm)
    assert counts == jcounts and max(counts) < lits
    np.testing.assert_allclose(de.numpy(), jd, rtol=0, atol=LAP_ATOL)


# image_warping's lattice inputs, whose iterates hardly depend on the dots'
# sum order (tests/test_torch_tiled_cg.py::_iw_inputs), over BATCH instances:
# GN with no exit and with the real exit, LM with no exit
@pytest.mark.parametrize("kind,lits,tol,q_tol", [
    ("GN", 25, 0.0, None),
    ("GN", 60, 1e-8, None),
    ("LM", 25, 0.0, -np.inf),
])
def test_batch_emulation_matches_pallas_under_vmap_image_warping(kind, lits, tol, q_tol):
    """The systems in turn on 3×2 tiles against the Pallas kernel under
    jax.vmap over the batch (interpret mode): counts equal, δ within
    VMAP_RTOL · max|δ| (tests/test_torch_tiled_bj.py's tolerance)."""
    calls, meta, b, pre, ctc = _iw_batch(kind, lattice=True)
    jmeta = calls[0][0]
    st = lambda i: {u: np.stack([c[i][u] for c in calls]) for u in calls[0][i]}  # noqa: E731
    jF = np.stack([c[0]["F"] for c in calls])
    jctc = ({u: np.stack([c[3]["ctc"][u] for c in calls]) for u in calls[0][3]["ctc"]}
            if ctc is not None else None)

    def one(F, r, p, c):
        kw = {} if c is None else dict(ctc=c, reset_period=RESET, q_tolerance=q_tol)
        return pcg.fused_grid_cg(dict(jmeta, F=F), r, p, lits, tol, interpret=True, **kw)

    jd, ji = jax.device_get(jax.vmap(one)(jF, st(1), st(2), jctc))
    lm = {} if ctc is None else dict(reset_period=RESET, q_tolerance=q_tol)
    de, counts = emulate_systems(meta, b, pre, lits, tol, _forced_plan(N, N, 3, 2, 1), ctc, **lm)
    assert counts == np.asarray(ji).reshape(-1).tolist()
    assert counts == [lits] * BATCH if tol == 0.0 else all(2 < c < lits for c in counts)
    for k in range(BATCH):
        want = _pack({u: v[k] for u, v in jd.items()}, meta)
        np.testing.assert_allclose(de[k].numpy(), want.numpy(), rtol=0,
                                   atol=VMAP_RTOL * float(want.abs().max()))

