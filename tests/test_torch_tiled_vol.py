"""The 3-D grid kernel's route and decomposition (csrc/tiled_vol_cg.cu:
``gn_vol_tiled``, ``gn_bj_vol_tiled``).

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template there). Here: which launches ``tiled_vol_plan``
takes and how ``_box_split`` cuts the grid; an emulation in plain PyTorch
that follows the kernel's decomposition box by box (each box's fields and
preconditioner staged over the box only, its r, δ and Ap of its own points,
p over the box and a halo of h, only z = M⁻¹r's shell exchanged through a
grid-sized array that is NaN off the shells, p formed over the halo from
it) held bitwise to the twin ``fused_grid_cg_reference`` on volumetric
systems, Jacobi and block-Jacobi, with forced plans that leave boxes uneven
and one point wide, and to the JAX package's Pallas kernel in its 3-D form
in interpret mode; and the wrapper's host-side contract on the CPU."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
from opt_tpu_torch.ops import _build, fused_cg
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy
from tests.test_torch_cg_variants import _pack, jax_cg_call, tplan
from tests.test_torch_volumetric import VOL, vol_inputs

torch.set_num_threads(2)

SMS, SMEM = fused_cg.SM90_LIMITS  # the H100 SXM's SMs and opt-in shared memory a block
JAX_RTOL = 1e-6  # δ against the Pallas kernel, whose dots sum in another order
BJ = {"preconditioner": "block_jacobi"}
_JAX_INPUTS = vol_inputs()  # the JAX package's system at 8³ (jax_cg_call caches it by identity)


# -- systems --------------------------------------------------------------------------


def _vol_inputs(shape):
    """tests/test_torch_volumetric.py::vol_inputs on a grid of any shape:
    one corner pinned, the opposite one pulled, the rest unconstrained."""
    rng = np.random.RandomState(2)
    ur = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1).astype(
        np.float32)
    con = -1e6 * np.ones(tuple(shape) + (3,), np.float32)
    con[0, 0, 0] = ur[0, 0, 0]
    con[-1, -1, -1] = ur[-1, -1, -1] + [1.0, 0.5, 0.0]
    return {
        "Offset": ur + rng.rand(*shape, 3).astype(np.float32) * 0.05,
        "Angle": np.zeros(tuple(shape) + (3,), np.float32), "UrShape": ur, "Constraints": con,
        "w_fitSqrt": np.sqrt(2.0).astype(np.float32), "w_regSqrt": np.sqrt(1.0).astype(np.float32),
    }


_SYSTEMS = {}


def _system(shape, pre="jacobi"):
    """The port's first volumetric GN system on the grid ``shape`` (W, H,
    D): (meta, b, pre or None, pre_blocks or None), packed."""
    key = (tuple(shape), pre)
    if key not in _SYSTEMS:
        inputs = vol_inputs(shape[0]) if len(set(shape)) == 1 else _vol_inputs(shape)
        plan = tplan(VOL, dict(zip("WHD", shape)), **({} if pre == "jacobi" else BJ))
        meta, r0, p, kw = plan.cg_inputs(inputs_from_numpy(inputs, device="cpu"))
        pb = kw["pre_blocks"]
        _SYSTEMS[key] = (meta, fused_cg.pack(r0, meta),
                         None if pb is not None else fused_cg.pack(p, meta),
                         None if pb is None else fused_cg.pack_pre_blocks(pb, meta))
    return _SYSTEMS[key]


def _synthetic_meta(dom, n_fields, triples, **extra):
    return dict({"F": torch.empty((n_fields,) + tuple(dom)), "triples": tuple(triples),
                 "rem": None, "chan_grid": False}, **extra)


# -- the emulation ---------------------------------------------------------------------


def _shell(extent, h):
    """The box's points within h of one of its faces: what a block writes
    of z."""
    idx = [torch.arange(n) for n in extent]
    z, y, x = idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]
    return ((z < h) | (z >= extent[0] - h) | (y < h) | (y >= extent[1] - h) | (x < h)
            | (x >= extent[2] - h))


def emulate(F, triples, b, pre, lits, tol, plan, *, pre_blocks=None, guard_div=True):
    """The 3-D grid kernel's loop in plain PyTorch, box by box: each box
    stages its fields and its preconditioner (``pre``, or the C·C planes
    ``pre_blocks``) over its own points only and keeps r, δ and Ap of its
    points and p over its points and a halo of h (zero beyond the grid).
    After the update, z = M⁻¹r of each box's shell goes to a grid-sized
    array that is NaN elsewhere, so a read off the shells shows; each box
    forms p = z + β·p over its halo from that array, over its own points
    from its own z. The first p is z₀ = M⁻¹b, exchanged the same way. Sums
    of the stencil start at +0 over the triples of the output channel in
    their order; dots are taken over the whole grid as the twin's ``_dot``
    takes them, and the scalar steps are the twin's. Returns (δ,
    iterations)."""
    C, N0, N1, N2 = (int(s) for s in b.shape)
    h = plan["halo"]
    boxes = fused_cg.box_bounds(plan, N0, N1, N2)
    by_chan = [[t for t in triples if t[1] == c] for c in range(C)]
    planes = pre if pre_blocks is None else pre_blocks

    def crop(t, bx):
        (z0, z1), (y0, y1), (x0, x1) = bx
        return t[:, z0:z1, y0:y1, x0:x1]

    def ext(t, bx):
        (z0, z1), (y0, y1), (x0, x1) = bx
        padded = torch.nn.functional.pad(t, (h,) * 6)
        return padded[:, z0:z1 + 2 * h, y0:y1 + 2 * h, x0:x1 + 2 * h].clone()

    def on_grid(bx):  # the haloed frame's points inside the grid
        (z0, z1), (y0, y1), (x0, x1) = bx
        z = torch.arange(z0 - h, z1 + h)[:, None, None]
        y = torch.arange(y0 - h, y1 + h)[None, :, None]
        x = torch.arange(x0 - h, x1 + h)[None, None, :]
        return (z >= 0) & (z < N0) & (y >= 0) & (y < N1) & (x >= 0) & (x < N2)

    def inner(e):
        return e[:, h:e.shape[1] - h, h:e.shape[2] - h, h:e.shape[3] - h]

    def extent(bx):
        return tuple(hi - lo for lo, hi in bx)

    def prec(m, x):  # z = M⁻¹ x over a box, m the box's staged planes
        return m * x if pre_blocks is None else fused_cg._block_prec(m)(x)

    def apply(Fb, pe, bx):
        r0, r1, r2 = extent(bx)
        out = []
        for c in range(C):
            a = torch.zeros((r0, r1, r2))
            for d, _i, j, fid in by_chan[c]:
                a = a + Fb[fid] * pe[j, h + d[0]:h + d[0] + r0, h + d[1]:h + d[1] + r1,
                                     h + d[2]:h + d[2] + r2]
            out.append(a)
        return torch.stack(out)

    def glob(parts):
        g = torch.full_like(b, float("nan"))
        for bx, v in zip(boxes, parts):
            (z0, z1), (y0, y1), (x0, x1) = bx
            g[:, z0:z1, y0:y1, x0:x1] = v
        return g

    def shells(parts):  # z_ring: each box's shell, NaN elsewhere
        g = torch.full_like(b, float("nan"))
        for bx, v in zip(boxes, parts):
            (z0, z1), (y0, y1), (x0, x1) = bx
            m = _shell(extent(bx), h)
            g[:, z0:z1, y0:y1, x0:x1] = torch.where(m, v, g[:, z0:z1, y0:y1, x0:x1])
        return g

    def frames(z, beta, pe):
        """p = z + β·p over each frame (p = z under ``pe`` None), z over
        the halo from the shells, 0 beyond the grid."""
        ring = shells(z)
        out = []
        for k, bx in enumerate(boxes):
            zh = ext(ring, bx)
            inner(zh).copy_(z[k])
            new = zh if pe is None else zh + beta * pe[k]
            out.append(torch.where(on_grid(bx), new, 0.0))
        return out

    Fs = [crop(F.float(), bx) for bx in boxes]  # staged once a solve, over the box only
    ms = [crop(planes, bx) for bx in boxes]
    r = [crop(b, bx).clone() for bx in boxes]
    d = [torch.zeros_like(x) for x in r]
    z = [prec(m, rk) for m, rk in zip(ms, r)]
    pe = frames(z, None, None)
    rz = fused_cg._dot(b, glob(z))
    floor = tol * rz
    l = 0
    while l < lits:
        Ap = [apply(Fb, p, bx) for Fb, p, bx in zip(Fs, pe, boxes)]
        den = fused_cg._dot(glob([inner(p) for p in pe]), glob(Ap))
        alpha = fused_cg.safe_div(rz, den, guard_div)
        d = [dk + alpha * inner(pk) for dk, pk in zip(d, pe)]
        r = [rk - alpha * ak for rk, ak in zip(r, Ap)]
        z = [prec(m, rk) for m, rk in zip(ms, r)]
        rz_new = fused_cg._dot(glob(z), glob(r))
        beta = fused_cg.safe_div(rz_new, rz, guard_div)
        pe = frames(z, beta, pe)
        rz = rz_new
        l += 1
        if bool((rz_new <= floor) | (den <= 0)):
            break
    return glob(d), l


def _twin(meta, b, pre, pb, lits, tol):
    return fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                            pre_blocks=pb)


# -- the emulation against the twin, bitwise ------------------------------------------

# (grid, preconditioner, boxes or None for the planner's, lits, tol): no exit
# (tol 0) and the real exits; the planner's split of 8³ (3 boxes of 3×8×8,
# the last 2 wide), even boxes of 4³, boxes one point wide along each axis,
# one box, and a 7×8×9 grid cut unevenly (3×3×3 boxes: the last ones one
# point wide along the first axis; 3×2×2 boxes of 3×4×5: ragged along the
# first and the last)
_CASES = [
    ((8, 8, 8), "jacobi", None, 30, 0.0),
    ((8, 8, 8), "jacobi", None, 400, 1e-12),
    ((8, 8, 8), "jacobi", (2, 2, 2), 30, 0.0),
    ((8, 8, 8), "jacobi", (8, 1, 1), 20, 0.0),
    ((8, 8, 8), "jacobi", (1, 8, 1), 20, 0.0),
    ((8, 8, 8), "jacobi", (1, 1, 8), 20, 0.0),
    ((8, 8, 8), "jacobi", (1, 1, 1), 30, 0.0),
    ((7, 8, 9), "jacobi", (3, 3, 3), 20, 0.0),
    ((7, 8, 9), "jacobi", (3, 2, 2), 400, 1e-12),
    ((8, 8, 8), "block_jacobi", None, 30, 0.0),
    ((8, 8, 8), "block_jacobi", None, 400, 1e-12),
    ((8, 8, 8), "block_jacobi", (2, 2, 2), 30, 0.0),
    ((8, 8, 8), "block_jacobi", (1, 8, 1), 20, 0.0),
    ((7, 8, 9), "block_jacobi", (3, 3, 3), 20, 0.0),
    ((7, 8, 9), "block_jacobi", (3, 2, 2), 400, 1e-12),
]


@pytest.mark.parametrize("dom,pre,boxes,lits,tol", _CASES)
def test_emulation_is_bitwise_the_twin(dom, pre, boxes, lits, tol):
    meta, b, p, pb = _system(dom, pre)
    C = int(b.shape[0])
    plan = fused_cg.tiled_vol_plan(meta, C, dom, lm=False, block=pb is not None, sm_count=SMS,
                                   smem_per_block=SMEM)
    assert plan is not None and plan["halo"] == 1
    if boxes is not None:
        plan = fused_cg.box_plan(dom, boxes, 1)
    de, le = emulate(meta["F"], meta["triples"], b, p, lits, tol, plan, pre_blocks=pb)
    dt, lt = _twin(meta, b, p, pb, lits, tol)
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())


def test_the_shell_is_what_the_halos_read():
    """Every halo point inside the grid lies on its owner's shell, on a
    split with boxes one point wide and uneven ones, at h = 1 and h = 2: the
    shell is all a neighbour reads, faces, edges and corners."""
    for dom, boxes, h in (((7, 8, 9), (3, 3, 3), 1), ((8, 8, 8), (8, 1, 1), 1),
                          ((9, 10, 11), (2, 3, 4), 2), ((6, 6, 6), (3, 3, 3), 2)):
        plan = fused_cg.box_plan(dom, boxes, h)
        bounds = fused_cg.box_bounds(plan, *dom)
        owner = torch.full(dom, -1, dtype=torch.long)
        on_shell = torch.zeros(dom, dtype=torch.bool)
        for k, bx in enumerate(bounds):
            (z0, z1), (y0, y1), (x0, x1) = bx
            owner[z0:z1, y0:y1, x0:x1] = k
            on_shell[z0:z1, y0:y1, x0:x1] = _shell((z1 - z0, y1 - y0, x1 - x0), h)
        read = torch.zeros(dom, dtype=torch.bool)
        for k, bx in enumerate(bounds):
            (z0, z1), (y0, y1), (x0, x1) = bx
            sl = tuple(slice(max(0, lo - h), min(n, hi + h)) for (lo, hi), n in zip(bx, dom))
            frame = torch.zeros(dom, dtype=torch.bool)
            frame[sl] = True
            frame[z0:z1, y0:y1, x0:x1] = False
            read |= frame
            assert bool((owner[frame] != k).all())
        assert bool(on_shell[read].all())
        assert int(read.sum()) > 0


# GN on the JAX package's first volumetric system at 8³ (the system its
# solver hands the Pallas kernel, carried across): the emulation on 2×2×2
# boxes against the Pallas kernel's 3-D form in interpret mode, Jacobi and
# block-Jacobi. The Pallas kernel sums its dots in another order: δ is held
# at JAX_RTOL of max|δ| after 8 iterations with no exit; by the real exit
# (tol 1e-8) that order has moved δ by up to 1.5e-6 of max|δ| under Jacobi,
# so there the counts are held equal and δ at EXIT_JAX_RTOL
# (tests/test_torch_volumetric.py holds the twin to Pallas at 1e-4 there)
EXIT_JAX_RTOL = 1e-5


@pytest.mark.parametrize("pre", ["jacobi", "block_jacobi"])
@pytest.mark.parametrize("lits,tol,rtol", [(8, 0.0, JAX_RTOL), (400, 1e-8, EXIT_JAX_RTOL)])
def test_emulation_matches_pallas_interpret(pre, lits, tol, rtol):
    n = 8
    jmeta, r0, jpre, kw = jax_cg_call(VOL, {"W": n, "H": n, "D": n}, _JAX_INPUTS,
                                      **({} if pre == "jacobi" else BJ))
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, **kw)
    meta = meta_from_numpy(jmeta, device="cpu")
    jd = _pack(jax.device_get(jd), meta)
    pb = None
    if pre == "block_jacobi":
        pb = fused_cg.pack_pre_blocks(torch.as_tensor(np.array(kw["pre_blocks"])), meta)
    de, le = emulate(meta["F"], meta["triples"], _pack(r0, meta),
                     None if pb is not None else _pack(jpre, meta), lits, tol,
                     fused_cg.box_plan((n, n, n), (2, 2, 2), 1), pre_blocks=pb)
    assert le == int(ji) and (le == lits if tol == 0.0 else 2 < le < lits)
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0,
                               atol=rtol * float(jd.abs().max()))



# -- plan and route --------------------------------------------------------------------


def _vol_triples():
    return _system((8, 8, 8))[0]["triples"]


@pytest.mark.parametrize("block,smem", [(False, 171484), (True, 202204)])
def test_plan_takes_volumetric_32(block, smem):
    """volumetric 32³×6 (128 fields, 142 triples, h = 1) on the H100: 8×4×4
    boxes of 4×8×8 points (128 blocks), its fields (131,072 B a box), r, δ,
    Ap (18,432 B), the haloed p (14,400 B) and the preconditioner over the
    box (6,144 B, or the 36 planes, 36,864 B) in shared memory."""
    dom = (32, 32, 32)
    meta = _synthetic_meta(dom, 128, _vol_triples())
    plan = fused_cg.tiled_vol_plan(meta, 6, dom, lm=False, block=block, sm_count=SMS,
                                   smem_per_block=SMEM)
    assert plan == {"boxes": (8, 4, 4), "box": (4, 8, 8), "halo": 1, "threads": 512,
                    "smem_bytes": smem, "layout": "vol"}
    assert smem == fused_cg.tiled_vol_smem_bytes(block, 6, 128, 4, 8, 8, 1, 142)
    assert smem - (36864 - 6144 if block else 0) == 272 + 1164 + 131072 + 18432 + 14400 + 6144
    b = torch.empty((6,) + dom)
    pb = torch.empty((36,) + dom) if block else None
    assert fused_cg.route_plan(meta, b, lm=False, pre_blocks=pb) == plan
    assert fused_cg.launch_instance(meta, b, pre_blocks=pb) == (
        "gn_bj_vol_tiled" if block else "gn_vol_tiled")
    # one byte less, and the launch keeps the template
    assert fused_cg.tiled_vol_plan(meta, 6, dom, lm=False, block=block, sm_count=SMS,
                                   smem_per_block=smem - 1) is None


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("case", ["lm", "cs", "bf16", "batch", "split", "64cubed", "rem"])
def test_plan_refuses_the_other_3d_forms(case, block):
    """LM, Chronopoulos–Gear, bfloat16 fields, a batch, the split, the
    remainder and volumetric 64³×6 (boxes of 8×16×16: 1,048,576 B of fields
    a box) keep the template, under either preconditioner, by name."""
    dom = (64, 64, 64) if case == "64cubed" else (32, 32, 32)
    meta = _synthetic_meta(dom, 128, _vol_triples())
    kw = dict(lm=case == "lm", cs=case == "cs", block=block, sm_count=SMS, smem_per_block=SMEM)
    C = 6
    b = torch.empty((C,) + dom)
    pb = torch.empty((C * C,) + dom) if block else None
    name = ("lm" if case == "lm" else "gn") + ("_cs" if case == "cs" else "") + (
        "_bj" if block else "")
    if case == "bf16":
        meta["F"] = meta["F"].to(torch.bfloat16)
        name += "_bf16"
    elif case == "batch":
        meta = dict(meta, batch=2, ctot=C, F=torch.empty((2, 128) + dom))
        b = torch.empty((2, C) + dom)
        pb = torch.empty((2, C * C) + dom) if block else None
        assert fused_cg.batched_kernel_form(meta, pb) == "multi"
        name += "_multi"
    elif case == "split":  # the planner never splits a coupled operator; refused all the same
        meta = dict(meta, chan_grid=True, ctot=C)
        C = 1
    elif case == "rem":
        meta["rem"] = {"rowptr": None, "col": None, "blk": None}
    assert fused_cg.tiled_vol_plan(meta, C, dom, **kw) is None
    if case not in ("split", "rem"):
        assert fused_cg.route_plan(meta, b, lm=case == "lm", cs=case == "cs",
                                   pre_blocks=pb) is None
        assert fused_cg.launch_instance(meta, b, lm=case == "lm", cs=case == "cs",
                                        pre_blocks=pb) == name


@pytest.mark.parametrize("dom,h", [((32, 32, 32), 1), ((6, 6, 6), 1), ((8, 8, 8), 1),
                                   ((7, 8, 9), 1), ((64, 64, 64), 1), ((20, 24, 28), 2),
                                   ((2, 100, 3), 1), ((5, 7, 300), 3)])
def test_boxes_cover_the_grid_once_within_the_sms(dom, h):
    """_box_split's boxes: a ceil split of each axis into at most 132,
    each box at least max(h, 1) wide on every axis, the grid covered once."""
    boxes, box = fused_cg._box_split(*dom, h, SMS)
    assert boxes[0] * boxes[1] * boxes[2] <= SMS
    assert box == tuple(-(-n // k) for n, k in zip(dom, boxes))
    plan = {"boxes": boxes, "box": box}
    hits = torch.zeros(dom, dtype=torch.int32)
    bounds = fused_cg.box_bounds(plan, *dom)
    assert len(bounds) == boxes[0] * boxes[1] * boxes[2]
    for bx in bounds:
        assert all(hi - lo >= max(h, 1) for lo, hi in bx)
        hits[tuple(slice(lo, hi) for lo, hi in bx)] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("dom,pre", [((32, 32, 32), "jacobi"), ((32, 32, 32), "block_jacobi"),
                                     ((6, 6, 6), "jacobi"), ((6, 6, 6), "block_jacobi")])
def test_box_plan_at_the_planners_boxes_is_the_planners_plan(dom, pre):
    """box_plan, which the forced splits use, gives tiled_vol_plan's own
    plan, shared memory included, at _box_split's boxes."""
    meta = _synthetic_meta(dom, 128, _vol_triples())
    block = pre == "block_jacobi"
    plan = fused_cg.tiled_vol_plan(meta, 6, dom, lm=False, block=block, sm_count=SMS,
                                   smem_per_block=SMEM)
    assert fused_cg.box_plan(dom, plan["boxes"], 1, meta, 6, block=block) == plan


@pytest.mark.parametrize("dom,boxes,h", [((8, 8, 8), (9, 1, 1), 1), ((7, 8, 9), (4, 1, 1), 2),
                                         ((8, 8, 8), (1, 1, 8), 2)])
def test_box_plan_refuses_a_box_narrower_than_the_halo(dom, boxes, h):
    """A split whose last box along some axis would be narrower than
    max(h, 1) (or empty) is refused, not planned."""
    with pytest.raises(ValueError, match="narrower than"):
        fused_cg.box_plan(dom, boxes, h)


def test_the_split_takes_the_smallest_haloed_box():
    """The largest haloed box is the fewest points any split within the SMs
    gives (counted up to the block's 512 threads), then the fewest boxes:
    6³ (the medium golden) is one box, its frame 8³ = 512; 8³ three boxes of
    3×8×8 (frames of 500)."""
    assert fused_cg._box_split(6, 6, 6, 1, SMS) == ((1, 1, 1), (6, 6, 6))
    assert fused_cg._box_split(8, 8, 8, 1, SMS) == ((3, 1, 1), (3, 8, 8))
    best = min((max((-(-32 // a) + 2) * (-(-32 // b) + 2) * (-(-32 // c) + 2), 512)
                for a in range(1, 33) for b in range(1, 33) for c in range(1, 33)
                if a * b * c <= SMS))
    boxes, box = fused_cg._box_split(32, 32, 32, 1, SMS)
    assert (box[0] + 2) * (box[1] + 2) * (box[2] + 2) == best == 600


def test_halo_is_the_largest_offset_on_any_axis():
    tr = [((0, 0, 0), 0, 0, 0), ((0, 0, 2), 0, 0, 1), ((-3, 0, 0), 0, 0, 2)]
    meta = _synthetic_meta((16, 16, 16), 3, tr)
    plan = fused_cg.tiled_vol_plan(meta, 1, (16, 16, 16), lm=False, sm_count=SMS,
                                   smem_per_block=SMEM)
    assert plan["halo"] == 3 and all(w >= 3 for w in plan["box"])


def test_medium_golden_takes_one_box():
    """volumetric's medium golden (6³, tests/test_golden_costs.py) routes to
    gn_vol_tiled on one box of the whole grid (chip_smoke.py's
    GOLDEN_FORMS)."""
    meta = _synthetic_meta((6, 6, 6), 128, _vol_triples())
    b = torch.empty((6, 6, 6, 6))
    plan = fused_cg.route_plan(meta, b, lm=False)
    assert plan["boxes"] == (1, 1, 1) and plan["box"] == (6, 6, 6)
    assert fused_cg.launch_instance(meta, b) == "gn_vol_tiled"


def test_a_2d_grid_keeps_the_2d_route():
    """[1, N1, N2] is a 2-D grid (tiled_grid_plan's), [N0, N1, N2] with N0 >
    1 the 3-D kernel's."""
    five = [((0, d1, d2), 0, 0, k) for k, (d1, d2) in enumerate(
        ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]
    flat = _synthetic_meta((1, 64, 64), 5, five)
    plan = fused_cg.route_plan(flat, torch.empty((1, 1, 64, 64)), lm=False)
    assert plan["layout"] == "resident" and "tiles" in plan
    deep = _synthetic_meta((4, 64, 64), 5, five)
    plan = fused_cg.route_plan(deep, torch.empty((1, 4, 64, 64)), lm=False)
    assert plan["layout"] == "vol" and plan["boxes"][0] * plan["boxes"][1] * plan["boxes"][2] <= SMS


def test_instance_names_and_launch_counts():
    names = [fused_cg.instance_name(*f) for f in fused_cg.TILED_INSTANCES[20:22]]
    assert names == ["gn_vol_tiled", "gn_bj_vol_tiled"]
    assert fused_cg.instance_name(False, False, block=True, tiled=True, vol=True) == names[1]
    fused_cg.reset_launch_counts()
    assert set(names) <= set(fused_cg.fused_grid_cg_kernel.launches)
    assert all(fused_cg.fused_grid_cg_kernel.launches[k] == 0 for k in names)


def test_build_compiles_the_vol_unit_and_reads_its_registers():
    assert "tiled_vol_cg.cu" in _build.UNITS and "tiled_cg.cuh" in _build.SOURCES
    assert (_build.CSRC / "tiled_vol_cg.cu").exists()
    lines = []
    for block, regs in ((0, 96), (1, 112)):
        lines.append("ptxas info    : Compiling entry function "
                     f"'_Z19tiled_vol_cg_kernelILb{block}EEvPKfS1_S1_PKiS3_iiiiiiiiiiiiifiPfS4_"
                     "P7double2S6_Pi' for 'sm_90a'")
        if block:
            lines.append("    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")
        lines.append(f"ptxas info    : Used {regs} registers, used 1 barriers, 552 bytes cmem[0]")
    got = _build.instance_registers("\n".join(lines))
    assert got == {fused_cg.TILED_INSTANCES[20]: (96, 0, 0),
                   fused_cg.TILED_INSTANCES[21]: (112, 8, 8)}


def test_smem_bytes_match_the_kernels_layout():
    """tiled_vol_smem_bytes is the unit's tv_smem_bytes: the same terms in
    the source."""
    src = (_build.CSRC / "tiled_vol_cg.cu").read_text()
    assert "4LL * (T * pts + 3LL * C * pts + C * ext + (block ? (long long)C * C : C) * pts)" in src
    assert "4LL * (2 * n_triples + C + 1)" in src and "16LL * (TGCG_WARPS + 1)" in src
    assert fused_cg.tiled_vol_smem_bytes(False, 1, 1, 1, 1, 1, 0, 1) == (
        16 * 17 + 4 * (1 + 3 + 1 + 1) + 4 * (2 + 2))


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("pre", ["jacobi", "block_jacobi"])
def test_kernel_wrapper_refuses_cpu_tensors_on_the_vol_route(pre):
    """A routed 3-D launch reaches the 3-D wrapper, whose device check
    raises for CPU tensors: nothing gives way to the template or the twin."""
    meta, b, p, pb = _system((8, 8, 8), pre)
    assert fused_cg.route_plan(meta, b, lm=False, pre_blocks=pb)["layout"] == "vol"
    with pytest.raises(ValueError, match="tiled_vol_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, p, 10, 0.0, pre_blocks=pb)


def test_vol_wrapper_checks_operands_first():
    meta, b, p, _pb = _system((8, 8, 8))
    plan = fused_cg.box_plan((8, 8, 8), (2, 2, 2), 1)
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_vol_cg_kernel(meta, b, p[:, :-1], 10, 0.0, plan)
    with pytest.raises(ValueError, match="pre_blocks has shape"):
        fused_cg.tiled_vol_cg_kernel(meta, b, None, 10, 0.0, plan,
                                     pre_blocks=torch.zeros((35, 8, 8, 8)))
    with pytest.raises(ValueError, match="float32 fields"):
        fused_cg.tiled_vol_cg_kernel(dict(meta, F=meta["F"].to(torch.bfloat16)), b, p, 10,
                                     0.0, plan)
    with pytest.raises(ValueError, match="3-D grid"):
        fused_cg.tiled_vol_cg_kernel(meta, b[:, 0], p[:, 0], 10, 0.0, plan)


def test_template_wrapper_keeps_the_lm_3d_form_on_cpu():
    """An LM launch on a 3-D grid routes to the template, whose device check
    speaks for it."""
    meta, b, p, _pb = _system((8, 8, 8))
    with pytest.raises(ValueError, match="^fused_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, p, 10, 0.0, ctc=p, reset_period=3,
                                      q_tolerance=1e-4)
