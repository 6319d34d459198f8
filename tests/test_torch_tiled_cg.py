"""The tiled CG kernel's route and decomposition (csrc/tiled_grid_cg.cu).

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin there). Here: which launches ``tiled_grid_plan`` takes and how it cuts
the grid; an emulation in plain PyTorch that follows the kernel's
decomposition tile by tile (each tile's state on its own, p with a halo,
only r's ring exchanged, p recomputed over the halo from the neighbours'
r, an LM reset iteration exchanging δ's ring) held bitwise to the twin
``fused_grid_cg_reference`` and to the JAX package's Pallas kernel in
interpret mode, on float32 fields and on bfloat16 ones; and the wrapper's
host-side contract on the CPU."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.ops import _build, fused_cg
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.test_torch_cg_variants import jax_cg_call

torch.set_num_threads(2)

N = 24
RESET = 3
SMS, SMEM = 132, 232448  # the H100 SXM's SMs and opt-in shared memory a block
JAX_RTOL = 1e-6  # δ against the Pallas kernel, whose dots sum in another order


# -- systems --------------------------------------------------------------------------


def _iw_inputs(lattice=False):
    """image_warping at N² as bench.py draws it: a grid of rest positions,
    small random offsets and angles, six fit constraints, an excluded
    block; with ``lattice``, also a fit constraint at every other row and
    column (as tests/test_torch_lm.py::_inputs), a GN system whose float32
    CG iterates do not depend on the order of the dots' sums."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    ur = np.stack(np.meshgrid(np.arange(N), np.arange(N), indexing="ij"), -1).astype(f32)
    con = -np.ones((N, N, 2), f32)
    for _ in range(6):
        i, j = rng.randint(0, N, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    if lattice:
        con[::2, ::2] = (ur[::2, ::2] + rng.randn(*con[::2, ::2].shape) * 2).clip(0)
    mask = np.zeros((N, N), f32)
    mask[16:20, 5:9] = 1.0
    return {
        "Offset": ur + rng.randn(N, N, 2).astype(f32) * 0.1,
        "Angle": (rng.randn(N, N) * 0.05).astype(f32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(100.0).astype(f32),
        "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def _jplan(kind):
    kind = kind.split("-")[0]
    return ot.Problem(jspecs.image_warping, kind=kind).plan(
        dims={"W": N, "H": N},
        init_params=ot.InitializationParameters(use_pallas_cg="interpret"),
        residual_reset_period=RESET,
    )


_SYSTEMS = {}


def _jax_system(kind):
    """image_warping's first system as the JAX package hands it to its fused
    kernel, as numpy: (meta, r0, pre, ctc or None). GN from the assembly
    (as tests/test_torch_fused_cg.py::_jax_system), LM from one LM step
    with the kernel spied on (as tests/test_torch_lm.py::_jax_lm_system);
    "gaussNewtonGPU-lattice" on the lattice inputs. A kind ending in " bf16"
    (as "LMGPU-lattice bf16"): the first step's system with bfloat16 fields
    (tests/test_torch_cg_variants.py::jax_cg_call)."""
    if kind in _SYSTEMS:
        return _SYSTEMS[kind]
    if kind.endswith(" bf16"):
        base = kind.removesuffix(" bf16")
        jmeta, r0, pre, kw = jax_cg_call("image_warping", {"W": N, "H": N},
                                         _iw_inputs(base.endswith("lattice")), base.split("-")[0],
                                         coefficient_dtype="bfloat16")
        _SYSTEMS[kind] = (jmeta, r0, pre, kw.get("ctc"))
        return _SYSTEMS[kind]
    plan = _jplan(kind)
    u, c, g, p = plan._normalize_and_place(_iw_inputs(kind.endswith("lattice")))
    sv = plan.solver
    if kind.startswith("gaussNewtonGPU"):
        fs = JFunctionSet(plan.compiled, c, g, p)
        fs.masks(u)
        cc = fs.assemble_const(u, sv._stencil_plan)
        _A, diag, jtf_fn, meta = fs.assemble_stencil(u, sv._stencil_plan, cc)
        r_terms = jtf_fn.r_terms if jtf_fn.r_terms is not None else fs.F(u)
        r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
        pre = fs.mask_rows(sv._guarded_invert(diag))
        out = jax.device_get((meta, r0, pre)) + (None,)
    else:
        sp = sv._traced_sp(plan.solver_params)
        state = sv._init_state(u, c, g, p, sp)
        seen = {}
        real = pcg.fused_grid_cg

        def spy(meta, r0, pre, lits, tol, **kw):
            seen.update(meta=meta, r0=r0, pre=pre, ctc=kw["ctc"])
            return real(meta, r0, pre, lits, tol, **kw)

        pcg.fused_grid_cg = spy
        try:
            sv._lm_step(state, JFunctionSet(plan.compiled, c, g, p), sp)
        finally:
            pcg.fused_grid_cg = real
        out = jax.device_get((seen["meta"], seen["r0"], seen["pre"], seen["ctc"]))
    _SYSTEMS[kind] = out
    return out


def _pack(d, meta):
    a = np.concatenate([np.asarray(d[u]) for u in meta["u_list"]], axis=-1)
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def _torch_system(kind):
    """(meta, b, pre, ctc or None) of image_warping's first system, carried
    across from the JAX package."""
    jmeta, r0, pre, ctc = _jax_system(kind)
    meta = meta_from_numpy(jmeta, device="cpu")
    return meta, _pack(r0, meta), _pack(pre, meta), None if ctc is None else _pack(ctc, meta)


def radius2_spec(S):
    """A second-neighbour stencil: a halo of two rows and columns."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ott.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ott.Select(ott.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def _radius2_system(w, h, kind="gaussNewtonGPU", bf16=False):
    rng = np.random.RandomState(5)
    inputs = {"X": rng.rand(w, h).astype(np.float32), "A": rng.rand(w, h).astype(np.float32)}
    ip = ott.InitializationParameters(coefficient_dtype="bfloat16") if bf16 else None
    plan = ott.Problem(radius2_spec, kind=kind).plan(dims={"W": w, "H": h}, device="cpu",
                                                     init_params=ip)
    meta, r0, pre, kw = plan.cg_inputs(inputs)
    ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LMGPU" else None
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), ctc


def _synthetic_meta(dom, triples, dtype=torch.float32, **extra):
    n_fields = 1 + max(f for (_d, _i, _j, f) in triples)
    return dict({"F": torch.zeros((n_fields,) + tuple(dom), dtype=dtype), "triples": tuple(triples),
                 "rem": None, "chan_grid": False}, **extra)


def _five_point(C=1):
    return [(d, c, c, k) for c in range(C)
            for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]


def _forced_plan(N1, N2, tr, tc, h):
    """A plan with this split (tiled_grid_plan chooses its own)."""
    return {"tiles": (tr, tc), "tile": (-(-N1 // tr), -(-N2 // tc)), "halo": h,
            "threads": fused_cg.TILED_THREADS, "smem_bytes": 0}


# -- the emulation ---------------------------------------------------------------------


def _ring(rows, cols, h):
    """The tile's points within h of its edge: what a block writes of r."""
    y = torch.arange(rows)[:, None]
    x = torch.arange(cols)[None, :]
    return (y < h) | (y >= rows - h) | (x < h) | (x >= cols - h)


def emulate(F, triples, b, pre, lits, tol, plan, *, ctc=None, reset_period=None,
            q_tolerance=None, guard_div=True, pre_blocks=None):
    """The tiled kernel's loop in plain PyTorch, tile by tile: each tile
    keeps r, δ and Ap of its own points and p over its points and a halo of
    h (zero beyond the grid); after the update only r's ring goes to a
    grid-sized array (NaN elsewhere, so a read off the rings shows), from
    which each tile forms p = M⁻¹·r + β·p over its halo; an LM reset
    iteration writes δ's ring the same way and applies A to δ's haloed
    copy. The preconditioner's planes (``pre``, or under ``pre_blocks``
    the C·C planes of the block apply) are staged once a tile over the tile
    and its halo, NaN beyond the grid (so a plane read off the grid shows),
    and read only from there; the block apply at a halo point takes every
    channel of the neighbours' r ring. Sums of the stencil start at +0 over
    the triples of the output channel in their order; dots are taken over
    the whole grid as the twin's ``_dot`` takes them, and the scalar steps
    are the twin's. Returns (δ, iterations)."""
    C, N1, N2 = (int(s) for s in b.shape)
    h = plan["halo"]
    tiles = fused_cg.tile_bounds(plan, N1, N2)
    F = F.float()
    by_chan = [[t for t in triples if t[1] == c] for c in range(C)]
    lm = ctc is not None

    def crop(t, tile):
        (r0, r1), (c0, c1) = tile
        return t[:, r0:r1, c0:c1]

    def ext(t, tile):
        (r0, r1), (c0, c1) = tile
        return torch.nn.functional.pad(t, (h, h, h, h))[:, r0:r1 + 2 * h, c0:c1 + 2 * h].clone()

    def on_grid(tile):  # the haloed frame's points inside the grid
        (r0, r1), (c0, c1) = tile
        y = torch.arange(r0 - h, r1 + h)[:, None]
        x = torch.arange(c0 - h, c1 + h)[None, :]
        return (y >= 0) & (y < N1) & (x >= 0) & (x < N2)

    def inner(e):
        return e[:, h:e.shape[1] - h, h:e.shape[2] - h]

    def apply(Ft, src, rows, cols):
        out = []
        for c in range(C):
            a = torch.zeros((rows, cols))
            for d, _i, j, fid in by_chan[c]:
                d1, d2 = d[-2], d[-1]
                a = a + Ft[fid] * src[j, h + d1:h + d1 + rows, h + d2:h + d2 + cols]
            out.append(a)
        return torch.stack(out)

    def glob(parts):
        g = torch.full_like(b, float("nan"))
        for tile, v in zip(tiles, parts):
            (r0, r1), (c0, c1) = tile
            g[:, r0:r1, c0:c1] = v
        return g

    def rings(parts):
        g = torch.full_like(b, float("nan"))
        for tile, v in zip(tiles, parts):
            (r0, r1), (c0, c1) = tile
            m = _ring(r1 - r0, c1 - c0, h)
            g[:, r0:r1, c0:c1] = torch.where(m, v, g[:, r0:r1, c0:c1])
        return g

    def halo_of(parts_inner, exchanged, tile):
        """A tile's haloed copy: its own points, the halo from the
        exchanged rings, zero beyond the grid."""
        e = torch.where(on_grid(tile), ext(exchanged, tile), 0.0)
        inner(e).copy_(parts_inner)
        return e

    # each tile's preconditioner planes over it and its halo, staged once
    planes = pre if pre_blocks is None else pre_blocks
    staged = []
    for t in tiles:
        m = ext(planes, t)
        staged.append(torch.where(on_grid(t), m, float("nan")))

    def prec(m, x):  # z = M⁻¹ x on a frame, m the frame's planes
        return m * x if pre_blocks is None else fused_cg._block_prec(m)(x)

    r = [crop(b, t).clone() for t in tiles]
    d = [torch.zeros_like(x) for x in r]
    pe = [torch.where(on_grid(t), prec(m, ext(b, t)), 0.0) for t, m in zip(tiles, staged)]
    rz = fused_cg._dot(b, glob([inner(p) for p in pe]))
    floor = tol * rz
    Q0 = torch.zeros_like(rz)
    l = 0
    while l < lits:
        Ap = []
        for k, t in enumerate(tiles):
            (r0, r1), (c0, c1) = t
            a = apply(crop(F, t), pe[k], r1 - r0, c1 - c0)
            if lm:
                a = a + crop(ctc, t) * inner(pe[k])
            Ap.append(a)
        den = fused_cg._dot(glob([inner(p) for p in pe]), glob(Ap))
        alpha = fused_cg.safe_div(rz, den, guard_div)
        d = [dk + alpha * inner(pk) for dk, pk in zip(d, pe)]
        if lm and (l + 1) % reset_period == 0:
            d_ring = rings(d)
            for k, t in enumerate(tiles):
                (r0, r1), (c0, c1) = t
                de = halo_of(d[k], d_ring, t)
                a = apply(crop(F, t), de, r1 - r0, c1 - c0) + crop(ctc, t) * d[k]
                r[k] = crop(b, t) - a
        else:
            r = [rk - alpha * ak for rk, ak in zip(r, Ap)]
        z = [prec(inner(m), rk) for m, rk in zip(staged, r)]
        if lm:
            rz_new = fused_cg._dot(glob(z), glob(r))
            q = fused_cg._dot(glob(d), b + glob(r))
        else:
            rz_new = fused_cg._dot(glob(z), glob(r))
        beta = fused_cg.safe_div(rz_new, rz, guard_div)
        r_ring = rings(r)
        for k, t in enumerate(tiles):
            zh = prec(staged[k], ext(r_ring, t))
            inner(zh).copy_(z[k])
            pe[k] = torch.where(on_grid(t), zh + beta * pe[k], 0.0)
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
    return glob(d), l


def _lm_kw(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


# -- plan and route --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_plan_takes_2d_float32_gn_and_lm(kind):
    meta, b, _pre, ctc = _torch_system(kind)
    plan = fused_cg.tiled_grid_plan(meta, 3, b.shape[1:], lm=ctc is not None,
                                    sm_count=SMS, smem_per_block=SMEM)
    assert plan is not None and plan["halo"] == 1 and plan["threads"] == 512
    tr, tc = plan["tiles"]
    assert tr * tc <= SMS
    assert plan["smem_bytes"] == fused_cg.tiled_smem_bytes(
        ctc is not None, 3, *plan["tile"], 1, len(meta["triples"]))


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("case", ["bf16", "cs", "cs_bf16", "rem", "split", "batch", "3d",
                                  "graph"])
def test_plan_refuses_other_forms(case, block):
    """The forms the tiled kernel does not take, with the elementwise and
    with the block preconditioner. bfloat16 fields and Chronopoulos–Gear are
    taken with the elementwise preconditioner (tests/test_torch_tiled_bf16.py,
    tests/test_torch_tiled_cs.py) and refused with the block one, and the two
    together are refused with either. The per-channel split is taken with the
    elementwise preconditioner, planned at one channel, and refused with the
    block one (tests/test_torch_tiled_multi.py). A batch is taken by the
    tiled grid kernel in the multi form only (route_plan), with either
    preconditioner: a batch of small systems, which batched_kernel_form
    sends to the block-per-system form, goes to the batch kernel with the
    elementwise preconditioner (gn_batch_tiled,
    tests/test_torch_tiled_batch.py) and keeps the template's gn_bj_batch
    with the block one."""
    dom = (64, 64)
    meta = _synthetic_meta(dom, _five_point(2))
    kw = dict(lm=False, block=block, sm_count=SMS, smem_per_block=SMEM)
    C = 2
    if case == "bf16":
        meta["F"] = meta["F"].to(torch.bfloat16)
    elif case == "cs":
        kw["cs"] = True
    elif case == "cs_bf16":
        meta["F"] = meta["F"].to(torch.bfloat16)
        kw["cs"] = True
    elif case == "rem":
        meta["rem"] = {"rowptr": None, "col": None, "blk": None}
    elif case == "split":
        meta = _synthetic_meta(dom, _five_point(1), chan_grid=True, ctot=2)
        C = 1  # the split's systems are one channel each
    elif case == "batch":
        dom = (8, 8)  # 2 x 64 values, and 4 x 64 more under block-Jacobi: the batch form
        meta = _synthetic_meta(dom, _five_point(2), batch=4, ctot=2)
        meta["F"] = torch.zeros((4, 5) + dom)
        b = torch.zeros((4, C) + dom)
        pb = torch.zeros((4, C * C) + dom) if block else None
        assert fused_cg.batched_kernel_form(meta, pb) == "batch"
        plan = fused_cg.route_plan(meta, b, lm=False, pre_blocks=pb)
        assert (plan is None) if block else (plan["layout"] == "batch")
        assert fused_cg.launch_instance(meta, b, pre_blocks=pb) == (
            "gn_bj_batch" if block else "gn_batch_tiled")
        # larger systems, the multi form, take the tiled kernel
        big = dict(meta, F=torch.zeros((4, 5, 64, 64)))
        bb = torch.zeros((4, C, 64, 64))
        pbb = torch.zeros((4, C * C, 64, 64)) if block else None
        assert fused_cg.batched_kernel_form(big, pbb) == "multi"
        assert fused_cg.route_plan(big, bb, lm=False, pre_blocks=pbb) is not None
        assert fused_cg.launch_instance(big, bb, pre_blocks=pbb) == (
            "gn_bj_multi_tiled" if block else "gn_multi_tiled")
    elif case == "3d":
        dom = (4, 64, 64)
        meta = _synthetic_meta(dom, [((0, 0, 0), 0, 0, 0), ((1, 0, 0), 0, 0, 1)])
        C = 1
    elif case == "graph":
        dom = (1, 4096)
        meta = _synthetic_meta(dom, [((0, 0), 0, 0, 0), ((0, 1), 0, 0, 1)])
        C = 1
    if case in ("bf16", "cs") and not block:  # taken, at the float32 standard plan's tiles
        plan = fused_cg.tiled_grid_plan(meta, C, dom, **kw)
        assert plan["tiles"] == fused_cg.tiled_grid_plan(
            _synthetic_meta(dom, _five_point(2)), C, dom, lm=False, sm_count=SMS,
            smem_per_block=SMEM)["tiles"]
    elif case == "split" and not block:  # taken, at one channel's plan
        plan = fused_cg.tiled_grid_plan(meta, C, dom, **kw)
        assert plan == fused_cg.tiled_grid_plan(_synthetic_meta(dom, _five_point(1)), 1, dom,
                                                lm=False, sm_count=SMS, smem_per_block=SMEM)
    elif case != "batch":
        assert fused_cg.tiled_grid_plan(meta, C, dom, **kw) is None
    if case not in ("3d", "graph", "cs"):  # the same meta as it came, taken
        base = _synthetic_meta((64, 64), _five_point(2))
        assert fused_cg.tiled_grid_plan(base, 2, (64, 64), lm=False, block=block, sm_count=SMS,
                                        smem_per_block=SMEM) is not None


def test_plan_takes_a_leading_unit_axis_and_refuses_a_deep_offset():
    flat = _synthetic_meta((1, 64, 64), [((0, 0, 0), 0, 0, 0), ((0, 1, 0), 0, 0, 1)])
    assert fused_cg.tiled_grid_plan(flat, 1, (1, 64, 64), lm=False, sm_count=SMS,
                                    smem_per_block=SMEM) is not None
    deep = _synthetic_meta((1, 64, 64), [((0, 0, 0), 0, 0, 0), ((1, 0, 0), 0, 0, 1)])
    assert fused_cg.tiled_grid_plan(deep, 1, (1, 64, 64), lm=False, sm_count=SMS,
                                    smem_per_block=SMEM) is None


@pytest.mark.parametrize("n,C,lm,taken", [(512, 3, False, True), (512, 3, True, True),
                                          (512, 4, False, True), (1024, 3, False, True),
                                          (1024, 3, True, True), (2048, 4, False, False)])
def test_plan_at_the_main_path_sizes(n, C, lm, taken):
    """512²×3 (image_warping) and 512²×4 (poisson) fit one tile an SM of an
    H100; 1024²×3 does not, but its r and haloed p do: the hbm layout
    (gn_hbm_tiled, lm_hbm_tiled); 2048²×4 fits neither and keeps the
    template."""
    T = 26 if C == 3 else 5
    meta = _synthetic_meta((n, n), [(d, c, c, k % T) for c in range(C)
                                    for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1),
                                                           (0, -1)))])
    meta["F"] = torch.empty((T, n, n))  # uninitialised: only its shape is read
    plan = fused_cg.tiled_grid_plan(meta, C, (n, n), lm=lm, sm_count=SMS, smem_per_block=SMEM)
    assert (plan is not None) == taken
    if taken:
        assert plan["tiles"][0] * plan["tiles"][1] == SMS
        assert plan["smem_bytes"] <= SMEM
        assert plan["layout"] == ("hbm" if n == 1024 else "resident")


def _iw_like_triples(C=3):
    """31 triples over 3 channels, as image_warping's operator has: a
    five-point stencil a channel and 16 cross-channel couplings."""
    pairs = [(i, j) for i in range(C) for j in range(C) if i != j]
    cross = ([((0, 0), i, j) for i, j in pairs] + [((1, 0), i, j) for i, j in pairs]
             + [((0, 1), i, j) for i, j in pairs[:4]])
    return _five_point(C) + [(d, i, j, 15 + k) for k, (d, i, j) in enumerate(cross)]


@pytest.mark.parametrize("lm,smem", [(True, 181340), (False, 179132)])
def test_plan_takes_block_jacobi_with_its_planes_in_shared_memory(lm, smem):
    """image_warping 512²×3 under block-Jacobi: the 12×11 tiles of 43×47 of
    the Jacobi plan, and shared memory for the 9 planes over each tile and
    its halo (4·9·45·49 = 79,380 B) beside the state: 181,340 B under LM
    (101,960 + 79,380), 179,132 B under GN (99,752 + 79,380)."""
    n = 512
    meta = _synthetic_meta((1, 1), _iw_like_triples())
    meta["F"] = torch.empty((31, n, n))  # uninitialised: only its shape is read
    kw = dict(lm=lm, sm_count=SMS, smem_per_block=SMEM)
    jacobi = fused_cg.tiled_grid_plan(meta, 3, (n, n), **kw)
    plan = fused_cg.tiled_grid_plan(meta, 3, (n, n), block=True, **kw)
    assert plan["tiles"] == jacobi["tiles"] == (12, 11) and plan["tile"] == (43, 47)
    assert plan["halo"] == 1 and plan["smem_bytes"] == smem
    assert smem - jacobi["smem_bytes"] == 4 * 9 * 45 * 49 == 79380
    assert plan["smem_bytes"] == fused_cg.tiled_smem_bytes(lm, 3, 43, 47, 1, 31, block=True)
    # the planes overflow: refused, and the launch keeps the template
    assert fused_cg.tiled_grid_plan(meta, 3, (n, n), block=True, lm=lm, sm_count=SMS,
                                    smem_per_block=smem - 1) is None
    six = _synthetic_meta((1, 1), _five_point(6))
    six["F"] = torch.empty((5, n, n))
    assert fused_cg.tiled_grid_plan(six, 6, (n, n), **kw) is not None
    assert fused_cg.tiled_grid_plan(six, 6, (n, n), block=True, **kw) is None


def test_plan_refuses_beyond_the_tiles_and_the_shared_memory():
    """Below the resident layout's shared memory the one-system Jacobi
    launch takes the hbm layout; below that layout's too, nothing."""
    meta = _synthetic_meta((512, 512), _five_point(3))
    assert fused_cg.tiled_grid_plan(meta, 3, (512, 512), lm=False, sm_count=4,
                                    smem_per_block=SMEM) is None
    plan = fused_cg.tiled_grid_plan(meta, 3, (512, 512), lm=False, sm_count=SMS,
                                    smem_per_block=SMEM)
    assert plan["layout"] == "resident"
    hbm = fused_cg.tiled_grid_plan(meta, 3, (512, 512), lm=False, sm_count=SMS,
                                   smem_per_block=plan["smem_bytes"] - 1)
    assert hbm["layout"] == "hbm" and hbm["tiles"] == plan["tiles"]
    assert fused_cg.tiled_grid_plan(meta, 3, (512, 512), lm=False, sm_count=SMS,
                                    smem_per_block=hbm["smem_bytes"] - 1) is None


@pytest.mark.parametrize("N1,N2,tr,tc,h", [(37, 29, 3, 2, 1), (500, 300, 11, 12, 1),
                                           (23, 19, 3, 2, 2), (16, 16, 1, 1, 1)])
def test_tiles_cover_the_grid_once(N1, N2, tr, tc, h):
    plan = _forced_plan(N1, N2, tr, tc, h)
    hits = torch.zeros((N1, N2), dtype=torch.int32)
    tiles = fused_cg.tile_bounds(plan, N1, N2)
    assert len(tiles) == tr * tc
    for (r0, r1), (c0, c1) in tiles:
        assert r1 - r0 >= max(h, 1) and c1 - c0 >= max(h, 1)
        hits[r0:r1, c0:c1] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("N1,N2,h", [(37, 29, 1), (512, 512, 1), (500, 300, 2), (7, 3, 3),
                                     (128, 128, 1)])
def test_the_split_is_a_ceil_split_within_the_sms(N1, N2, h):
    split = fused_cg._tile_split(N1, N2, h, SMS)
    if N2 < h:
        assert split is None
        return
    tr, tc, th, tw = split
    assert tr * tc <= SMS and th == -(-N1 // tr) and tw == -(-N2 // tc)
    assert N1 - (tr - 1) * th >= max(h, 1) and N2 - (tc - 1) * tw >= max(h, 1)


def test_halo_from_the_triples():
    meta, b, _pre, _ctc = _torch_system("gaussNewtonGPU")
    kw = dict(lm=False, sm_count=SMS, smem_per_block=SMEM)
    assert fused_cg.tiled_grid_plan(meta, 3, b.shape[1:], **kw)["halo"] == 1
    rmeta, rb, _p, _c = _radius2_system(23, 19)
    assert fused_cg.tiled_grid_plan(rmeta, 1, rb.shape[1:], **kw)["halo"] == 2
    asym = _synthetic_meta((64, 64), [((0, 0), 0, 0, 0), ((0, 3), 0, 0, 1), ((-1, 0), 0, 0, 2)])
    assert fused_cg.tiled_grid_plan(asym, 1, (64, 64), **kw)["halo"] == 3


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_route_names_the_tiled_instance(kind):
    meta, b, _pre, ctc = _torch_system(kind)
    lm = ctc is not None
    assert fused_cg.launch_instance(meta, b, lm=lm) == ("lm_tiled" if lm else "gn_tiled")
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == (
        "lm_cs_tiled" if lm else "gn_cs_tiled")
    bf = dict(meta, F=meta["F"].to(torch.bfloat16))
    assert fused_cg.launch_instance(bf, b, lm=lm) == ("lm_bf16_tiled" if lm else "gn_bf16_tiled")
    pb = torch.zeros((9,) + tuple(b.shape[1:]))
    assert fused_cg.launch_instance(meta, b, lm=lm, pre_blocks=pb) == (
        "lm_bj_tiled" if lm else "gn_bj_tiled")
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True, pre_blocks=pb) == (
        "lm_cs_bj" if lm else "gn_cs_bj")


@pytest.mark.parametrize("lm", [False, True])
def test_route_takes_the_multi_form_of_a_block_batch(lm):
    """A batched meta takes the tiled kernel in the multi form (the systems
    in turn): 4 × 64²×3 systems, under block-Jacobi and, at the Jacobi
    plan, without it; by Chronopoulos–Gear it keeps the template's strided
    multi form."""
    n, B = 64, 4
    meta = _synthetic_meta((1, 1), _iw_like_triples(), batch=B, ctot=3)
    meta["F"] = torch.zeros((B, 31, n, n))
    b = torch.zeros((B, 3, n, n))
    pb = torch.zeros((B, 9, n, n))
    assert fused_cg.batched_kernel_form(meta, pb) == "multi"
    plan = fused_cg.route_plan(meta, b, lm=lm, pre_blocks=pb)
    assert plan is not None and plan == fused_cg.tiled_grid_plan(
        meta, 3, (n, n), lm=lm, block=True, sm_count=SMS, smem_per_block=SMEM)
    # without the block preconditioner, the one-system Jacobi plan
    jacobi = fused_cg.tiled_grid_plan(meta, 3, (n, n), lm=lm, block=False, sm_count=SMS,
                                      smem_per_block=SMEM)
    assert jacobi is not None and jacobi == fused_cg.tiled_grid_plan(
        _synthetic_meta((1, 1), _iw_like_triples()), 3, (n, n), lm=lm, sm_count=SMS,
        smem_per_block=SMEM)
    name = "lm" if lm else "gn"
    assert fused_cg.launch_instance(meta, b, lm=lm, pre_blocks=pb) == name + "_bj_multi_tiled"
    assert fused_cg.route_plan(meta, b, lm=lm) == jacobi
    assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_multi_tiled"
    assert fused_cg.route_plan(meta, b, lm=lm, cs=True) is None
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == name + "_cs_multi"
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True, pre_blocks=pb) == (
        name + "_cs_bj_multi")


def test_instance_names_and_launch_counts():
    names = [fused_cg.instance_name(*f) for f in fused_cg.TILED_INSTANCES]
    assert names == ["gn_tiled", "lm_tiled", "gn_bj_tiled", "lm_bj_tiled",
                     "gn_bj_multi_tiled", "lm_bj_multi_tiled", "gn_rem_tiled", "lm_rem_tiled",
                     "gn_rem_multi_tiled", "lm_rem_multi_tiled", "gn_cs_tiled", "lm_cs_tiled",
                     "gn_bf16_tiled", "lm_bf16_tiled", "gn_multi_tiled", "lm_multi_tiled",
                     "gn_hbm_tiled", "lm_hbm_tiled", "gn_dia_tiled", "lm_dia_tiled",
                     "gn_vol_tiled", "gn_bj_vol_tiled", "gn_batch_tiled", "lm_batch_tiled"]
    fused_cg.reset_launch_counts()
    assert set(names) | {"gn", "lm", "gn_bj", "lm_bj_multi"} <= set(
        fused_cg.fused_grid_cg_kernel.launches)
    assert len(fused_cg.fused_grid_cg_kernel.launches) == 96 + 24


def test_build_compiles_the_tiled_unit_and_reads_its_registers():
    assert "tiled_grid_cg.cu" in _build.UNITS and "tiled_grid_cg.cu" in _build.SOURCES
    assert (_build.CSRC / "tiled_grid_cg.cu").exists()
    # the eight float32 kernels, tiled_grid_cg_kernel<LM, BLOCK, float,
    # MULTI, HBM>: the Jacobi ones for one system, for several (MULTI) and in
    # the hbm layout (HBM) under their own launch names, a block-Jacobi
    # kernel's registers under its one-system and its multi-system names
    lines, want = [], {}
    for k, (lm, block, multi, hbm) in enumerate((
            (0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 1, 0), (1, 1, 1, 0), (0, 0, 1, 0), (1, 0, 1, 0),
            (0, 0, 0, 1), (1, 0, 0, 1))):
        lines.append("ptxas info    : Compiling entry function "
                     f"'_Z20tiled_grid_cg_kernelILb{lm}ELb{block}EfLb{multi}ELb{hbm}EEvPKT1_PKfS4_' "
                     "for 'sm_90a'")
        if k == 0:
            lines.append("    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads")
        lines.append(f"ptxas info    : Used {64 + 8 * k} registers, used 1 barriers, 416 bytes "
                     "cmem[0]")
        for m in (False, True) if block else (bool(multi),):
            key = (bool(lm), False, False, bool(block), False, m, False, True)
            want[key + ((True,) if hbm else ())] = (
                (64 + 8 * k,) + ((4, 4) if k == 0 else (0, 0)))
    regs = _build.instance_registers("\n".join(lines))
    # the grid kernel's ten float32 launch names (the graph kernel's six:
    # tests/test_torch_tiled_graph.py, tests/test_torch_tiled_dia.py; the
    # bf16 and Chronopoulos-Gear ones: tests/test_torch_tiled_bf16.py,
    # tests/test_torch_tiled_cs.py)
    assert regs == want and set(regs) == set(fused_cg.TILED_INSTANCES[:6]
                                             + fused_cg.TILED_INSTANCES[14:18])


# -- the emulation against the twin, bitwise ------------------------------------------


def _twin(meta, b, pre, lits, tol, ctc=None, q_tol=None):
    return fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                            **_lm_kw(ctc, q_tol))


# (system, tiles, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM), and the
# real exits; float32 fields, and bfloat16 ones (gn_bf16_tiled, lm_bf16_tiled: the
# stencil widens each field exactly as it reads it, so this emulation, which
# widens F, is their loop too), also on tiles the split leaves ragged (5×4 of 24²)
_EMULATION_CASES = [
    ("image_warping GN", (3, 2), 30, 0.0, None),
    ("image_warping GN", (3, 2), 400, 1e-12, None),
    ("image_warping LM", (3, 2), 30, 0.0, -np.inf),
    ("image_warping LM", (3, 2), 400, 1e-12, 1e-4),
    ("image_warping GN", (1, 1), 30, 0.0, None),
    ("radius2 23x19 GN", (3, 2), 40, 0.0, None),
    ("radius2 23x19 GN", (3, 2), 400, 1e-12, None),
    ("radius2 23x19 LM", (3, 2), 40, 0.0, -np.inf),
    ("image_warping GN bf16", (3, 2), 30, 0.0, None),
    ("image_warping GN bf16", (3, 2), 400, 1e-12, None),
    ("image_warping GN bf16", (5, 4), 30, 0.0, None),
    ("image_warping GN bf16", (1, 1), 30, 0.0, None),
    ("image_warping LM bf16", (3, 2), 30, 0.0, -np.inf),
    ("image_warping LM bf16", (3, 2), 400, 1e-12, 1e-4),
    ("image_warping LM bf16", (5, 4), 30, 0.0, -np.inf),
    ("radius2 23x19 GN bf16", (3, 2), 40, 0.0, None),
    ("radius2 23x19 GN bf16", (3, 2), 400, 1e-12, None),
    ("radius2 23x19 LM bf16", (3, 2), 40, 0.0, -np.inf),
]


def _system(name):
    """(meta, b, pre, ctc or None) of a named case: "image_warping" or
    "radius2 23x19", then "GN" or "LM", then "bf16" for bfloat16 fields."""
    words = name.split()
    kind = "LMGPU" if "LM" in words else "gaussNewtonGPU"
    bf16 = words[-1] == "bf16"
    if name.startswith("image_warping"):
        return _torch_system(kind + (" bf16" if bf16 else ""))
    return _radius2_system(23, 19, kind, bf16)


@pytest.mark.parametrize("name,tiles,lits,tol,q_tol", _EMULATION_CASES)
def test_emulation_is_bitwise_the_twin(name, tiles, lits, tol, q_tol):
    meta, b, pre, ctc = _system(name)
    assert meta["F"].dtype == (torch.bfloat16 if name.endswith("bf16") else torch.float32)
    C, N1, N2 = b.shape
    h = fused_cg.tiled_grid_plan(meta, C, (N1, N2), lm=ctc is not None, sm_count=SMS,
                                 smem_per_block=SMEM)["halo"]
    plan = _forced_plan(N1, N2, *tiles, h)
    de, le = emulate(meta["F"], meta["triples"], b, pre, lits, tol, plan,
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


# GN on the lattice system, whose rᵀz/rᵀz₀ falls to 7.3e-10 at iteration 14
# (never under 1.7e-9 before): the exit at tol 8e-10; the bench-like GN system amplifies
# the dots' sum order to 1e-3 of δ in 25 iterations, so it is held to the
# twin only, bitwise, above. With bfloat16 fields (the Pallas kernel's
# coefficient_dtype bfloat16) on the lattice system, GN and LM
@pytest.mark.parametrize("kind,lits,tol,q_tol", [
    ("gaussNewtonGPU-lattice", 60, 8e-10, None),
    ("gaussNewtonGPU-lattice", 25, 0.0, None),
    ("LMGPU", 25, 0.0, -np.inf),
    ("gaussNewtonGPU-lattice bf16", 25, 0.0, None),
    ("gaussNewtonGPU-lattice bf16", 60, 8e-10, None),
    ("LMGPU-lattice bf16", 25, 0.0, -np.inf),
])
def test_emulation_matches_pallas_interpret(kind, lits, tol, q_tol):
    """The emulation on 3×2 tiles against the JAX package's fused kernel in
    interpret mode on the same fields: equal counts, δ within JAX_RTOL ·
    max|δ|."""
    jmeta, r0, jpre, jctc = _jax_system(kind)
    meta, b, pre, ctc = _torch_system(kind)
    lm = {} if jctc is None else dict(ctc=jctc, reset_period=RESET, q_tolerance=q_tol)
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, **lm)
    jd = _pack(jax.device_get(jd), meta)
    plan = _forced_plan(N, N, 3, 2, 1)
    de, le = emulate(meta["F"], meta["triples"], b, pre, lits, tol, plan, **_lm_kw(ctc, q_tol))
    assert le == int(ji) == (lits if tol == 0.0 else 14)
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0,
                               atol=JAX_RTOL * float(jd.abs().max()))


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_kernel_wrapper_refuses_cpu_tensors_on_the_tiled_route(kind):
    """Every launch the tiled route takes (Jacobi, block-Jacobi, a batch of
    block-Jacobi systems in the multi form) reaches the tiled wrapper, whose
    device check raises for CPU tensors: nothing gives way to the template
    or to the twin."""
    meta, b, pre, ctc = _torch_system(kind)
    lm = _lm_kw(ctc, 1e-4)
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **lm)
    pb = torch.zeros((9,) + tuple(b.shape[1:]))
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, None, 10, 0.0, pre_blocks=pb, **lm)
    B = 4  # 24²×3 systems and their 9 planes: past BATCH_BLOCK_ELEMS, the multi form
    batched = dict(meta, F=meta["F"][None].expand(B, -1, -1, -1).contiguous(), batch=B)
    rep_ = lambda t: t[None].expand(B, *t.shape).contiguous()  # noqa: E731
    lmb = {k: rep_(v) if k == "ctc" else v for k, v in lm.items()}
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(batched, rep_(b), None, 10, 0.0, pre_blocks=rep_(pb),
                                      **lmb)


def test_tiled_wrapper_checks_operands_first():
    meta, b, pre, _ctc = _torch_system("gaussNewtonGPU")
    plan = _forced_plan(N, N, 3, 2, 1)
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre[:, :-1], 10, 0.0, plan)
    with pytest.raises(ValueError, match="pre_blocks has shape"):
        fused_cg.tiled_grid_cg_kernel(meta, b, None, 10, 0.0, plan,
                                      pre_blocks=torch.zeros((8, N, N)))
    batched = dict(meta, F=meta["F"][None].expand(2, -1, -1, -1).contiguous(), batch=2)
    with pytest.raises(ValueError, match="pre has shape"):  # a batch's pre has its batch axis
        fused_cg.tiled_grid_cg_kernel(batched, b[None].expand(2, -1, -1, -1).contiguous(),
                                      pre, 10, 0.0, plan)
    with pytest.raises(ValueError, match="reset_period"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre, 10, 0.0, plan, ctc=pre)
    with pytest.raises(ValueError, match="float32 or bfloat16 fields"):
        fused_cg.tiled_grid_cg_kernel(dict(meta, F=meta["F"].to(torch.float16)), b, pre, 10,
                                      0.0, plan)


def test_template_wrapper_still_takes_the_other_forms_on_cpu():
    """A Chronopoulos–Gear launch under block-Jacobi routes to the template,
    whose device check speaks for it."""
    meta, b, pre, _ctc = _torch_system("gaussNewtonGPU")
    pb = torch.zeros((9,) + tuple(b.shape[1:]))
    with pytest.raises(ValueError, match="^fused_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, None, 10, 0.0, cs=True, pre_blocks=pb)
