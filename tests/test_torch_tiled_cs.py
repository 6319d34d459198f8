"""The tiled CG kernel's Chronopoulos–Gear instances (csrc/tiled_grid_cs.cu:
``gn_cs_tiled``, ``lm_cs_tiled``) on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template's ``gn_cs``/``lm_cs`` there). Here: which launches
``tiled_grid_plan`` takes under ``cs`` and its shared memory; an emulation
in plain PyTorch of the one-barrier loop tile by tile (:func:`emulate_cs`:
each tile keeps r, s and u over its halo, p and δ over its halo under LM
and over the tile under GN, w over the tile; only w's ring goes through a
grid-sized array, in two buffers by the iteration's parity, NaN off the
rings and the other parity's buffer refilled with NaN every iteration; an
LM reset sends r's ring the same way) held bitwise to the twin
``fused_grid_cg_reference(..., cs=True)`` and to the JAX package's Pallas
kernel in interpret mode; and the wrapper's host-side contract."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
from opt_tpu_torch.ops import _build, fused_cg
from tests.test_torch_tiled_cg import (
    JAX_RTOL,
    N,
    RESET,
    SMEM,
    SMS,
    _forced_plan,
    _iw_like_triples,
    _jax_system,
    _pack,
    _radius2_system,
    _ring,
    _synthetic_meta,
    _torch_system,
    emulate,
)

torch.set_num_threads(2)

CS = "chronopoulos_gear"
# δ against the Pallas kernel's Chronopoulos–Gear form at 25 iterations and
# at the real exit: the twin's own bar there
# (tests/test_torch_cg_variants.py::DELTA_RTOL). The loop amplifies the
# dots' sum order (float32 in the Pallas kernel, float64 here) more than the
# standard one does; JAX_RTOL (1e-6) is held where it holds (GN's first
# iteration, LM's tenth), and on the lattice GN system at 2 and 3
# iterations both loops part from their Pallas forms by the same amount
# (test_cs_parts_from_pallas_as_the_standard_loop_does)
CS_JAX_RTOL = 1e-5


# -- the emulation ---------------------------------------------------------------------


def emulate_cs(F, triples, b, pre, lits, tol, plan, *, ctc=None, reset_period=None,
               q_tolerance=None, guard_div=True):
    """The Chronopoulos–Gear tiled kernel's loop in plain PyTorch, tile by
    tile, one exchange an iteration: each tile keeps r, s and u over its
    points and a halo of h, p and δ over the halo too under LM (whose reset
    applies A to δ) and over its points under GN, w over its points; zero
    beyond the grid. After the apply only w's ring goes to a grid-sized
    array, the buffer of the iteration's parity (NaN off the rings; the
    other parity's buffer is refilled with NaN every iteration, so a read of
    a stale buffer or off a ring shows), from which each tile forms s = w +
    β·s over its halo; p, δ, r and u follow there by the tile's own
    arithmetic. An LM reset forms r = b − (A·δ + ctc·δ) over the tile from
    δ's haloed copy and sends r's ring the same way. pre is read over the
    tile and its halo, NaN beyond the grid (a read off the grid shows).
    Sums of the stencil start at +0 over the triples of the output channel
    in their order; dots are taken over the whole grid as the twin's
    ``_dot`` takes them, and the scalar steps are the twin's (``_run_cs``).
    Returns (δ, iterations)."""
    C, N1, N2 = (int(s) for s in b.shape)
    h = plan["halo"]
    tiles = fused_cg.tile_bounds(plan, N1, N2)
    F = F.float()
    by_chan = [[t for t in triples if t[1] == c] for c in range(C)]
    lm = ctc is not None
    nan = float("nan")

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
        g = torch.full_like(b, nan)
        for tile, v in zip(tiles, parts):
            (r0, r1), (c0, c1) = tile
            g[:, r0:r1, c0:c1] = v
        return g

    def send_rings(buf, parts):
        """Each tile's ring of its part into ``buf`` (a grid-sized array)."""
        for tile, v in zip(tiles, parts):
            (r0, r1), (c0, c1) = tile
            m = _ring(r1 - r0, c1 - c0, h)
            buf[:, r0:r1, c0:c1] = torch.where(m, v, buf[:, r0:r1, c0:c1])

    def haloed(own, buf, tile):
        """A tile's haloed frame: its own points, the halo from the
        neighbours' rings in ``buf``, zero beyond the grid."""
        e = torch.where(on_grid(tile), ext(buf, tile), 0.0)
        inner(e).copy_(own)
        return e

    grid = [on_grid(t) for t in tiles]
    pre_e = [torch.where(g, ext(pre, t), nan) for g, t in zip(grid, tiles)]
    r = [torch.where(g, ext(b, t), 0.0) for g, t in zip(grid, tiles)]
    u = [torch.where(g, m * rk, 0.0) for g, m, rk in zip(grid, pre_e, r)]
    s = [torch.zeros_like(rk) for rk in r]
    p = [torch.zeros_like(rk) if lm else torch.zeros_like(inner(rk)) for rk in r]
    d = [torch.zeros_like(pk) for pk in p]
    own = (lambda x: inner(x)) if lm else (lambda x: x)  # δ's (p's) tile points
    w_buf = [torch.full_like(b, nan), torch.full_like(b, nan)]
    zero = torch.zeros((), dtype=b.dtype)
    gamma = alpha_prev = torch.ones((), dtype=b.dtype)
    floor, Q0 = None, zero
    l = 0
    while l < lits:
        par = l % 2
        w_buf[1 - par] = torch.full_like(b, nan)  # the other parity's: stale from here on
        w = []
        for k, t in enumerate(tiles):
            (r0, r1), (c0, c1) = t
            a = apply(crop(F, t), u[k], r1 - r0, c1 - c0)
            if lm:
                a = a + crop(ctc, t) * inner(u[k])
            w.append(a)
        send_rings(w_buf[par], w)
        rg, ug = glob([inner(x) for x in r]), glob([inner(x) for x in u])
        gamma_new = fused_cg._dot(rg, ug)
        delta_d = fused_cg._dot(ug, glob(w))
        first = l == 0
        if first:
            floor = tol * gamma_new  # the twin's tol·rᵀz₀, rᵀz₀ = ⟨b, M⁻¹b⟩
        if lm:
            Q = 0.5 * fused_cg._dot(glob([own(x) for x in d]), b + rg)
            stop = (gamma_new <= floor) | ((l * (Q - Q0)) / Q < q_tolerance)
        else:
            stop = gamma_new <= floor
        beta = zero if first else fused_cg.safe_div(gamma_new, gamma, guard_div)
        den = delta_d - beta * fused_cg.safe_div(gamma_new, alpha_prev, guard_div)
        used_den = delta_d if first else den
        if bool(stop) and not first:
            break  # this iteration is not counted
        bad_den = bool(used_den <= 0)
        alpha = fused_cg.safe_div(gamma_new, used_den, guard_div)
        for k, t in enumerate(tiles):
            g = grid[k]
            wk = haloed(w[k], w_buf[par], t)
            s[k] = torch.where(g, wk + beta * s[k], 0.0)
            if lm:
                p[k] = torch.where(g, u[k] + beta * p[k], 0.0)
                d[k] = torch.where(g, d[k] + alpha * p[k], 0.0)
            else:
                p[k] = inner(u[k]) + beta * p[k]
                d[k] = d[k] + alpha * p[k]
            r[k] = torch.where(g, r[k] + (-alpha) * s[k], 0.0)
            u[k] = torch.where(g, pre_e[k] * r[k], 0.0)
        l += 1
        gamma, alpha_prev = gamma_new, alpha
        if lm:
            Q0 = Q
        if bad_den:
            break
        if lm and l % reset_period == 0:
            rt = []
            for k, t in enumerate(tiles):
                (r0, r1), (c0, c1) = t
                a = apply(crop(F, t), d[k], r1 - r0, c1 - c0) + crop(ctc, t) * inner(d[k])
                rt.append(crop(b, t) + (-1.0) * a)
            r_buf = torch.full_like(b, nan)
            send_rings(r_buf, rt)
            for k, t in enumerate(tiles):
                r[k] = haloed(rt[k], r_buf, t)
                u[k] = torch.where(grid[k], pre_e[k] * r[k], 0.0)
    return glob([own(x) for x in d]), l


def _lm_kw(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


def _twin(meta, b, pre, lits, tol, ctc=None, q_tol=None):
    return fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                            cs=True, **_lm_kw(ctc, q_tol))


def _system(name):
    kind = "LMGPU" if name.endswith("LM") else "gaussNewtonGPU"
    if name.startswith("image_warping"):
        return _torch_system(kind)
    return _radius2_system(23, 19, kind)


# -- the emulation against the twin, bitwise ------------------------------------------

# (system, tiles, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM: the
# step denominator's exit stays, which these systems do not reach in
# `lits`), and the real exits; 3×2 tiles, tiles left ragged by the split
# (5×4 of 24², 3×2 of 23×19), one tile
_CASES = [
    ("image_warping GN", (3, 2), 30, 0.0, None),
    ("image_warping GN", (3, 2), 400, 1e-12, None),
    ("image_warping GN", (5, 4), 30, 0.0, None),
    ("image_warping GN", (1, 1), 30, 0.0, None),
    ("image_warping LM", (3, 2), 30, 0.0, -np.inf),
    ("image_warping LM", (3, 2), 400, 1e-12, 1e-4),
    ("image_warping LM", (5, 4), 30, 0.0, -np.inf),
    ("image_warping LM", (1, 1), 30, 0.0, -np.inf),
    ("radius2 23x19 GN", (3, 2), 40, 0.0, None),
    ("radius2 23x19 GN", (3, 2), 400, 1e-12, None),
    ("radius2 23x19 LM", (3, 2), 40, 0.0, -np.inf),
]


@pytest.mark.parametrize("name,tiles,lits,tol,q_tol", _CASES)
def test_cs_emulation_is_bitwise_the_twin(name, tiles, lits, tol, q_tol):
    meta, b, pre, ctc = _system(name)
    C, N1, N2 = b.shape
    h = fused_cg.tiled_grid_plan(meta, C, (N1, N2), lm=ctc is not None, cs=True, sm_count=SMS,
                                 smem_per_block=SMEM)["halo"]
    assert h == (2 if name.startswith("radius2") else 1)
    plan = _forced_plan(N1, N2, *tiles, h)
    de, le = emulate_cs(meta["F"], meta["triples"], b, pre, lits, tol, plan,
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


# -- the emulation against the Pallas kernel in interpret mode ------------------------


# GN on the lattice system, with no exit and with the real exit (the loop's
# γ/γ₀ falls past 1e-9 at iteration 14), LM with no exit, each at the bar
# its iterations hold: the bench-like GN system amplifies the dots' sum
# order, so it is held to the twin only, bitwise, above
@pytest.mark.parametrize("kind,lits,tol,q_tol,rtol", [
    ("gaussNewtonGPU-lattice", 1, 0.0, None, JAX_RTOL),
    ("gaussNewtonGPU-lattice", 25, 0.0, None, CS_JAX_RTOL),
    ("gaussNewtonGPU-lattice", 60, 1e-9, None, CS_JAX_RTOL),
    ("LMGPU", 10, 0.0, -np.inf, JAX_RTOL),
    ("LMGPU", 25, 0.0, -np.inf, CS_JAX_RTOL),
])
def test_cs_emulation_matches_pallas_interpret(kind, lits, tol, q_tol, rtol):
    """The emulation on 3×2 tiles against the JAX package's fused kernel in
    its Chronopoulos–Gear form in interpret mode: equal counts, δ within
    rtol · max|δ|."""
    jmeta, r0, jpre, jctc = _jax_system(kind)
    meta, b, pre, ctc = _torch_system(kind)
    lm = {} if jctc is None else dict(ctc=jctc, reset_period=RESET, q_tolerance=q_tol)
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, cg_variant=CS, **lm)
    jd = _pack(jax.device_get(jd), meta)
    de, le = emulate_cs(meta["F"], meta["triples"], b, pre, lits, tol, _forced_plan(N, N, 3, 2, 1),
                        **_lm_kw(ctc, q_tol))
    assert le == int(ji)
    assert le == lits if tol == 0.0 else 2 < le < lits
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0, atol=rtol * float(jd.abs().max()))


@pytest.mark.parametrize("lits", [2, 3])
def test_cs_parts_from_pallas_as_the_standard_loop_does(lits):
    """Where the CS emulation is past 1e-6 of the Pallas kernel's CS form
    on the lattice GN system early on, the standard emulation is as far
    from the Pallas kernel's standard form: the parting is the system's
    (its dots' sum order), not the Chronopoulos–Gear loop's."""
    jmeta, r0, jpre, _jctc = _jax_system("gaussNewtonGPU-lattice")
    meta, b, pre, _ctc = _torch_system("gaussNewtonGPU-lattice")
    plan = _forced_plan(N, N, 3, 2, 1)
    parted = []
    for em, variant in ((emulate_cs, CS), (emulate, "standard")):
        jd, _ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, 0.0, interpret=True, cg_variant=variant)
        jd = _pack(jax.device_get(jd), meta)
        de, _le = em(meta["F"], meta["triples"], b, pre, lits, 0.0, plan)
        parted.append(float((de - jd).abs().max() / jd.abs().max()))
    assert parted[0] > JAX_RTOL
    assert parted[0] == pytest.approx(parted[1], rel=1e-2)


# -- plan and route --------------------------------------------------------------------


def _main_path_meta(n, C, T=None):
    """A meta of image_warping's (C = 3, its 31 triples) or poisson's (C =
    4, a five-point stencil a channel, 5 fields) shape at n²."""
    triples = _iw_like_triples() if C == 3 else [
        (d, c, c, k) for c in range(C)
        for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]
    meta = _synthetic_meta((1, 1), triples)
    meta["F"] = torch.empty((T or (31 if C == 3 else 5), n, n))  # only its shape is read
    return meta


# (C, lm, shared memory a block): poisson 512²×4 GN, image_warping 512²×3 GN and LM,
# poisson LM, each on 12×11 tiles of 43×47 with a halo of 1 (45×49)
@pytest.mark.parametrize("C,lm,smem", [(4, False, 203300), (3, False, 152672),
                                       (3, True, 157360), (4, True, 209460)])
def test_plan_takes_cs_at_the_main_path_sizes(C, lm, smem):
    meta = _main_path_meta(512, C)
    kw = dict(lm=lm, sm_count=SMS, smem_per_block=SMEM)
    plan = fused_cg.tiled_grid_plan(meta, C, (512, 512), cs=True, **kw)
    standard = fused_cg.tiled_grid_plan(meta, C, (512, 512), **kw)
    assert plan["tiles"] == standard["tiles"] == (12, 11) and plan["tile"] == (43, 47)
    assert plan["halo"] == 1 and plan["threads"] == 512
    assert plan["smem_bytes"] == smem
    assert smem == fused_cg.tiled_smem_bytes(lm, C, 43, 47, 1, len(meta["triples"]), cs=True)
    # beyond the block's shared memory: refused, and the launch keeps the template
    assert fused_cg.tiled_grid_plan(meta, C, (512, 512), cs=True, lm=lm, sm_count=SMS,
                                    smem_per_block=smem - 1) is None


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("th,tw,h,C,n", [(43, 47, 1, 4, 20), (8, 10, 2, 1, 9), (1, 1, 0, 3, 31)])
def test_cs_shared_memory_is_the_layouts_sum(lm, th, tw, h, C, n):
    """tiled_smem_bytes(cs=True): the block-sum records (16 warps and one
    broadcast record of 16 bytes, two sets under LM), r, s and u over the
    tile and its halo, p and δ over it too under LM and over the tile under
    GN, w over the tile, four bytes a value, and the triples' two int
    offsets each and the channels' C + 1 starts."""
    pts, ext = th * tw, (th + 2 * h) * (tw + 2 * h)
    records = 16 * 17 * (2 if lm else 1)
    state = 4 * C * (3 * ext + (2 * ext if lm else 2 * pts) + pts)
    assert fused_cg.tiled_smem_bytes(lm, C, th, tw, h, n, cs=True) == (
        records + state + 4 * (2 * n + C + 1))


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_route_names_the_cs_instance(kind):
    meta, b, _pre, ctc = _torch_system(kind)
    lm = ctc is not None
    name = "lm" if lm else "gn"
    assert fused_cg.route_plan(meta, b, lm=lm, cs=True) == fused_cg.tiled_grid_plan(
        meta, 3, (N, N), lm=lm, cs=True, sm_count=SMS, smem_per_block=SMEM)
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == name + "_cs_tiled"
    # Chronopoulos-Gear with block-Jacobi or bfloat16 fields keeps the template
    pb = torch.zeros((9, N, N))
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True, pre_blocks=pb) == name + "_cs_bj"
    bf = dict(meta, F=meta["F"].to(torch.bfloat16))
    assert fused_cg.launch_instance(bf, b, lm=lm, cs=True) == name + "_cs_bf16"


def test_cs_batch_keeps_the_template():
    """A batch under Chronopoulos-Gear, with block-Jacobi (the multi form)
    or without: refused by the planner, the template's instances named."""
    n, B = 64, 4
    meta = _synthetic_meta((1, 1), _iw_like_triples(), batch=B, ctot=3)
    meta["F"] = torch.zeros((B, 31, n, n))
    b = torch.zeros((B, 3, n, n))
    pb = torch.zeros((B, 9, n, n))
    kw = dict(sm_count=SMS, smem_per_block=SMEM)
    for block in (False, True):
        assert fused_cg.tiled_grid_plan(meta, 3, (n, n), lm=True, cs=True, block=block,
                                        **kw) is None
    assert fused_cg.route_plan(meta, b, lm=True, cs=True, pre_blocks=pb) is None
    assert fused_cg.launch_instance(meta, b, lm=True, cs=True, pre_blocks=pb) == "lm_cs_bj_multi"
    assert fused_cg.launch_instance(meta, b, lm=True, cs=True) == "lm_cs_multi"


def test_build_reads_the_cs_kernels_registers():
    """The CS unit is built and its two kernels' registers
    (tiled_grid_cs_kernel<LM>) stand under gn_cs_tiled and lm_cs_tiled."""
    assert "tiled_grid_cs.cu" in _build.UNITS and "tiled_grid.cuh" in _build.SOURCES
    assert (_build.CSRC / "tiled_grid_cs.cu").exists()
    lines = []
    for lm in (0, 1):
        lines.append("ptxas info    : Compiling entry function "
                     f"'_Z20tiled_grid_cs_kernelILb{lm}EEvPKfS1_S1_S1_PKiS3_iiiiiiiiifiifPfS4_S4_"
                     "P7double2S6_Pi' for 'sm_90a'")
        if lm:
            lines.append("    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads")
        lines.append(f"ptxas info    : Used {100 + lm} registers, used 1 barriers")
    regs = _build.instance_registers("\n".join(lines))
    assert regs == {(False, False, True, False, False, False, False, True): (100, 0, 0),
                    (True, False, True, False, False, False, False, True): (101, 8, 4)}
    assert [fused_cg.instance_name(*k) for k in regs] == ["gn_cs_tiled", "lm_cs_tiled"]


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_cs_launch_reaches_the_tiled_wrapper(kind):
    """A Chronopoulos–Gear launch the route takes reaches the tiled wrapper,
    whose device check raises for CPU tensors after its operand checks:
    nothing gives way to the template or to the twin."""
    meta, b, pre, ctc = _torch_system(kind)
    lm = _lm_kw(ctc, 1e-4)
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, cs=True, **lm)
    plan = fused_cg.route_plan(meta, b, lm=ctc is not None, cs=True)
    with pytest.raises(ValueError, match="pre has shape"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre[:, :-1], 10, 0.0, plan, cs=True, **lm)
    with pytest.raises(ValueError, match="no tiled instance takes"):
        fused_cg.tiled_grid_cg_kernel(meta, b, None, 10, 0.0, plan, cs=True,
                                      pre_blocks=torch.zeros((9, N, N)), **lm)
    with pytest.raises(ValueError, match="no tiled instance takes"):
        fused_cg.tiled_grid_cg_kernel(dict(meta, F=meta["F"].to(torch.bfloat16)), b, pre, 10,
                                      0.0, plan, cs=True, **lm)
