"""The tiled CG kernel's hbm layout (csrc/tiled_grid_cg.cu: ``gn_hbm_tiled``,
``lm_hbm_tiled``) on the CPU: a one-system float32 Jacobi launch whose
resident state does not fit one tile an SM but whose r over the tile and p
over its halo do, with δ and Ap in a device frame a block. It stands for
the JAX package's ``_hbm_tiled_kernel`` (image_warping 1024²×3).

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template's ``gn``/``lm`` there). Here: which launches
``tiled_grid_plan`` takes in the hbm layout and which it refuses; a plan
forced into that layout at 24² (``smem_per_block`` between the two
layouts' needs), on whose tiles the emulation of the resident loop
(tests/test_torch_tiled_cg.py::emulate: the layout moves δ and Ap, not the
arithmetic, so this checks the tiling, not the hbm code) is bitwise the
twin ``fused_grid_cg_reference``; the twin
against the Pallas HBM-streaming kernel ``_hbm_tiled_cg`` in interpret
mode; and the wrapper's host-side contract on the CPU."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
from opt_tpu_torch.ops import fused_cg
from tests.test_torch_tiled_cg import (
    JAX_RTOL,
    N,
    RESET,
    SMEM,
    SMS,
    _iw_like_triples,
    _jax_system,
    _lm_kw,
    _pack,
    _synthetic_meta,
    _torch_system,
    _twin,
    emulate,
)

torch.set_num_threads(2)

BIG = 1024  # image_warping 1024²×3, the JAX package's _hbm_tiled_kernel case
HBM_SMEM = 198920  # its hbm layout a block: 272 + 4·3·(86·94 + 88·96) + 4·(2·31 + 4)


def _big_meta(n=BIG, C=3, **extra):
    """An image_warping-like meta at n²×C: 31 triples over 31 fields, F
    uninitialised (only its shape is read)."""
    meta = _synthetic_meta((1, 1), _iw_like_triples(C), **extra)
    meta["F"] = torch.empty((31, n, n))
    return meta


def _needs(meta, C, dom, lm):
    """(resident, hbm) shared memory a block of a launch on this meta at
    its one-system plan's tiles."""
    plan = fused_cg.tiled_grid_plan(meta, C, dom, lm=lm, sm_count=SMS, smem_per_block=SMEM)
    (th, tw), h, n = plan["tile"], plan["halo"], len(meta["triples"])
    return (fused_cg.tiled_smem_bytes(lm, C, th, tw, h, n),
            fused_cg.tiled_smem_bytes(lm, C, th, tw, h, n, hbm=True))


def _between(meta, C, dom, lm):
    """A shared-memory limit between the hbm layout's need and the
    resident one's: only the hbm layout fits."""
    resident, hbm = _needs(meta, C, dom, lm)
    assert hbm < resident
    return (resident + hbm) // 2


# -- plan and route --------------------------------------------------------------------


@pytest.mark.parametrize("lm", [False, True])
def test_plan_takes_image_warping_1024_in_the_hbm_layout(lm):
    """12×11 tiles of 86×94, as the resident layout would cut it, whose
    resident state (about 392 KB a block) does not fit 232,448 B but whose
    r and haloed p do: 198,920 B under GN and LM alike."""
    meta = _big_meta()
    plan = fused_cg.tiled_grid_plan(meta, 3, (BIG, BIG), lm=lm, sm_count=SMS,
                                    smem_per_block=SMEM)
    assert plan["layout"] == "hbm"
    assert plan["tiles"] == (12, 11) and plan["tile"] == (86, 94) and plan["halo"] == 1
    assert plan["smem_bytes"] == fused_cg.tiled_smem_bytes(lm, 3, 86, 94, 1, 31, hbm=True)
    assert plan["smem_bytes"] == HBM_SMEM <= SMEM
    assert fused_cg.tiled_smem_bytes(lm, 3, 86, 94, 1, 31) > SMEM


def test_hbm_layout_keeps_r_and_haloed_p_only():
    """The hbm layout's bytes: the records, r over the tile, p over its
    frame and the triples, the same under GN and LM; the resident layout's
    exceed them by δ and Ap (haloed under LM)."""
    C, th, tw, h, n = 3, 86, 94, 1, 31
    pts, ext = th * tw, (th + 2 * h) * (tw + 2 * h)
    gn = fused_cg.tiled_smem_bytes(False, C, th, tw, h, n, hbm=True)
    assert gn == fused_cg.tiled_smem_bytes(True, C, th, tw, h, n, hbm=True)
    assert fused_cg.tiled_smem_bytes(False, C, th, tw, h, n) - gn == 4 * C * 2 * pts
    assert fused_cg.tiled_smem_bytes(True, C, th, tw, h, n) - gn == 4 * C * (pts + ext)


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("case", ["block", "cs", "bf16", "split", "batch"])
def test_plan_refuses_the_hbm_layout_for_other_forms(case, lm):
    """Where only the hbm layout would fit (a limit between the two
    layouts' needs), block-Jacobi, Chronopoulos–Gear, bfloat16 fields, the
    per-channel split and a batch are refused: the hbm instances are one
    system of the standard loop on float32 fields with the Jacobi
    preconditioner. The plain one-system launch at the same limit takes it."""
    n = 256
    C = 1 if case == "split" else 3
    base = _big_meta(n, C)
    limit = _between(base, C, (n, n), lm)
    assert fused_cg.tiled_grid_plan(base, C, (n, n), lm=lm, sm_count=SMS,
                                    smem_per_block=limit)["layout"] == "hbm"
    meta, kw = base, dict(lm=lm, sm_count=SMS, smem_per_block=limit)
    if case == "block":
        kw["block"] = True
    elif case == "cs":
        kw["cs"] = True
    elif case == "bf16":
        meta = dict(base, F=base["F"].to(torch.bfloat16))
    elif case == "split":
        meta = dict(base, chan_grid=True, ctot=4)
    else:
        meta = dict(base, F=torch.empty((4, 31, n, n)), batch=4, ctot=C)
    assert fused_cg.tiled_grid_plan(meta, C, (n, n), **kw) is None


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("C", [4, 5])
def test_plan_takes_the_hbm_layout_up_to_four_channels(C, lm):
    """Where only the hbm layout would fit, a launch of up to
    HBM_MAX_CHANNELS (4) channels takes it and one of more is refused: each
    thread of the hbm instances holds a point's values of every channel in
    registers, and the launch refuses more channels on the card."""
    n = 256
    meta = _big_meta(n, C)
    meta["F"] = torch.empty((1 + max(f for (_d, _i, _j, f) in meta["triples"]), n, n))
    plan = fused_cg.tiled_grid_plan(meta, C, (n, n), lm=lm, sm_count=SMS,
                                    smem_per_block=_between(meta, C, (n, n), lm))
    assert fused_cg.HBM_MAX_CHANNELS == 4
    if C <= fused_cg.HBM_MAX_CHANNELS:
        assert plan["layout"] == "hbm"
    else:
        assert plan is None


@pytest.mark.parametrize("lm", [False, True])
def test_plan_refuses_2048x4_in_either_layout(lm):
    """poisson 2048²×4 fits neither layout and keeps the template."""
    meta = _synthetic_meta((1, 1), [(d, c, c, k) for c in range(4) for k, d in enumerate(
        ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))])
    meta["F"] = torch.empty((5, 2048, 2048))
    assert fused_cg.tiled_grid_plan(meta, 4, (2048, 2048), lm=lm, sm_count=SMS,
                                    smem_per_block=SMEM) is None
    tr, tc, th, tw = fused_cg._tile_split(2048, 2048, 1, SMS)
    assert fused_cg.tiled_smem_bytes(lm, 4, th, tw, 1, 20, hbm=True) > SMEM


@pytest.mark.parametrize("lm", [False, True])
def test_route_names_the_hbm_instances(lm):
    """At the card's limits image_warping 1024²×3 launches gn_hbm_tiled or
    lm_hbm_tiled; by Chronopoulos–Gear, with bfloat16 fields or under
    block-Jacobi it keeps the template's instance."""
    meta = _big_meta()
    b = torch.empty((3, BIG, BIG))
    name = "lm" if lm else "gn"
    assert fused_cg.route_plan(meta, b, lm=lm)["layout"] == "hbm"
    assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_hbm_tiled"
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == name + "_cs"
    bf = dict(meta, F=meta["F"].to(torch.bfloat16))
    assert fused_cg.launch_instance(bf, b, lm=lm) == name + "_bf16"
    pb = torch.empty((9, BIG, BIG))
    assert fused_cg.launch_instance(meta, b, lm=lm, pre_blocks=pb) == name + "_bj"


# -- a plan forced into the hbm layout at 24² -------------------------------------------


def _forced_hbm_plan(meta, b, lm):
    C, N1, N2 = b.shape
    plan = fused_cg.tiled_grid_plan(meta, C, (N1, N2), lm=lm, sm_count=SMS,
                                    smem_per_block=_between(meta, C, (N1, N2), lm))
    assert plan["layout"] == "hbm"
    assert plan["smem_bytes"] == fused_cg.tiled_smem_bytes(
        lm, C, *plan["tile"], plan["halo"], len(meta["triples"]), hbm=True)
    return plan


# (system, lits, tol, q_tol): no exit (LM through several resets), and the real exits
_FORCED_CASES = [
    ("gaussNewtonGPU", 30, 0.0, None),
    ("gaussNewtonGPU", 400, 1e-12, None),
    ("LMGPU", 30, 0.0, -np.inf),
    ("LMGPU", 400, 1e-12, 1e-4),
]


@pytest.mark.parametrize("kind,lits,tol,q_tol", _FORCED_CASES)
def test_emulation_on_the_forced_hbm_plan_is_bitwise_the_twin(kind, lits, tol, q_tol):
    """image_warping 24²×3 on the tiles of a plan the limit forces into the
    hbm layout: the emulation of the resident loop, tile by tile, with δ's
    ring exchanged at each LM reset, equals the twin bit for bit. This
    checks the hbm plan's tiling, not the hbm instances' code (where δ and
    Ap live, the chunked loads of tg_sum_triples and the four-point walks
    of csrc/tiled_grid_cg.cu), which runs only on the card: chip_smoke.py
    holds it bitwise to the twin there."""
    meta, b, pre, ctc = _torch_system(kind)
    plan = _forced_hbm_plan(meta, b, ctc is not None)
    tr, tc = plan["tiles"]
    assert tr * tc > 1
    de, le = emulate(meta["F"], meta["triples"], b, pre, lits, tol, plan, **_lm_kw(ctc, q_tol))
    dt, lt = _twin(meta, b, pre, lits, tol, ctc, q_tol)
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    if ctc is not None and tol == 0.0:
        assert le > 3 * RESET  # resets occurred
    assert torch.equal(de, dt) and bool(torch.isfinite(de).all())


# GN on the lattice system, whose iterates do not depend on the dots' sum
# order (tests/test_torch_tiled_cg.py::test_emulation_matches_pallas_interpret),
# to its exit and with none; LM through several resets
@pytest.mark.parametrize("kind,lits,tol,q_tol", [
    ("gaussNewtonGPU-lattice", 60, 8e-10, None),
    ("gaussNewtonGPU-lattice", 25, 0.0, None),
    ("LMGPU", 25, 0.0, -np.inf),
])
def test_twin_matches_pallas_hbm_tiled_interpret(kind, lits, tol, q_tol):
    """The twin that stands in for the hbm instances on the CPU against
    the JAX package's HBM-streaming kernel, _hbm_tiled_cg, in interpret
    mode with three 8-row windows at 24²: equal counts, δ within
    JAX_RTOL · max|δ|."""
    jmeta, r0, jpre, jctc = _jax_system(kind)
    meta, b, pre, ctc = _torch_system(kind)
    lm = {} if jctc is None else dict(ctc=jax.numpy.asarray(ctc.numpy()), reset_period=RESET,
                                      q_tolerance=np.float32(q_tol))
    jd, ji = pcg._hbm_tiled_cg(dict(jmeta, hbm_tiled={"th": 8, "halo": 1}),
                               jax.numpy.asarray(b.numpy()), jax.numpy.asarray(pre.numpy()),
                               lits, tol, guard_div=True, interpret=True, **lm)
    dt, lt = _twin(meta, b, pre, lits, tol, ctc, q_tol)
    jd = _pack(jax.device_get(jd), meta)
    assert lt == int(ji) == (lits if tol == 0.0 else 14)
    np.testing.assert_allclose(dt.numpy(), jd.numpy(), rtol=0,
                               atol=JAX_RTOL * float(jd.abs().max()))


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("lm", [False, True])
def test_kernel_wrapper_refuses_cpu_tensors_on_the_hbm_route(lm):
    """image_warping 1024²×3 routes to the tiled wrapper in the hbm layout,
    whose device check raises for CPU tensors: nothing gives way to the
    template or to the twin."""
    meta = _big_meta()
    b, pre = torch.zeros((3, BIG, BIG)), torch.ones((3, BIG, BIG))
    kw = dict(ctc=torch.zeros((3, BIG, BIG)), reset_period=RESET, q_tolerance=1e-4) if lm else {}
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **kw)


@pytest.mark.parametrize("lm", [False, True])
def test_tiled_wrapper_takes_the_forced_hbm_plan_and_refuses_its_other_forms(lm):
    """A plan in the hbm layout reaches the wrapper's device check for one
    system on float32 fields with the Jacobi preconditioner, and is refused
    before it by Chronopoulos–Gear, bfloat16 fields and block-Jacobi."""
    meta, b, pre, ctc = _torch_system("LMGPU" if lm else "gaussNewtonGPU")
    plan = _forced_hbm_plan(meta, b, lm)
    kw = _lm_kw(ctc, 1e-4)
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre, 10, 0.0, plan, **kw)
    with pytest.raises(ValueError, match="the hbm layout takes one system"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre, 10, 0.0, plan, cs=True, **kw)
    with pytest.raises(ValueError, match="the hbm layout takes one system"):
        fused_cg.tiled_grid_cg_kernel(dict(meta, F=meta["F"].to(torch.bfloat16)), b, pre, 10,
                                      0.0, plan, **kw)
    pb = torch.zeros((9, N, N))
    with pytest.raises(ValueError, match="the hbm layout takes one system"):
        fused_cg.tiled_grid_cg_kernel(meta, b, None, 10, 0.0, plan, pre_blocks=pb, **kw)
