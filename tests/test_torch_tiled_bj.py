"""The tiled CG kernel's block-Jacobi instances (csrc/tiled_grid_cg.cu:
``gn_bj_tiled``, ``lm_bj_tiled``, and ``gn_bj_multi_tiled``,
``lm_bj_multi_tiled`` for a batch of systems in turn) on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin there). Here the emulation of its partition
(tests/test_torch_tiled_cg.py::emulate with ``pre_blocks``: the C·C planes
staged once a tile over the tile and its halo, the block apply on the halo
from every channel of the neighbours' r ring, NaN off the exchanged rings
and off the grid's planes; a batch as its systems in turn) is held bitwise
to the twin ``fused_grid_cg_reference(..., pre_blocks=...)``, one system
and ``batched=True``, and to the JAX package's Pallas kernel in interpret
mode, one system and under ``jax.vmap``."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import meta_from_numpy
from tests.test_torch_cg_variants import jax_cg_call
from tests.test_torch_tiled_cg import (
    JAX_RTOL,
    N,
    RESET,
    SMEM,
    SMS,
    _forced_plan,
    _iw_inputs,
    _pack,
    emulate,
    radius2_spec,
)

torch.set_num_threads(2)

VMAP_RTOL = 1e-5  # δ against the Pallas kernel under jax.vmap (tests/test_torch_batched_graph.py)
BJ = {"preconditioner": "block_jacobi"}
KINDS = {"GN": "gaussNewtonGPU", "LM": "LMGPU"}
# image_warping's inputs at N² (tests/test_torch_tiled_cg.py::_iw_inputs): the
# bench-like ones, and the lattice ones whose GN iterates do not depend on
# the dots' sum order; jax_cg_call caches a system by its inputs' identity
INPUTS = {"bench": _iw_inputs(), "lattice": _iw_inputs(lattice=True)}


def _moved(inputs, k):
    """Instance k of a batch: the inputs with the fit constraints moved."""
    if k == 0:
        return inputs
    rng = np.random.RandomState(10 + k)
    con = inputs["Constraints"].copy()
    live = con[..., 0] >= 0
    con[live] = (con[live] + rng.randn(int(live.sum()), 2).astype(np.float32)).clip(0)
    return dict(inputs, Constraints=con)


BATCH = 3
BATCH_INPUTS = {name: [_moved(inp, k) for k in range(BATCH)] for name, inp in INPUTS.items()}


def _jax_bj_system(kind, inputs):
    """What the JAX package's first step hands its fused kernel on
    image_warping under block-Jacobi (numpy: meta, r0, pre, keywords)."""
    return jax_cg_call("image_warping", {"W": N, "H": N}, inputs, KINDS[kind], **BJ)


def _torch_bj(call):
    """The JAX call's system in the port's packed layout: (meta, b,
    pre_blocks [C·C, N, N], ctc or None)."""
    jmeta, r0, _pre, kw = call
    meta = meta_from_numpy(jmeta, device="cpu")
    pb = fused_cg.pack_pre_blocks(torch.as_tensor(np.array(kw["pre_blocks"])), meta)
    ctc = _pack(kw["ctc"], meta) if "ctc" in kw else None
    return meta, _pack(r0, meta), pb, ctc


def _radius2_bj(kind, w=23, h=19):
    """The radius-2 stencil (a halo of 2) under block-Jacobi, from the
    port's own plan: (meta, b, pre_blocks, ctc or None)."""
    rng = np.random.RandomState(5)
    inputs = {"X": rng.rand(w, h).astype(np.float32), "A": rng.rand(w, h).astype(np.float32)}
    plan = ott.Problem(radius2_spec, kind=KINDS[kind]).plan(
        dims={"W": w, "H": h}, device="cpu", init_params=ott.InitializationParameters(**BJ))
    meta, r0, _pre, kw = plan.cg_inputs(inputs)
    ctc = fused_cg.pack(kw["ctc"], meta) if kind == "LM" else None
    return meta, fused_cg.pack(r0, meta), fused_cg.pack_pre_blocks(kw["pre_blocks"], meta), ctc


def _lm(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


def _halo(meta, C, dom, lm):
    return fused_cg.tiled_grid_plan(meta, C, dom, lm=lm, block=True, sm_count=SMS,
                                    smem_per_block=SMEM)["halo"]


def emulate_systems(F, triples, b, pb, lits, tol, plan, ctc=None, **lm):
    """The multi-system instances' loop: the batch's systems in turn, each
    with its own fields, planes, exit and count, on the same tiles.
    Returns (δ [B, C, *dom], counts)."""
    out, counts = [], []
    for k in range(int(b.shape[0])):
        d, l = emulate(F[k], triples, b[k], None, lits, tol, plan, pre_blocks=pb[k],
                       ctc=None if ctc is None else ctc[k], **lm)
        out.append(d)
        counts.append(l)
    return torch.stack(out), counts


# -- the emulation against the twin, bitwise ------------------------------------------

# (system, tiles, lits, tol, q_tol): no exit (tol 0, q_tol -inf under LM), and the
# real exits; 3×2 tiles, tiles left ragged by the split (5×4 of 24², 3×2 of
# 23×19), one tile
_CASES = [
    ("image_warping GN", (3, 2), 30, 0.0, None),
    ("image_warping GN", (3, 2), 400, 1e-12, None),
    ("image_warping GN", (5, 4), 30, 0.0, None),
    ("image_warping LM", (3, 2), 30, 0.0, -np.inf),
    ("image_warping LM", (3, 2), 400, 1e-12, 1e-4),
    ("image_warping LM", (5, 4), 30, 0.0, -np.inf),
    ("image_warping GN", (1, 1), 30, 0.0, None),
    ("radius2 23x19 GN", (3, 2), 40, 0.0, None),
    ("radius2 23x19 GN", (3, 2), 400, 1e-12, None),
    ("radius2 23x19 LM", (3, 2), 40, 0.0, -np.inf),
]


def _system(name):
    kind = name.split()[-1]
    if name.startswith("image_warping"):
        return _torch_bj(_jax_bj_system(kind, INPUTS["bench"]))
    return _radius2_bj(kind)


@pytest.mark.parametrize("name,tiles,lits,tol,q_tol", _CASES)
def test_block_emulation_is_bitwise_the_twin(name, tiles, lits, tol, q_tol):
    meta, b, pb, ctc = _system(name)
    C, N1, N2 = b.shape
    h = _halo(meta, C, (N1, N2), ctc is not None)
    assert h == (2 if name.startswith("radius2") else 1)
    plan = _forced_plan(N1, N2, *tiles, h)
    de, le = emulate(meta["F"], meta["triples"], b, None, lits, tol, plan, pre_blocks=pb,
                     **_lm(ctc, q_tol))
    dt, lt = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, None, lits, tol,
                                              pre_blocks=pb, **_lm(ctc, q_tol))
    assert le == lt
    if tol == 0.0:
        assert le == lits
    else:
        assert 2 < le < lits
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())
    if ctc is not None and tol == 0.0:
        assert le > 3 * RESET  # resets occurred


def _stacked(kind, name):
    """The batch's systems (BATCH_INPUTS[name]) as the JAX calls and as the
    port's batched operands (meta with F [B, T, N, N], b, pre_blocks, ctc)."""
    calls = [_jax_bj_system(kind, inp) for inp in BATCH_INPUTS[name]]
    systems = [_torch_bj(c) for c in calls]
    for meta, *_ in systems[1:]:  # one structure, the instances' own fields
        assert meta["triples"] == systems[0][0]["triples"]
    meta = dict(systems[0][0], F=torch.stack([s[0]["F"] for s in systems]), batch=BATCH)
    stack = lambda i: None if systems[0][i] is None else torch.stack([s[i] for s in systems])  # noqa: E731
    return calls, meta, stack(1), stack(2), stack(3)


@pytest.mark.parametrize("kind,tiles,lits,tol,q_tol", [
    ("GN", (3, 2), 30, 0.0, None),
    ("GN", (3, 2), 400, 1e-12, None),
    ("LM", (5, 4), 30, 0.0, -np.inf),
    ("LM", (3, 2), 400, 1e-12, 1e-4),
])
def test_multi_system_emulation_is_bitwise_the_batched_twin(kind, tiles, lits, tol, q_tol):
    """The systems in turn, each with its own fields, planes, exit and
    count, against the batched twin (n_sys = B, batched=True)."""
    _calls, meta, b, pb, ctc = _stacked(kind, "bench")
    plan = _forced_plan(N, N, *tiles, 1)
    de, counts = emulate_systems(meta["F"], meta["triples"], b, pb, lits, tol, plan, ctc,
                                 **({} if ctc is None else dict(reset_period=RESET,
                                                                 q_tolerance=q_tol)))
    twin_counts = []
    dt, lt = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, None, lits, tol, pre_blocks=pb, n_sys=BATCH,
        batched=True, counts=twin_counts, **_lm(ctc, q_tol))
    assert counts == twin_counts and sum(counts) == lt
    if tol == 0.0:
        assert counts == [lits] * BATCH
    assert torch.equal(de, dt)
    assert bool(torch.isfinite(de).all())


# -- the emulation against the Pallas kernel in interpret mode ------------------------

# The lattice system, GN with no exit and with the real exit, LM with no
# exit: under block-Jacobi its iterates move 1.3e-7 (LM) and 2.5e-7 (GN)
# of max|δ| in 25 iterations by the dots' sum order, where the bench-like
# system's move 2.8e-6 (LM) and 2.0e-6 (GN), past JAX_RTOL; that one is
# held to the twin only, bitwise, above
_PALLAS = [
    ("GN", "lattice", 25, 0.0, None),
    ("GN", "lattice", 60, 1e-8, None),
    ("LM", "lattice", 25, 0.0, -np.inf),
]


@pytest.mark.parametrize("kind,name,lits,tol,q_tol", _PALLAS)
def test_block_emulation_matches_pallas_interpret(kind, name, lits, tol, q_tol):
    """The emulation on 3×2 tiles against the JAX package's fused kernel's
    block_pre form in interpret mode: equal counts, δ within JAX_RTOL ·
    max|δ|."""
    call = _jax_bj_system(kind, INPUTS[name])
    jmeta, r0, jpre, kw = call
    jkw = dict(pre_blocks=kw["pre_blocks"])
    if "ctc" in kw:
        jkw.update(ctc=kw["ctc"], reset_period=RESET, q_tolerance=q_tol)
    jd, ji = pcg.fused_grid_cg(jmeta, r0, jpre, lits, tol, interpret=True, **jkw)
    meta, b, pb, ctc = _torch_bj(call)
    jd = _pack(jax.device_get(jd), meta)
    de, le = emulate(meta["F"], meta["triples"], b, None, lits, tol, _forced_plan(N, N, 3, 2, 1),
                     pre_blocks=pb, **_lm(ctc, q_tol))
    assert le == int(ji)
    assert le == lits if tol == 0.0 else 2 < le < lits
    np.testing.assert_allclose(de.numpy(), jd.numpy(), rtol=0,
                               atol=JAX_RTOL * float(jd.abs().max()))


@pytest.mark.parametrize("kind,name,lits,tol,q_tol", _PALLAS)
def test_multi_system_emulation_matches_pallas_under_vmap(kind, name, lits, tol, q_tol):
    """The systems in turn against the Pallas kernel under jax.vmap over the
    batch (interpret mode): equal counts, δ within VMAP_RTOL · max|δ|."""
    calls, meta, b, pb, ctc = _stacked(kind, name)
    jmeta = calls[0][0]
    st = lambda key: {u: np.stack([c[key][u] for c in calls]) for u in calls[0][key]}  # noqa: E731
    jF = np.stack([c[0]["F"] for c in calls])
    jpb = np.stack([c[3]["pre_blocks"] for c in calls])
    jctc = ({u: np.stack([c[3]["ctc"][u] for c in calls]) for u in calls[0][3]["ctc"]}
            if ctc is not None else None)

    def one(F, r, p, pbk, c):
        kw = dict(pre_blocks=pbk)
        if c is not None:
            kw.update(ctc=c, reset_period=RESET, q_tolerance=q_tol)
        return pcg.fused_grid_cg(dict(jmeta, F=F), r, p, lits, tol, interpret=True, **kw)

    jd, ji = jax.device_get(jax.vmap(one)(jF, st(1), st(2), jpb, jctc))
    de, counts = emulate_systems(meta["F"], meta["triples"], b, pb, lits, tol,
                                 _forced_plan(N, N, 3, 2, 1), ctc,
                                 **({} if ctc is None else dict(reset_period=RESET,
                                                                 q_tolerance=q_tol)))
    assert counts == np.asarray(ji).reshape(-1).tolist()
    if tol == 0.0:
        assert counts == [lits] * BATCH
    for k in range(BATCH):
        want = _pack({u: v[k] for u, v in jd.items()}, meta)
        np.testing.assert_allclose(de[k].numpy(), want.numpy(), rtol=0,
                                   atol=VMAP_RTOL * float(want.abs().max()))
