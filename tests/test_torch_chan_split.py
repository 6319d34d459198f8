"""The per-channel split of the fused CG loop (the JAX package's
``chan_grid`` form) through opt_tpu_torch, held to opt_tpu on the CPU: the
planner's decision (poisson's channel-diagonal operator splits beyond the
working-set constant; image_warping's cross-channel operator, a
block-Jacobi plan and a joint loop that fits do not), the one-channel
triples, the twin over C independent systems against the Pallas kernel
with ``chan_grid=True`` in interpret mode (δ, each channel's own count, the
summed count returned), whole solves against the JAX package's split solve,
and the descriptor carried across by ``utils.convert``. The CUDA
multi-system instances run on the card in chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy
from tests.test_torch_cg_variants import (
    _pack, count_fused, jax_cg_call, poisson_inputs, warp_inputs)

torch.set_num_threads(2)

f32 = np.float32
N = 48
DIMS = {"W": N, "H": N}
POISSON = poisson_inputs(N)  # tests/test_pallas.py:690-698 but for the mask's hole
KINDS = ["gaussNewtonGPU", "LMGPU"]
PLANE_BYTES = 4 * N * N


@pytest.fixture
def lowered(monkeypatch):
    """Both packages' criteria lowered so that poisson 48²×4 splits: the
    JAX package's VMEM budget as tests/test_pallas.py:699-700 lowers it, the
    port's working-set constant to 30 planes (the joint loop's 7·4 + 5 = 33
    planes are beyond it, one channel's 7 + 5 = 12 are not)."""
    plane = pcg.padded_spatial_elems((N, N)) * 4
    monkeypatch.setattr(pcg, "VMEM_BUDGET_BYTES", 30 * plane)
    monkeypatch.setattr(fused_cg, "SPLIT_WORKING_SET_BYTES", 30 * PLANE_BYTES)


def tplan(name="poisson_image_editing", kind="gaussNewtonGPU", dims=DIMS, **ip):
    return ott.Problem(getattr(tspecs, name), kind=kind).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))


def jplan(kind="gaussNewtonGPU", **ip):
    return ot.Problem(jspecs.poisson_image_editing, kind=kind).plan(
        dims=DIMS, init_params=ot.InitializationParameters(**ip))


def tmeta(plan, inputs):
    return plan.cg_inputs(inputs_from_numpy(inputs, device="cpu"))[0]


# -- the planner -------------------------------------------------------------------


def test_split_triples():
    lap = [((0, 0), c, c, 0) for c in range(3)] + [((1, 0), c, c, 1) for c in range(3)]
    assert fused_cg.split_triples(lap, 3) == (((0, 0), 0, 0, 0), ((1, 0), 0, 0, 1))
    assert fused_cg.split_triples(lap[:2], 1) is None  # one channel: nothing to split
    assert fused_cg.split_triples(lap + [((0, 0), 0, 1, 2)], 3) is None  # a cross-channel triple
    assert fused_cg.split_triples(lap + [((0, 1), 0, 0, 2)], 3) is None  # channel 0 has one more
    assert fused_cg.split_triples(lap[:3] + lap[4:], 3) is None  # channel 0 lacks one
    per_chan = [((0, 0), c, c, c) for c in range(3)]  # each channel its own field
    assert fused_cg.split_triples(per_chan, 3) is None
    assert fused_cg.split_triples(lap[:4], 4) is None  # a channel with no triple


def test_default_constant_splits_1024_and_not_512():
    """The working set the criterion counts (7 state planes a channel plus
    the 5 fields, float32) against the default constant: poisson 1024²×4 is
    beyond it jointly and within it a channel; 512²×4 fits jointly."""
    limit, planes = fused_cg.SPLIT_WORKING_SET_BYTES, fused_cg.STATE_PLANES_PER_CHANNEL
    big, small = 4 * 1024 * 1024, 4 * 512 * 512
    assert (planes * 4 + 5) * big > limit >= (planes + 5) * big
    assert (planes * 4 + 5) * small <= limit


@pytest.mark.parametrize("kind", KINDS)
def test_planner_splits_poisson_beyond_the_constant(lowered, kind):
    """poisson 48²×4 under the lowered constant: ``chan_grid``, the five
    one-channel triples of the JAX package's descriptor, the shared fields
    to 1e-6."""
    want = meta_from_numpy(jax_cg_call("poisson_image_editing", DIMS, POISSON, kind)[0], "cpu")
    assert want["chan_grid"]
    meta = tmeta(tplan(kind=kind), POISSON)
    assert meta["chan_grid"] and meta["ctot"] == 4
    assert meta["triples"] == want["triples"] and len(meta["triples"]) == 5
    assert all(i == 0 and j == 0 for (_d, i, j, _f) in meta["triples"])
    np.testing.assert_allclose(meta["F"].numpy(), want["F"].numpy(), rtol=0, atol=1e-6)


def test_planner_keeps_a_joint_loop_that_fits():
    """At the default constant poisson 48²×4 (33 planes of 9 KB) stays
    joint: 20 triples, one a channel and offset."""
    meta = tmeta(tplan(), POISSON)
    assert not meta["chan_grid"] and len(meta["triples"]) == 20


def test_planner_keeps_one_channel_beyond_the_constant(monkeypatch):
    """Where one channel's working set is beyond the constant too, the
    split gains nothing and the loop stays joint."""
    monkeypatch.setattr(fused_cg, "SPLIT_WORKING_SET_BYTES", 10 * PLANE_BYTES)
    assert not tmeta(tplan(), POISSON)["chan_grid"]


def test_planner_does_not_split_image_warping(lowered):
    """Cross-channel triples (tests/test_pallas.py:728-751): never split,
    whatever the constant."""
    meta = tmeta(tplan("image_warping"), warp_inputs(N))
    assert meta is not None and not meta["chan_grid"]
    assert any(i != j for (_d, i, j, _f) in meta["triples"])


def _smooth4(pkg):
    """A four-channel smoothing energy, channel-diagonal with
    channel-identical fields like poisson, but with its preconditioner on."""

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 4, (W, H))
        A = S.Array("A", 4, (W, H))
        S.Energy(0.5 * (X(0, 0) - A(0, 0)))
        for dx, dy in ((1, 0), (0, 1)):
            S.Energy(pkg.Select(pkg.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))

    return spec


def test_planner_does_not_split_under_block_jacobi(lowered):
    """A block preconditioner couples the channels: under block-Jacobi a
    separable operator keeps the joint loop (with Jacobi it splits), and
    the solve goes through the block-Jacobi loop with no fallback, to the
    JAX package's cost. poisson switches its preconditioner off
    (UsePreconditioner(False)), so no block is applied and it splits under
    either setting, as in the JAX package."""
    rng = np.random.RandomState(2)
    inputs = {"X": rng.rand(N, N, 4).astype(f32), "A": rng.rand(N, N, 4).astype(f32)}
    plans = {}
    for pre in ("jacobi", "block_jacobi"):
        plans[pre] = ott.Problem(_smooth4(ott)).plan(
            dims=DIMS, device="cpu", init_params=ott.InitializationParameters(preconditioner=pre))
    meta = tmeta(plans["jacobi"], inputs)
    assert meta["chan_grid"] and meta["ctot"] == 4
    meta, _r0, _pre, kw = plans["block_jacobi"].cg_inputs(inputs_from_numpy(inputs, device="cpu"))
    assert not meta["chan_grid"] and kw["pre_blocks"] is not None
    res = plans["block_jacobi"].solve(dict(inputs), nIterations=1, lIterations=20)
    assert plans["block_jacobi"].fused_fallback is None
    jres = ot.Problem(_smooth4(ot)).plan(
        dims=DIMS, init_params=ot.InitializationParameters(
            preconditioner="block_jacobi", use_pallas_cg="interpret")
    ).solve(dict(inputs), nIterations=1, lIterations=20)
    np.testing.assert_allclose(res.final_cost, jres.final_cost, rtol=1e-5)
    # poisson: no preconditioner, so nothing couples the channels
    pmeta, _r0, _pre, pkw = tplan(preconditioner="block_jacobi").cg_inputs(
        inputs_from_numpy(POISSON, device="cpu"))
    jmeta, _jr0, _jpre, jkw = jax_cg_call("poisson_image_editing", DIMS, POISSON,
                                          preconditioner="block_jacobi")
    assert pmeta["chan_grid"] and pkw["pre_blocks"] is None
    assert jmeta["chan_grid"] and jkw["pre_blocks"] is None


# -- the twin against the Pallas kernel --------------------------------------------


def _pallas_split(call, lits, tol, **over):
    """The JAX call's split system through the Pallas kernel in interpret
    mode: (δ packed [C, H, W], the summed count, each channel's count). The
    kernel returns only the sum, so each channel's count comes from the
    same kernel on that channel alone (a one-channel descriptor over the
    shared fields), which is what a grid step of the split runs."""
    jmeta, r0, pre, jkw = call
    kw = dict(jkw, **over)
    assert jmeta["chan_grid"]
    d, total = pcg.fused_grid_cg(jmeta, r0, pre, lits, tol, interpret=True, **kw)
    one = dict(jmeta, chan_grid=False, ctot=1, channels={"X": 1})
    counts = []
    for c in range(int(jmeta["ctot"])):
        sl = lambda a: {"X": a["X"][..., c : c + 1]}  # noqa: E731
        kc = dict(kw, ctc=sl(kw["ctc"])) if kw.get("ctc") is not None else kw
        dc, lc = pcg.fused_grid_cg(one, sl(r0), sl(pre), lits, tol, interpret=True, **kc)
        np.testing.assert_array_equal(np.asarray(dc["X"]), np.asarray(d["X"])[..., c : c + 1])
        counts.append(int(lc))
    return np.moveaxis(np.asarray(jax.device_get(d["X"])), -1, 0), int(total), counts


def _twin_split(call, lits, tol, **over):
    jmeta, r0, pre, jkw = call
    kw = dict(jkw, **over)
    meta = meta_from_numpy(jmeta, device="cpu")
    tkw = {}
    if kw.get("ctc") is not None:
        tkw = dict(ctc=_pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                   q_tolerance=float(kw["q_tolerance"]))
    counts = []
    d, total = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], _pack(r0, meta), _pack(pre, meta), lits, tol,
        n_sys=int(meta["ctot"]), counts=counts, **tkw)
    return d.numpy(), total, counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("exit_", ["none", "real"])
def test_twin_matches_pallas_chan_grid(lowered, kind, exit_):
    """The twin over four one-channel systems against the Pallas kernel
    with ``chan_grid=True`` in interpret mode, GN and LM: with no exit
    after 40 iterations a channel, and with the real exits (GN's rᵀz floor;
    LM's too, its ζ exit switched off: ζ is a difference of two sums that
    the two loops take in another width): each channel's own count equal,
    the counts differing between channels at the exits, their sum returned,
    δ to 1e-6 (max|δ| is 1)."""
    call = jax_cg_call("poisson_image_editing", DIMS, POISSON, kind)
    over = dict(q_tolerance=-np.inf) if kind == "LMGPU" else {}
    lits, tol = (40, 0.0) if exit_ == "none" else (400, 1e-12)
    jd, jtotal, jcounts = _pallas_split(call, lits, tol, **over)
    td, ttotal, tcounts = _twin_split(call, lits, tol, **over)
    assert tcounts == jcounts and ttotal == jtotal == sum(jcounts)
    if exit_ == "none":
        assert jcounts == [40] * 4
    else:
        assert all(5 < c < 400 for c in jcounts) and len(set(jcounts)) > 1
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)


def test_lm_q_exit_is_each_channels_own(lowered):
    """With a loose q_tolerance each channel leaves by its own ζ exit, at
    the Pallas kernel's counts."""
    call = jax_cg_call("poisson_image_editing", DIMS, POISSON, "LMGPU")
    jd, jtotal, jcounts = _pallas_split(call, 400, 1e-12, q_tolerance=1e-2)
    td, ttotal, tcounts = _twin_split(call, 400, 1e-12, q_tolerance=1e-2)
    assert tcounts == jcounts and ttotal == jtotal and max(jcounts) < 100
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)


def test_twin_refuses_what_the_split_cannot_take():
    meta = tmeta(tplan(), POISSON)
    b = torch.ones((4, N, N))
    with pytest.raises(ValueError, match="do not split"):
        fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b[:3], b[:3], 5, 0.0, n_sys=2)
    with pytest.raises(ValueError, match="no remainder and no block"):
        fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, b, 5, 0.0, n_sys=4,
                                         pre_blocks=torch.ones((16, N, N)))


# -- whole solves ------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_split_solve_matches_jax(lowered, monkeypatch, kind):
    """tests/test_pallas.py:713-727 through both packages: the split solve
    (nIterations=2, lIterations=40) against the JAX package's split solve,
    costs to 1e-5 and the unknown to 1e-4 (its own test holds split and
    joint to 1e-3 and 2e-3), with the summed CG count (up to 4·40 a step)
    equal, and against this port's joint solve to 1e-3."""
    calls = count_fused(monkeypatch)
    tp, jp = tplan(kind=kind), jplan(kind, use_pallas_cg="interpret")
    tr = tp.solve(dict(POISSON), nIterations=2, lIterations=40)
    jr = jp.solve(dict(POISSON), nIterations=2, lIterations=40)
    assert tp.fused_fallback is None and jp.fused_fallback is None
    assert len(calls) == tr.num_iterations
    np.testing.assert_allclose(tr.costs, jr.costs, rtol=1e-5)
    np.testing.assert_allclose(tr.unknowns["X"].numpy(), np.asarray(jr.unknowns["X"]),
                               rtol=0, atol=1e-4)
    assert tr.num_linear_iterations == jr.num_linear_iterations
    assert tr.num_linear_iterations > 40 * tr.num_iterations  # counts summed over channels
    monkeypatch.setattr(fused_cg, "SPLIT_WORKING_SET_BYTES", 50 * 2**20)
    joint = tplan(kind=kind).solve(dict(POISSON), nIterations=2, lIterations=40)
    np.testing.assert_allclose(tr.final_cost, joint.final_cost, rtol=1e-3)
    np.testing.assert_allclose(tr.unknowns["X"].numpy(), joint.unknowns["X"].numpy(),
                               rtol=0, atol=2e-3)


def test_fused_grid_cg_returns_the_summed_count(lowered):
    """``fused_grid_cg`` on a split descriptor: the iterations it returns
    are the sum of the systems' counts."""
    tp = tplan()
    meta, r0, pre, _kw = tp.cg_inputs(inputs_from_numpy(POISSON, device="cpu"))
    _d, iters = fused_cg.fused_grid_cg(meta, r0, pre, 400, 1e-12)
    counts = []
    fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), 400,
        1e-12, n_sys=4, counts=counts)
    assert len(counts) == 4 and int(iters) == sum(counts)


# -- the descriptor carried across -------------------------------------------------


def test_convert_carries_chan_grid(lowered):
    jm = jax_cg_call("poisson_image_editing", DIMS, POISSON)[0]
    meta = meta_from_numpy(jm, device="cpu")
    assert meta["chan_grid"] is True and meta["ctot"] == 4 and len(meta["triples"]) == 5
    joint = meta_from_numpy({k: v for k, v in jm.items() if k != "chan_grid"}, device="cpu")
    assert joint["chan_grid"] is False
