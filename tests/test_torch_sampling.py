"""SampledImage through opt_tpu_torch, held to opt_tpu on the CPU: the
bilinear sampler (integer positions hit texels, taps outside the image are
zero), its position derivative taken from the dx/dy images under ``jvp`` and
``vmap(jvp)``, optical_flow's registry, residuals, JᵀF, Jacobi diagonal,
assembly plan and fused descriptor, the fused loop's twin against the Pallas
kernel in interpret mode, whole steps, the medium golden and the host-driven
two-level loop with ``upsample2x_nearest``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu import assembly as j_asm
from opt_tpu.compile import compile_spec as j_compile
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu.ops import sampling as j_sampling
from opt_tpu_torch import assembly as t_asm
from opt_tpu_torch.compile import compile_spec as t_compile
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import sampling as t_sampling
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy
from tests.test_golden_costs import GOLDEN, _medium_cases
from tests.test_torch_cg_variants import count_fused, jax_cg_call, twin_vs_pallas

torch.set_num_threads(2)

f32 = np.float32
N = 24
DIMS = {"W": N, "H": N}
FLOW = "optical_flow"


def flow_inputs(n=N, noise=0.3):
    """bench.py::bench_optical_flow's finest level at n²: a smoothed random
    image and itself translated by (2, 1), central differences of the
    second; the flow starts at ``noise``·randn so that the samples fall
    between texels (and a few outside the image)."""
    rng = np.random.RandomState(0)
    base = rng.rand(n + 8, n + 8).astype(f32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, -1, 0)
            + np.roll(base, -1, 1)) / 5.0
    a, b = base[4 : 4 + n, 4 : 4 + n].copy(), base[6 : 6 + n, 5 : 5 + n].copy()
    dx, dy = np.zeros_like(b), np.zeros_like(b)
    dx[1:-1, :] = 0.5 * (b[2:, :] - b[:-2, :])
    dy[:, 1:-1] = 0.5 * (b[:, 2:] - b[:, :-2])
    return {"X": noise * rng.randn(n, n, 2).astype(f32), "I": a, "I_hat": b, "I_hat_dx": dx,
            "I_hat_dy": dy, "w_fit": 10.0, "w_reg": 0.1}


INPUTS = flow_inputs()


def jplan(dims=DIMS, **ip):
    return ot.Problem(jspecs.optical_flow).plan(
        dims=dims, init_params=ot.InitializationParameters(**ip))


def tplan(dims=DIMS, **ip):
    return ott.Problem(tspecs.optical_flow).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))


# -- the sampler -------------------------------------------------------------------


def _images(w=7, h=5, c=2):
    rng = np.random.RandomState(3)
    return [rng.rand(w, h, c).astype(f32) for _ in range(3)]


def test_bilinear_hits_texels_and_zero_pads():
    img = _images()[0]
    ii, jj = np.meshgrid(np.arange(7, dtype=f32), np.arange(5, dtype=f32), indexing="ij")
    out = t_sampling._bilinear(torch.as_tensor(img), torch.as_tensor(ii), torch.as_tensor(jj))
    assert torch.equal(out, torch.as_tensor(img))  # integer positions: the texels, exactly
    x = torch.tensor([-1.0, -0.5, 6.5, 7.0, 3.0, 3.0], dtype=torch.float32)
    y = torch.tensor([2.0, 2.0, 1.0, 1.0, -0.25, 4.75], dtype=torch.float32)
    out = t_sampling._bilinear(torch.as_tensor(img), x, y).numpy()
    want = np.stack([
        np.zeros(2, f32),  # every tap outside
        0.5 * img[0, 2],  # the tap at x = -1 reads zero
        0.5 * img[6, 1],  # the tap at x = 7 reads zero
        np.zeros(2, f32),
        0.75 * img[3, 0],  # the tap at y = -1 reads zero
        0.25 * img[3, 4],  # the tap at y = 5 reads zero
    ])
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)


def test_bilinear_matches_jax():
    """Random positions, a tenth of them outside the image: to 1e-6."""
    img = _images()[0]
    rng = np.random.RandomState(4)
    x = (rng.rand(40, 3) * 9 - 1).astype(f32)
    y = (rng.rand(40, 3) * 7 - 1).astype(f32)
    got = t_sampling._bilinear(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y))
    want = np.asarray(j_sampling._bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _positions():
    rng = np.random.RandomState(5)
    x = (rng.rand(6, 4) * 8 - 0.5).astype(f32)
    y = (rng.rand(6, 4) * 6 - 0.5).astype(f32)
    return x, y, rng.randn(3, 6, 4).astype(f32), rng.randn(3, 6, 4).astype(f32)


def test_jvp_reads_the_derivative_images():
    """The tangent is dx·ẋ + dy·ẏ with dx, dy bilinear samples of the
    derivative images (not the interpolation's slope), the value the plain
    sample: against their definition exactly and against the JAX package's
    ``custom_jvp`` to 1e-6; no tangent flows into the images."""
    img, dxi, dyi = (torch.as_tensor(a) for a in _images())
    x, y, tx, ty = _positions()
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    fn = lambda a, b: t_sampling.sample_with_derivs(img, dxi, dyi, a, b)  # noqa: E731
    val, tan = torch.func.jvp(fn, (xt, yt), (torch.as_tensor(tx[0]), torch.as_tensor(ty[0])))
    assert torch.equal(val, t_sampling._bilinear(img, xt, yt))
    want = (t_sampling._bilinear(dxi, xt, yt) * torch.as_tensor(tx[0])[..., None]
            + t_sampling._bilinear(dyi, xt, yt) * torch.as_tensor(ty[0])[..., None])
    assert torch.equal(tan, want)
    jfn = lambda a, b: j_sampling.sample_with_derivs(*(jnp.asarray(i) for i in _images()), a, b)  # noqa: E731
    jval, jtan = jax.jvp(jfn, (jnp.asarray(x), jnp.asarray(y)),
                         (jnp.asarray(tx[0]), jnp.asarray(ty[0])))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tan.numpy(), np.asarray(jtan), rtol=0, atol=1e-6)
    # the images carry no derivative
    _v, t_img = torch.func.jvp(
        lambda im: t_sampling.sample_with_derivs(im, dxi, dyi, xt, yt), (img,),
        (torch.ones_like(img),))
    assert float(t_img.abs().max()) == 0.0


def test_jvp_under_vmap_and_vjp():
    """``vmap(jvp)`` over a batch of tangents (the assembly's probes) gives
    each tangent's jvp; the vjp pulls back through the same dx/dy samples."""
    img, dxi, dyi = (torch.as_tensor(a) for a in _images())
    x, y, tx, ty = _positions()
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    fn = lambda a, b: t_sampling.sample_with_derivs(img, dxi, dyi, a, b)  # noqa: E731
    batched = torch.func.vmap(lambda a, b: torch.func.jvp(fn, (xt, yt), (a, b))[1])(
        torch.as_tensor(tx), torch.as_tensor(ty))
    for k in range(3):
        one = torch.func.jvp(fn, (xt, yt), (torch.as_tensor(tx[k]), torch.as_tensor(ty[k])))[1]
        assert torch.equal(batched[k], one)
    out, pull = torch.func.vjp(fn, xt, yt)
    ct = torch.as_tensor(np.random.RandomState(6).randn(*out.shape).astype(f32))
    gx, gy = pull(ct)
    np.testing.assert_allclose(
        gx.numpy(), (t_sampling._bilinear(dxi, xt, yt) * ct).sum(-1).numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        gy.numpy(), (t_sampling._bilinear(dyi, xt, yt) * ct).sum(-1).numpy(), rtol=1e-6, atol=1e-7)


def test_central_difference_images_match_jax():
    img = _images()[0]
    for got, want in zip(t_sampling.central_difference_images(torch.as_tensor(img)),
                         j_sampling.central_difference_images(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_image_without_derivative_images():
    """``S.SampledImage(image)`` alone takes central differences of the
    image as its derivative images, in both packages."""

    def make(pkg):
        def spec(S):
            W, H = S.Dim("W"), S.Dim("H")
            X = S.Unknown("X", 2, (W, H))
            A = S.Array("A", 1, (W, H))
            samp = S.SampledImage(A)
            i, j = S.Index(0), S.Index(1)
            S.Energy(samp(i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1]) - 0.5,
                     0.1 * (X(0, 0) - X(1, 0)))

        return spec

    rng = np.random.RandomState(7)
    inputs = {"X": 0.4 * rng.randn(8, 8, 2).astype(f32), "A": rng.rand(8, 8).astype(f32)}
    dims = {"W": 8, "H": 8}
    jp = ot.Problem(make(ot)).plan(dims=dims)
    tp = ott.Problem(make(ott)).plan(dims=dims, device="cpu")
    ju, jc, jg, jpar = jp._normalize_and_place(dict(inputs))
    tu, tc, tg, tpar = tp._normalize_and_place(dict(inputs))
    want = np.asarray(jax.device_get(JFunctionSet(jp.compiled, jc, jg, jpar).jtf(ju)["X"]))
    got = TFunctionSet(tp.compiled, tc, tg, tpar).jtf(tu)["X"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- optical_flow ------------------------------------------------------------------


def _slot_sig(s):
    return (str(s.key), s.kind, s.image, s.offset, s.channels, s.is_unknown, s.internal)


def test_registry_and_plan_equal_jax():
    """The same slots (the sampled images are read whole, not as slots),
    the same comparison constants, no tainted term (the sampler's own
    floor/ceil/casts are not gates of the residual, as the JAX package does
    not descend into its ``custom_jvp`` rule) and equal assembly plans."""
    jc, tc = jplan().compiled, tplan().compiled
    assert [_slot_sig(s) for s in tc.registry.slots] == [_slot_sig(s) for s in jc.registry.slots]
    assert not any("I_hat" in str(s.key) for s in tc.registry.slots)
    pj = j_compile(jspecs.optical_flow, {"W": 8, "H": 8}, jnp.float32)
    pt = t_compile(tspecs.optical_flow, {"W": 8, "H": 8}, torch.float32)
    a = j_asm._probe_inputs(pj, np.random.RandomState(1), 32)
    b = t_asm._probe_inputs(pt, np.random.RandomState(1), 32)
    assert t_asm._comparison_constants(pt, *b) == j_asm._comparison_constants(pj, *a)
    assert (t_asm._terms_with_traced_gates(pt, *b)
            == j_asm._terms_with_traced_gates(pj, *a) == frozenset())
    sj, st = jplan().solver._stencil_plan, tplan().solver._stencil_plan
    assert st.w_spec == sj.w_spec
    assert st.scalar_groups == sj.scalar_groups
    assert st.const_tsids == sj.const_tsids


def test_user_gates_on_sampled_values_still_taint():
    """A comparison of a sampled value against an array (no literal) is a
    gate of the user's residual: its term is tainted in both packages,
    although the sampler's own piecewise ops are passed over."""

    def make(pkg):
        def spec(S):
            W, H = S.Dim("W"), S.Dim("H")
            X = S.Unknown("X", 2, (W, H))
            A = S.Array("A", 1, (W, H))
            B = S.Array("B", 1, (W, H))
            samp = S.SampledImage(A)
            i, j = S.Index(0), S.Index(1)
            v = samp(i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1])
            S.Energy(pkg.Select(pkg.greater(v, B(0, 0)), v, 0.0), X(0, 0) - X(1, 0))

        return spec

    pj = j_compile(make(ot), {"W": 8, "H": 8}, jnp.float32)
    pt = t_compile(make(ott), {"W": 8, "H": 8}, torch.float32)
    a = j_asm._probe_inputs(pj, np.random.RandomState(1), 32)
    b = t_asm._probe_inputs(pt, np.random.RandomState(1), 32)
    assert (t_asm._terms_with_traced_gates(pt, *b)
            == j_asm._terms_with_traced_gates(pj, *a) == frozenset({0}))


def test_residuals_jtf_and_diagonal_match_jax():
    jp, tp = jplan(), tplan()
    ju, jc, jg, jpar = jp._normalize_and_place(dict(INPUTS))
    tu, tc, tg, tpar = tp._normalize_and_place(dict(INPUTS))
    jfs, tfs = JFunctionSet(jp.compiled, jc, jg, jpar), TFunctionSet(tp.compiled, tc, tg, tpar)
    for a, b in zip(tfs.F(tu), jax.device_get(jfs.F(ju))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1.0))
    for got, want in ((tfs.jtf(tu), jfs.jtf(ju)), (tfs.jtj_diag(tu), jfs.jtj_diag(ju))):
        want = np.asarray(jax.device_get(want["X"]))
        np.testing.assert_allclose(got["X"].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_fused_descriptor_equals_jax():
    """C = 2 with cross-channel triples (the fit term couples u and v
    through dx·dy): triples equal, fields to 1e-5 of their scale, no
    per-channel split."""
    want = meta_from_numpy(jax_cg_call(FLOW, DIMS, INPUTS)[0], device="cpu")
    tp = tplan()
    meta, _r0, _pre, _kw = tp.cg_inputs(inputs_from_numpy(INPUTS, device="cpu"))
    assert tp.fused_fallback is None and meta is not None
    assert meta["ctot"] == 2 and not meta["chan_grid"]
    assert meta["triples"] == want["triples"]
    assert any(i != j for (_d, i, j, _f) in meta["triples"])
    np.testing.assert_allclose(meta["F"].numpy(), want["F"].numpy(), rtol=0,
                               atol=1e-5 * float(want["F"].abs().max()))


@pytest.mark.parametrize("lits,rtol", [(10, 1e-5), (50, 2e-3)])
def test_twin_matches_pallas_interpret(lits, rtol):
    """The twin against ``pallas_cg.fused_grid_cg(..., interpret=True)`` on
    the system the JAX step hands its kernel (no preconditioner:
    UsePreconditioner(False)): equal counts; δ to 1e-5 of its scale after
    10 iterations (1e-6 read) and to 2e-3 after the path's 50 (5e-4 read:
    on this unpreconditioned system the two loops' float32 iterates, their
    dots summed in another order and width, part by about 4x every 10
    iterations)."""
    jd, ji, td, ti = twin_vs_pallas(jax_cg_call(FLOW, DIMS, INPUTS), lits, 1e-12)
    assert ti == ji == lits
    np.testing.assert_allclose(td, jd, rtol=0, atol=rtol * np.abs(jd).max())


def test_steps_match_jax_through_the_fused_loop(monkeypatch):
    """One step of 10 CG iterations to 1e-5 (cost) and 1e-4 (the flow). At
    the path's 50 iterations a step the unpreconditioned CG is unstable: from
    the 15th iteration on a rounding difference grows about 2.5x an
    iteration, in float64 as in float32 (ROADMAP.md queue 3), so one step's
    cost is held to 1e-3 (7e-5 read) and three steps' to 1e-2 (1.3e-3
    read); the fused loop runs once a step on both sides, with equal
    counts."""
    calls = count_fused(monkeypatch)
    tp, jp = tplan(), jplan(use_pallas_cg="interpret")
    t1 = tp.solve(dict(INPUTS), nIterations=1, lIterations=10)
    j1 = jp.solve(dict(INPUTS), nIterations=1, lIterations=10)
    np.testing.assert_allclose(t1.final_cost, j1.final_cost, rtol=1e-5)
    np.testing.assert_allclose(t1.unknowns["X"].numpy(), np.asarray(j1.unknowns["X"]),
                               rtol=0, atol=1e-4)
    del calls[:]
    t3 = tp.solve(dict(INPUTS), nIterations=3, lIterations=50)
    j3 = jp.solve(dict(INPUTS), nIterations=3, lIterations=50)
    np.testing.assert_allclose(t3.costs[0], j3.costs[0], rtol=1e-3)
    np.testing.assert_allclose(t3.costs, j3.costs, rtol=1e-2)
    assert t3.num_linear_iterations == j3.num_linear_iterations == 150
    assert len(calls) == 3
    assert tp.fused_fallback is None and jp.fused_fallback is None


def test_medium_golden():
    """tests/test_golden_costs.py's optical_flow pin (GN 4x40 at 32²) within
    its 5e-3."""
    kind, nl, li, golden = GOLDEN[FLOW]
    dims, inputs = _medium_cases()[FLOW]
    tp = ott.Problem(tspecs.optical_flow, kind=kind).plan(dims=dims, device="cpu")
    res = tp.solve(dict(inputs), nIterations=nl, lIterations=li)
    assert tp.fused_fallback is None
    np.testing.assert_allclose(res.final_cost, golden, rtol=5e-3)


# -- the level loop ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (7, 5)])
def test_upsample2x_nearest_matches_jax(shape):
    rng = np.random.RandomState(8)
    a = rng.randn(4, 4, 2).astype(f32)
    got = ott.upsample2x_nearest(torch.as_tensor(a), shape, scale=2.0)
    want = np.asarray(ot.upsample2x_nearest(jnp.asarray(a), shape, scale=2.0))
    assert tuple(got.shape) == shape + (2,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 1, 0] == 2.0 * a[0, 0, 0] and got[2, 3, 1] == 2.0 * a[1, 1, 1]


def test_two_level_loop_matches_jax():
    """bench.py::bench_optical_flow's host-driven loop at 16² then 32² (a
    plan a level, the flow upsampled and doubled between), GN 2x12 a level
    (12 CG iterations, where the unpreconditioned loop is still stable):
    each level's costs to 1e-4 of the JAX package's."""
    fine = flow_inputs(32, noise=0.0)
    coarse = {k: (v[::2, ::2].copy() if isinstance(v, np.ndarray) and k != "X" else v)
              for k, v in fine.items()}
    b = coarse["I_hat"]
    coarse["I_hat_dx"], coarse["I_hat_dy"] = np.zeros_like(b), np.zeros_like(b)
    coarse["I_hat_dx"][1:-1, :] = 0.5 * (b[2:, :] - b[:-2, :])
    coarse["I_hat_dy"][:, 1:-1] = 0.5 * (b[:, 2:] - b[:, :-2])
    coarse["X"] = np.zeros((16, 16, 2), f32)
    tX, jX = coarse["X"], coarse["X"]
    for level in (coarse, fine):
        w, h = level["I"].shape
        tr = tplan({"W": w, "H": h}).solve({**level, "X": tX}, nIterations=2, lIterations=12)
        jr = jplan({"W": w, "H": h}).solve({**level, "X": jX}, nIterations=2, lIterations=12)
        np.testing.assert_allclose(tr.costs, jr.costs, rtol=1e-4)
        tX = ott.upsample2x_nearest(tr.unknowns["X"], (2 * w, 2 * h), scale=2.0)
        jX = np.asarray(ot.upsample2x_nearest(jr.unknowns["X"], (2 * w, 2 * h), scale=2.0))
