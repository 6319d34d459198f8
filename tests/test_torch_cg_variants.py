"""The solver variants of the port held to opt_tpu on the CPU:
Chronopoulos–Gear CG (``cg_variant="chronopoulos_gear"``) and bfloat16
coefficient storage (``coefficient_dtype="bfloat16"``); the block-Jacobi
preconditioner is in test_torch_block_jacobi.py, on the helpers here.

For each, the fused loop's plain twin is held to the JAX package's Pallas
kernel in interpret mode on the system opt_tpu's own solver hands it (the
cs and bf16 forms, GN and LM, grid and graph), with equal iteration
counts; the narrowed fields are held to the JAX package's; and the JAX
package's own variant tests run through the port. The CUDA instances
themselves run on the card in chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu.ops.pallas_cg as pcg
import opt_tpu_torch as ott
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.solver import gauss_newton as t_gn
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy, pre_blocks_from_numpy

torch.set_num_threads(2)

f32 = np.float32
# f32 CG iterates whose dot products are summed in another order, after a
# fixed count; and at the real exits, which run up to hundreds of
# iterations on ill-conditioned systems (image_warping)
DELTA_RTOL = 1e-5
EXIT_DELTA_RTOL = 1e-4
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
CS = "chronopoulos_gear"
LM_KW = ("ctc", "reset_period", "q_tolerance")


# -- inputs (the JAX package's variant tests) ------------------------------------


def poisson_inputs(n):
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), f32)
    mask[n // 4 : -n // 4, n // 4 : -n // 4] = 0.0
    return {"X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32), "M": mask}


def warp_inputs(n, con_a=(2.0, 2.0), at=1, w_fit=3.0, jitter=0.05):
    """tests/test_bf16_coefficients.py::_warp_inputs (at=1) and
    tests/test_block_jacobi.py::_warp_case (at=2, con_a (4, 4))."""
    rng = np.random.RandomState(0)
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    con[at, at] = con_a
    con[n - 1 - at, n - 1 - at] = [n - 2.0 - at, n - at] if at == 1 else [n - 6.0, n - 2.0]
    return {
        "Offset": ur + jitter * rng.randn(n, n, 2).astype(f32),
        "Angle": np.zeros((n, n), f32), "UrShape": ur, "Constraints": con,
        "Mask": np.zeros((n, n), f32), "w_fitSqrt": f32(w_fit), "w_regSqrt": f32(1.0),
    }


def arap_inputs(n_side, pin_rows=False):
    """tests/test_cg_variants.py::_arap_inputs, or with pin_rows
    tests/test_block_jacobi.py::_arap_case (first row pinned, last pulled)."""
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -np.ones((N, 3), f32)
    if pin_rows:
        con[vid[0, :]] = pos[vid[0, :]]
        con[vid[-1, :]] = pos[vid[-1, :]] + [2, 0, 1]
    else:
        con[0] = pos[0]
        con[-1] = pos[-1] + [2, 0, 1]
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32), "UrShape": pos,
        "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": f32(1.0), "w_regSqrt": f32(np.sqrt(0.5)),
    }


# -- the system each package hands its fused loop ---------------------------------


class _Seen(Exception):
    pass


_CALLS = {}


def jax_cg_call(name, dims, inputs, kind="gaussNewtonGPU", **ip):
    """What opt_tpu's solver hands its fused kernel in the first step at
    ``inputs`` (its step run eagerly, the kernel call caught): numpy
    (meta, r0, pre, keywords: cg_variant, pre_blocks and under LM ctc,
    reset_period, q_tolerance)."""
    key = (name, tuple(sorted(dims.items())), kind, tuple(sorted(ip.items())), id(inputs))
    if key not in _CALLS:
        plan = ot.Problem(getattr(jspecs, name), kind=kind).plan(
            dims=dims, init_params=ot.InitializationParameters(use_pallas_cg="interpret", **ip)
        )
        u, c, g, p = plan._normalize_and_place(dict(inputs))
        sv = plan.solver
        sp = sv._traced_sp(plan.solver_params)
        state = sv._init_state(u, c, g, p, sp)
        seen = {}
        real = pcg.fused_grid_cg

        def spy(meta, r0, pre, lits, tol, **kw):
            seen.update(meta=meta, r0=r0, pre=pre, kw=kw)
            raise _Seen()

        pcg.fused_grid_cg = spy
        try:
            (sv._lm_step if kind == "LMGPU" else sv._gn_step)(state, JFunctionSet(plan.compiled, c, g, p), sp)
        except _Seen:
            pass
        finally:
            pcg.fused_grid_cg = real
        assert seen, "opt_tpu's step did not take its fused kernel"
        kw = {k: v for k, v in seen["kw"].items()
              if k in ("cg_variant", "pre_blocks") + LM_KW}
        _CALLS[key] = jax.device_get((seen["meta"], seen["r0"], seen["pre"], kw))
    return _CALLS[key]


def _pack(d, meta):
    """A numpy [*dom, C_u] dict in the meta's packed layout [C, *kernel dom]."""
    a = np.concatenate([np.asarray(d[u]) for u in meta["u_list"]], axis=-1)
    a = np.moveaxis(a, -1, 0)
    return torch.as_tensor(np.ascontiguousarray(a.reshape((a.shape[0],) + tuple(meta["F"].shape[1:]))))


def twin_vs_pallas(call, lits, tol, **over):
    """The JAX call's system through Pallas interpret mode and through the
    port's twin (on the descriptor carried across): (δ JAX, iterations
    JAX, δ twin, iterations twin), δ packed and flattened."""
    jmeta, jr0, jpre, jkw = call
    kw = dict(jkw, **over)
    jd, ji = pcg.fused_grid_cg(jmeta, jr0, jpre, lits, tol, interpret=True, **kw)
    meta = meta_from_numpy(jmeta, device="cpu")
    tkw = dict(cs=kw.get("cg_variant") == CS, rem=meta["rem"])
    if kw.get("pre_blocks") is not None:
        tkw["pre_blocks"] = fused_cg.pack_pre_blocks(
            pre_blocks_from_numpy(kw["pre_blocks"], "cpu"), meta)
    if kw.get("ctc") is not None:
        tkw.update(ctc=_pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                   q_tolerance=float(kw["q_tolerance"]))
    td, ti = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], _pack(jr0, meta), _pack(jpre, meta), lits, tol, **tkw)
    jd = _pack(jax.device_get(jd), meta).numpy().ravel()
    return jd, int(ji), td.numpy().ravel(), ti


def assert_twin_matches(call, lits, tol, expect=None, **over):
    """Equal iteration counts (``expect`` when given) and δ within
    DELTA_RTOL of max|δ| (EXIT_DELTA_RTOL where the loop ran to an exit).
    LM's ζ is a difference of two sums that the Pallas kernel takes in
    float32 and the twin in float64 (ROADMAP.md queue 3), so where an LM
    loop runs to its exits the callers test the rᵀz floor
    (q_tolerance=-inf)."""
    jd, ji, td, ti = twin_vs_pallas(call, lits, tol, **over)
    assert ti == ji, (ti, ji)
    if expect is not None:
        assert ji == expect, ji
    rtol = DELTA_RTOL if ji == lits else EXIT_DELTA_RTOL
    np.testing.assert_allclose(td, jd, rtol=0, atol=rtol * np.abs(jd).max())
    return ji


def count_fused(monkeypatch):
    """Counts the port solver's fused-loop calls (the twin on the CPU)."""
    calls = []
    real = t_gn.fused_grid_cg

    def wrapped(*a, **kw):
        calls.append(kw.get("cg_variant"))
        return real(*a, **kw)

    monkeypatch.setattr(t_gn, "fused_grid_cg", wrapped)
    return calls


def tplan(name, dims, kind="gaussNewtonGPU", **ip):
    return ott.Problem(getattr(tspecs, name), kind=kind).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))


def jplan(name, dims, kind="gaussNewtonGPU", **ip):
    return ot.Problem(getattr(jspecs, name), kind=kind).plan(
        dims=dims, init_params=ot.InitializationParameters(**ip))


GRID = {"W": 24, "H": 24}
N32 = {"W": 32, "H": 32}
POISSON32 = poisson_inputs(32)
POISSON24 = poisson_inputs(24)
WARP16 = warp_inputs(16)
WARP24 = warp_inputs(24, con_a=(4.0, 4.0), at=2)
ARAP_DIMS, ARAP8 = arap_inputs(8)
_, ARAP8_ROWS = arap_inputs(8, pin_rows=True)


# -- Chronopoulos–Gear -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("exit_", ["none", "real"])
def test_cs_twin_matches_pallas_interpret(kind, exit_):
    """The twin's Chronopoulos–Gear loop against the Pallas kernel's cs
    form on poisson 32²×4: with no exit after 40 iterations, and with the
    real exits (GN's rᵀz floor, LM's ζ exit) at equal counted iterations."""
    call = jax_cg_call("poisson_image_editing", N32, POISSON32, kind, cg_variant=CS)
    assert call[3]["cg_variant"] == CS
    if exit_ == "none":
        over = dict(q_tolerance=-np.inf) if kind == "LMGPU" else {}
        assert_twin_matches(call, 40, 0.0, expect=40, **over)
    else:
        n = assert_twin_matches(call, 400, 1e-12)
        assert 5 < n < 400


def test_cs_twin_lm_resets_on_image_warping():
    """The LM cs form with a reset every 3 counted iterations, on
    image_warping's mixed unknowns (cross-channel triples, excluded
    rows)."""
    call = jax_cg_call("image_warping", {"W": 16, "H": 16}, WARP16, "LMGPU", cg_variant=CS)
    assert_twin_matches(call, 20, 0.0, expect=20, reset_period=3, q_tolerance=-np.inf)


@pytest.mark.parametrize("case", ["poisson", "arap"])
@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_cs_matches_standard_and_jax(monkeypatch, case, kind):
    """tests/test_cg_variants.py:53,94 through the port: the CS solve lands
    on the standard solve's cost with about as many CG iterations, and on
    opt_tpu's CS solve's cost and iterations."""
    if case == "poisson":
        name, dims, inputs = "poisson_image_editing", GRID, POISSON24
        sp = dict(nIterations=3, lIterations=80) if kind == "gaussNewtonGPU" else dict(
            nIterations=4, lIterations=60)
    else:
        name, dims, inputs = "arap_mesh_deformation", ARAP_DIMS, ARAP8
        sp = dict(nIterations=4, lIterations=40) if kind == "gaussNewtonGPU" else dict(
            nIterations=5, lIterations=40)
    calls = count_fused(monkeypatch)
    plan = tplan(name, dims, kind, cg_variant=CS)
    res = plan.solve(dict(inputs), **sp)
    std = tplan(name, dims, kind).solve(dict(inputs), **sp)
    assert plan.fused_fallback is None and calls[: res.num_iterations] == [CS] * res.num_iterations
    j = jplan(name, dims, kind, cg_variant=CS).solve(dict(inputs), **sp)
    np.testing.assert_allclose(res.final_cost, std.final_cost, rtol=GOLDEN_RTOL, atol=1e-6)
    slack = 0.1 if kind == "gaussNewtonGPU" else 0.15
    assert abs(res.num_linear_iterations - std.num_linear_iterations) <= (
        slack * std.num_linear_iterations + 3)
    # arap's GN trajectory amplifies rounding from step to step (ROADMAP.md
    # queue 3), so the two packages' CS solves part there by more
    rtol = 1e-4 if case == "poisson" else GOLDEN_RTOL
    np.testing.assert_allclose(res.final_cost, j.final_cost, rtol=rtol, atol=1e-6)
    if kind == "gaussNewtonGPU":  # LM's function-tolerance exit may part them by a step
        assert abs(res.num_linear_iterations - j.num_linear_iterations) <= (
            0.1 * j.num_linear_iterations + 2)


def test_cs_lm_q_exit_fires():
    """tests/test_cg_variants.py:129: with a loose q_tolerance the CS LM loop
    leaves early as the standard one does, and as opt_tpu's."""
    sp = dict(nIterations=2, lIterations=200, q_tolerance=1e-2)
    counts = {}
    for variant in ("standard", CS):
        counts[variant] = tplan("poisson_image_editing", GRID, "LMGPU", cg_variant=variant).solve(
            dict(POISSON24), **sp).num_linear_iterations
    j = jplan("poisson_image_editing", GRID, "LMGPU", cg_variant=CS).solve(dict(POISSON24), **sp)
    assert counts["standard"] < 2 * 200, counts
    assert abs(counts[CS] - counts["standard"]) <= 0.15 * counts["standard"] + 3, counts
    assert counts[CS] == j.num_linear_iterations


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_eager_cs_loop_equals_twin(kind):
    """use_pallas_cg="off" runs the same _run_cg algebra on the unpacked
    operator: the same counted iterations and costs as the fused twin."""
    sp = dict(nIterations=2, lIterations=60)
    a = tplan("poisson_image_editing", GRID, kind, cg_variant=CS).solve(dict(POISSON24), **sp)
    b = tplan("poisson_image_editing", GRID, kind, cg_variant=CS,
              use_pallas_cg="off").solve(dict(POISSON24), **sp)
    assert a.num_linear_iterations == b.num_linear_iterations
    np.testing.assert_allclose(a.costs, b.costs, rtol=1e-5)


# -- bfloat16 coefficients ---------------------------------------------------------


@pytest.mark.parametrize("case", ["poisson", "arap_lm"])
def test_bf16_meta_matches_jax(case):
    """The meta's F (and a graph's remainder-free DIA fields) are stored in
    bfloat16, equal to opt_tpu's bf16 meta, and to the float32 meta's
    fields rounded to bf16 (at 1e-6 of each field's scale)."""
    if case == "poisson":
        name, dims, inputs, kind = "poisson_image_editing", N32, POISSON32, "gaussNewtonGPU"
    else:
        name, dims, inputs, kind = "arap_mesh_deformation", ARAP_DIMS, ARAP8, "LMGPU"
    jmeta = jax_cg_call(name, dims, inputs, kind, coefficient_dtype="bfloat16")[0]
    t_in = inputs_from_numpy(inputs, device="cpu")
    meta = tplan(name, dims, kind, coefficient_dtype="bfloat16").cg_inputs(t_in)[0]
    meta32 = tplan(name, dims, kind).cg_inputs(t_in)[0]
    assert meta["F"].dtype == torch.bfloat16 and np.asarray(jmeta["F"]).dtype.name == "bfloat16"
    assert meta["triples"] == meta_from_numpy(jmeta, device="cpu")["triples"]
    got = meta["F"].float().numpy()
    want = np.asarray(jmeta["F"], f32).reshape(got.shape[0], -1)[:, : got[0].size].reshape(got.shape)
    rounded = meta32["F"].to(torch.bfloat16).float().numpy()
    scale = np.abs(rounded).reshape(len(rounded), -1).max(axis=1).reshape((-1,) + (1,) * (got.ndim - 1))
    np.testing.assert_allclose(got, rounded, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.maximum(scale, 1e-30).max())


@pytest.mark.parametrize("form", ["gn", "lm", "graph_lm"])
def test_bf16_twin_matches_pallas_interpret(form):
    """The twin with bf16 F (widened, float32 products) against the Pallas
    kernel with bf16 fields: poisson GN, image_warping LM and the arap grid
    mesh LM."""
    if form == "gn":
        call = jax_cg_call("poisson_image_editing", N32, POISSON32, coefficient_dtype="bfloat16")
    elif form == "lm":
        call = jax_cg_call("image_warping", {"W": 16, "H": 16}, WARP16, "LMGPU",
                           coefficient_dtype="bfloat16")
    else:
        call = jax_cg_call("arap_mesh_deformation", ARAP_DIMS, ARAP8, "LMGPU",
                           coefficient_dtype="bfloat16")
    over = dict(q_tolerance=-np.inf) if form != "gn" else {}
    assert_twin_matches(call, 30, 0.0, expect=30, **over)
    assert 1 < assert_twin_matches(call, 400, 1e-8, **over) < 400


# tests/test_bf16_coefficients.py:90's cases; arap by plain GN is not among
# them (bf16 + GN on a stiff graph energy takes non-descent steps: LM)
BF16_CASES = {
    "poisson": ("poisson_image_editing", GRID, POISSON24, dict(nIterations=4, lIterations=60)),
    "image_warping": ("image_warping", {"W": 16, "H": 16}, WARP16,
                      dict(nIterations=6, lIterations=40)),
    "arap": ("arap_mesh_deformation", ARAP_DIMS, ARAP8, dict(nIterations=6, lIterations=40)),
}


@pytest.mark.parametrize("name,kind", [
    ("poisson", "gaussNewtonGPU"), ("poisson", "LMGPU"), ("image_warping", "gaussNewtonGPU"),
    ("image_warping", "LMGPU"), ("arap", "LMGPU"),
])
def test_bf16_coefficients_match_f32_final_cost(monkeypatch, name, kind):
    spec, dims, inputs, sp = BF16_CASES[name]
    calls = count_fused(monkeypatch)
    plan16 = tplan(spec, dims, kind, coefficient_dtype="bfloat16")
    res_16 = plan16.solve(dict(inputs), **sp)
    assert plan16.fused_fallback is None and len(calls) == res_16.num_iterations
    res_f32 = tplan(spec, dims, kind).solve(dict(inputs), **sp)
    assert np.isfinite(res_16.final_cost)
    assert res_16.final_cost <= res_16.costs[0] + 1e-6
    np.testing.assert_allclose(res_16.final_cost, res_f32.final_cost, rtol=GOLDEN_RTOL, atol=1e-6)


@pytest.mark.parametrize("coeff", ["float16", torch.float64, "int8", "bf16"])
def test_coefficient_dtype_refused_when_the_plan_is_built(coeff):
    """The kernel reads float32 or bfloat16 fields: any other coefficient
    dtype is refused by the solver's constructor, not in the middle of a
    solve."""
    with pytest.raises(ValueError, match="coefficient_dtype must be None, 'bfloat16' or 'float32'"):
        tplan("poisson_image_editing", N32, coefficient_dtype=coeff)


@pytest.mark.parametrize("coeff,want", [
    ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    ("float32", torch.float32), (torch.float32, torch.float32),
])
def test_coefficient_dtype_accepted_by_name_or_dtype(coeff, want):
    meta = tplan("poisson_image_editing", N32, coefficient_dtype=coeff).cg_inputs(
        inputs_from_numpy(POISSON32, device="cpu"))[0]
    assert meta["F"].dtype == want
