"""The port's solve timer (opt_tpu_torch/utils/timer.py,
``collect_per_kernel_timing``) and memory report held to the JAX package's
surface (tests/test_api_and_tools.py) on the CPU.

A timed solve is the untimed solve with marks around its phases: its
unknowns, costs and counts are bitwise the untimed ones'. Its rows are
disjoint and never negative, PCGStep1 counts the CG iterations executed,
computeCost the steps taken, and the table's greppable lines read as the
JAX package's. On the CPU the marks are the host clock; on the card
(chip_smoke.py) they are CUDA events.
"""

import re
import time

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from chip_smoke import arap_grid_inputs, bench_image_warping_inputs
from opt_tpu.models.specs import laplacian as jlaplacian
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.utils import memory, timer

torch.set_num_threads(2)

f32 = np.float32
N = 12
STEPS = dict(nIterations=3, lIterations=5)


def lap_inputs(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}


def timed_plan(spec, dims, kind="gaussNewtonGPU", **ip):
    return ott.Problem(spec, kind=kind).plan(
        dims=dims, device="cpu",
        init_params=ott.InitializationParameters(collect_per_kernel_timing=True, **ip))


def timing_lines(out):
    timing = [ln for ln in out.splitlines() if ln.startswith("TIMING ")]
    per_iter = [ln for ln in out.splitlines() if ln.startswith("Per-iter times ms")]
    return timing, per_iter


def test_report_solve_timing_lines(capsys):
    """collect_per_kernel_timing emits the reference's greppable surface
    (util.t:469-508), as the JAX package's report_solve_timing prints it
    (given its phase table, so that nothing is compiled): the kernel
    table's header, the TIMING line of three totals and the 'Per-iter
    times ms' pair."""
    import types

    from opt_tpu.utils.timer import report_solve_timing as jreport

    plan = timed_plan(tspecs.laplacian, {"W": N, "H": N})
    res = plan.solve(lap_inputs(), nIterations=2, lIterations=5)
    out = capsys.readouterr().out
    jplan = types.SimpleNamespace(_timing_phases={"PCGInit1": (0.5, "nonlinear"),
                                                  "PCGStep1": (0.25, "linear"),
                                                  "computeCost": (0.125, "nonlinear")})
    jout = jreport(jplan, res)
    assert "PCGInit1" in out and "PCGStep1" in out
    for text in (out, jout):
        timing, per_iter = timing_lines(text)
        assert len(timing) == 1 and len(timing[0].split()) == 4, timing
        assert len(per_iter) == 1 and per_iter[0].startswith(
            "Per-iter times ms (nonlinear,linear):")
    head = [ln for ln in out.splitlines() if "Kernel" in ln or set(ln) <= set("-+")]
    jhead = [ln for ln in jout.splitlines() if "Kernel" in ln or set(ln) <= set("-+")]
    assert head == jhead
    assert re.search(r"^CG instances: plain twin of gn_tiled x2$", out, re.M)


def test_timing_line_fields_in_the_reference_order(capsys):
    """TIMING <PCGInit1 total> <PCGStep1 total> <overall>, as the rows say."""
    plan = timed_plan(tspecs.laplacian, {"W": N, "H": N})
    plan.solve(lap_inputs(), **STEPS)
    (line,), _ = timing_lines(capsys.readouterr().out)
    rows = plan._timing_phases
    want = [rows["PCGInit1"].total_ms, rows["PCGStep1"].total_ms, rows["overall"].total_ms]
    assert [float(v) for v in line.split()[1:]] == pytest.approx(want, rel=1e-6)


ARAP_DIMS, ARAP_INPUTS = arap_grid_inputs(6)
CASES = {
    "laplacian_gn": (tspecs.laplacian, {"W": N, "H": N}, lap_inputs(), "gaussNewtonGPU", {},
                     False, "plain twin of gn_tiled"),
    "laplacian_lm": (tspecs.laplacian, {"W": N, "H": N}, lap_inputs(), "LMGPU", {}, False,
                     "plain twin of lm_tiled"),
    "laplacian_gn_stepwise": (tspecs.laplacian, {"W": N, "H": N}, lap_inputs(),
                              "gaussNewtonGPU", {}, True, "plain twin of gn_tiled"),
    "laplacian_composed": (tspecs.laplacian, {"W": N, "H": N}, lap_inputs(), "gaussNewtonGPU",
                           {"use_fused_jtj": False}, False, "eager loop"),
    "image_warping_lm_block_jacobi": (
        tspecs.image_warping, {"W": 8, "H": 8}, None, "LMGPU",
        {"preconditioner": "block_jacobi"}, False, "plain twin of lm_bj_tiled"),
    "arap_graph_gn": (tspecs.arap_mesh_deformation, ARAP_DIMS, ARAP_INPUTS, "gaussNewtonGPU",
                      {}, False, "plain twin of gn_dia_tiled"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_timed_solve_is_the_untimed_solve(case):
    """Timing changes nothing (bitwise unknowns, costs and counts); the rows
    are disjoint, never negative, and count what ran."""
    spec, dims, inputs, kind, ip, stepwise, instance = CASES[case]
    inputs = bench_image_warping_inputs(8) if inputs is None else inputs
    plain = ott.Problem(spec, kind=kind).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))
    want = plain.solve(dict(inputs), stepwise=stepwise, **STEPS)
    plan = timed_plan(spec, dims, kind, **ip)
    got = plan.solve(dict(inputs), stepwise=stepwise, **STEPS)
    assert got.costs == want.costs and got.final_cost == want.final_cost
    assert (got.num_iterations, got.num_linear_iterations) == (
        want.num_iterations, want.num_linear_iterations)
    for k in want.unknowns:
        assert torch.equal(got.unknowns[k], want.unknowns[k])
    rows = plan._timing_phases
    assert rows["PCGStep1"].count == got.num_linear_iterations
    assert rows["computeCost"].count == got.num_iterations
    assert all(st.total_ms >= 0.0 for st in rows.values()), rows
    kernels = sum(st.total_ms for name, st in rows.items() if name not in ("other", "overall"))
    assert kernels <= rows["overall"].total_ms
    assert rows["other"].total_ms == pytest.approx(rows["overall"].total_ms - kernels)
    assert plan._timing_instances == {instance: got.num_iterations}
    if kind == "LMGPU":
        assert rows["computeModelCost"].count == got.num_iterations
        assert rows["PCGComputeCtC"].count == got.num_iterations
    if ip.get("preconditioner") == "block_jacobi":
        assert rows["blockInverse"].count == got.num_iterations


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_timed_solve_holds_to_the_jax_package(kind):
    """The timed port solve against the JAX package's on the same inputs:
    the same step and CG counts, the costs at 1e-6."""
    inputs = lap_inputs(seed=1)
    got = timed_plan(tspecs.laplacian, {"W": N, "H": N}, kind).solve(dict(inputs), **STEPS)
    want = ot.Problem(jlaplacian, kind=kind).plan(dims={"W": N, "H": N}).solve(
        dict(inputs), **STEPS)
    assert (got.num_iterations, got.num_linear_iterations) == (
        want.num_iterations, want.num_linear_iterations)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-6)


def test_nested_phases_are_disjoint():
    """A phase inside another is taken out of the outer row; the time
    outside every row is "other"."""
    with timer.SolveTimer("cpu") as t:
        with timer.phase("assembleFields"):
            time.sleep(0.02)
            with timer.phase("computedBundle"):
                time.sleep(0.03)
        time.sleep(0.01)
    assert timer.active() is None
    rows = t.read()
    assert 0.02 * 1e3 <= rows["assembleFields"].total_ms < 0.03 * 1e3
    assert rows["computedBundle"].total_ms >= 0.03 * 1e3
    assert rows["other"].total_ms >= 0.01 * 1e3
    assert (rows["assembleFields"].count, rows["computedBundle"].count) == (1, 1)
    assert list(rows)[-2:] == ["other", "overall"]
    # no timer, no marks: phase() is a no-op outside a timed solve
    with timer.phase("PCGInit1"):
        pass


def test_profile_plan(capsys):
    """The analogue of test_api_and_tools.py::test_profile_plan: the
    per-iteration times come from one timed solve, never a difference."""
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 16, "H": 16}, device="cpu")
    rep = timer.profile_plan(plan, lap_inputs(16), n_nonlinear=2, l_small=5, l_big=15)
    out = capsys.readouterr().out
    assert "TIMING" in out and "Marginal times ms" in out
    assert rep["nonlinear_ms"] > 0 and rep["linear_ms"] > 0
    assert plan.solver.ip.collect_per_kernel_timing is False
    assert set(rep["phases"]) >= {"PCGInit1", "PCGStep1", "computeCost", "other"}


def test_report_needs_a_timed_solve():
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu")
    res = plan.solve(lap_inputs(8), nIterations=1, lIterations=3)
    assert plan._timing_phases is None
    with pytest.raises(RuntimeError, match="no timed solve"):
        timer.report_solve_timing(plan, res)


def test_batched_and_scheduled_solves_time_nothing(capsys):
    """As in the JAX package, only Plan.solve reports."""
    plan = timed_plan(tspecs.laplacian, {"W": 8, "H": 8})
    rng = np.random.RandomState(0)
    plan.solve_batched({"X": rng.rand(2, 8, 8).astype(f32), "A": rng.rand(8, 8).astype(f32)},
                       nIterations=1, lIterations=3)
    plan.solve_scheduled(lap_inputs(8), lambda c, i: c, 2, nIterations=1, lIterations=3)
    assert "TIMING" not in capsys.readouterr().out and plan._timing_phases is None


def test_memory_on_the_cpu():
    """utils/memory.py: the CPU has no allocator statistics (None, as the
    JAX package's CPU backend), and the report says so in one line."""
    from opt_tpu.utils import memory as jmemory

    assert memory.memory_stats("cpu") is None and jmemory.memory_stats() is None
    assert memory.live_buffer_bytes("cpu") == 0
    lines = []
    text = memory.report("cpu", print_fn=lines.append)
    assert lines == [text] and text.startswith("cpu memory:")
