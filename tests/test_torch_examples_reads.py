"""The port's example apps held to the JAX package's on the CPU:
shape_from_shading, optical_flow, volumetric_mesh_deformation (the specs
that read a ComputedArray, a SampledImage, a 3-D grid).

As ``tests/test_torch_examples_grid.py``, whose helpers these are. Each
app's final costs agree at the golden rtol of 5e-3. These solves do not
settle in float32 (ROADMAP.md queue 3), so shape_from_shading and
volumetric also hold their first outer solve at 1e-4 in float32 and their
whole ``--double`` runs at 1e-6. optical_flow's one outer solve is the
whole pyramid (three levels of GN 1x50), and its CG is unstable past about
15 iterations in float64 too (queue 3): the packages' float64 solves of
the same levels agree to 1e-14 at 10 CG iterations a level, and part by
7e-8, 4e-4 and 1.3e-3 at the three levels at 50. The JAX app's
``--double`` leaves its ``PyramidPlan`` in float32 (opt_tpu/pyramid.py
takes no dtype), so the port's float64 run is held to the JAX package's
float64 solves of the same three levels, one plan a level, the flow
prolonged between them, in a process of its own
(tests/float32_limits.py::jax_float64), at the golden rtol, as its float32
run is held to the JAX app's.
"""

from __future__ import annotations

import pytest

from tests.float32_limits import jax_float64
from tests.test_torch_examples_grid import (
    DOUBLE_RTOL,
    FIRST_OUTER_RTOL,
    GOLDEN_RTOL,
    checkout_state,
    hold_app,
    printed_costs,
    raises_without_cuda,
    rel,
    run_port_app,
    start_jax_runs,
    wait_all,
)

APPS = ("shape_from_shading", "optical_flow", "volumetric_mesh_deformation")


def jax_flow_float64():
    """The optical_flow app's --small pyramid solved by the JAX package in
    float64 (run by tests/float32_limits.py::jax_float64 with x64 on): the
    JAX app's own images, pyramid and level inputs (examples/optical_flow.py's
    main and FlowSolver), each level by its own plan, GN 1x50, from the
    coarse level's zero flow, the flow upsampled 2x (and doubled) into the
    next level."""
    import numpy as np

    import opt_tpu as ot
    from opt_tpu.models.specs import optical_flow
    from opt_tpu.utils.io import load_image
    from tests.test_torch_examples_grid import jax_app_module

    japp = jax_app_module("optical_flow")
    p0, p1 = japp.data_path("dogdance0.png"), japp.data_path("dogdance1.png")
    if p0 and p1:
        im0 = load_image(p0).mean(-1).astype(np.float32)[:64, :64]
        im1 = load_image(p1).mean(-1).astype(np.float32)[:64, :64]
    else:
        rng = np.random.RandomState(0)
        im0 = rng.rand(64, 64).astype(np.float32)
        im1 = np.roll(im0, (1, 2), (0, 1))
    app = japp.FlowSolver(im0, im1, {"numIter": 3, "nonLinearIter": 1, "linearIter": 50})
    X = None
    for lvl in range(app.levels):
        inputs = app._level_inputs(lvl)
        dims = {"W": inputs["I"].shape[0], "H": inputs["I"].shape[1]}
        if X is not None:
            inputs["X"] = ot.upsample2x_nearest(X, (dims["W"], dims["H"]), scale=2.0)
        res = ot.Problem(optical_flow).plan(dims=dims, double_precision=True).solve(
            inputs, nIterations=1, lIterations=50)
        X = res.unknowns["X"]
    return {"cost": np.float64(res.final_cost)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = [(a, False) for a in APPS] + [(a, True) for a in APPS if a != "optical_flow"]
    started = start_jax_runs(
        tmp_path_factory.mktemp("jax_apps"), runs,
        extra={"flow_float64": lambda: jax_float64("tests.test_torch_examples_reads",
                                                   "jax_flow_float64")})
    yield started
    wait_all(started)


@pytest.fixture(scope="module")
def checkout_before():
    return checkout_state()


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("double", [False, True], ids=["float32", "float64"])
def test_app_matches_jax(app, double, jax_runs, checkout_before, tmp_path, monkeypatch,
                         capsys):
    port_out = run_port_app(app, tmp_path, monkeypatch, capsys, double=double)
    if app == "optical_flow" and double:
        want = float(jax_runs["flow_float64"][0].result()["cost"])
        (got,) = printed_costs(port_out).values()
        assert rel(got, want) <= GOLDEN_RTOL, (got, want)
    else:
        future, jax_dir = jax_runs[(app, double)]
        first = None if double or app == "optical_flow" else FIRST_OUTER_RTOL
        hold_app(app, future.result(), port_out, jax_dir, tmp_path, double=double,
                 **({"final_rtol": DOUBLE_RTOL} if double else {}), first_rtol=first)
    assert checkout_state() == checkout_before


@pytest.mark.parametrize("app", APPS)
def test_app_without_cpu_raises_without_cuda(app, tmp_path, monkeypatch):
    raises_without_cuda(app, tmp_path, monkeypatch)
