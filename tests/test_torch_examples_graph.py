"""The port's example apps held to the JAX package's on the CPU: the graph
apps arap_mesh_deformation (with its device schedule of the markers),
cotangent_mesh_smoothing, embedded_mesh_deformation and
robust_nonrigid_alignment.

As ``tests/test_torch_examples_grid.py``, whose helpers these are. Each
app's final costs agree at the golden rtol of 5e-3. arap, cotangent and
embedded do not settle in float32 (ROADMAP.md queue 3), so each also holds
its first outer solve at 1e-4 in float32 and its whole ``--double`` run at
1e-6 against the JAX app's ``--double`` run.
"""

from __future__ import annotations

import pytest

from tests.test_torch_examples_grid import (
    DOUBLE_RTOL,
    FIRST_OUTER_RTOL,
    checkout_state,
    hold_app,
    raises_without_cuda,
    run_port_app,
    start_jax_runs,
    wait_all,
)

UNSETTLED = ("arap_mesh_deformation", "cotangent_mesh_smoothing", "embedded_mesh_deformation")
APPS = UNSETTLED + ("robust_nonrigid_alignment",)
CASES = [(a, False) for a in APPS] + [(a, True) for a in UNSETTLED]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    started = start_jax_runs(tmp_path_factory.mktemp("jax_apps"), CASES)
    yield started
    wait_all(started)


@pytest.fixture(scope="module")
def checkout_before():
    return checkout_state()


@pytest.mark.parametrize("app,double", CASES,
                         ids=[f"{a}-{'float64' if d else 'float32'}" for a, d in CASES])
def test_app_matches_jax(app, double, jax_runs, checkout_before, tmp_path, monkeypatch, capsys):
    port_out = run_port_app(app, tmp_path, monkeypatch, capsys, double=double)
    future, jax_dir = jax_runs[(app, double)]
    if double:
        hold_app(app, future.result(), port_out, jax_dir, tmp_path, double=True,
                 final_rtol=DOUBLE_RTOL)
    else:
        hold_app(app, future.result(), port_out, jax_dir, tmp_path,
                 first_rtol=FIRST_OUTER_RTOL if app in UNSETTLED else None)
    assert checkout_state() == checkout_before


@pytest.mark.parametrize("app", APPS)
def test_app_without_cpu_raises_without_cuda(app, tmp_path, monkeypatch):
    raises_without_cuda(app, tmp_path, monkeypatch)
