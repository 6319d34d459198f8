"""The port's example apps (opt_tpu_torch/examples/) held to the JAX
package's (examples/) on the CPU: minimal, curve_fitting,
poisson_image_editing, image_warping, intrinsic_image_decomposition.

Each JAX app runs as a subprocess (``--small --cpu``, its working directory
and ``--results`` under a temporary directory), at most three at a time from
a module fixture; each port app runs in-process through ``main(argv)`` in a
temporary directory. Both print the same lines, numbers aside, and their
costs agree: the final costs at the golden rtol of 5e-3 (curve_fitting, at
convergence, by its fitted parameters, its cost at the float32 floor of its
residuals). The port app reads its example data from where the JAX app
reads it, so the two solve the same problem whether that data is present
or both fall back to synthetic data. Neither writes into the checkout. Without ``--cpu`` a port app
plans on the card and raises where CUDA is missing.

The helpers here serve ``tests/test_torch_examples_reads.py`` and
``tests/test_torch_examples_graph.py`` as well.
"""

from __future__ import annotations

import concurrent.futures
import csv
import importlib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from opt_tpu_torch.examples import common as port_common

REPO = Path(__file__).resolve().parents[1]
GOLDEN_RTOL = 5e-3
FIRST_OUTER_RTOL = 1e-4
DOUBLE_RTOL = 1e-6
JAX_AT_ONCE = 3  # JAX app processes running at one time

# what each app writes into its working directory (besides --results)
OUTPUTS = {
    "minimal": ("minimal_before.png", "minimal_after.png"),
    "curve_fitting": (),
    "poisson_image_editing": ("poisson_result.png",),
    "image_warping": ("output.png", "inputMark.png"),
    "intrinsic_image_decomposition": ("outputAlbedo.png", "outputShading.png"),
    "shape_from_shading": ("sfsOutput.imagedump", "sfsOutput0.png", "sfsOutput.ply"),
    "optical_flow": ("out.png",),
    "volumetric_mesh_deformation": ("out.ply",),
    "arap_mesh_deformation": ("arap_result.ply",),
    "cotangent_mesh_smoothing": ("cotangent_result.ply",),
    "embedded_mesh_deformation": ("embedded_result.ply",),
    "robust_nonrigid_alignment": ("out.ply",),
}
# the apps that solve through the harness, and so write a results CSV
HARNESS_APPS = tuple(a for a in OUTPUTS if a not in ("minimal", "curve_fitting"))

NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


def checkout_state() -> dict:
    """(mtime, size) of every place in the checkout an app could write to:
    its output files' names at the root and the files under results/."""
    paths = [REPO / n for outs in OUTPUTS.values() for n in outs]
    if (REPO / "results").is_dir():
        paths += sorted((REPO / "results").iterdir())
    return {str(p): (p.stat().st_mtime_ns, p.stat().st_size) for p in paths if p.exists()}


def run_jax_app(app: str, workdir: Path, double: bool = False) -> str:
    """The JAX package's app, ``--small --cpu``, in ``workdir``: its stdout."""
    workdir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(REPO / "examples" / f"{app}.py"), "--small", "--cpu",
           "--results", str(workdir / "results")] + (["--double"] if double else [])
    proc = subprocess.run(cmd, cwd=workdir, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def start_jax_runs(root: Path, runs, extra=None) -> dict:
    """Start the JAX apps ``runs`` ((app, double) pairs), each in a
    directory of its own under ``root``, and the callables of ``extra``
    ({key: fn}), JAX_AT_ONCE at a time: {key: (future, its directory or
    None)}."""
    pool = concurrent.futures.ThreadPoolExecutor(JAX_AT_ONCE)
    started = {}
    for app, double in runs:
        d = root / f"{app}_{'double' if double else 'float'}"
        started[(app, double)] = (pool.submit(run_jax_app, app, d, double), d)
    started.update({k: (pool.submit(fn), None) for k, fn in (extra or {}).items()})
    pool.shutdown(wait=False)
    return started


def wait_all(started: dict) -> None:
    concurrent.futures.wait([f for f, _d in started.values()])


def jax_app_module(name: str):
    """The JAX package's ``examples/<name>.py``, imported from its file
    (examples/ is no package) under a name of its own."""
    sys.path.insert(0, str(REPO / "examples"))  # its apps import `common`
    try:
        spec = importlib.util.spec_from_file_location(f"jax_examples_{name}",
                                                      REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "examples"))
    return mod


def run_port_app(app: str, workdir: Path, monkeypatch, capsys, double: bool = False) -> str:
    """The port's app, ``--small --cpu``, in-process in ``workdir``, its
    example data looked up where the JAX app looks: its stdout."""
    workdir.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(port_common, "REFERENCE_DATA", jax_app_module("common").REFERENCE_DATA)
    mod = importlib.import_module(f"opt_tpu_torch.examples.{app}")
    capsys.readouterr()
    mod.main(["--small", "--cpu", "--results", str(workdir / "results")]
             + (["--double"] if double else []))
    return capsys.readouterr().out


def masked(out: str) -> list:
    """The printed lines with every number replaced by '#'."""
    return [re.sub(NUM, "#", ln) for ln in out.splitlines()]


def printed_costs(out: str) -> dict:
    """The '**Final Costs**' block ({run: cost}), or the app's 'final
    cost' line ({"final": cost})."""
    lines = out.splitlines()
    if "**Final Costs**" in lines:
        costs = {}
        for ln in lines[lines.index("**Final Costs**") + 1:]:
            m = re.fullmatch(rf"(.+): ({NUM}|nan|inf)", ln)
            if not m:
                break
            costs[m.group(1)] = float(m.group(2))
        return costs
    (m,) = re.findall(rf"final cost:? ({NUM})", out)
    return {"final": float(m)}


def csv_costs(results: Path, app: str, double: bool) -> dict:
    """{run: [cost of each outer solve]} from the app's results CSV."""
    path = results / f"{app}_results_{'double' if double else 'float'}.csv"
    with open(path) as f:
        rows = list(csv.reader(f))
    runs = [h[: -len(" cost")] for h in rows[0][::2]]
    return {run: [float(r[2 * k]) for r in rows[1:] if r[2 * k]] for k, run in enumerate(runs)}


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def hold_app(app, jax_out, port_out, jax_dir, port_dir, *, double=False, final_rtol=GOLDEN_RTOL,
             first_rtol=None):
    """The port app's run held to the JAX app's: the same printed lines,
    numbers aside, and the same runs; each run's final cost at
    ``final_rtol`` and, with ``first_rtol``, its first outer solve's cost
    at that (both from the results CSV, the full digits); the outputs in
    the working directories."""
    assert masked(port_out) == masked(jax_out)
    jc, pc = printed_costs(jax_out), printed_costs(port_out)
    assert pc.keys() == jc.keys() and pc
    for run in jc:
        assert rel(pc[run], jc[run]) <= final_rtol, (run, pc[run], jc[run])
    if app in HARNESS_APPS:
        jr, pr = (csv_costs(d / "results", app, double) for d in (jax_dir, port_dir))
        assert pr.keys() == jr.keys()
        for run in jr:
            assert len(pr[run]) == len(jr[run]) > 0
            assert rel(pr[run][-1], jr[run][-1]) <= final_rtol, (run, pr[run], jr[run])
            if first_rtol is not None:
                assert rel(pr[run][0], jr[run][0]) <= first_rtol, (run, pr[run], jr[run])
    for d in (jax_dir, port_dir):
        assert all((d / n).is_file() for n in OUTPUTS[app]), sorted(os.listdir(d))


def raises_without_cuda(app: str, tmp_path: Path, monkeypatch):
    """The port app without --cpu plans on the card: where CUDA is missing
    it raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"opt_tpu_torch.examples.{app}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--small", "--results", str(tmp_path / "results")])
    assert not any((tmp_path / n).exists() for n in OUTPUTS[app])


APPS = ("minimal", "curve_fitting", "poisson_image_editing", "image_warping",
        "intrinsic_image_decomposition")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    started = start_jax_runs(tmp_path_factory.mktemp("jax_apps"), [(a, False) for a in APPS])
    yield started
    wait_all(started)


@pytest.fixture(scope="module")
def checkout_before():
    return checkout_state()


@pytest.mark.parametrize("app", [a for a in APPS if a != "curve_fitting"])
def test_app_matches_jax(app, jax_runs, checkout_before, tmp_path, monkeypatch, capsys):
    port_out = run_port_app(app, tmp_path, monkeypatch, capsys)
    future, jax_dir = jax_runs[(app, False)]
    hold_app(app, future.result(), port_out, jax_dir, tmp_path)
    assert checkout_state() == checkout_before


def test_curve_fitting_matches_jax(jax_runs, checkout_before, tmp_path, monkeypatch, capsys):
    """At convergence the fit's cost is float32 rounding of its residuals
    (each up to |y| ~ 200, so the floor is N·(|y|·2⁻²⁴)² ~ 7e-8, and the two
    packages land at 1.28e-7 and 1.30e-7): the fit is held by its
    parameters, and each cost by that floor."""
    port_out = run_port_app("curve_fitting", tmp_path, monkeypatch, capsys)
    future, _jax_dir = jax_runs[("curve_fitting", False)]
    jax_out = future.result()
    assert masked(port_out) == masked(jax_out)
    fit = rf"fit: a=({NUM}) b=({NUM}) .*final cost ({NUM})"
    (ja, jb, jcost), = re.findall(fit, jax_out)
    (pa, pb, pcost), = re.findall(fit, port_out)
    assert (float(pa), float(pb)) == (float(ja), float(jb)) == (100.0, 102.0)
    floor = 512 * (202.0 * 2.0 ** -24) ** 2
    assert 0 <= float(pcost) <= 10 * floor and 0 <= float(jcost) <= 10 * floor
    assert checkout_state() == checkout_before


@pytest.mark.parametrize("app", APPS)
def test_app_without_cpu_raises_without_cuda(app, tmp_path, monkeypatch):
    raises_without_cuda(app, tmp_path, monkeypatch)
