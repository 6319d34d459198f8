"""opt_tpu_torch stands alone: it imports neither JAX nor opt_tpu, builds no
kernel on import, and never carries on on the CPU when the card was asked
for."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import opt_tpu_torch as ot
from opt_tpu_torch.models.specs import arap_mesh_deformation, laplacian
from opt_tpu_torch.ops import graph_ops
from opt_tpu_torch.utils import reorder
rng = np.random.RandomState(0)
plan = ot.Problem(laplacian).plan(dims={"W": 8, "H": 8}, device="cpu")
res = plan.solve({"X": rng.rand(8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")},
                 nIterations=2, lIterations=10)
assert np.isfinite(res.final_cost) and res.num_linear_iterations > 0
n = 12
v0 = np.arange(n, dtype="i4"); v1 = (v0 + 1) % n
perm = reorder.rcm_order(v0, v1, n)
v0, v1 = reorder.remap_edges(perm, v0, v1)
pos = rng.rand(n, 3).astype("f4")
con = -np.ones((n, 3), "f4"); con[0] = 0.5
plan = ot.Problem(arap_mesh_deformation).plan(dims={"N": n}, device="cpu")
res = plan.solve({"Offset": pos.copy(), "Angle": np.zeros((n, 3), "f4"), "UrShape": pos,
                  "Constraints": con, "G": {"v0": v0, "v1": v1},
                  "w_fitSqrt": 1.0, "w_regSqrt": 1.0}, nIterations=2, lIterations=10)
assert np.isfinite(res.final_cost) and plan.fused_fallback is None
# SampledImage (ops/sampling.py), the level loop's prolongation (pyramid.py)
# and a ComputedArray spec
from opt_tpu_torch.models.specs import optical_flow, shape_from_shading
im = rng.rand(8, 8).astype("f4")
flow = {"I": im, "I_hat": np.roll(im, 1, 0), "I_hat_dx": 0.1 * im, "I_hat_dy": 0.1 * im,
        "w_fit": 10.0, "w_reg": 0.1}
X = np.zeros((4, 4, 2), "f4")
for n in (4, 8):
    level = {k: (v[:: 8 // n, :: 8 // n] if isinstance(v, np.ndarray) else v) for k, v in flow.items()}
    plan = ot.Problem(optical_flow).plan(dims={"W": n, "H": n}, device="cpu")
    res = plan.solve({**level, "X": X}, nIterations=1, lIterations=5)
    assert np.isfinite(res.final_cost) and plan.fused_fallback is None
    X = ot.upsample2x_nearest(res.unknowns["X"], (2 * n, 2 * n), scale=2.0)
assert tuple(X.shape) == (16, 16, 2)
depth = (2.0 + 0.1 * rng.rand(8, 8)).astype("f4")
plan = ot.Problem(shape_from_shading).plan(dims={"W": 8, "H": 8}, device="cpu")
res = plan.solve({"X": depth.copy(), "D_i": depth, "Im": rng.rand(8, 8).astype("f4"),
                  "edgeMaskR": np.ones((8, 8), "f4"), "edgeMaskC": np.ones((8, 8), "f4"),
                  "w_p": 1.0, "w_s": 10.0, "w_g": 1.0, "f_x": 500.0, "f_y": 500.0,
                  "u_x": 4.0, "u_y": 4.0, **{f"L_{i}": 0.1 for i in range(1, 10)}},
                 nIterations=1, lIterations=5)
assert np.isfinite(res.final_cost) and plan.fused_fallback is None
# the batched, scheduled and pyramid solves
plan = ot.Problem(laplacian).plan(dims={"W": 8, "H": 8}, device="cpu")
res = plan.solve_batched({"X": rng.rand(3, 8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")},
                         nIterations=2, lIterations=10)
assert res.final_costs.shape == (3,) and np.isfinite(res.final_costs).all()
res = plan.solve_scheduled({"X": rng.rand(8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")},
                           lambda c, i: c, 2, nIterations=1, lIterations=5)
assert len(res.costs) == 2
pp = ot.PyramidPlan(ot.Problem(laplacian), [{"W": 4, "H": 4}, {"W": 8, "H": 8}],
                    lambda u, i, d: {"X": ot.upsample2x_nearest(u["X"], (d["W"], d["H"]))},
                    device="cpu", nIterations=1, lIterations=5)
res = pp.solve([{"X": np.zeros((4, 4), "f4"), "A": rng.rand(4, 4).astype("f4")},
                {"X": np.zeros((8, 8), "f4"), "A": rng.rand(8, 8).astype("f4")}])
assert len(res.costs) == 2 and np.isfinite(res.final_cost)
# the Opt.h functions, the C library's bridge and its build script
import opt_tpu_torch.api as api
import opt_tpu_torch.native_bridge
from opt_tpu_torch.native import build
state = api.new_state(device="cpu")
plan = api.problem_plan(state, api.problem_define(state, laplacian), {"W": 8, "H": 8})
api.problem_init(plan, {"X": rng.rand(8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")})
while api.problem_step(plan):
    pass
assert np.isfinite(api.problem_current_cost(plan))
assert {"opt_tpu_torch.ops.sampling", "opt_tpu_torch.pyramid"} <= set(sys.modules)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "opt_tpu" or m.startswith("opt_tpu."))
assert not bad, bad
assert "opt_tpu_torch.ops._build" not in sys.modules
assert "triton" not in sys.modules
print("ISOLATED")
"""


def test_import_and_cpu_solve_load_no_jax_and_no_kernel():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|opt_tpu)\b(?!_torch)", re.M)
    files = sorted((REPO / "opt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"distributed.py", "mesh.py"} <= {f.name for f in files if f.parent.name == "parallel"}
    assert {"timer.py", "plan_report.py", "checkpoint.py", "memory.py", "io.py"} <= {
        f.name for f in files if f.parent.name == "utils"}
    assert REPO / "opt_tpu_torch" / "harness.py" in files
    assert {REPO / "opt_tpu_torch" / "api.py", REPO / "opt_tpu_torch" / "native_bridge.py",
            REPO / "opt_tpu_torch" / "native" / "build.py"} <= set(files)
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_c_library_names_only_the_port():
    """The port's C library embeds CPython and imports the port's bridge,
    never the JAX package's; its client loads no energy file of its own
    that imports anything."""
    native = REPO / "opt_tpu_torch" / "native"
    cpp = (native / "opttpu_torch.cpp").read_text()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', cpp) == ["opt_tpu_torch.native_bridge"]
    for src in (cpp, (native / "client.c").read_text()):
        names = set(re.findall(r"\bopt_tpu\w*(?:\.\w+)*", src))
        assert names <= {"opt_tpu_torch", "opt_tpu_torch.native_bridge"}, names
    spec = (REPO / "native" / "test" / "laplacian_spec.py").read_text()
    assert not re.search(r"^\s*(import|from)\s", spec, re.M)


def test_default_plan_without_cuda_raises(monkeypatch):
    """plan() with no device runs on the card: where CUDA is absent it
    raises, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": 8})


def test_cuda_plan_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cuda")


@pytest.mark.parametrize("device", ["meta", "mps"])
def test_other_plan_devices_raise(device):
    with pytest.raises(ValueError, match="unsupported device"):
        ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device=device)


def test_fused_grid_cg_refuses_other_devices():
    meta = {"u_list": ("X",), "offs": {"X": 0}, "channels": {"X": 1}, "ctot": 1,
            "triples": (((0, 0), 0, 0, 0),), "F": torch.ones((1, 4, 4), device="meta")}
    x = {"X": torch.ones((4, 4, 1), device="meta")}
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        fused_cg.fused_grid_cg(meta, x, x, 5, 0.0)


# -- the reference's keywords and switches the port has not reached ---------------


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "item 8"),
                                     ({"dynamic_topology": True}, "item 4")])
def test_plan_takes_the_reference_keywords_and_raises(kw, item):
    """Problem.plan takes ``mesh=`` and ``dynamic_topology=`` as the JAX
    package does. A graph spec plans on a mesh (item 8b), in float64 too;
    what a mesh does not take yet raises before the mesh is read, naming
    its roadmap item: a dynamic topology on a mesh (item 8e). A dynamic
    topology (item 4's first bullet) is ported: the graph plan takes it."""
    if "dynamic_topology" in kw:
        plan = ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": 8}, device="cpu", **kw)
        assert plan.dynamic_topology and plan.solver.ip.dynamic_topology is True
        return
    with pytest.raises(NotImplementedError, match=item):
        ott.Problem(tspecs.arap_mesh_deformation).plan(dims={"N": 8}, device="cpu",
                                                      double_precision=True,
                                                      dynamic_topology=True, **kw)


def test_plan_takes_the_default_keywords():
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", mesh=None,
                                              dynamic_topology=False)
    assert plan.solver.ip.dynamic_topology is False


@pytest.mark.parametrize("field,value,error,match", [
    ("edge_reorder", "owner", None, None),
    ("edge_reorder", "bogus", ValueError, "only implemented mode"),
    ("aligned_graph_assembly", True, NotImplementedError, "not to be ported"),
])
def test_unported_init_params_raise(field, value, error, match):
    """InitializationParameters that the port does not read raise, where the
    JAX package would act on them. ``edge_reorder="owner"`` is ported
    (item 8b): a plan takes it, and off a mesh it reorders nothing, as in
    the JAX package."""
    ip = ott.InitializationParameters(**{field: value})
    if error is None:
        plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu",
                                                  init_params=ip)
        assert plan.solver.ip.edge_reorder == "owner"
        return
    with pytest.raises(error, match=match):
        ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", init_params=ip)


def test_collect_per_kernel_timing_plans_on_the_cpu(capsys):
    """collect_per_kernel_timing=True (queue 1 item 6a) plans and solves on
    the CPU and prints the reference's TIMING line, where it raised
    before it was ported."""
    ip = ott.InitializationParameters(collect_per_kernel_timing=True)
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", init_params=ip)
    rng = np.random.RandomState(0)
    res = plan.solve({"X": rng.rand(8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")},
                     nIterations=2, lIterations=5)
    out = capsys.readouterr().out
    assert "TIMING " in out and "Per-iter times ms (nonlinear,linear):" in out
    assert plan._timing_phases["PCGStep1"].count == res.num_linear_iterations


@pytest.mark.parametrize("value", [False, None, "auto"])
def test_edge_reorder_off_is_accepted(value):
    ip = ott.InitializationParameters(edge_reorder=value)
    ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", init_params=ip)


def test_enable_double_precision_is_exported():
    """A script written for the reference calls it before a float64 plan."""
    assert "enable_double_precision" in ott.__all__
    assert ott.enable_double_precision() is None
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu",
                                              double_precision=True)
    assert plan.compiled.dtype == torch.float64


def test_explicit_jtj_plans_on_the_cpu_and_raises_under_a_mesh():
    """use_explicit_jtj=True (queue 1 item 5) plans and solves on the CPU,
    with no assembly plan; a mesh of several ranks cannot take it and says
    so, naming its roadmap item, rather than running another operator."""
    import types

    import numpy as np

    ip = ott.InitializationParameters(use_explicit_jtj=True)
    plan = ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", init_params=ip)
    assert plan.solver._stencil_plan is None
    rng = np.random.RandomState(0)
    res = plan.solve({"X": rng.rand(8, 8).astype("f4"), "A": rng.rand(8, 8).astype("f4")},
                     nIterations=1, lIterations=20)
    assert np.isfinite(res.final_cost) and res.num_linear_iterations > 0
    mesh = types.SimpleNamespace(shape=(2, 2), size=4, coords=(0, 0), device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 8e"):
        ott.Problem(tspecs.laplacian).plan(dims={"W": 8, "H": 8}, device="cpu", mesh=mesh,
                                           init_params=ip)
