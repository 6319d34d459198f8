"""The port's plan report (``Plan.dump_hlo``, opt_tpu_torch/utils/plan_report.py),
which stands where the JAX package's dump_hlo prints its compiled HLO
(tests/test_api_and_tools.py::test_dump_hlo_and_verbosity3): on a grid, a
graph, an eager-loop plan (couplings across vertex spaces) and an explicit
J plan it names the path, ``fused_fallback`` and the instance that
``fused_cg.launch_instance`` gives for the same system; it launches no CG
loop and leaves the plan's state alone; ``set_verbosity(3)`` writes it once
a plan."""

import glob

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott
from chip_smoke import (arap_grid_inputs, bench_image_warping_inputs, cluster_arap_inputs,
                        cluster_arap_spec)
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.logging import set_verbosity
from opt_tpu_torch.utils.plan_report import HEADER

torch.set_num_threads(2)


def lap_inputs(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def cases():
    arap_dims, arap_in = arap_grid_inputs(6)
    cl_dims, cl_in = cluster_arap_inputs(16, 4)
    return {
        # name: spec, dims, inputs, kind, init params, path, fused_fallback
        "grid": (tspecs.laplacian, {"W": 8, "H": 8}, lap_inputs(), "gaussNewtonGPU", {},
                 "plain twin", None),
        "grid_lm_block_jacobi": (tspecs.image_warping, {"W": 8, "H": 8},
                                 bench_image_warping_inputs(8), "LMGPU",
                                 {"preconditioner": "block_jacobi"}, "plain twin", None),
        "graph": (tspecs.arap_mesh_deformation, arap_dims, arap_in, "gaussNewtonGPU", {},
                  "plain twin", None),
        "cross_space": (cluster_arap_spec(ott), cl_dims, cl_in, "gaussNewtonGPU", {},
                        "eager loop", "no_kernel"),
        "explicit_j": (tspecs.laplacian, {"W": 8, "H": 8}, lap_inputs(), "gaussNewtonGPU",
                       {"use_explicit_jtj": True}, "explicit J", None),
    }


CASES = cases()


def plan_of(name):
    spec, dims, inputs, kind, ip, _path, _fb = CASES[name]
    plan = ott.Problem(spec, kind=kind).plan(dims=dims, device="cpu",
                                            init_params=ott.InitializationParameters(**ip))
    return plan, inputs


def lines(txt):
    return dict(ln.split(": ", 1) for ln in txt.splitlines()[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_report_names_the_path_fallback_and_instance(name, tmp_path):
    plan, inputs = plan_of(name)
    path = str(tmp_path / "report.txt")
    txt = plan.dump_hlo(dict(inputs), path=path)
    assert open(path).read() == txt
    assert txt.splitlines()[0] == HEADER
    got = lines(txt)
    _spec, _dims, _in, kind, _ip, want_path, want_fb = CASES[name]
    assert got["path"] == want_path
    assert got["fused_fallback"] == str(want_fb)
    meta, r0, _pre, kw = plan.cg_inputs(dict(inputs))
    if want_path == "plain twin":
        want = fused_cg.launch_instance(meta, fused_cg.pack(r0, meta), lm=kw.get("ctc") is not None,
                                        cs=kw["cg_variant"] == "chronopoulos_gear",
                                        pre_blocks=kw["pre_blocks"])
        assert got["instance"] == want
        assert got["triples"] == str(len(meta["triples"]))
        assert got["route"].startswith("{") and "layout" in got["route"]
    else:
        assert got["instance"] == "None" and meta is None
    # the library is not built on the CPU: no registers to read
    assert "registers" not in got or got["registers"] == "None"


def test_report_leaves_the_state_alone():
    """dump_hlo launches no CG loop and leaves the plan's state as it was,
    before init and in the middle of a stepwise solve."""
    plan, inputs = plan_of("grid")
    plan.dump_hlo(dict(inputs))
    assert plan._state is None
    plan.init(dict(inputs))
    plan.step()
    state = plan._state
    before = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
    x = state["X"]["X"].clone()
    plan.dump_hlo(dict(inputs), nIterations=1, lIterations=3)
    assert plan._state is state
    assert all(torch.equal(state[k], v) for k, v in before.items())
    assert torch.equal(plan._state["X"]["X"], x)
    plan.step()  # the stepwise solve carries on


def test_verbosity3_writes_one_report_a_plan(tmp_path, monkeypatch):
    """The analogue of test_dump_hlo_and_verbosity3: set_verbosity(3) makes
    Plan.solve write the report once a plan, numbered."""
    monkeypatch.chdir(tmp_path)
    first, inputs = plan_of("grid")
    second, _ = plan_of("grid")
    set_verbosity(3)
    try:
        first.solve(dict(inputs), nIterations=1, lIterations=3)
        first.solve(dict(inputs), nIterations=1, lIterations=3)
        second.solve(dict(inputs), nIterations=1, lIterations=3)
    finally:
        set_verbosity(0)
    files = sorted(glob.glob(str(tmp_path / "opt_tpu_torch_solve_plan_*.txt")))
    assert len(files) == 2
    for f in files:
        assert open(f).read().splitlines()[0] == HEADER
