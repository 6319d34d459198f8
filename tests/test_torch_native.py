"""The port's C API layer against the JAX package's: both native bridges
driven from Python with ctypes pointers into copies of one set of numpy
buffers (a grid spec and a graph spec with a scalar Param, each an energy
file that imports nothing), and the port's C library and client built
here with g++ and gcc and run on the CPU, and without CUDA where the card
was asked for (opt_tpu_torch/native/, native/include/OptTpu.h).

Each client runs in its own process, which loads only the port's library:
the JAX package's libopttpu exports the same symbols
(tests/test_native.py runs its client)."""

import shutil

import numpy as np
import pytest
import torch

import opt_tpu.api as jax_api
import opt_tpu.native_bridge as jax_bridge
import opt_tpu_torch.native_bridge as torch_bridge
from opt_tpu_torch.native import build as native_build

torch.set_num_threads(2)

BRIDGES = {"jax": jax_bridge, "torch": torch_bridge}

GRID_SPEC = """
def spec(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))
"""

GRAPH_SPEC = """
def spec(S):
    N = S.Dim("N")
    X = S.Unknown("X", 2, (N,))
    T = S.Array("T", 2, (N,))
    w = S.Param("w")
    G = S.Graph("G", v0=(N,), v1=(N,))
    S.Energy(w * (X(0) - T(0)))
    S.Energy(X(G.v0) - X(G.v1))
"""


def _grid_case():
    rng = np.random.RandomState(0)
    n = 10
    a = rng.rand(n, n, 1).astype(np.float32)
    return GRID_SPEC, [n, n], [a.copy(), a]


def _graph_case():
    rng = np.random.RandomState(1)
    n = 16
    v0 = np.arange(n, dtype=np.int32)
    v1 = ((v0 + 1) % n).astype(np.int32)
    return GRAPH_SPEC, [n], [np.zeros((n, 2), np.float32), rng.rand(n, 2).astype(np.float32),
                             np.array([n], np.int32), v0, v1, np.array([0.7], np.float32)]


CASES = {"grid": _grid_case, "graph": _graph_case}


def _drive(bridge, path, dims, bufs, stepwise):
    """One Opt.h lifecycle through ``bridge``; returns (final cost, the
    handles it made)."""
    st = bridge.new_state(0, 0, 0)
    pr = bridge.problem_define(st, str(path), "gaussNewtonGPU")
    dims = np.asarray(dims, np.uint32)
    pl = bridge.problem_plan(st, pr, dims.ctypes.data, len(dims))
    bridge.set_solver_parameter(pl, "nIterations", 3.0)
    bridge.set_solver_parameter(pl, "lIterations", 20.0)
    ptrs = [b.ctypes.data for b in bufs]
    if stepwise:
        bridge.problem_init(pl, ptrs)
        while bridge.problem_step(pl):
            pass
    else:
        assert bridge.problem_solve(pl, ptrs) == 0
    cost = bridge.current_cost(pl)
    bridge.plan_free(pl)
    bridge.problem_delete(st, pr)
    bridge.release_state(st)
    return cost, (st, pr, pl)


@pytest.mark.parametrize("stepwise", [True, False], ids=["init_step", "solve"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bridges_agree(case, stepwise, tmp_path, monkeypatch):
    monkeypatch.setenv(torch_bridge.DEVICE_ENV, "cpu")
    text, dims, bufs = CASES[case]()
    path = tmp_path / f"{case}_energy.py"
    path.write_text(text)
    out = {}
    for name, bridge in BRIDGES.items():
        mine = [b.copy() for b in bufs]
        cost, handles = _drive(bridge, path, dims, mine, stepwise)
        assert not set(handles) & set(bridge._OBJECTS), "handles not released"
        out[name] = cost, mine
    (c_jax, b_jax), (c_torch, b_torch) = out["jax"], out["torch"]
    np.testing.assert_allclose(c_torch, c_jax, rtol=1e-5)
    # the unknowns written back into the caller's buffer, the rest untouched
    assert not np.array_equal(b_torch[0], bufs[0])
    np.testing.assert_allclose(b_torch[0], b_jax[0], atol=1e-5)
    for got, given in zip(b_torch[1:], bufs[1:]):
        assert np.array_equal(got, given)


def test_bridge_double_precision_writes_back_float32(tmp_path, monkeypatch):
    """Under doublePrecision the plan computes in float64 and the caller's
    float32 buffer gets its unknowns rounded to float32, as the JAX
    package's bridge does (its float64 run needs jax x64, a global switch,
    so it is not run here)."""
    monkeypatch.setenv(torch_bridge.DEVICE_ENV, "cpu")
    text, dims, bufs = _grid_case()
    path = tmp_path / "grid_energy.py"
    path.write_text(text)
    st = torch_bridge.new_state(1, 0, 0)
    pr = torch_bridge.problem_define(st, str(path), "gaussNewtonGPU")
    dims = np.asarray(dims, np.uint32)
    pl = torch_bridge.problem_plan(st, pr, dims.ctypes.data, len(dims))
    plan = torch_bridge._get(pl)
    assert plan.compiled.dtype == torch.float64
    mine = [b.copy() for b in bufs]
    torch_bridge.problem_solve(pl, [b.ctypes.data for b in mine])
    assert mine[0].dtype == np.float32 and plan.unknowns["X"].dtype == torch.float64
    assert np.array_equal(mine[0], plan.unknowns["X"].numpy().astype(np.float32))
    torch_bridge.plan_free(pl)
    torch_bridge.problem_delete(st, pr)
    torch_bridge.release_state(st)


def test_bridge_plan_without_cuda_raises(tmp_path, monkeypatch):
    """With OPT_TPU_TORCH_DEVICE unset the plan asks for the card and, where
    CUDA is absent, raises; nothing runs on the CPU."""
    monkeypatch.delenv(torch_bridge.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "grid_energy.py"
    path.write_text(GRID_SPEC)
    st = torch_bridge.new_state(0, 0, 0)
    pr = torch_bridge.problem_define(st, str(path), "gaussNewtonGPU")
    dims = np.array([8, 8], np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_bridge.problem_plan(st, pr, dims.ctypes.data, 2)
    torch_bridge.problem_delete(st, pr)
    torch_bridge.release_state(st)


@pytest.fixture(scope="module")
def client():
    """The port's library and client, built here (skipped only where the
    compiler or libpython is missing, as tests/test_native.py skips)."""
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("g++ or gcc not found")
    if not native_build.libpython().exists():
        pytest.skip(f"no shared libpython at {native_build.libpython()}")
    return native_build.build_native()


def test_client_on_the_cpu_matches_jax(client, tmp_path):
    run = native_build.run_client(64, 64, 3, 30, tmp_path / "out.bin", device="cpu",
                                  timeout=300)
    assert run["rc"] == 0, run["stdout"] + run["stderr"]
    assert "PASS" in run["stdout"]
    assert run["final_cost"] < run["init_cost"]
    solve = run["solve"]  # the bridge's line at verbosity 1
    assert solve["device"] == "cpu" and solve["path"] == "plain twin"
    assert solve["fused_fallback"] is None and solve["launches"] == {}
    A = run["A"]
    state = jax_api.new_state()
    plan = jax_api.problem_plan(
        state, jax_api.problem_define(state, str(native_build.REPO / "native" / "test" /
                                                 "laplacian_spec.py")), {"W": 64, "H": 64})
    jax_api.set_solver_parameter(plan, "nIterations", 3)
    jax_api.set_solver_parameter(plan, "lIterations", 30)
    jax_api.problem_init(plan, {"X": A.copy(), "A": A.copy()})
    while jax_api.problem_step(plan):
        pass
    np.testing.assert_allclose(run["final_cost"], jax_api.problem_current_cost(plan), rtol=1e-5)
    np.testing.assert_allclose(run["X"], np.asarray(plan.unknowns["X"]).reshape(64, 64),
                               atol=1e-5)


def test_client_without_cuda_fails_with_the_cuda_error(client, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the client plans on it")
    run = native_build.run_client(64, 64, 3, 30, tmp_path / "out.bin", timeout=300)
    assert run["rc"] == 1, run["stdout"] + run["stderr"]
    assert "ProblemPlan failed" in run["stderr"]
    assert "CUDA is not available" in run["stderr"]
    assert run["solve"] is None and "PASS" not in run["stdout"]
