"""The port's driver entry (opt_tpu_torch/entry.py) held to the JAX
package's (__graft_entry__.py) on the CPU.

``entry(device="cpu")``'s step agrees with the JAX entry's step (cost and
unknowns at 1e-5, the same CG count) and is bit for bit a one-step
``Plan.solve``. ``dryrun_multichip(4, device="cpu")`` runs on a 2x2 gloo
world: every rank agrees, the sharded loop ran every CG apply (the tile
twin on the CPU), and the two grid solves' costs (standard PCG and
Chronopoulos-Gear, both with block-Jacobi) agree with the JAX package's
same solves on four virtual CPU devices at 1e-4.

The dry run's graph solve (arap by LM on a 64-vertex ring, under the
mesh's Chronopoulos-Gear and block-Jacobi) inverts 6x6 blocks of condition
6e5 (median) to 2e7 in float32: past 1/u, so float32 keeps no digit of
the preconditioned step in their weakest directions, and the packages land
at 18.7727 (JAX) and 19.2120 (port), float64 at 18.5806. Its float32 cost
is held finite and below the initial cost; the method is held in float64,
where the two packages' single-device solves of the same step agree at
1e-8 (the JAX side in a process of its own,
tests/float32_limits.py::jax_float64). A rank that raises makes the
parent raise;
without ``device`` both entry points plan on the card and raise where CUDA
is missing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
import opt_tpu_torch as ot
from opt_tpu_torch import entry as tentry
from opt_tpu_torch.models.specs import arap_mesh_deformation, image_warping
from tests.float32_limits import jax_float64

torch.set_num_threads(2)

GRID_RTOL = 1e-4
GRAPH_FLOAT64_RTOL = 1e-8
GRAPH_IP = dict(cg_variant="chronopoulos_gear", preconditioner="block_jacobi")


def graph_inputs(N):
    """The dry run's graph problem (__graft_entry__.py:103-118)."""
    rng = np.random.RandomState(1)
    f32 = np.float32
    pos = rng.rand(N, 3).astype(f32)
    con = -np.ones((N, 3), f32)
    con[0] = pos[0] + 0.25
    v0 = np.arange(N, dtype=np.int32)
    return {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), f32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0, "v1": (v0 + 1) % N},
        "w_fitSqrt": np.sqrt(10.0).astype(f32),
        "w_regSqrt": np.sqrt(1.0).astype(f32),
    }


def jax_graph_float64():
    """The dry run's graph step on one device in float64 by the JAX package
    (run by tests/float32_limits.py::jax_float64 with x64 on)."""
    import opt_tpu as jot
    from opt_tpu.models.specs import arap_mesh_deformation as jarap

    plan = jot.Problem(jarap).plan(dims={"N": 64}, kind="LMGPU", double_precision=True,
                                   init_params=jot.InitializationParameters(**GRAPH_IP))
    res = plan.solve(graph_inputs(64), nIterations=1, lIterations=3)
    return {"cost": np.float64(res.final_cost)}


def jax_dryrun_costs():
    """The JAX dry run's three solves (__graft_entry__.py:61-126) on four of
    the virtual CPU devices, the first under the port's explicit standard
    PCG with block-Jacobi (the JAX dry run's first solve takes the mesh's
    "auto", the second's recurrence): their final costs."""
    import jax

    import opt_tpu as jot
    from opt_tpu.models.specs import arap_mesh_deformation as jarap
    from opt_tpu.models.specs import image_warping as jwarp
    from opt_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    a, b = mesh.devices.shape
    n = max(8 * a, 8 * b)
    grid = jot.Problem(jwarp).plan(
        dims={"W": n, "H": n}, mesh=mesh,
        init_params=jot.InitializationParameters(**dict(tentry.GRID_CASES)["grid"]),
    ).solve(jentry._warp_inputs(n), nIterations=1, lIterations=3)
    fused = jot.Problem(jwarp).plan(
        dims={"W": n, "H": n}, mesh=mesh,
        init_params=jot.InitializationParameters(use_pallas_cg="interpret", **GRAPH_IP),
    ).solve(jentry._warp_inputs(n), nIterations=1, lIterations=3)
    graph = jot.Problem(jarap).plan(dims={"N": 64}, mesh=mesh, kind="LMGPU").solve(
        graph_inputs(64), nIterations=1, lIterations=3)
    return {"grid": grid.final_cost, "grid_cs_bj": fused.final_cost, "graph": graph.final_cost}


@pytest.fixture(scope="module")
def dryrun():
    return tentry.dryrun_multichip(4, device="cpu")


def test_entry_step_matches_jax():
    jfn, jargs = jentry.entry()
    jstate = jfn(*jargs)
    fn, args = tentry.entry(device="cpu")
    state = fn(*args)
    assert rel(float(state["prev_cost"]), float(jstate["prev_cost"])) <= 1e-5
    assert int(state["lin_iters"]) == int(jstate["lin_iters"]) > 0
    assert state["X"].keys() == jstate["X"].keys()
    for k, X in state["X"].items():
        J = np.asarray(jstate["X"][k])
        assert X.shape == J.shape
        assert np.abs(X.numpy() - J).max() <= 1e-5 * np.abs(J).max(), k


def test_entry_step_is_a_one_step_solve():
    fn, args = tentry.entry(device="cpu")
    state = fn(*args)
    plan = ot.Problem(image_warping).plan(dims={"W": 64, "H": 64}, device="cpu")
    res = plan.solve(tentry._warp_inputs(64), nIterations=1)
    assert float(state["prev_cost"]) == res.final_cost
    assert int(state["lin_iters"]) == res.num_linear_iterations
    assert all(torch.equal(state["X"][k], res.unknowns[k]) for k in res.unknowns)


def test_dryrun_multichip_matches_jax(dryrun):
    assert [r["rank"] for r in dryrun] == [0, 1, 2, 3]
    first = dryrun[0]
    for r in dryrun:
        for case in ("grid", "grid_cs_bj", "graph"):
            assert (r[case]["cost"], r[case]["lin"]) == (first[case]["cost"], first[case]["lin"])
        for case in ("grid", "grid_cs_bj"):
            c = r[case]
            # every CG apply on the CPU's twin: one an iteration, no kernel
            assert c["applies"] == c["lin"] > 0 and c["tile_kernel_launches"] == 0
            assert c["fused_fallback"] is None
            assert c["variant"] == list(dict(tentry.GRID_CASES)[case].values())
        assert r["grid"]["variant"] == ["standard", "block_jacobi"]
        assert r["grid_cs_bj"]["variant"] == ["chronopoulos_gear", "block_jacobi"]
        # two recurrences: their float32 costs after three CG steps may
        # coincide, their unknowns do not
        assert r["grid"]["x_digest"] != r["grid_cs_bj"]["x_digest"]
    want = jax_dryrun_costs()
    for case in ("grid", "grid_cs_bj"):
        assert rel(first[case]["cost"], want[case]) <= GRID_RTOL, (case, first[case], want)
    # the graph solve in float32: finite, below its initial cost, as the
    # JAX package's is (see the module's docstring)
    plan = ot.Problem(arap_mesh_deformation, kind="LMGPU").plan(dims={"N": 64}, device="cpu")
    plan.init(graph_inputs(64))
    initial = plan.current_cost()
    assert np.isfinite(first["graph"]["cost"]) and first["graph"]["cost"] < initial
    assert want["graph"] < initial


def test_dryrun_graph_step_matches_jax_in_float64():
    plan = ot.Problem(arap_mesh_deformation, kind="LMGPU").plan(
        dims={"N": 64}, device="cpu", double_precision=True,
        init_params=ot.InitializationParameters(**GRAPH_IP))
    got = plan.solve(graph_inputs(64), nIterations=1, lIterations=3).final_cost
    want = float(jax_float64("tests.test_torch_entry", "jax_graph_float64")["cost"])
    assert rel(got, want) <= GRAPH_FLOAT64_RTOL, (got, want)


def raising_rank(world, device):
    """A rank's work that fails on rank 2 only (the others return at once)."""
    if dist.get_rank() == 2:
        raise ValueError("rank 2 fails on purpose")
    return {}


def test_a_rank_that_raises_makes_the_parent_raise():
    with pytest.raises(RuntimeError, match="rank 2 failed:(.|\n)*rank 2 fails on purpose"):
        tentry.run_ranks(raising_rank, 4, "cpu", timeout_s=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.dryrun_multichip(4)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)
