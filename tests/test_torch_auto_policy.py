"""The auto policy under a mesh (tests/test_auto_policy.py's resolutions,
with the mesh's size) and what it buys: Chronopoulos–Gear's one all_reduce
per CG iteration against the standard loop's two, counted by the mesh's
communicator (the analogue of test_hlo_audit_cs_halves_cg_loop_all_reduces,
which counts the all-reduce ops of the compiled program).

The ranks are one gloo world of four CPU processes, started once for the
module (tests/test_torch_sharding.py::run_world).
"""

import numpy as np
import pytest

import opt_tpu_torch as ott
from test_torch_sharding import NS, run_world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _v, ranks, _dir = run_world(tmp_path_factory.mktemp("auto_policy"), "auto_policy")
    return ranks


def test_single_device_resolution():
    plan = ott.Problem(NS["specs"](ott)["poisson_image_editing"]).plan(
        dims={"W": 16, "H": 16}, device="cpu")
    ip = plan.solver.ip
    assert (ip.cg_variant, ip.preconditioner, ip.edge_reorder) == ("standard", "jacobi", False)


@pytest.mark.parametrize("case,want", [
    # test_auto_policy.py:60: a grid on a mesh of several ranks
    ("resolved_grid", ["chronopoulos_gear", "block_jacobi", False]),
    # :88: explicit values pass through
    ("resolved_manual", ["standard", "jacobi", False]),
    # :74: a graph's resolution at the mesh's size (a graph plan on a mesh
    # takes it: tests/test_torch_sharding.py's "arap_auto")
    ("resolved_graph", ["chronopoulos_gear", "block_jacobi", "owner"]),
])
def test_mesh_resolution(world, case, want):
    for r in world:
        assert r[case] == want, (r["rank"], r[case])


@pytest.mark.parametrize("case,per_iteration", [
    ("gn_standard", 2), ("gn_cs", 1), ("lm_standard", 2), ("lm_cs", 1),
])
def test_cs_halves_the_cg_loop_all_reduces(world, case, per_iteration):
    """The standard loop reduces ⟨p, Ap⟩ and then rᵀz (with LM's Q beside
    it): two all_reduces an iteration; Chronopoulos–Gear's γ, δ (and Q) go
    in one. Each CG call adds the initial rᵀz's; a Chronopoulos–Gear loop
    that stops on its floor reduces the uncounted iteration's dots too."""
    for r in world:
        for st in r[case]["stats"]:
            passes = st["iterations"] if per_iteration == 2 else st["applies"] - (
                st["iterations"] // 10 if case.startswith("lm") else 0)
            assert st["all_reduce"] == 1 + per_iteration * passes, st


def test_auto_config_matches_pinned_equivalent_on_mesh(world):
    """test_auto_policy.py:103 on a grid: the auto mesh config (CS +
    block-Jacobi) solves to the same cost as the same explicit config on
    one device, with the same CG count."""
    single = ott.Problem(NS["specs"](ott)["image_warping"], kind="LMGPU").plan(
        dims={"W": 32, "H": 32}, device="cpu",
        init_params=ott.InitializationParameters(**NS["CS_BJ"]),
    ).solve(NS["inputs"]("image_warping", 32, 32), nIterations=3, lIterations=20,
            q_tolerance=1e-2)
    got = world[0]["lm_auto"]
    assert got["ip"] == ["chronopoulos_gear", "block_jacobi", False]
    assert got["lin"] == single.num_linear_iterations
    assert np.isclose(got["cost"], single.final_cost, rtol=2e-3), (got["cost"], single.final_cost)
