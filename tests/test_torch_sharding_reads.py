"""The port's sharded solve of grid specs that read Index, a SampledImage or
a ComputedArray (opt_tpu_torch/spec.py, compile.py, parallel/mesh.py,
problem.py, pyramid.py), held to the port's single-rank solve and to the
JAX package.

* shape_from_shading at 32x32 (Index inside two ComputedArrays, B_I and
  valid, and in the smoothness term), on a smooth depth ramp so that its
  smoothness term is active, with a block of invalid depths across the
  corner of the 2x2 split (Exclude rows and gated terms on four tiles);
* optical_flow at 16x16 (Index and a SampledImage of the second image),
  and its two-level PyramidPlan, 16x16 then 32x32, the flow prolonged
  between levels.

Each rank's region is the tile plus the reach of every term, a
ComputedArray's expression included (grid_reach); Index reads the region's
global origin; the sampled image is bound whole. The JAX package's default
mesh solve of shape_from_shading parts from its own single-device solve
(ROADMAP.md queue 3), so the port's SFS mesh solve is held to the JAX
single-device solve and to the JAX mesh solve of the composed operator
(use_fused_jtj=False), never to the JAX default mesh solve.

Tolerances (relative, on the costs after each step):

* against the port's single-rank solve under the same settings: 1e-5 on
  each of the two steps, the CG counts equal (pinned); 1e-4 under the
  mesh's auto policy (Chronopoulos-Gear and block-Jacobi against the same
  on one rank: its recurrences amplify the dots' sum order); the unknowns
  within 1e-5 of their largest entry;
* against the JAX package: 1e-4 on the first step (two float32 programs
  that sum in other orders); optical_flow's whole 2x10 solve at 1e-5 as
  the JAX package's own mesh and single-device solves agree to 1e-6;
* the pyramid at 10 CG iterations a step (optical_flow's CG parts two
  float32 solves past about 15, ROADMAP.md queue 3): each level's final
  cost at 1e-4 against the JAX PyramidPlan on the mesh;
* the region's fields, right-hand side and preconditioner on each tile
  against the single-device ones cropped to the tile: equal, bit for bit
  (every entry is computed by the same elementwise arithmetic from the
  same values; the 1e-6 of the largest entry that a sum order could move
  is not needed).

The port's ranks are one gloo world of four CPU processes started once for
the module; the JAX side runs meanwhile in this process on four of
tests/conftest.py's eight virtual CPU devices.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from opt_tpu_torch.compile import compile_spec
from opt_tpu_torch.parallel.mesh import ShardingRules, grid_reach
from opt_tpu_torch.problem import Plan
from opt_tpu_torch.spec import whole_image_key

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

# The specs, inputs and cases both sides build (the ranks import neither
# JAX nor opt_tpu)
SHARED = r'''
import numpy as np

f32 = np.float32


def specs(ot):
    import importlib

    models = importlib.import_module(ot.__name__ + ".models.specs")
    return {"sfs": models.shape_from_shading, "flow": models.optical_flow}


def sfs_inputs(n):
    """bench.py::bench_shape_from_shading's parameters on a smooth depth ramp
    (neighbours within the 0.01 discontinuity threshold: the smoothness
    term is active), the unknown moved off it by a little noise, and a 4x4
    block of invalid depths across the middle of the grid."""
    rng = np.random.RandomState(0)
    ii, jj = np.meshgrid(np.arange(n, dtype=f32), np.arange(n, dtype=f32), indexing="ij")
    depth = (2.0 + 0.002 * ii + 0.001 * jj).astype(f32)
    x = depth + 0.0005 * rng.randn(n, n).astype(f32)
    h = n // 2
    depth[h - 2:h + 2, h - 3:h + 1] = 0.0
    return {"X": x, "D_i": depth, "Im": rng.rand(n, n).astype(f32),
            "edgeMaskR": np.ones((n, n), f32), "edgeMaskC": np.ones((n, n), f32),
            "w_p": 1.0, "w_s": 10.0, "w_g": 1.0, "f_x": 500.0, "f_y": 500.0,
            "u_x": n / 2.0, "u_y": n / 2.0,
            **{f"L_{i}": (0.5 if i == 1 else 0.1) for i in range(1, 10)}}


def flow_inputs(n, levels=1):
    """bench.py::bench_optical_flow's inputs, coarse to fine."""
    from chip_smoke import flow_levels

    return flow_levels(n, levels)


def case_inputs(spec, n):
    return sfs_inputs(n) if spec == "sfs" else flow_inputs(n)[0]


PINNED = {"cg_variant": "standard", "preconditioner": "jacobi"}
CS_BJ = {"cg_variant": "chronopoulos_gear", "preconditioner": "block_jacobi"}
# name: spec, grid side, the mesh's init parameters, the single rank's,
# nonlinear x CG iterations, the unknown
CASES = {
    "sfs": ("sfs", 32, PINNED, PINNED, 2, 10),
    "sfs_auto": ("sfs", 32, {}, CS_BJ, 2, 10),
    "flow": ("flow", 16, PINNED, PINNED, 2, 10),
    "flow_auto": ("flow", 16, {}, CS_BJ, 2, 10),
}
# the pyramid: two levels, 16x16 then 32x32, GN 2x10 a level, pinned
PYRAMID_N, PYRAMID_NL, PYRAMID_LI = 32, 2, 10


def pyramid_dims():
    return [{"W": PYRAMID_N // 2, "H": PYRAMID_N // 2}, {"W": PYRAMID_N, "H": PYRAMID_N}]


def prolong_with(upsample):
    def prolong(unknowns, i, next_dims):
        return {"X": upsample(unknowns["X"], (next_dims["W"], next_dims["H"]), scale=2.0)}
    return prolong
'''

WORKER = r'''
import hashlib, json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import opt_tpu_torch as ot
from opt_tpu_torch.parallel import initialize, make_mesh
from opt_tpu_torch.utils.plan_report import plan_summary

rank, world, store, out_dir = sys.argv[1:5]
rank, world = int(rank), int(world)
ns = {{}}
exec(open(out_dir + "/shared.py").read(), ns)
initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
mesh = make_mesh(device="cpu")
specs = ns["specs"](ot)


def digest(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def record(plans, res, inputs):
    return {{"cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
            "steps": res.num_iterations, "fallback": [p.fused_fallback for p in plans],
            "stats": [st for p in plans for st in p.solver.cg_stats],
            "shape": list(res.unknowns["X"].shape), "digest": digest(res.unknowns["X"]),
            "summary": [plan_summary(p, i, p.solver_params) for p, i in zip(plans, inputs)]}}


out = {{"rank": rank}}
for name, (spec, n, ip, _single, nl, li) in ns["CASES"].items():
    inputs = ns["case_inputs"](spec, n)
    plan = ot.Problem(specs[spec]).plan(
        dims={{"W": n, "H": n}}, mesh=mesh, device="cpu",
        init_params=ot.InitializationParameters(**ip))
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    if rank == 0:
        np.save(f"{{out_dir}}/{{name}}.npy", res.unknowns["X"].numpy())
    out[name] = record([plan], res, [inputs])
    out[name]["tile"] = [list(t) for t in plan.rules.tile]
    out[name]["halo"] = list(plan.rules.halo)
levels = ns["flow_inputs"](ns["PYRAMID_N"], 2)
pp = ot.PyramidPlan(ot.Problem(specs["flow"]), ns["pyramid_dims"](),
                    ns["prolong_with"](ot.upsample2x_nearest), mesh=mesh, device="cpu",
                    init_params=ot.InitializationParameters(**ns["PINNED"]),
                    nIterations=ns["PYRAMID_NL"], lIterations=ns["PYRAMID_LI"])
res = pp.solve([dict(lv) for lv in levels])
if rank == 0:
    np.save(f"{{out_dir}}/pyramid.npy", res.unknowns["X"].numpy())
out["pyramid"] = record(pp.plans, res, levels)
out["pyramid"]["level_costs"] = pp.level_costs
out["pyramid"]["level_lin"] = pp.level_lin_iters
with open(f"{{out_dir}}/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
'''


def shared():
    ns = {}
    exec(SHARED, ns)
    return ns


sys.path.insert(0, REPO)  # chip_smoke, which SHARED imports
NS = shared()
CASES = NS["CASES"]


def jax_solves():
    """The JAX package's solves each case is held to: single-device (its
    default plan, the standard loop and Jacobi); for shape_from_shading the
    2x2 mesh's solve of the composed operator, pinned; for optical_flow the
    2x2 mesh's default plan and its pinned one; and the pyramid on the
    mesh, pinned."""
    import jax

    mesh = jax_make_mesh(jax.devices()[:WORLD], shape=(2, 2))
    specs = NS["specs"](ot)
    pinned = NS["PINNED"]
    out = {}
    for spec, n in (("sfs", 32), ("flow", 16)):
        inputs = NS["case_inputs"](spec, n)
        if spec == "sfs":
            plans = {"single": {}, "mesh_composed": {"mesh": mesh, "init_params":
                     ot.InitializationParameters(use_fused_jtj=False, **pinned)}}
        else:
            plans = {"single": {}, "mesh_default": {"mesh": mesh}, "mesh_pinned": {
                "mesh": mesh, "init_params": ot.InitializationParameters(**pinned)}}
        for key, kw in plans.items():
            res = ot.Problem(specs[spec]).plan(dims={"W": n, "H": n}, **kw).solve(
                dict(inputs), nIterations=2, lIterations=10)
            out[(spec, key)] = (list(res.costs), res.num_linear_iterations)
    pp = ot.PyramidPlan(ot.Problem(specs["flow"]), NS["pyramid_dims"](),
                        NS["prolong_with"](ot.upsample2x_nearest), mesh=mesh,
                        init_params=ot.InitializationParameters(**pinned),
                        nIterations=NS["PYRAMID_NL"], lIterations=NS["PYRAMID_LI"])
    res = pp.solve([dict(lv) for lv in NS["flow_inputs"](NS["PYRAMID_N"], 2)])
    out[("flow", "pyramid_mesh")] = (list(res.costs), res.num_linear_iterations)
    return out


def run_world(tmp_path, while_running):
    """Start a gloo world of WORLD CPU ranks running WORKER; call
    ``while_running()`` meanwhile; return (its value, the ranks' results by
    rank, the directory holding rank 0's unknowns)."""
    out_dir = tmp_path / "world"
    out_dir.mkdir()
    (out_dir / "shared.py").write_text(SHARED)
    script = out_dir / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                          str(out_dir / "store"), str(out_dir)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(WORLD)
    ]
    try:
        value = while_running()
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return value, ranks, out_dir


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding_reads")
    jax_res, ranks, out_dir = run_world(tmp, jax_solves)
    return {"jax": jax_res, "ranks": ranks, "dir": out_dir}


_SINGLE = {}


def port_single(name):
    """The port's solve of a case on one device (the CPU) with the case's
    single-rank settings: (costs, CG count, X)."""
    if name not in _SINGLE:
        spec, n, _ip, single, nl, li = CASES[name]
        res = ott.Problem(NS["specs"](ott)[spec]).plan(
            dims={"W": n, "H": n}, device="cpu",
            init_params=ott.InitializationParameters(**single),
        ).solve(dict(NS["case_inputs"](spec, n)), nIterations=nl, lIterations=li)
        _SINGLE[name] = (res.costs, res.num_linear_iterations, res.unknowns["X"].numpy())
    return _SINGLE[name]


def _rel(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_solve_matches_single_rank(world, name):
    """The port's 2x2 mesh solve against its own single-rank solve: each
    step's cost at 1e-5 (pinned) or 1e-4 (auto), the CG counts equal, the
    unknowns of the global shape, finite, within 1e-5 of their largest
    entry (equal in this repo's CPU runs: the dots' float64 sums make the
    iterates independent of the split, where the cost's sum is not)."""
    costs, lin, X = port_single(name)
    got = world["ranks"][0][name]
    rtol = 1e-5 if CASES[name][2] else 1e-4
    assert len(got["costs"]) == len(costs) == CASES[name][4]
    assert max(_rel(got["costs"], costs)) <= rtol, (got["costs"], costs)
    assert got["lin"] == lin, (got["lin"], lin)
    Xm = np.load(world["dir"] / f"{name}.npy")
    assert Xm.shape == X.shape and np.isfinite(Xm).all()
    assert np.abs(Xm - X).max() <= 1e-5 * np.abs(X).max(), np.abs(Xm - X).max()


@pytest.mark.parametrize("name,ref", [
    ("sfs", "single"), ("sfs", "mesh_composed"),
    ("flow", "single"), ("flow", "mesh_pinned"),
    ("flow_auto", "mesh_default"),
])
def test_mesh_solve_matches_jax(world, name, ref):
    """The port's mesh solve against the JAX package's: the first step's
    cost at 1e-4 and the CG counts equal; optical_flow's whole 2x10 solve
    at 1e-5. shape_from_shading is held to the JAX single-device solve and
    to its composed-operator mesh solve only (the JAX default mesh solve
    parts from both, ROADMAP.md queue 3)."""
    spec = CASES[name][0]
    costs, lin = world["jax"][(spec, ref)]
    got = world["ranks"][0][name]
    assert _rel(got["costs"][:1], costs[:1])[0] <= 1e-4, (got["costs"], costs)
    if spec == "flow":
        assert max(_rel(got["costs"], costs)) <= 1e-5, (got["costs"], costs)
    assert got["lin"] == lin, (got["lin"], lin)


def test_jax_default_mesh_sfs_is_not_the_reference(world):
    """The JAX package's composed-operator mesh solve of shape_from_shading
    agrees with its single-device solve (1e-5) and the port's mesh solve
    with both: the reference the port is held to is the single-device
    semantics."""
    single = world["jax"][("sfs", "single")][0]
    composed = world["jax"][("sfs", "mesh_composed")][0]
    assert max(_rel(composed, single)) <= 1e-5, (composed, single)


def test_pyramid_on_the_mesh_matches_jax(world):
    """The port's two-level PyramidPlan on the 2x2 mesh against the JAX
    package's on its mesh: each level's final cost at 1e-4, the CG counts
    equal; and against the port's single-rank PyramidPlan at 1e-5 a level,
    the level's steps' costs (level_costs) ending at its final cost, the
    unknowns global (32x32x2) and within 1e-5 of the single rank's largest
    entry."""
    costs, lin = world["jax"][("flow", "pyramid_mesh")]
    got = world["ranks"][0]["pyramid"]
    assert max(_rel(got["costs"], costs)) <= 1e-4, (got["costs"], costs)
    assert got["lin"] == lin
    pp = ott.PyramidPlan(ott.Problem(NS["specs"](ott)["flow"]), NS["pyramid_dims"](),
                         NS["prolong_with"](ott.upsample2x_nearest), device="cpu",
                         init_params=ott.InitializationParameters(**NS["PINNED"]),
                         nIterations=NS["PYRAMID_NL"], lIterations=NS["PYRAMID_LI"])
    res = pp.solve([dict(lv) for lv in NS["flow_inputs"](NS["PYRAMID_N"], 2)])
    assert max(_rel(got["costs"], res.costs)) <= 1e-5, (got["costs"], res.costs)
    for lc, want in zip(got["level_costs"], pp.level_costs):
        assert max(_rel(lc, want)) <= 1e-5, (lc, want)
    assert [lc[-1] for lc in got["level_costs"]] == got["costs"]
    assert got["level_lin"] == pp.level_lin_iters and sum(got["level_lin"]) == got["lin"]
    X = res.unknowns["X"].numpy()
    Xm = np.load(world["dir"] / "pyramid.npy")
    assert Xm.shape == X.shape == (NS["PYRAMID_N"], NS["PYRAMID_N"], 2)
    assert np.abs(Xm - X).max() <= 1e-5 * np.abs(X).max(), np.abs(Xm - X).max()


@pytest.mark.parametrize("name", list(CASES) + ["pyramid"])
def test_every_rank_ran_the_sharded_kernel_loop_and_agrees(world, name):
    """Every rank ran the sharded loop at every step (the plan report's path
    "sharded loop" with K5, tile_apply_kernel<float>, as the apply), with no
    fallback, and agrees with rank 0 bit for bit, its unknowns included;
    the auto policy resolved to Chronopoulos-Gear and block-Jacobi."""
    first = world["ranks"][0][name]
    tiles = set()
    for r in world["ranks"]:
        got = r[name]
        assert got["fallback"] == [None] * len(got["fallback"])
        assert (got["cost"], got["lin"], got["costs"], got["digest"]) == (
            first["cost"], first["lin"], first["costs"], first["digest"])
        assert len(got["stats"]) == got["steps"] >= 1
        for st in got["stats"]:
            assert st["loop"] == "sharded loop" and st["applies"] >= st["iterations"]
        for summary in got["summary"]:
            assert summary["path"] == "sharded loop", summary
            assert summary["instance"] == "tile_apply_kernel<float>"
            assert summary["fused_fallback"] is None
            want = CASES[name][3] if name in CASES else NS["PINNED"]
            assert [summary["cg_variant"], summary["preconditioner"]] == [
                want["cg_variant"], want["preconditioner"]]
        if name in CASES:
            tiles.add(tuple(map(tuple, got["tile"])))
    if name in CASES:
        assert len(tiles) == WORLD


# -- in-process checks: the region against the single-device grid, no gloo ------


def region_plan(spec, rules):
    """A rank's plan without the world: the region's problem holding its
    origin, as Problem.plan builds it under a mesh, its system read as a
    single device's."""
    region = dict(zip(("W", "H"), rules.region_shape))
    compiled = dataclasses.replace(compile_spec(spec, region, torch.float32),
                                   grid_origin=rules.origin)
    return Plan(ott.Problem(spec), compiled, "gaussNewtonGPU", None, {}, torch.device("cpu"))


def region_inputs(compiled, rules, inputs):
    """What Plan._local_inputs gives a rank: each image's region, and a
    sampled image whole beside it."""
    out = {}
    for k, v in inputs.items():
        if k in compiled.registry.images:
            a = torch.as_tensor(np.asarray(v))
            if k in compiled.registry.sampled:
                out[whole_image_key(k)] = a
            v = rules.local(a)
        out[k] = v
    return out


def split_2x2(rules_of):
    """rules_of(mesh) for each position of a 2x2 mesh, with no world."""
    return [rules_of(types.SimpleNamespace(shape=(2, 2), coords=(gx, gy)))
            for gx in range(2) for gy in range(2)]


@pytest.mark.parametrize("spec,n", [("sfs", 32), ("flow", 16)])
def test_region_system_equals_the_cropped_single_device_system(spec, n):
    """On each tile of a 2x2 split, the region's assembled fields F, its
    right-hand side -JᵀF and its Jacobi preconditioner, cropped to the tile,
    equal the single-device ones cropped to the tile, bit for bit, with the
    same triples (the arithmetic of each entry is elementwise in values that
    are equal: every read of a tile point's residuals lies in the region,
    the coordinates are global and the sampled image is whole)."""
    fn = NS["specs"](ott)[spec]
    dims = {"W": n, "H": n}
    inputs = NS["case_inputs"](spec, n)
    meta, r0, pre, _kw = ott.Problem(fn).plan(dims=dims, device="cpu").cg_inputs(dict(inputs))
    reach = grid_reach(compile_spec(fn, dims, torch.float32))
    for rules in split_2x2(lambda m: ShardingRules(m, (n, n), reach)):
        plan = region_plan(fn, rules)
        m, b, p, _ = plan.cg_inputs(region_inputs(plan.compiled, rules, inputs))
        (r0_, r1_), (c0_, c1_) = rules.tile
        assert m["triples"] == meta["triples"]
        assert torch.equal(rules.crop_fields(m["F"]), meta["F"][:, r0_:r1_, c0_:c1_])
        for k in r0:
            assert torch.equal(rules.crop(b[k]), r0[k][r0_:r1_, c0_:c1_])
            assert torch.equal(rules.crop(p[k]), pre[k][r0_:r1_, c0_:c1_])


@pytest.mark.parametrize("axis", [0, 1])
def test_region_index_is_the_sliced_global_index(axis):
    """Index under a mesh: on each region of an uneven 2x2 split of a 13x10
    grid (a halo of (2, 1)), the coordinate field equals the global field sliced
    to the region, exactly; and the residuals that read it, at the centre
    and inside an inlined ComputedArray expression read at an offset
    (where the call site's composed offset is still added), equal the
    global ones on the tile."""
    from opt_tpu_torch.spec import SpecBuilder

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        C = S.ComputedArray("C", (W, H), lambda: S.Index(axis) * X(0, 0))
        S.Energy(X(0, 0) - 0.01 * S.Index(axis), X(0, 0) - X(2, 1), C(1, -1) - X(0, 0))

    def terms(compiled, x):
        return compiled.residual_terms({"X": x[..., None]}, {}, {}, {})

    dims = {"W": 13, "H": 10}
    whole = compile_spec(spec, dims, torch.float32)
    x = torch.as_tensor(np.random.RandomState(1).rand(13, 10).astype("f4"))
    want = terms(whole, x)
    coords = torch.arange(dims["W" if axis == 0 else "H"], dtype=torch.float32)
    coords = (coords[:, None] if axis == 0 else coords[None, :]).expand(13, 10)[..., None]
    assert grid_reach(whole) == (2, 1)
    for rules in split_2x2(lambda m: ShardingRules(m, (13, 10), grid_reach(whole))):
        (a0, a1), (b0, b1) = rules.region
        region = dict(zip(("W", "H"), rules.region_shape))
        c = dataclasses.replace(compile_spec(spec, region, torch.float32),
                                grid_origin=rules.origin)
        b = SpecBuilder("field", region, torch.float32, registry=c.registry,
                        bindings={"origin": c.grid_origin}, device="cpu")
        with b:
            assert torch.equal(b.Index(axis), coords[a0:a1, b0:b1])
        got = terms(c, rules.local(x))
        for k in (0, 2):
            assert torch.equal(rules.crop(got[k]), rules.crop(want[k][a0:a1, b0:b1]))


def test_sfs_grid_reach_covers_its_computed_arrays():
    """grid_reach of shape_from_shading, derived by hand from the spec
    (opt_tpu_torch/models/specs.py), is (3, 3):

    * E_p and the Exclude read X and D_i at the centre: reach 0;
    * E_g_h reads B_I at (0, 0) and (1, 0), edgeMaskR at the centre and the
      gate InBoundsExpanded(0, 0, 1) (the centre ± 1). B_I's expression
      reads X at (0, 0), (-1, 0), (0, -1), Im and D_i at the same three,
      and its own InBoundsExpanded(0, 0, 1): rows and columns -1..1 about
      the element. So about the residual, rows span -1 (B_I(0, 0)'s gate)
      to 2 (B_I(1, 0)'s gate, 1 + 1) and columns -1 to 1: a reach of
      (3, 2). Without B_I's expression (the reads of the term's slots
      alone: X at (1, -1) through B_I(1, 0)'s gradient slot, the gate at
      ±1) it is (2, 2);
    * E_g_v reads B_I at (0, 0) and (0, 1): (2, 3) likewise;
    * E_s reads X at the centre and its four neighbours (the
      back-projected points p) and valid at the centre, whose expression
      reads X and D_i at the centre and its four neighbours and gates on
      InBoundsExpanded(0, 0, 1): rows and columns -1..1, a reach of (2, 2).

    The largest along each axis: (3, 3). Each of the two ComputedArrays is
    recorded (neither nests another), so none is inlined and counted twice.
    """
    fn = NS["specs"](ott)["sfs"]
    c = compile_spec(fn, {"W": 32, "H": 32}, torch.float32)
    reach = c.registry.computed_reach
    assert c.registry.computed_failed == set()
    assert reach == {"B_I": ((-1, -1), (1, 1)), "valid": ((-1, -1), (1, 1))}
    assert grid_reach(c) == (3, 3)
    # without the expressions' reach, the slots alone
    plain = types.SimpleNamespace(terms=c.terms, registry=types.SimpleNamespace(
        slots=c.registry.slots, exclude_terms=c.registry.exclude_terms,
        computed_reach={k: ((0, 0), (0, 0)) for k in reach}))
    assert grid_reach(plain) == (2, 2)
