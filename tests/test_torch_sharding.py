"""The port's sharded solve (opt_tpu_torch/parallel, ops/sharded_cg.py) held
to the JAX package's mesh solve (tests/test_sharding.py) and to its own
single-rank solve.

The port's ranks are processes of one gloo world on the CPU: a module
fixture starts four (a 2x2 mesh) once, runs every case in that world and
returns the results, which the parametrised tests then read. The JAX side
runs in this process on four of the eight virtual CPU devices of
tests/conftest.py, with the Pallas tile kernel in interpret mode, while the
ranks work.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as tF

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from opt_tpu_torch.ops import sharded_cg
from opt_tpu_torch.ops.fused_cg import _stencil_apply
from opt_tpu_torch.parallel import distributed, make_mesh
from opt_tpu_torch.parallel.mesh import ShardingRules

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

# The specs and inputs both sides build, and the cases (shared with the
# ranks, which import neither JAX nor opt_tpu)
SHARED = r'''
import numpy as np


def specs(ot):
    """The cases' specs, written against either package (``ot``)."""
    import importlib

    def poisson2(S):  # tests/test_sharding.py::poisson_spec
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        T = S.Array("T", 2, (W, H))
        M = S.Array("M", 1, (W, H))
        S.UsePreconditioner(False)
        S.Exclude(ot.Not(ot.eq(M(0, 0), 0)))
        for dx, dy in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
            e = (X(0, 0) - X(dx, dy)) - (T(0, 0) - T(dx, dy))
            S.Energy(ot.Select(ot.InBounds(dx, dy), e, 0.0))

    def biharmonic(S):  # tests/test_sharding.py::test_sharded_fused_cg_radius2_stencil
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.3 * (X(0, 0) - A(0, 0)))
        for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
            S.Energy(ot.Select(ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))

    models = importlib.import_module(ot.__name__ + ".models.specs")
    return {"poisson2": poisson2, "biharmonic": biharmonic,
            "image_warping": models.image_warping,
            "poisson_image_editing": models.poisson_image_editing}


def inputs(name, h, w):
    """Each case's inputs, as tests/test_sharding.py makes them."""
    f32 = np.float32
    if name == "poisson2":
        rng = np.random.RandomState(0)
        return {"X": rng.rand(h, w, 2).astype(f32), "T": rng.rand(h, w, 2).astype(f32),
                "M": (rng.rand(h, w) > 0.7).astype(f32)}
    if name == "biharmonic":
        rng = np.random.RandomState(5)
        return {"X": rng.rand(h, w).astype(f32), "A": rng.rand(h, w).astype(f32)}
    if name == "image_warping":
        rng = np.random.RandomState(0)
        ur = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).astype(f32)
        con = -np.ones((h, w, 2), f32)
        for _ in range(6):
            i, j = rng.randint(0, h, 2)
            con[i, j] = [i + rng.randn(), j + rng.randn()]
        return {"Offset": ur.copy(), "Angle": np.zeros((h, w), f32), "UrShape": ur,
                "Constraints": con, "Mask": np.zeros((h, w), f32),
                "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32)}
    if name == "poisson_image_editing":
        rng = np.random.RandomState(1)
        mask = np.ones((h, w), f32)
        mask[4:-4, 4:-4] = 0
        return {"X": rng.rand(h, w, 4).astype(f32), "T": rng.rand(h, w, 4).astype(f32),
                "M": mask}
    raise KeyError(name)


PINNED = {"cg_variant": "standard", "preconditioner": "jacobi", "edge_reorder": False}
CS_BJ = {"cg_variant": "chronopoulos_gear", "preconditioner": "block_jacobi",
         "edge_reorder": False}
# name: spec, kind, grid, mesh init parameters, the single-rank equivalent,
# nonlinear x CG iterations, extra solver parameters, (cost rtol,
# unknowns atol), the unknown compared, whether the JAX mesh solve is held
# too. LM's zeta exit is decided by a difference of two sums (ROADMAP.md
# queue 3): the LM cases put q_tolerance where zeta crosses it by a wide
# margin in both packages.
CASES = {
    # test_sharding.py:39 (the mesh's auto policy: Chronopoulos-Gear)
    "poisson": ("poisson2", "gaussNewtonGPU", (32, 32), {}, CS_BJ, 2, 50, {}, (1e-4, 1e-4),
                "X", True),
    # test_sharding.py:477, its four parametrisations
    "warp_gn_standard": ("image_warping", "gaussNewtonGPU", (32, 32), PINNED, PINNED, 3, 20,
                         {}, (1e-3, 1e-3), "Offset", True),
    "warp_gn_cs_bj": ("image_warping", "gaussNewtonGPU", (32, 32), CS_BJ, CS_BJ, 3, 20, {},
                      (1e-3, 1e-3), "Offset", True),
    "warp_lm_standard": ("image_warping", "LMGPU", (32, 32), PINNED, PINNED, 3, 20,
                         {"q_tolerance": 1e-2}, (1e-3, 1e-3), "Offset", True),
    "warp_lm_cs_bj": ("image_warping", "LMGPU", (32, 32), CS_BJ, CS_BJ, 3, 20,
                      {"q_tolerance": 1e-2}, (1e-3, 1e-3), "Offset", True),
    # test_sharding.py:557, a halo of two
    "radius2": ("biharmonic", "gaussNewtonGPU", (32, 32), PINNED, PINNED, 2, 25, {},
                (1e-4, 1e-4), "X", True),
    # an uneven split (17 + 16 rows), which the JAX package's sharded loop declines
    "uneven": ("poisson2", "gaussNewtonGPU", (33, 32), PINNED, PINNED, 2, 50, {},
               (1e-4, 1e-4), "X", False),
}
'''

WORKER = r'''
import json, sys, traceback
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import opt_tpu_torch as ot
from opt_tpu_torch.parallel import initialize, make_mesh
from opt_tpu_torch.parallel.mesh import ShardingRules
from opt_tpu_torch.solver.params import resolve_auto_policy

rank, world, store, out_dir, job = sys.argv[1:6]
rank, world = int(rank), int(world)
ns = {{}}
exec(open(out_dir + "/shared.py").read(), ns)
initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
mesh = make_mesh(device="cpu")
specs = ns["specs"](ot)
out = {{"rank": rank, "coords": list(mesh.coords)}}


def solve(name, spec, kind, grid, ip, nl, li, extra, unknown):
    plan = ot.Problem(specs[spec], kind=kind).plan(
        dims={{"W": grid[0], "H": grid[1]}}, mesh=mesh, device="cpu",
        init_params=ot.InitializationParameters(**ip))
    mesh.reset_counts()
    res = plan.solve(ns["inputs"](spec, *grid), nIterations=nl, lIterations=li, **extra)
    if rank == 0:
        np.save(f"{{out_dir}}/{{name}}.npy", res.unknowns[unknown].numpy())
    return {{"cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
            "steps": res.num_iterations, "fallback": res.fused_fallback,
            "stats": plan.solver.cg_stats,
            "shape": list(res.unknowns[unknown].shape), "tile": plan.rules.tile,
            "ip": [plan.solver.ip.cg_variant, plan.solver.ip.preconditioner,
                   plan.solver.ip.edge_reorder]}}


if job == "sharding":
    for name, (spec, kind, grid, ip, _single, nl, li, extra, _tol, unknown, _jax) in \
            ns["CASES"].items():
        out[name] = solve(name, spec, kind, grid, ip, nl, li, extra, unknown)
    # the halo: a 3-channel 33x32 tile extended by two in both axes
    g = torch.as_tensor(np.random.RandomState(7).rand(3, 33, 32).astype("f4"))
    rules = ShardingRules(mesh, (33, 32), (2, 2))
    (r0, r1), (c0, c1) = rules.tile
    ext = mesh.extend(mesh.extend(g[:, r0:r1, c0:c1], 2, 0), 2, 1)
    pad = torch.nn.functional.pad(g, (2, 2, 2, 2))
    out["halo_zeros"] = torch.equal(ext, pad[:, r0:r1 + 4, c0:c1 + 4])
    hwc = g.movedim(0, -1)
    reg = rules.extend_region({{"a": hwc[r0:r1, c0:c1, :1], "b": hwc[r0:r1, c0:c1, 1:]}})
    whole = torch.cat([reg["a"], reg["b"]], -1)
    out["halo_clip"] = torch.equal(whole, rules.local(hwc))
    out["gathered"] = torch.equal(rules.gather(rules.local(hwc)), hwc)
    # what a mesh refuses, by ROADMAP item
    refusals = {{"arap_mesh_deformation": {{"N": 64}},
                 "volumetric_mesh_deformation": {{"W": 8, "H": 8, "D": 8}},
                 "optical_flow": {{"W": 16, "H": 16}}, "shape_from_shading": {{"W": 16, "H": 16}}}}
    import opt_tpu_torch.models.specs as tspecs
    for name, dims in refusals.items():
        try:
            ot.Problem(getattr(tspecs, name)).plan(dims=dims, mesh=mesh, device="cpu")
            out["refuse_" + name] = ["planned", ""]
        except Exception as e:
            out["refuse_" + name] = [type(e).__name__, str(e)]
elif job == "auto_policy":
    def ip_of(spec, **kw):
        plan = ot.Problem(specs[spec]).plan(dims={{"W": 16, "H": 16}}, mesh=mesh, device="cpu",
                                            init_params=ot.InitializationParameters(**kw))
        ip = plan.solver.ip
        return [ip.cg_variant, ip.preconditioner, ip.edge_reorder]
    out["resolved_grid"] = ip_of("poisson_image_editing")
    out["resolved_manual"] = ip_of("poisson_image_editing", **ns["PINNED"])
    g = resolve_auto_policy(ot.InitializationParameters(), mesh.size, True)
    out["resolved_graph"] = [g.cg_variant, g.preconditioner, g.edge_reorder]
    cases = {{
        "gn_standard": ("gaussNewtonGPU", ns["PINNED"], {{}}),
        "gn_cs": ("gaussNewtonGPU", dict(ns["PINNED"], cg_variant="chronopoulos_gear"), {{}}),
        "lm_standard": ("LMGPU", ns["PINNED"], {{"q_tolerance": 1e-2}}),
        "lm_cs": ("LMGPU", dict(ns["PINNED"], cg_variant="chronopoulos_gear"),
                  {{"q_tolerance": 1e-2}}),
        "lm_auto": ("LMGPU", {{}}, {{"q_tolerance": 1e-2}}),
    }}
    for name, (kind, ip, extra) in cases.items():
        out[name] = solve(name, "image_warping", kind, (32, 32), ip, 3, 20, extra, "Offset")
with open(f"{{out_dir}}/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
'''


def run_world(tmp_path, job, while_running=None):
    """Start a gloo world of WORLD CPU ranks that runs ``job`` of WORKER;
    call ``while_running()`` meanwhile; return (its value, the ranks'
    results by rank, the directory holding rank 0's unknowns)."""
    out_dir = tmp_path / job
    out_dir.mkdir()
    (out_dir / "shared.py").write_text(SHARED)
    script = out_dir / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r), str(WORLD), str(out_dir / "store"),
             str(out_dir), job],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(WORLD)
    ]
    try:
        value = while_running() if while_running is not None else None
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return value, ranks, out_dir


def shared():
    ns = {}
    exec(SHARED, ns)
    return ns


NS = shared()
CASES = NS["CASES"]
JAX_CASES = [k for k, c in CASES.items() if c[-1]]


def jax_mesh_solves():
    """The JAX package's mesh solve of every case it takes, on a 2x2 mesh of
    virtual CPU devices with the tile kernel in interpret mode."""
    import jax

    mesh = jax_make_mesh(jax.devices()[:WORLD], shape=(2, 2))
    specs = NS["specs"](ot)
    out = {}
    for name in JAX_CASES:
        spec, kind, grid, ip, _single, nl, li, extra, _tol, unknown, _jax = CASES[name]
        res = ot.Problem(specs[spec], kind=kind).plan(
            dims={"W": grid[0], "H": grid[1]}, mesh=mesh,
            init_params=ot.InitializationParameters(use_pallas_cg="interpret", **ip),
        ).solve(NS["inputs"](spec, *grid), nIterations=nl, lIterations=li, **extra)
        out[name] = (res.final_cost, res.num_linear_iterations, np.asarray(res.unknowns[unknown]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_res, ranks, out_dir = run_world(tmp_path_factory.mktemp("sharding"), "sharding",
                                        jax_mesh_solves)
    return {"jax": jax_res, "ranks": ranks, "dir": out_dir}


def port_single(name):
    """The port's solve of a case on one device (the CPU), with the
    variants the mesh resolved to."""
    spec, kind, grid, _ip, single, nl, li, extra, _tol, unknown, _jax = CASES[name]
    res = ott.Problem(NS["specs"](ott)[spec], kind=kind).plan(
        dims={"W": grid[0], "H": grid[1]}, device="cpu",
        init_params=ott.InitializationParameters(**single),
    ).solve(NS["inputs"](spec, *grid), nIterations=nl, lIterations=li, **extra)
    return res.final_cost, res.num_linear_iterations, res.unknowns[unknown].numpy()


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_solve_matches_jax_mesh_solve(world, name):
    """The port on a 2x2 gloo world against opt_tpu on a 2x2 device mesh:
    equal CG counts, the costs and unknowns to test_sharding.py's
    tolerances."""
    rtol, atol = CASES[name][8]
    cost, lin, X = world["jax"][name]
    got = world["ranks"][0][name]
    assert got["lin"] == lin, (got["lin"], lin)
    assert np.isclose(got["cost"], cost, rtol=rtol), (got["cost"], cost)
    Xp = np.load(world["dir"] / f"{name}.npy")
    assert Xp.shape == X.shape
    assert np.abs(Xp - X).max() <= atol


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_solve_matches_single_rank(world, name):
    """The port's sharded solve against its own solve on one device with
    the same variants: equal CG counts, costs and unknowns to the case's
    tolerances."""
    rtol, atol = CASES[name][8]
    cost, lin, X = port_single(name)
    got = world["ranks"][0][name]
    assert got["lin"] == lin, (got["lin"], lin)
    assert np.isclose(got["cost"], cost, rtol=rtol), (got["cost"], cost)
    assert np.abs(np.load(world["dir"] / f"{name}.npy") - X).max() <= atol


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_path_ran_every_step_on_every_rank(world, name):
    """Every rank ran the sharded loop (the tile apply's twin, on the CPU)
    at every nonlinear step, with no fallback, and agrees with the others
    bit for bit; the unknowns came back global."""
    grid = CASES[name][2]
    first = world["ranks"][0][name]
    tiles = set()
    for r in world["ranks"]:
        got = r[name]
        assert got["fallback"] is None
        assert len(got["stats"]) == got["steps"] >= 1
        for st in got["stats"]:
            assert st["kernel"] is False and st["applies"] >= st["iterations"]
            assert st["p2p_phases"] == 2 * st["applies"]
        assert (got["cost"], got["lin"], got["costs"]) == (first["cost"], first["lin"],
                                                           first["costs"])
        assert tuple(got["shape"][:2]) == grid
        tiles.add(tuple(map(tuple, got["tile"])))
    assert len(tiles) == WORLD


@pytest.mark.parametrize("mode", ["halo_zeros", "halo_clip", "gathered"])
def test_halo_exchange_equals_slicing_the_global_tensor(world, mode):
    """extend on a 2x2 world equals slicing the zero-padded global tensor,
    corners included ("zeros"), or the region of the global tensor
    ("clip"); the gather puts the tiles back together."""
    assert all(r[mode] for r in world["ranks"])


@pytest.mark.parametrize("spec,item", [
    ("arap_mesh_deformation", "item 8b"),
    ("volumetric_mesh_deformation", "item 8c"),
    ("optical_flow", "item 8d"),
    ("shape_from_shading", "item 8d"),
])
def test_mesh_refusals_name_their_item(world, spec, item):
    """A mesh on a graph spec, a 3-D grid, or a spec that reads Index, a
    SampledImage or a ComputedArray raises, naming its ROADMAP item."""
    for r in world["ranks"]:
        kind, msg = r["refuse_" + spec]
        assert kind == "NotImplementedError" and item in msg, (kind, msg)


# -- the tile apply's twin against the whole-grid apply, in this process ---------


def _meta(spec, grid, kind="gaussNewtonGPU", **ip):
    plan = ott.Problem(NS["specs"](ott)[spec], kind=kind).plan(
        dims={"W": grid[0], "H": grid[1]}, device="cpu",
        init_params=ott.InitializationParameters(**ip))
    meta, *_ = plan.cg_inputs(NS["inputs"](spec, *grid))
    return meta


@pytest.mark.parametrize("case", ["radius1", "radius2", "image_warping", "bf16", "uneven"])
def test_tile_apply_twin_equals_the_whole_grid_apply(case):
    """tile_apply_reference on each tile of a 2x2 split, fed the tile of p
    extended from the zero-padded global p, equals the whole grid's
    _stencil_apply cropped to the tile, exactly."""
    spec, grid, ip = {
        "radius1": ("poisson2", (32, 32), {}),
        "radius2": ("biharmonic", (32, 32), {}),
        "image_warping": ("image_warping", (32, 32), {}),
        "bf16": ("poisson2", (32, 32), {"coefficient_dtype": "bfloat16"}),
        "uneven": ("poisson2", (33, 32), {}),
    }[case]
    meta = _meta(spec, grid, **ip)
    if case == "image_warping":
        assert (meta["F"].shape[0], len(meta["triples"])) == (26, 31)
    if case == "bf16":
        assert meta["F"].dtype == torch.bfloat16
    F, triples = meta["F"], meta["triples"]
    ah, aw = sharded_cg.halo_widths(triples)
    assert (ah, aw) == ((2, 2) if case == "radius2" else (1, 1))
    p = torch.as_tensor(np.random.RandomState(3).randn(meta["ctot"], *grid).astype("f4"))
    whole = _stencil_apply(F.float(), triples, p)
    pad = tF.pad(p, (aw, aw, ah, ah))
    for gx in range(2):
        for gy in range(2):
            rules = ShardingRules(types.SimpleNamespace(shape=(2, 2), coords=(gx, gy)), grid,
                                  (ah, aw))
            (r0, r1), (c0, c1) = rules.tile
            got = sharded_cg.tile_apply(F[:, r0:r1, c0:c1].contiguous(), triples,
                                        pad[:, r0:r1 + 2 * ah, c0:c1 + 2 * aw], ah, aw)
            assert torch.equal(got, whole[:, r0:r1, c0:c1])


def test_tile_apply_refuses_other_devices():
    F = torch.ones((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        sharded_cg.tile_apply(F, (((0, 0), 0, 0, 0),), torch.ones((1, 4, 4), device="meta"),
                              0, 0)


def test_ranks_never_build_the_library(tmp_path, monkeypatch):
    """A rank that finds the kernel library missing raises; it never starts
    nvcc itself."""
    from opt_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="not built"):
        _build.build_library(build=False)


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="share one device"):
        distributed.initialize(f"file://{tmp_path}/store", world_size=2, rank=0, backend="nccl")
    with pytest.raises(ValueError, match="backend must be"):
        distributed.initialize(f"file://{tmp_path}/store", world_size=2, rank=0)


def test_mesh_without_cuda_raises_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(device="cuda")
    assert make_mesh(device="cpu").device.type == "cpu"


def test_one_by_one_mesh_is_the_single_device_plan():
    """With no process group the mesh is 1x1, and the plan is the
    single-device plan: same result, no sharding rules."""
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.size, distributed.is_primary()) == ((1, 1), 1, True)
    spec = NS["specs"](ott)["poisson2"]
    inputs = NS["inputs"]("poisson2", 16, 16)
    a = ott.Problem(spec).plan(dims={"W": 16, "H": 16}, device="cpu", mesh=mesh)
    b = ott.Problem(spec).plan(dims={"W": 16, "H": 16}, device="cpu")
    assert a.rules is None
    ra = a.solve(dict(inputs), nIterations=1, lIterations=20)
    rb = b.solve(dict(inputs), nIterations=1, lIterations=20)
    assert (ra.final_cost, ra.num_linear_iterations) == (rb.final_cost, rb.num_linear_iterations)


@pytest.mark.parametrize("shape,halo", [((5, 32), (1, 1)), ((32, 6), (0, 4))])
def test_tiles_narrower_than_the_halo_raise(shape, halo):
    with pytest.raises(ValueError, match="narrower than the halo"):
        ShardingRules(types.SimpleNamespace(shape=(4, 2), coords=(0, 0)), shape, halo)
