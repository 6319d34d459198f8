"""The port's sharded solve under the options a mesh takes since slice 27
(opt_tpu_torch/problem.py, ops/sharded_cg.py, parallel/mesh.py,
functions.py, utils/timer.py), held to the port's single-rank solve and to
the JAX package's 2x2 mesh solve.

* the two bundled specs no other test runs on a mesh (ROADMAP.md item
  8f): intrinsic_image_decomposition at 16x16 (a grid, L_p) and
  robust_nonrigid_alignment at N = 64 (a graph, C = 7, a graph group over
  6 of the 7 channels, per-vertex ConstraintNormals), GN 2x10;
* float64 plans on a mesh: laplacian at 16x16 (the sharded loop on the
  tiles, its apply K5's float64 instance on the card, the plain twin
  here) and arap_mesh_deformation on an 8x8 grid mesh (the owner blocks'
  loop), GN 2x10;
* the composed operator on a mesh (``use_fused_jtj=False``): shape_from_
  shading at 16x16 GN 1x10 (Index inside ComputedArrays; the JAX
  package's composed mesh solve is its mesh solve that keeps to its single
  device, ROADMAP.md queue 3) and arap on the 8x8 grid mesh GN 1x10, with
  the probed Jacobi diagonal of a graph mesh, held to the single device's
  in float64 on arap and robust_nonrigid;
* a timed mesh solve (``collect_per_kernel_timing``) of laplacian and of
  arap: every rank keeps its rows, rank 0 prints the table, and the
  solve is the untimed one bit for bit;
* what is left of item 8e still raises, naming it, and the port-only
  helpers ``cg_inputs`` and ``batched_cg_inputs`` raise on a mesh.

Tolerances: a float64 solve against another, 1e-9 on the cost and the
unknowns with equal CG counts (they agree to 1e-12); a float32 solve's
costs after each step at 1e-4 (two float32 programs that sum in other
orders, as tests/test_torch_sharding.py's pinned cases) with equal CG
counts.

The port's ranks are one gloo world of four CPU processes started once for
the module; the JAX package's mesh solves run meanwhile in processes of
their own, one in float32 and one in float64 (``jax_enable_x64`` is
process-global).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott

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

    m = importlib.import_module(ot.__name__ + ".models.specs")
    return {"intrinsic": m.intrinsic_image_decomposition, "robust": m.robust_nonrigid_alignment,
            "laplacian": m.laplacian, "arap": m.arap_mesh_deformation,
            "sfs": m.shape_from_shading}


def sfs_inputs(n):
    """tests/test_torch_sharding_reads.py's: a smooth depth ramp (the
    smoothness term active), the unknown off it by a little noise, a 4x4
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


def inputs_of(spec):
    """(dims, inputs) of a case's spec."""
    from chip_smoke import arap_grid_inputs, intrinsic_inputs, robust_inputs

    if spec == "intrinsic":
        return {"W": 16, "H": 16}, intrinsic_inputs(16)
    if spec == "robust":
        return robust_inputs(8)
    if spec == "laplacian":
        rng = np.random.RandomState(0)
        return {"W": 16, "H": 16}, {"X": rng.rand(16, 16).astype(f32),
                                    "A": rng.rand(16, 16).astype(f32)}
    if spec == "arap":
        return arap_grid_inputs(8)
    if spec == "sfs":
        return {"W": 16, "H": 16}, sfs_inputs(16)
    raise KeyError(spec)


PINNED = {"cg_variant": "standard", "preconditioner": "jacobi", "edge_reorder": False}
COMPOSED = dict(PINNED, use_fused_jtj=False)
# name: spec, init parameters (the mesh's and the single rank's), nonlinear
# x CG iterations, float64, the unknown compared
CASES = {
    "intrinsic": ("intrinsic", PINNED, 2, 10, False, "r"),
    "robust": ("robust", PINNED, 2, 10, False, "Offset"),
    "laplacian_f64": ("laplacian", PINNED, 2, 10, True, "X"),
    "arap_f64": ("arap", PINNED, 2, 10, True, "Offset"),
    "sfs_composed": ("sfs", COMPOSED, 1, 10, False, "X"),
    "arap_composed": ("arap", COMPOSED, 1, 10, False, "Offset"),
}
# the cases solved once more with collect_per_kernel_timing
TIMED = ("laplacian", "arap")
# the probed Jacobi diagonal of a graph mesh, float64, against the single device
DIAG = ("arap", "robust")
'''

WORKER = r'''
import contextlib, hashlib, io, json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import opt_tpu_torch as ot
from opt_tpu_torch.parallel import initialize, make_mesh

rank, world, store, out_dir = sys.argv[1:5]
rank, world = int(rank), int(world)
ns = {{}}
exec(open(out_dir + "/shared.py").read(), ns)
initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
mesh = make_mesh(device="cpu")
specs = ns["specs"](ot)


def digest(res):
    h = hashlib.sha256()
    for k in sorted(res.unknowns):
        h.update(res.unknowns[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def plan_of(spec, ip, dbl=False, **extra):
    dims, _inputs = ns["inputs_of"](spec)
    return ot.Problem(specs[spec]).plan(dims=dims, mesh=mesh, device="cpu",
                                        double_precision=dbl,
                                        init_params=ot.InitializationParameters(**ip, **extra))


def record(plan, res):
    return {{"cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
            "fallback": res.fused_fallback, "digest": digest(res),
            "loops": [st["loop"] for st in plan.solver.cg_stats],
            "kernel": [st["kernel"] for st in plan.solver.cg_stats],
            "dtype": str(plan.compiled.dtype)}}


out = {{"rank": rank}}
for name, (spec, ip, nl, li, dbl, unknown) in ns["CASES"].items():
    plan = plan_of(spec, ip, dbl)
    res = plan.solve(dict(ns["inputs_of"](spec)[1]), nIterations=nl, lIterations=li)
    if rank == 0:
        np.save(f"{{out_dir}}/{{name}}.npy", res.unknowns[unknown].numpy())
    out[name] = record(plan, res)
    if name in ("laplacian_f64", "sfs_composed"):
        out[name]["report"] = plan.dump_hlo(dict(ns["inputs_of"](spec)[1]))
# a timed mesh solve against the untimed one
for spec in ns["TIMED"]:
    inputs = ns["inputs_of"](spec)[1]
    got = {{}}
    for timed in (False, True):
        plan = plan_of(spec, ns["PINNED"], collect_per_kernel_timing=timed)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = plan.solve(dict(inputs), nIterations=2, lIterations=10)
        got["timed" if timed else "untimed"] = record(plan, res)
    got["printed"] = buf.getvalue()
    got["rows"] = {{k: [v.count, v.total_ms] for k, v in plan._timing_phases.items()}}
    got["instances"] = plan._timing_instances
    got["stats"] = plan.solver.cg_stats
    out["timed_" + spec] = got
# the probed Jacobi diagonal of a graph mesh in float64, gathered
for spec in ns["DIAG"]:
    plan = plan_of(spec, ns["PINNED"], True)
    u, c, g, p = plan._normalize_and_place(dict(ns["inputs_of"](spec)[1]))
    fs = plan.solver._fs(c, g, p)
    diag = {{k: plan.rules.gather(v, k) for k, v in fs.jtj_diag(u).items()}}
    if rank == 0:
        np.savez(f"{{out_dir}}/diag_{{spec}}.npz", **{{k: v.numpy() for k, v in diag.items()}})


# what is left of item 8e, and the port-only helpers
def alias_at_slot(S):
    N = S.Dim("N")
    X = S.Unknown("X", 1, (N,))
    Xa = S.Array("Xa", 1, (N,), alias="X")
    G = S.Graph("G", a=(N,), b=(N,))
    S.Energy(X(G.a) - X(G.b), 0.1 * (X(G.a) - Xa(G.b)))


lap_in = ns["inputs_of"]("laplacian")[1]
arap_dims, arap_in = ns["inputs_of"]("arap")
lap = plan_of("laplacian", ns["PINNED"])
batch = {{"X": np.stack([lap_in["X"]] * 2), "A": lap_in["A"]}}
calls = {{
    "solve_batched": lambda: lap.solve_batched(batch),
    "solve_scheduled": lambda: lap.solve_scheduled(dict(lap_in), lambda consts, i: consts, 2),
    "dump_jacobian": lambda: lap.dump_jacobian(dict(lap_in)),
    "use_explicit_jtj": lambda: plan_of("laplacian", ns["PINNED"], use_explicit_jtj=True),
    "dynamic_topology": lambda: plan_of("arap", ns["PINNED"], dynamic_topology=True),
    "alias_at_slot": lambda: ot.Problem(alias_at_slot).plan(dims={{"N": 16}}, mesh=mesh,
                                                             device="cpu"),
    "cg_inputs": lambda: lap.cg_inputs(dict(lap_in)),
    "batched_cg_inputs": lambda: lap.batched_cg_inputs(batch),
}}
for name, call in calls.items():
    try:
        call()
        out["refuse_" + name] = ["ran", ""]
    except Exception as e:
        out["refuse_" + name] = [type(e).__name__, str(e)]
with open(f"{{out_dir}}/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
'''

# The JAX package's 2x2 mesh solves of the cases of one precision, in a
# process of their own
JAX_MESH = r'''
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import opt_tpu as ot
from opt_tpu.parallel.mesh import make_mesh

shared, out, precision = sys.argv[2:5]
f64 = precision == "float64"
if f64:
    ot.enable_double_precision()
ns = {}
exec(open(shared).read(), ns)
mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
specs = ns["specs"](ot)
got = {}
for name, (spec, ip, nl, li, dbl, unknown) in ns["CASES"].items():
    if dbl != f64:
        continue
    dims, inputs = ns["inputs_of"](spec)
    res = ot.Problem(specs[spec]).plan(
        dims=dims, mesh=mesh, double_precision=dbl,
        init_params=ot.InitializationParameters(validate_fused_jtj=False, **ip),
    ).solve(inputs, nIterations=nl, lIterations=li)
    got[name + "__costs"] = np.asarray(res.costs, np.float64)
    got[name + "__lin"] = np.int64(res.num_linear_iterations)
    got[name + "__X"] = np.asarray(res.unknowns[unknown])
np.savez(out, **got)
'''


def shared():
    ns = {}
    exec(SHARED, ns)
    return ns


sys.path.insert(0, REPO)  # chip_smoke, which SHARED imports
NS = shared()
CASES = NS["CASES"]
F32 = [k for k, c in CASES.items() if not c[4]]
F64 = [k for k, c in CASES.items() if c[4]]
F64_RTOL, F64_ATOL = 1e-9, 1e-9
FIRST_STEPS_RTOL = 1e-4


def run_world(tmp_path):
    """The gloo world of WORLD CPU ranks running WORKER, and the JAX
    package's mesh solves in two processes meanwhile: (the JAX results by
    case, the ranks' results by rank, the directory of rank 0's arrays)."""
    out_dir = tmp_path / "world"
    out_dir.mkdir()
    (out_dir / "shared.py").write_text(SHARED)
    script = out_dir / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(out_dir / "store"), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(WORLD)]
    jax_out = {p: tmp_path / f"jax_{p}.npz" for p in ("float32", "float64")}
    procs += [subprocess.Popen([sys.executable, "-c", JAX_MESH, REPO, str(out_dir / "shared.py"),
                                str(f), p], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               env=env, text=True)
              for p, f in jax_out.items()]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    got = {**np.load(jax_out["float32"]), **np.load(jax_out["float64"])}
    jax_res = {name: (list(got[name + "__costs"]), int(got[name + "__lin"]), got[name + "__X"])
               for name in CASES}
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return jax_res, ranks, out_dir


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_res, ranks, out_dir = run_world(tmp_path_factory.mktemp("sharding_options"))
    return {"jax": jax_res, "ranks": ranks, "dir": out_dir}


_SINGLE = {}


def port_single(name):
    """The port's solve of a case on one device (the CPU): (costs after
    each step, CG count, the compared unknown)."""
    if name not in _SINGLE:
        spec, ip, nl, li, dbl, unknown = CASES[name]
        dims, inputs = NS["inputs_of"](spec)
        res = ott.Problem(NS["specs"](ott)[spec]).plan(
            dims=dims, device="cpu", double_precision=dbl,
            init_params=ott.InitializationParameters(**ip),
        ).solve(inputs, nIterations=nl, lIterations=li)
        _SINGLE[name] = (res.costs, res.num_linear_iterations, res.unknowns[unknown].numpy())
    return _SINGLE[name]


def _held(world, name, costs, lin, X):
    got = world["ranks"][0][name]
    assert got["lin"] == lin, (got["lin"], lin)
    if CASES[name][4]:
        assert np.allclose(got["costs"], costs, rtol=F64_RTOL, atol=0), (got["costs"], costs)
        got_X = np.load(world["dir"] / f"{name}.npy")
        assert got_X.shape == X.shape and got_X.dtype == np.float64
        assert np.abs(got_X - X).max() <= F64_ATOL, np.abs(got_X - X).max()
    else:
        assert np.allclose(got["costs"], costs, rtol=FIRST_STEPS_RTOL, atol=0), (
            got["costs"], costs)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_solve_matches_single_rank(world, name):
    """The port's 2x2 mesh solve against its own single-rank solve under
    the same settings: float64 at 1e-9 (costs and the unknown), float32's
    costs after each step at 1e-4; equal CG counts."""
    _held(world, name, *port_single(name))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_solve_matches_jax_mesh_solve(world, name):
    """The port's 2x2 mesh solve against the JAX package's 2x2 mesh solve
    under the same settings (the composed operator's for the composed
    cases), at the same tolerances; equal CG counts."""
    _held(world, name, *world["jax"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_ran_its_loop_and_agrees(world, name):
    """Every rank ran the loop of its case at every step with no fallback
    and no kernel (the CPU's twin): a grid's sharded loop, a graph's owner
    blocks' loop, or under the composed operator the sharded composed loop;
    a float64 plan in float64; every rank's costs, counts and unknowns
    equal rank 0's bit for bit."""
    spec, ip, nl, _li, dbl, _u = CASES[name]
    want = ("sharded composed loop" if not ip.get("use_fused_jtj", True)
            else "sharded graph loop" if spec in ("robust", "arap") else "sharded loop")
    first = world["ranks"][0][name]
    for r in world["ranks"]:
        got = r[name]
        assert got["fallback"] is None and got["loops"] == [want] * nl
        assert not any(got["kernel"])
        assert got["dtype"] == ("torch.float64" if dbl else "torch.float32")
        assert (got["costs"], got["lin"], got["digest"]) == (first["costs"], first["lin"],
                                                              first["digest"])


def test_plan_report_names_the_float64_instance_and_the_composed_loop(world):
    """Plan.dump_hlo on a mesh: a float64 grid plan's path is the sharded
    loop, its instance K5's float64 one; a composed plan's path is the
    sharded composed loop, with no instance."""
    f64 = world["ranks"][0]["laplacian_f64"]["report"]
    assert "path: sharded loop" in f64 and "instance: tile_apply_kernel<double>" in f64, f64
    assert "dtype: float64" in f64 and "field_dtype: float64" in f64, f64
    composed = world["ranks"][0]["sfs_composed"]["report"]
    assert "path: sharded composed loop" in composed and "instance: None" in composed, composed


@pytest.mark.parametrize("spec", NS["DIAG"])
def test_probed_graph_diagonal_matches_the_single_device(world, spec):
    """FunctionSet.jtj_diag on a graph mesh (the composed operator's
    preconditioner: each graph slot's per-edge squares sent back to their
    owners by one reverse exchange), gathered, against the single device's
    in float64 at 1e-6 of its largest entry."""
    dims, inputs = NS["inputs_of"](spec)
    plan = ott.Problem(NS["specs"](ott)[spec]).plan(
        dims=dims, device="cpu", double_precision=True,
        init_params=ott.InitializationParameters(**NS["PINNED"]))
    u, c, g, p = plan._normalize_and_place(dict(inputs))
    want = plan.solver._fs(c, g, p).jtj_diag(u)
    got = np.load(world["dir"] / f"diag_{spec}.npz")
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        v = v.numpy()
        assert got[k].shape == v.shape and np.abs(v).max() > 0
        assert np.abs(got[k] - v).max() <= 1e-6 * np.abs(v).max(), k


@pytest.mark.parametrize("spec", NS["TIMED"])
def test_timed_mesh_solve_is_the_untimed_one(world, spec):
    """collect_per_kernel_timing on a mesh: every rank's solve equals its
    untimed solve bit for bit and keeps its rows (PCGStep1 counting the CG
    iterations; the tile apply an apply, two halo phases an apply on a
    grid; an all_to_all an apply on a graph; the all_reduces), which are
    never negative and add up to the solve; rank 0 alone prints the
    reference's table and its TIMING and Per-iter lines."""
    for r in world["ranks"]:
        got = r["timed_" + spec]
        timed, untimed = got["timed"], got["untimed"]
        assert (timed["costs"], timed["lin"], timed["digest"]) == (
            untimed["costs"], untimed["lin"], untimed["digest"])
        rows = got["rows"]
        assert rows["PCGStep1"][0] == timed["lin"]
        assert all(ms >= 0.0 for _c, ms in rows.values()), rows
        parts = sum(ms for k, (_c, ms) in rows.items() if k not in ("other", "overall"))
        assert parts <= rows["overall"][1] * (1 + 1e-9)
        applies = sum(st["applies"] for st in got["stats"])
        cg_reduces = sum(st["all_reduce"] for st in got["stats"])
        assert rows["allReduce"][0] >= cg_reduces > 0
        if spec == "laplacian":
            assert rows["tileApply"][0] == applies
            assert rows["haloExchange"][0] >= 2 * applies
            assert got["instances"] == {"sharded loop": 2}
        else:
            assert rows["allToAll"][0] >= applies and "tileApply" not in rows
            assert got["instances"] == {"sharded graph loop": 2}
        printed = got["printed"]
        if r["rank"] == 0:
            assert "TIMING " in printed and "Per-iter times ms" in printed, printed
            assert "haloExchange" in printed or "allToAll" in printed, printed
        else:
            assert printed == ""


@pytest.mark.parametrize("call", ["solve_batched", "solve_scheduled", "dump_jacobian",
                                  "use_explicit_jtj", "dynamic_topology", "alias_at_slot"])
def test_what_is_left_of_item_8e_raises(world, call):
    """solve_batched, solve_scheduled and dump_jacobian on a mesh,
    use_explicit_jtj and dynamic_topology=True on a mesh, and an alias
    image read at a graph slot on a graph mesh raise, naming ROADMAP.md
    item 8e."""
    for r in world["ranks"]:
        kind, msg = r["refuse_" + call]
        assert kind == "NotImplementedError" and "item 8e" in msg, (kind, msg)


@pytest.mark.parametrize("call", ["cg_inputs", "batched_cg_inputs"])
def test_port_only_helpers_raise_on_a_mesh(world, call):
    """cg_inputs and batched_cg_inputs have no counterpart in the JAX
    package (the port's own single-device test surface): on a mesh they
    raise, naming no roadmap item."""
    for r in world["ranks"]:
        kind, msg = r["refuse_" + call]
        assert kind == "NotImplementedError" and "port-only" in msg and "item" not in msg, (
            kind, msg)
