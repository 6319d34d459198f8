"""The port's sharded solve of 3-D grids and of graph specs over several
vertex spaces (opt_tpu_torch/parallel/mesh.py, ops/sharded_cg.py) held to
the JAX package's mesh solve and to the port's own single-rank solve.

* 3-D tiles: volumetric_mesh_deformation at 8x8x4 on a 2x2 mesh, split
  along its first two axes (tiles of 4x4x4, a halo of one along each
  split axis, the third axis whole): GN and LM, the standard loop with
  Jacobi ("pinned"), the mesh's auto policy (Chronopoulos-Gear and
  block-Jacobi) and the standard loop with block-Jacobi. The JAX package
  runs XLA's loop there: its sharded kernel takes 2-D tiles only.
* several vertex spaces: tests/test_torch_cross_space.py's two-space toy
  (X on N = 64, Y on U = 8; and U = 3, where the fourth rank owns no vertex
  of U), chip_smoke.py's ARAP with rotation clusters at 16x16 with 4x4
  clusters (Offset on N, Angle on P), and a split image read at a slot
  that points into another split space.

Each case is held three ways: against the JAX package's 2x2 mesh solve
under the same settings, against the port's single-rank solve (the auto
policy's against the single rank's Chronopoulos-Gear and block-Jacobi),
and rank against rank (bit for bit). The tolerances are those of
tests/test_torch_sharding.py's cases: the pinned ones (1e-4 on the cost
and the unknowns) as its poisson, radius-2 and pinned arap cases, the
block-Jacobi and auto ones (1e-3) as its image_warping and arap_auto
cases. U = 3's Y is held in float64 instead (F64_LEGS): the float32 Ys of
every solve land 1.4e-4 to 2.7e-4 from the float64 Y, past 1e-4, while in
float64 the packages and the mesh agree to 1e-12; each float32 Y is then
held to the float64 one by the float32 reach of its capped solve
(tests/float32_limits.py::capped_cg_reach). Also checked: the 3-D region's halo exchange against slicing the
global tensor, the 3-D tile apply against the whole-grid apply, the
exchange widths M against a count from the global tables, one all_to_all
a CG apply, the plan report, a 3-D checkpoint, and the three mesh
refusals left under ROADMAP.md item 8c.

The port's ranks are one gloo world of four CPU processes started once for
the module; the JAX side runs meanwhile: the grid cases in this process on
four of tests/conftest.py's eight virtual CPU devices, the graph cases in
a process of their own.
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
from opt_tpu_torch.parallel import mesh as port_mesh
from opt_tpu_torch.parallel.mesh import ShardingRules
from tests.float32_limits import capped_cg_reach, jacobi_condition

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

# The specs, inputs and cases both sides build (the ranks import neither
# JAX nor opt_tpu)
SHARED = r'''
import numpy as np

f32 = np.float32


def specs(ot):
    """The cases' specs, written against either package (``ot``)."""
    import importlib

    from chip_smoke import cluster_arap_spec

    def two_space(S):  # tests/test_torch_cross_space.py::two_space_spec
        N, U = S.Dim("N"), S.Dim("U")
        X = S.Unknown("X", 2, (N,))
        Y = S.Unknown("Y", 1, (U,))
        T = S.Array("T", 2, (N,))
        A = S.Array("A", 2, (N,))
        G = S.Graph("G", a0=(N,), a1=(N,), b=(U,))
        S.Energy(0.5 * (X(0) - A(0)))
        S.Energy((X(G.a0) - X(G.a1)) - Y(G.b) * (T(G.a0) - T(G.a1)))

    def split_read(S):
        # W lies on M, which slot c splits into owner blocks, and is read
        # at slot a too, which points into N
        N, M = S.Dim("N"), S.Dim("M")
        X = S.Unknown("X", 1, (N,))
        W = S.Array("W", 1, (M,))
        G = S.Graph("G", a=(N,), b=(N,), c=(M,))
        S.Energy(X(G.a) - X(G.b), 0.3 * (X(G.a) - W(G.a)), 0.2 * (X(G.b) - W(G.c)))

    models = importlib.import_module(ot.__name__ + ".models.specs")
    return {"volumetric": models.volumetric_mesh_deformation, "two_space": two_space,
            "cluster": cluster_arap_spec(ot), "split_read": split_read}


def case_inputs(name):
    """(dims, inputs) of a case's spec."""
    if name == "volumetric":
        from chip_smoke import volumetric_inputs

        return {"W": 8, "H": 8, "D": 4}, volumetric_inputs((8, 8, 4))
    if name.startswith("two_space"):  # tests/test_torch_cross_space.py::two_space_inputs
        N, U, E = 64, (3 if name == "two_space_u3" else 8), 160
        rng = np.random.RandomState(0)
        a0 = rng.randint(0, N, E)
        return {"N": N, "U": U}, {
            "X": rng.rand(N, 2).astype(f32), "Y": (1.0 + 0.1 * rng.rand(U, 1)).astype(f32),
            "T": rng.rand(N, 2).astype(f32), "A": rng.rand(N, 2).astype(f32),
            "G": {"a0": a0.astype(np.int32),
                  "a1": ((a0 + rng.randint(1, N, E)) % N).astype(np.int32),
                  "b": rng.randint(0, U, E).astype(np.int32)}}
    if name == "cluster":
        from chip_smoke import cluster_arap_inputs

        return cluster_arap_inputs(16, 4)
    if name == "split_read":
        rng = np.random.RandomState(0)
        a = np.arange(64, dtype=np.int32)
        return {"N": 64, "M": 128}, {
            "X": rng.rand(64, 1).astype(f32), "W": rng.rand(128, 1).astype(f32),
            "G": {"a": a, "b": ((a + 1) % 64).astype(np.int32),
                  "c": rng.randint(0, 128, 64).astype(np.int32)}}
    raise KeyError(name)


PINNED = {"cg_variant": "standard", "preconditioner": "jacobi", "edge_reorder": False}
CS_BJ = {"cg_variant": "chronopoulos_gear", "preconditioner": "block_jacobi",
         "edge_reorder": False}
BJ = {"cg_variant": "standard", "preconditioner": "block_jacobi", "edge_reorder": False}
PINNED_TOL, AUTO_TOL = (1e-4, 1e-4), (1e-3, 1e-3)
# name: spec, kind, mesh init parameters, the single-rank equivalent,
# nonlinear x CG iterations, extra solver parameters, (cost rtol, unknowns
# atol), the unknown compared. LM's zeta exit is decided by a difference of
# two sums (ROADMAP.md queue 3): the LM cases put q_tolerance where zeta
# crosses it by a wide margin.
LM_Q = {"q_tolerance": 1e-2}
CASES = {
    "vol_gn_pinned": ("volumetric", "gaussNewtonGPU", PINNED, PINNED, 2, 10, {}, PINNED_TOL,
                      "Offset"),
    "vol_gn_auto": ("volumetric", "gaussNewtonGPU", {}, CS_BJ, 2, 10, {}, AUTO_TOL, "Offset"),
    "vol_gn_bj": ("volumetric", "gaussNewtonGPU", BJ, BJ, 2, 10, {}, AUTO_TOL, "Offset"),
    "vol_lm_pinned": ("volumetric", "LMGPU", PINNED, PINNED, 2, 10, LM_Q, PINNED_TOL, "Offset"),
    "vol_lm_auto": ("volumetric", "LMGPU", {}, CS_BJ, 2, 10, LM_Q, AUTO_TOL, "Offset"),
    "two_space": ("two_space", "gaussNewtonGPU", PINNED, PINNED, 2, 10, {}, PINNED_TOL, "Y"),
    "two_space_auto": ("two_space", "gaussNewtonGPU", {}, dict(CS_BJ, edge_reorder=False), 2,
                       10, {}, AUTO_TOL, "Y"),
    "two_space_lm": ("two_space", "LMGPU", PINNED, PINNED, 2, 10, LM_Q, PINNED_TOL, "Y"),
    "two_space_u3": ("two_space", "gaussNewtonGPU", PINNED, PINNED, 2, 10, {}, PINNED_TOL, "Y"),
    "cluster": ("cluster", "gaussNewtonGPU", PINNED, PINNED, 2, 10, {}, PINNED_TOL, "Angle"),
    "split_read": ("split_read", "gaussNewtonGPU", PINNED, PINNED, 2, 10, {}, PINNED_TOL, "X"),
}


# the cases also solved in float64, whose float32 unknowns are held to the
# float64 ones by the float32 reach (test_mesh_solve_matches_jax_mesh_solve)
F64_LEGS = ("two_space_u3",)


def inputs_of(case):
    spec = CASES[case][0]
    return case_inputs(case if case == "two_space_u3" else spec)
'''

WORKER = r'''
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import opt_tpu_torch as ot
from opt_tpu_torch.parallel import initialize, make_mesh
from opt_tpu_torch.parallel.mesh import ShardingRules
from opt_tpu_torch.utils import checkpoint

rank, world, store, out_dir = sys.argv[1:5]
rank, world = int(rank), int(world)
ns = {{}}
exec(open(out_dir + "/shared.py").read(), ns)
initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
mesh = make_mesh(device="cpu")
specs = ns["specs"](ot)
out = {{"rank": rank, "coords": list(mesh.coords)}}
for name, (spec, kind, ip, _single, nl, li, extra, _tol, unknown) in ns["CASES"].items():
    dims, inputs = ns["inputs_of"](name)
    plan = ot.Problem(specs[spec], kind=kind).plan(
        dims=dims, mesh=mesh, device="cpu", init_params=ot.InitializationParameters(**ip))
    mesh.reset_counts()
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li, **extra)
    counts = dict(mesh.counts)
    if rank == 0:
        np.save(f"{{out_dir}}/{{name}}.npy", res.unknowns[unknown].numpy())
    got = {{"cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
           "steps": res.num_iterations, "fallback": res.fused_fallback,
           "stats": plan.solver.cg_stats, "counts": counts,
           "unknowns": len(res.unknowns), "shape": list(res.unknowns[unknown].shape),
           "ip": [plan.solver.ip.cg_variant, plan.solver.ip.preconditioner]}}
    if plan.rules.kind == "grid":
        got["tile"] = [list(t) for t in plan.rules.tile]
    else:
        graphs = plan._normalize_and_place(dict(inputs))[2]
        got["M"] = {{g: {{
            "slot": {{s: t["M"] for s, t in gd["__slot_halo__"].items()}},
            "split": {{"@".join(k): t["M"] for k, t in gd["__split_read__"].items()}},
            "inc": {{k: t["inc_M"] for k, t in gd["__groups__"].items()}},
            "cross": {{k: t["x_M"] for k, t in gd["__groups__"].items()}},
            "coupling_blocks": {{k: t["M"] for k, t in gd.get("__ell__", {{"inc": {{}}}})["inc"].items()}},
            "coupling_reads": {{"|".join(k): t["M"] for k, t in
                               gd.get("__ell__", {{"ell": {{}}}})["ell"].items()}}}}
            for g, gd in graphs.items()}}
        got["blocks"] = {{repr(isp): list(plan.rules.block(isp)) for isp in plan.rules.spaces}}
    if name in ("vol_gn_pinned", "cluster"):
        got["report"] = plan.dump_hlo(dict(inputs))
    if name == "vol_gn_pinned":
        # a checkpoint of the 3-D solve restored into a fresh plan: the tiles
        # back, every global unknown equal
        ck = checkpoint.save(f"{{out_dir}}/ck_{{name}}", plan)
        fresh = ot.Problem(specs[spec], kind=kind).plan(
            dims=dims, mesh=mesh, device="cpu", init_params=ot.InitializationParameters(**ip))
        checkpoint.restore(ck, fresh, inputs=dict(inputs))
        got["restored"] = all(torch.equal(fresh.unknowns[k], v) for k, v in res.unknowns.items())
    out[name] = got
for name in ns["F64_LEGS"]:
    spec, kind, ip, _single, nl, li, extra, _tol, unknown = ns["CASES"][name]
    dims, inputs = ns["inputs_of"](name)
    plan = ot.Problem(specs[spec], kind=kind).plan(
        dims=dims, mesh=mesh, device="cpu", double_precision=True,
        init_params=ot.InitializationParameters(**ip))
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li, **extra)
    if rank == 0:
        np.save(f"{{out_dir}}/{{name}}_f64.npy", res.unknowns[unknown].numpy())
    out[name + "_f64"] = {{"cost": res.final_cost, "lin": res.num_linear_iterations,
                          "fallback": res.fused_fallback,
                          "loops": [st["loop"] for st in plan.solver.cg_stats],
                          "dtype": str(res.unknowns[unknown].dtype)}}
# the 3-D halo: a 3-channel 9x8x5 tile extended by one row and two columns
g = torch.as_tensor(np.random.RandomState(7).rand(3, 9, 8, 5).astype("f4"))
rules = ShardingRules(mesh, (9, 8, 5), (1, 2))
(r0, r1), (c0, c1) = rules.tile
ext = mesh.extend(mesh.extend(g[:, r0:r1, c0:c1], 1, 0), 2, 1)
pad = torch.nn.functional.pad(g, (0, 0, 2, 2, 1, 1))
out["halo_zeros"] = torch.equal(ext, pad[:, r0:r1 + 2, c0:c1 + 4])
hwc = g.movedim(0, -1)
reg = rules.extend_region({{"a": hwc[r0:r1, c0:c1, :, :1], "b": hwc[r0:r1, c0:c1, :, 1:]}})
out["halo_clip"] = torch.equal(torch.cat([reg["a"], reg["b"]], -1), rules.local(hwc))
out["gathered"] = torch.equal(rules.gather(rules.local(hwc)), hwc)
# what a mesh still refuses under item 8c
def grid_and_graph(S):
    W, H, N = S.Dim("W"), S.Dim("H"), S.Dim("N")
    X = S.Unknown("X", 1, (W, H))
    Y = S.Unknown("Y", 1, (N,))
    G = S.Graph("G", a=(N,), b=(N,))
    S.Energy(X(0, 0) - X(1, 0))
    S.Energy(Y(G.a) - Y(G.b))
def vertex_stencil(S):
    N = S.Dim("N")
    X = S.Unknown("X", 1, (N,))
    G = S.Graph("G", a=(N,), b=(N,))
    S.Energy(X(G.a) - X(G.b), X(0) - X(1))
def two_grids(S):
    W, H, V = S.Dim("W"), S.Dim("H"), S.Dim("V")
    X = S.Unknown("X", 1, (W, H))
    Y = S.Unknown("Y", 1, (W, V))
    S.Energy(X(0, 0) - X(1, 0))
    S.Energy(Y(0, 0) - Y(0, 1))
refusals = {{"grid_and_graph": (grid_and_graph, {{"W": 8, "H": 8, "N": 16}}),
             "vertex_stencil": (vertex_stencil, {{"N": 16}}),
             "two_grids": (two_grids, {{"W": 8, "H": 8, "V": 8}})}}
for name, (spec, dims) in refusals.items():
    try:
        ot.Problem(spec).plan(dims=dims, mesh=mesh, device="cpu")
        out["refuse_" + name] = ["planned", ""]
    except Exception as e:
        out["refuse_" + name] = [type(e).__name__, str(e)]
with open(f"{{out_dir}}/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
'''

# The JAX package's 2x2 mesh solves of the graph cases, in a process of
# their own beside the grid cases in this process: each on XLA's loop, its
# assembled operator taken as it is (validate_fused_jtj=False: the port
# validates its own)
JAX_GRAPH = r'''
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
if f64:  # process-global: the float64 legs run in a process of their own
    ot.enable_double_precision()
ns = {}
exec(open(shared).read(), ns)
mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
specs = ns["specs"](ot)
got = {}
for name, (spec, kind, ip, _single, nl, li, extra, _tol, unknown) in ns["CASES"].items():
    if spec == "volumetric" or (f64 and name not in ns["F64_LEGS"]):
        continue
    dims, inputs = ns["inputs_of"](name)
    res = ot.Problem(specs[spec], kind=kind).plan(
        dims=dims, mesh=mesh, double_precision=f64,
        init_params=ot.InitializationParameters(validate_fused_jtj=False, **ip),
    ).solve(inputs, nIterations=nl, lIterations=li, **extra)
    name = name + "_f64" if f64 else name
    got[name + "__cost"] = np.float64(res.final_cost)
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
GRID = [k for k, c in CASES.items() if c[0] == "volumetric"]
GRAPH = [k for k in CASES if k not in GRID]


def jax_mesh_solves(tmp_path):
    """The JAX package's 2x2 mesh solve of every case: the grid cases here
    (the tile kernel declines a 3-D grid, so XLA's loop runs), the graph
    cases in a process of their own (JAX_GRAPH), the float64 legs in
    another."""
    import jax

    (tmp_path / "shared.py").write_text(SHARED)
    out_files = {p: tmp_path / f"jax_graph_{p}.npz" for p in ("float32", "float64")}
    procs = {p: subprocess.Popen(
        [sys.executable, "-c", JAX_GRAPH, REPO, str(tmp_path / "shared.py"), str(f), p],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p, f in out_files.items()}
    try:
        mesh = jax_make_mesh(jax.devices()[:WORLD], shape=(2, 2))
        specs = NS["specs"](ot)
        out = {}
        for name in GRID:
            spec, kind, ip, _single, nl, li, extra, _tol, unknown = CASES[name]
            dims, inputs = NS["inputs_of"](name)
            res = ot.Problem(specs[spec], kind=kind).plan(
                dims=dims, mesh=mesh,
                init_params=ot.InitializationParameters(use_pallas_cg="interpret", **ip),
            ).solve(inputs, nIterations=nl, lIterations=li, **extra)
            out[name] = (res.final_cost, res.num_linear_iterations,
                         np.asarray(res.unknowns[unknown]))
        logs = {p: proc.communicate(timeout=900)[0] for p, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    for p, proc in procs.items():
        assert proc.returncode == 0, logs[p][-4000:]
    got = {**np.load(out_files["float32"]), **np.load(out_files["float64"])}
    for name in GRAPH + [n + "_f64" for n in NS["F64_LEGS"]]:
        out[name] = (float(got[name + "__cost"]), int(got[name + "__lin"]), got[name + "__X"])
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
    tmp = tmp_path_factory.mktemp("sharding_spaces")
    jax_res, ranks, out_dir = run_world(tmp, lambda: jax_mesh_solves(tmp))
    return {"jax": jax_res, "ranks": ranks, "dir": out_dir}


_SINGLE = {}


def port_single(name, double_precision=False, l_iterations=None):
    """The port's solve of a case on one device (the CPU), with the case's
    single-rank variants, in float32 or float64, at the case's CG
    iterations a step or ``l_iterations``: (final cost, CG count, the
    compared unknown, the move of every unknown from the inputs)."""
    key = (name, double_precision, l_iterations)
    if key not in _SINGLE:
        spec, kind, _ip, single, nl, li, extra, _tol, unknown = CASES[name]
        dims, inputs = NS["inputs_of"](name)
        res = ott.Problem(NS["specs"](ott)[spec], kind=kind).plan(
            dims=dims, device="cpu", double_precision=double_precision,
            init_params=ott.InitializationParameters(**single),
        ).solve(inputs, nIterations=nl, lIterations=l_iterations or li, **extra)
        move = max(float(np.abs(v.numpy() - inputs[k]).max()) for k, v in res.unknowns.items())
        _SINGLE[key] = (res.final_cost, res.num_linear_iterations,
                        res.unknowns[unknown].numpy(), move)
    return _SINGLE[key][:3]


def _held(name, got_cost, got_X, cost, X):
    rtol, atol = CASES[name][7]
    assert np.isclose(got_cost, cost, rtol=rtol), (got_cost, cost)
    assert got_X.shape == X.shape
    assert np.abs(got_X - X).max() <= atol, np.abs(got_X - X).max()


F64_RTOL, F64_ATOL = 1e-9, 1e-9  # a float64 solve against another (5e-13 apart)


def _f64_held(got, got_X, cost, lin, X):
    assert got["lin"] == lin, (got["lin"], lin)
    assert np.isclose(got["cost"], cost, rtol=F64_RTOL), (got["cost"], cost)
    assert got_X.shape == X.shape and got_X.dtype == np.float64
    assert np.abs(got_X - X).max() <= F64_ATOL, np.abs(got_X - X).max()


def float32_reach(name):
    """The float32 reach of a float64 leg's unknown: the capped solve's
    (tests/float32_limits.py::capped_cg_reach) from the port's float64
    single-rank solves at the case's CG iterations a step and one fewer,
    and the Jacobi-scaled condition number of its float64 Jacobian at the
    inputs."""
    spec, kind, _ip, single, nl, li, _extra, _tol, _unknown = CASES[name]
    dims, inputs = NS["inputs_of"](name)
    plan = ott.Problem(NS["specs"](ott)[spec], kind=kind).plan(
        dims=dims, device="cpu", double_precision=True,
        init_params=ott.InitializationParameters(**single))
    kappa = jacobi_condition(plan.dump_jacobian(dict(inputs), dense=True))
    _c, lin, X64 = port_single(name, True)
    move = _SINGLE[(name, True, None)][3]
    fewer = port_single(name, True, li - 1)[2]
    return capped_cg_reach(lin, kappa, move, float(np.abs(X64 - fewer).max()))


def _f32_held(name, got_cost, got_X, cost, X64):
    """A float32 result of a float64 leg: the cost at the case's rtol, the
    unknown within the float32 reach of the float64 one."""
    rtol, _atol = CASES[name][7]
    assert np.isclose(got_cost, cost, rtol=rtol), (got_cost, cost)
    assert got_X.shape == X64.shape
    reach = float32_reach(name)
    assert np.abs(got_X - X64).max() <= reach, (np.abs(got_X - X64).max(), reach)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_solve_matches_jax_mesh_solve(world, name):
    """The port on a 2x2 gloo world against the JAX package on a 2x2
    device mesh, under the same settings: equal CG counts, the cost and
    the unknowns at the case's tolerances. A float64 leg (F64_LEGS): the
    float64 mesh solves at 1e-9 with equal CG counts, and each float32
    mesh solve's unknown (the port's, the JAX package's) within the float32
    reach of the port's float64 one, their costs at the case's rtol."""
    cost, lin, X = world["jax"][name]
    got = world["ranks"][0][name]
    assert got["lin"] == lin, (got["lin"], lin)
    got_X = np.load(world["dir"] / f"{name}.npy")
    if name not in NS["F64_LEGS"]:
        _held(name, got["cost"], got_X, cost, X)
        return
    f64, X64 = world["ranks"][0][name + "_f64"], np.load(world["dir"] / f"{name}_f64.npy")
    _f64_held(f64, X64, *world["jax"][name + "_f64"])
    for got_cost, got_X32 in ((got["cost"], got_X), (cost, X)):
        _f32_held(name, got_cost, got_X32, f64["cost"], X64)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_solve_matches_single_rank(world, name):
    """The port's mesh solve against its own single-rank solve with the
    mesh's resolved variants: equal CG counts, the cost and the unknowns at
    the case's tolerances. A float64 leg: the float64 mesh solve against
    the float64 single rank at 1e-9 with equal CG counts, and the float32
    mesh and single-rank unknowns within the float32 reach of the float64
    one."""
    cost, lin, X = port_single(name)
    got = world["ranks"][0][name]
    assert got["lin"] == lin, (got["lin"], lin)
    got_X = np.load(world["dir"] / f"{name}.npy")
    if name not in NS["F64_LEGS"]:
        _held(name, got["cost"], got_X, cost, X)
        return
    f64, X64 = world["ranks"][0][name + "_f64"], np.load(world["dir"] / f"{name}_f64.npy")
    assert f64["fallback"] is None and f64["dtype"] == "torch.float64"
    assert set(f64["loops"]) == {"sharded graph loop"}
    _f64_held(f64, X64, *port_single(name, True))
    for got_cost, got_X32 in ((got["cost"], got_X), (cost, X)):
        _f32_held(name, got_cost, got_X32, f64["cost"], X64)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_ran_the_sharded_loop_and_agrees(world, name):
    """Every rank ran the sharded loop at every step, with no fallback and
    no kernel (the 3-D tile's apply and the graph apply are plain PyTorch),
    and agrees with rank 0 bit for bit; the unknowns came back global. A 3-D
    apply takes the two halo phases of a 2-D one; a graph apply one
    all_to_all for every read of another rank's rows, of its groups and its
    couplings across spaces."""
    first = world["ranks"][0][name]
    vol = name in GRID
    tiles = set()
    for r in world["ranks"]:
        got = r[name]
        assert got["fallback"] is None
        assert len(got["stats"]) == got["steps"] >= 1
        assert (got["cost"], got["lin"], got["costs"]) == (first["cost"], first["lin"],
                                                           first["costs"])
        assert [st["iterations"] for st in got["stats"]] == [
            st["iterations"] for st in first["stats"]]
        for st in got["stats"]:
            assert st["kernel"] is False and st["applies"] >= st["iterations"]
            assert st["loop"] == ("sharded 3-D loop" if vol else "sharded graph loop")
            if vol:
                assert st["p2p_phases"] == 2 * st["applies"] and st["all_to_all"] == 0
            else:
                assert st["all_to_all"] == st["applies"] and st["p2p_phases"] == 0
        assert got["ip"] == [CASES[name][3]["cg_variant"], CASES[name][3]["preconditioner"]]
        if vol:
            tiles.add(tuple(map(tuple, got["tile"])))
        else:
            assert got["counts"]["all_gather"] == got["unknowns"]
    if vol:
        assert len(tiles) == WORLD and first["shape"] == [8, 8, 4, 3]


@pytest.mark.parametrize("mode", ["halo_zeros", "halo_clip", "gathered"])
def test_3d_halo_exchange_equals_slicing_the_global_tensor(world, mode):
    """On a 9x8x5 grid split 2x2 (an uneven split along the rows), extend
    along both split axes equals slicing the zero-padded global tensor,
    corners included, and the third axis whole ("zeros"), or the region of
    the global tensor ("clip"); the gather puts the tiles back together."""
    assert all(r[mode] for r in world["ranks"])


def test_3d_plan_report_and_checkpoint(world):
    """Plan.dump_hlo names the 3-D sharded loop (no kernel instance) and
    its tile, region and whole axis; a checkpoint of the 3-D solve restores
    on every rank."""
    report = world["ranks"][0]["vol_gn_pinned"]["report"]
    assert "path: sharded 3-D loop" in report and "instance: None" in report
    assert '"tile": [[0, 4], [0, 4]]' in report and '"whole": [4]' in report, report
    assert all(r["vol_gn_pinned"]["restored"] for r in world["ranks"])


def test_cluster_plan_report_names_the_couplings(world):
    report = world["ranks"][0]["cluster"]["report"]
    assert "path: sharded graph loop" in report and "couplings: 4" in report, report
    assert '"coupling_reads": {"r<-v0"' in report, report


def _ranks_M(cross, n, src, req):
    """The width M of an exchange, counted from the global table: the most
    distinct rows one rank needs from another."""
    cross = np.asarray(cross).reshape(len(cross), -1)
    best = 0
    for d, (r0, r1) in enumerate(req):
        ids = cross[r0:r1].ravel()
        ids = ids[ids < n]
        for s, (s0, s1) in enumerate(src):
            if s != d:
                best = max(best, len(np.unique(ids[(ids >= s0) & (ids < s1)])))
    return max(best, 1)


def test_exchange_widths(world):
    """The widths M of the several-space exchanges, on every rank, equal a
    count from the global tables: the two-space toy's per-edge reads at its
    U slot, its couplings' block gathers and p reads across N and U
    (graph_ops.ell_tables), the split read's exchange of W at slot a
    against M's blocks, and U = 3's empty block on the last rank."""
    from opt_tpu_torch.ops import graph_ops

    split = port_mesh.split_bounds
    _dims, inp = NS["inputs_of"]("two_space")
    G = inp["G"]
    E, N, U = len(G["a0"]), 64, 8
    eb, nb, ub = split(E, WORLD), split(N, WORLD), split(U, WORLD)
    inc, ell = graph_ops.ell_tables({k: G[k] for k in ("a0", "a1", "b")},
                                    {"a0": N, "a1": N, "b": U})
    want = {"slot": {"b": _ranks_M(G["b"][:, None], U, ub, eb)},
            "coupling_blocks": {k: _ranks_M(inc[k], E, eb, ub if k == "b" else nb)
                                for k in ("a0", "a1", "b")},
            "coupling_reads": {f"{ko}|{ki}": _ranks_M(ell[(ko, ki)], U if ki == "b" else N,
                                                      ub if ki == "b" else nb,
                                                      ub if ko == "b" else nb)
                               for (ko, ki) in ell if "b" in (ko, ki)}}
    _dims, sr = NS["inputs_of"]("split_read")
    want_split = _ranks_M(sr["G"]["a"][:, None], 128, split(128, WORLD), split(64, WORLD))
    for r in world["ranks"]:
        got = r["two_space"]["M"]["G"]
        assert got["slot"]["b"] == want["slot"]["b"]
        assert got["coupling_blocks"] == want["coupling_blocks"]
        assert got["coupling_reads"] == want["coupling_reads"]
        assert r["split_read"]["M"]["G"]["split"] == {"a@M": want_split}
        # U = 3 over four ranks: blocks of 1, 1, 1 and none
        _n_block, u_block = r["two_space_u3"]["blocks"].values()
        assert u_block == [[0, 1], [1, 2], [2, 3], [3, 3]][r["rank"]]


@pytest.mark.parametrize("spec", ["grid_and_graph", "vertex_stencil", "two_grids"])
def test_refusals_left_under_item_8c(world, spec):
    """A spec with both a grid and a graph, a 1-D image read at an offset
    (a stencil on a vertex space) and a grid spec over several grid index
    spaces still raise on a mesh, naming ROADMAP item 8c."""
    for r in world["ranks"]:
        kind, msg = r["refuse_" + spec]
        assert kind == "NotImplementedError" and "item 8c" in msg, (kind, msg)


# -- the 3-D tile apply against the whole-grid apply, in this process -------------


@pytest.mark.parametrize("ip", [{}, {"preconditioner": "block_jacobi"}])
def test_3d_tile_apply_equals_the_whole_grid_apply(ip):
    """tile_apply_reference on each 3-D tile of a 2x2 split of volumetric's 8x8x4
    operator (18 fields, 6 channels, offsets along all three axes), fed the
    tile of p extended from the zero-padded global p along the split axes,
    equals the whole grid's _stencil_apply cropped to the tile, exactly."""
    dims, inputs = NS["inputs_of"]("vol_gn_pinned")
    plan = ott.Problem(NS["specs"](ott)["volumetric"]).plan(
        dims=dims, device="cpu", init_params=ott.InitializationParameters(**ip))
    meta = plan.cg_inputs(dict(inputs))[0]
    F, triples = meta["F"], meta["triples"]
    assert F.dim() == 4 and meta["ctot"] == 6
    assert {d[2] for d, *_ in triples} == {-1, 0, 1}
    ah, aw = sharded_cg.halo_widths(triples)
    assert (ah, aw) == (1, 1)
    p = torch.as_tensor(np.random.RandomState(3).randn(6, 8, 8, 4).astype("f4"))
    whole = _stencil_apply(F.float(), triples, p)
    pad = tF.pad(p, (0, 0, aw, aw, ah, ah))
    for gx in range(2):
        for gy in range(2):
            rules = ShardingRules(types.SimpleNamespace(shape=(2, 2), coords=(gx, gy)),
                                  (8, 8, 4), (ah, aw))
            (r0, r1), (c0, c1) = rules.tile
            got = sharded_cg.tile_apply_reference(F[:, r0:r1, c0:c1].contiguous(), triples,
                                                  pad[:, r0:r1 + 2 * ah, c0:c1 + 2 * aw], ah, aw)
            assert torch.equal(got, whole[:, r0:r1, c0:c1])
