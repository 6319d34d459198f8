"""Driver entry points on the port: a one-step check and a multi-rank dry run.

PyTorch counterpart of ``__graft_entry__.py``. :func:`entry` returns one
Gauss-Newton nonlinear step of image_warping at 64x64 with its arguments;
:func:`dryrun_multichip` runs the sharded solves of the reference's dry run
on ``n_devices`` ranks of a ``torch.distributed`` gloo world (all of them on
the one card, or on the CPU when the caller asks for it). Both run on the
card unless ``device="cpu"`` is given, and raise where CUDA is missing.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

# how long the parent waits for the ranks' results
RANKS_TIMEOUT_S = 600.0
# the dry run's two grid solves: (name, init parameters)
GRID_CASES = (
    ("grid", {"cg_variant": "standard", "preconditioner": "block_jacobi"}),
    ("grid_cs_bj", {"cg_variant": "chronopoulos_gear", "preconditioner": "block_jacobi"}),
)


def _warp_inputs(n: int):
    rng = np.random.RandomState(0)
    f32 = np.float32
    ur = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1
    ).astype(f32)
    con = -np.ones((n, n, 2), f32)
    con[0, 0] = [1.0, 1.0]
    con[n // 2, n // 2] = [n / 2 + 1.0, n / 2 - 1.0]
    con[-1, -1] = [n - 2.0, n - 2.0]
    return {
        "Offset": ur + rng.rand(n, n, 2).astype(f32) * 0.1,
        "Angle": np.zeros((n, n), f32),
        "UrShape": ur,
        "Constraints": con,
        "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": np.sqrt(10.0).astype(f32),
        "w_regSqrt": np.sqrt(1.0).astype(f32),
    }


def entry(device=None):
    """(fn, example_args): one Gauss-Newton nonlinear step on the flagship
    model (image_warping — 2D ARAP with mixed float2+float unknowns, the
    reference's canonical nonlinear example) at 64x64 on ``device`` (the
    card unless ``"cpu"``). ``fn(*example_args)`` returns the solver state
    after the step: ``X``, ``prev_cost`` (the cost after it),
    ``lin_iters``."""
    import opt_tpu_torch as ot
    from opt_tpu_torch.models.specs import image_warping
    from opt_tpu_torch.solver.params import normalize_solver_params

    n = 64
    plan = ot.Problem(image_warping).plan(
        dims={"W": n, "H": n}, device="cuda" if device is None else device
    )
    unknowns, consts, graphs, params = plan.compiled.normalize_inputs(
        _warp_inputs(n), plan.device
    )
    sp = normalize_solver_params(plan.solver_params)
    state = plan.solver.init(unknowns, consts, graphs, params, sp)
    fn = plan.solver.step
    example_args = (state, consts, graphs, params, sp)
    return fn, example_args


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def dryrun_rank(n_devices: int, device=None) -> dict:
    """One rank's part of :func:`dryrun_multichip`, inside a process group
    of ``n_devices`` ranks: the solves sharded over the most-square mesh of
    the ranks, each checked. Returns {"grid", "grid_cs_bj", "graph"} (the
    grid names those of GRID_CASES): each solve's final cost and counts.

    Exercises the port's multi-rank shardings: 2-D spatial tiling of grid
    unknowns (halo exchange for the stencil JᵀJp, the per-tile apply K5 on
    the card, its plain twin on the CPU), owner blocks of graph vertices
    with the all_to_all exchange of other ranks' rows, all-reduced CG
    reductions."""
    import opt_tpu_torch as ot
    from opt_tpu_torch.models.specs import arap_mesh_deformation, image_warping
    from opt_tpu_torch.ops import sharded_cg
    from opt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    if mesh.size != n_devices:
        _fail(f"the process group has {mesh.size} ranks, not {n_devices}")
    a, b = mesh.shape
    kernel = mesh.device.type == "cuda"
    out = {}

    # grid problem: spatially tiled over (gx, gy), by the standard PCG
    # recurrence and by Chronopoulos-Gear (what "auto" takes on a mesh),
    # both under block-Jacobi: two sharded loops held to each other (with
    # scalar Jacobi the first solve's three CG steps land 5e-3 apart);
    # every CG apply of every step through the sharded loop, on the card
    # the tile kernel each time
    n = max(8 * a, 8 * b)
    for name, ip in GRID_CASES:
        plan = ot.Problem(image_warping).plan(
            dims={"W": n, "H": n}, mesh=mesh, device=mesh.device.type,
            init_params=ot.InitializationParameters(**ip))
        sharded_cg.reset_launch_counts()
        plan.solver.cg_stats.clear()
        res = plan.solve(_warp_inputs(n), nIterations=1, lIterations=3)
        stats = list(plan.solver.cg_stats)
        applies = sum(st["applies"] for st in stats)
        launches = sharded_cg.tile_apply_kernel.launches
        if not np.isfinite(res.final_cost):
            _fail(f"{name}: final cost {res.final_cost}")
        if (len(stats) != res.num_iterations or applies < 1
                or any(st["loop"] != "sharded loop" or st["kernel"] != kernel for st in stats)
                or launches != (applies if kernel else 0)):
            _fail(f"{name}: the sharded loop did not run every apply: {len(stats)} sharded CG "
                  f"calls for {res.num_iterations} steps, {applies} applies, {launches} tile "
                  f"kernel launches, loops {[(st['loop'], st['kernel']) for st in stats]}")
        out[name] = {"cost": res.final_cost, "lin": res.num_linear_iterations,
                     "steps": res.num_iterations, "applies": applies,
                     "tile_kernel_launches": launches, "fused_fallback": res.fused_fallback,
                     "variant": [plan.solver.ip.cg_variant, plan.solver.ip.preconditioner],
                     "x_digest": hashlib.sha256(b"".join(
                         v.cpu().numpy().tobytes() for _k, v in sorted(res.unknowns.items())
                     )).hexdigest()}
    if not np.allclose(out["grid_cs_bj"]["cost"], out["grid"]["cost"], rtol=1e-3):
        _fail(f"the two grid solves part: {out['grid_cs_bj']['cost']} and {out['grid']['cost']}")

    # graph problem: vertices in owner blocks over the flattened mesh
    N = 16 * n_devices
    rng = np.random.RandomState(1)
    f32 = np.float32
    pos = rng.rand(N, 3).astype(f32)
    con = -np.ones((N, 3), f32)
    con[0] = pos[0] + 0.25
    v0 = np.arange(N, dtype=np.int32)
    inputs = {
        "Offset": pos.copy(),
        "Angle": np.zeros((N, 3), f32),
        "UrShape": pos,
        "Constraints": con,
        "G": {"v0": v0, "v1": (v0 + 1) % N},
        "w_fitSqrt": np.sqrt(10.0).astype(f32),
        "w_regSqrt": np.sqrt(1.0).astype(f32),
    }
    plan_g = ot.Problem(arap_mesh_deformation).plan(
        dims={"N": N}, mesh=mesh, kind="LMGPU", device=mesh.device.type)
    # the exchange tables of the other ranks' rows must be built for the
    # cross-endpoint p reads (parallel/mesh.py halo_gather); the solve
    # below then runs the all_to_all exchange
    g = plan_g._normalize_and_place(dict(inputs))[2]["G"]
    if not g.get("__slot_halo__") or not g.get("__groups__"):
        _fail("halo tables missing")
    res_g = plan_g.solve(inputs, nIterations=1, lIterations=3)
    if not np.isfinite(res_g.final_cost):
        _fail(f"graph: final cost {res_g.final_cost}")
    out["graph"] = {"cost": res_g.final_cost, "lin": res_g.num_linear_iterations,
                    "steps": res_g.num_iterations, "fused_fallback": res_g.fused_fallback}
    return out


def _rank_main(rank: int, world: int, store: str, device, results, work) -> None:
    """A started rank: joins the gloo world through the file ``store``,
    runs ``work(world, device)`` and puts {rank, **its result} (or {rank,
    error}) on ``results``."""
    import torch.distributed as dist

    from opt_tpu_torch.parallel import initialize

    try:
        torch.set_num_threads(1)
        initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
        results.put({"rank": rank, **work(world, device)})
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(work, n_devices: int, device=None):
    """Start ``n_devices`` ranks by the spawn method, one gloo world over a
    file store in a new temporary directory, each running
    ``work(n_devices, device)`` (a module-level function). Returns the
    handle :func:`collect_ranks` takes."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="opt_tpu_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_devices, os.path.join(tmp, "store"), device, results, work),
                         daemon=True)
             for r in range(n_devices)]
    for proc in procs:
        proc.start()
    return procs, results, tmp


def collect_ranks(handle, timeout_s: float = RANKS_TIMEOUT_S) -> list:
    """The started ranks' results by rank. Raises when a rank raises, exits
    without a result or stays silent past ``timeout_s``; every rank is
    stopped and the store removed before it returns."""
    procs, results, tmp = handle
    got = {}
    try:
        deadline = time.monotonic() + timeout_s
        while len(got) < len(procs):
            try:
                msg = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]} and no "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{len(procs) - len(got)} rank(s) silent after "
                                       f"{timeout_s} s") from None
                continue
            if "error" in msg:
                raise RuntimeError(f"rank {msg['rank']} failed:\n{msg['error']}")
            got[msg["rank"]] = msg
    finally:
        for proc in procs:
            proc.join(timeout=30)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(len(procs))]


def run_ranks(work, n_devices: int, device=None, timeout_s: float = RANKS_TIMEOUT_S) -> list:
    """:func:`start_ranks` then :func:`collect_ranks`: the ranks' results."""
    return collect_ranks(start_ranks(work, n_devices, device), timeout_s)


def prepare_device(device) -> None:
    """Ready the dry run's device, the card unless ``device`` names the
    CPU: raise where CUDA is missing, and on the card build the kernel
    library, which the ranks only load."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} requested but CUDA is not available")
        from opt_tpu_torch.ops._build import build_library

        build_library()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the sharded solves of the reference's dry run on ``n_devices``
    ranks (:func:`dryrun_rank`): image_warping over a 2-D mesh of tiles, by
    standard PCG and by Chronopoulos-Gear, both with block-Jacobi, and
    arap by LM over owner blocks, each checked on every rank. The
    ``n_devices`` gloo ranks are started on the card (all on one card, the
    kernel library built first), or on the CPU for ``device="cpu"``; their
    results are returned by rank. Raises when a rank's check fails."""
    prepare_device(device)
    return run_ranks(dryrun_rank, n_devices, device)
