#!/usr/bin/env python3
"""Drive the PyTorch port (opt_tpu_torch) on one CUDA card, end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernel from opt_tpu_torch/ops/csrc with nvcc, holds the
kernel against its plain PyTorch twin at the main path's shapes, solves the
bench headline (poisson_image_editing at 512x512x4, one GN step, up to 2000
CG iterations) through the public API on the card, checks the final cost
against the JAX package's and the medium golden costs, times the kernel,
the twin, the assembly and the whole solve with CUDA events, and prints one
JSON line per result. It exits non-zero, with no result line, when CUDA is
not available or any check fails. It imports neither JAX nor opt_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import opt_tpu_torch as ot
from opt_tpu_torch.functions import FunctionSet
from opt_tpu_torch.models.specs import laplacian, poisson_image_editing
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.ops._build import build_library, load_library, nvcc_path

MAIN_N = 512  # the bench headline's grid side
BIG_N = 2048  # a grid whose state (64 MB a vector) exceeds the 50 MB L2
# Final cost of the main-path solve (poisson 512x512x4, bench inputs, 1 GN
# step, lIterations=2000, default plan) from the JAX package on the CPU
# (568 CG iterations there), computed with:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import poisson_image_editing as s; n=512;
#   r=np.random.RandomState(0); m=np.ones((n,n),'f4'); m[64:-64,64:-64]=0;
#   i={'X':r.rand(n,n,4).astype('f4'),'T':r.rand(n,n,4).astype('f4'),'M':m};
#   print(ot.Problem(s).plan(dims={'W':n,'H':n}).solve(i,nIterations=1,
#   lIterations=2000).final_cost)"
JAX_CPU_POISSON_512_COST = 415.1882629394531
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
# (spec, nIterations, lIterations, golden) from tests/test_golden_costs.py
MEDIUM_GOLDENS = {
    "laplacian": (laplacian, 6, 40, 1.6753909587860107),
    "poisson_image_editing": (poisson_image_editing, 2, 120, 258.89776611328125),
}
# kernel vs twin after a fixed iteration count: f32 CG iterates with the
# dot products summed in another order (double partials vs torch.sum)
DELTA_RTOL = 1e-4
CG_TOL = 1e-12  # SOLVER_PARAMETER_DEFAULTS["cg_rz_tolerance"]
KERNEL_ENTRY = {
    "name": "fused_grid_cg",
    "route": "cuda",
    "source": "opt_tpu_torch/ops/csrc/fused_grid_cg.cu",
    "replaces": "opt_tpu/ops/pallas_cg.py:328",
}


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_poisson_inputs(n):
    """bench.py::bench_poisson's inputs: RandomState(0), a border mask."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    mask = np.ones((n, n), f32)
    mask[n // 8 : -n // 8, n // 8 : -n // 8] = 0.0
    return {"X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32), "M": mask}


def laplacian_inputs(n):
    rng = np.random.RandomState(0)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def medium_inputs():
    """tests/test_specs.py::_cases draw order at N_GRID=32, N_VERT=200,
    up to the two specs of this slice."""
    rng = np.random.RandomState(0)
    n, N, f32 = 32, 200, np.float32
    rng.rand(N, 3)  # pos3
    lap = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    rng.rand(N), rng.rand(N)  # curve_fitting data
    poi = {
        "X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32),
        "M": (rng.rand(n, n) > 0.5).astype(f32),
    }
    return {"laplacian": lap, "poisson_image_editing": poi}, {"W": n, "H": n}


def system(spec, n, inputs):
    plan = ot.Problem(spec).plan(dims={"W": n, "H": n}, device="cuda")
    meta, r0, pre = plan.gn_system(inputs)
    if meta is None or plan.fused_fallback is not None:
        raise RuntimeError(f"{spec.__name__} {n}: no fused grid CG meta ({plan.fused_fallback})")
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)


def kernel_vs_twin(label, meta, b, pre, lits, tol):
    dk, ik = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, tol)
    dr, ir = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol)
    torch.cuda.synchronize()
    ik = int(ik.item())
    err = float((dk - dr).abs().max())
    scale = float(dr.abs().max())
    finite = bool(torch.isfinite(dk).all())
    log(json.dumps({"check": "kernel_vs_twin", "case": label, "lits": lits, "tol": tol,
                    "kernel_iters": ik, "twin_iters": ir, "max_abs_err": err,
                    "max_abs_delta": scale, "rel_err": err / max(scale, 1e-30)}))
    if not finite:
        raise RuntimeError(f"{label}: kernel delta not finite")
    if tol == 0.0:
        if ik != lits or ir != lits:
            raise RuntimeError(f"{label}: iteration counts {ik}/{ir}, expected {lits}")
        if err > DELTA_RTOL * scale:
            raise RuntimeError(f"{label}: max|dδ| {err} > {DELTA_RTOL}·max|δ| {scale}")
    return err


def time_cuda(fn, reps):
    """Mean ms per call over `reps` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nv = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {nv.stdout.strip().splitlines()[-1]}")

    # 1. build
    t0 = time.perf_counter()
    info = build_library()
    load_library()
    log(f"build: {'built' if info['built'] else 'cached'} {info['path']} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        if "fused_grid_cg" in line or "registers" in line or "nvcc" in line:
            log(f"  {line.strip()}")

    # 2. kernel against twin at the main path's shapes
    n = MAIN_N
    inputs = bench_poisson_inputs(n)
    meta, b, pre = system(poisson_image_editing, n, inputs)
    log(f"poisson {n}x{n}x4: {meta['F'].shape[0]} fields, {len(meta['triples'])} triples")
    main_err = kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 50, 0.0)
    kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 2000, CG_TOL)
    lmeta, lb, lpre = system(laplacian, n, laplacian_inputs(n))
    kernel_vs_twin(f"laplacian{n}", lmeta, lb, lpre, 50, 0.0)
    kernel_vs_twin(f"laplacian{n}", lmeta, lb, lpre, 2000, CG_TOL)
    bmeta, bb, bpre = system(poisson_image_editing, BIG_N, bench_poisson_inputs(BIG_N))
    kernel_vs_twin(f"poisson{BIG_N}x4", bmeta, bb, bpre, 50, 0.0)
    kernel_vs_twin(f"poisson{BIG_N}x4", bmeta, bb, bpre, 200, CG_TOL)
    del bmeta, bb, bpre
    d1, i1 = fused_cg.fused_grid_cg_kernel(meta, b, pre, 300, CG_TOL)
    d2, i2 = fused_cg.fused_grid_cg_kernel(meta, b, pre, 300, CG_TOL)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2)) and int(i1.item()) == int(i2.item())
    log(json.dumps({"check": "bitwise_repeat", "case": f"poisson{n}x4", "iters": int(i1.item()),
                    "equal": same}))
    if not same:
        raise RuntimeError("two launches on the same input differ")

    # 3. the main path through the public API
    fused_cg.fused_grid_cg_kernel.launches = 0
    plan = ot.Problem(poisson_image_editing).plan(dims={"W": n, "H": n}, device="cuda")
    res = plan.solve(dict(inputs), nIterations=1, lIterations=2000)
    torch.cuda.synchronize()
    launches = fused_cg.fused_grid_cg_kernel.launches
    X = res.unknowns["X"]
    rel = abs(res.final_cost - JAX_CPU_POISSON_512_COST) / JAX_CPU_POISSON_512_COST
    log(json.dumps({"check": "main_path", "case": f"poisson{n}x4 1x2000",
                    "final_cost": res.final_cost, "jax_cpu_cost": JAX_CPU_POISSON_512_COST,
                    "rel_diff": rel, "lin_iters": res.num_linear_iterations,
                    "kernel_launches": launches, "fused_fallback": plan.fused_fallback}))
    if launches != 1 or plan.fused_fallback is not None:
        raise RuntimeError(f"main path did not run the kernel once ({launches} launches, "
                           f"fallback {plan.fused_fallback})")
    if tuple(X.shape) != (n, n, 4) or not bool(torch.isfinite(X).all()):
        raise RuntimeError(f"main path unknowns are not finite of shape ({n}, {n}, 4)")
    if rel > GOLDEN_RTOL:
        raise RuntimeError(f"final cost {res.final_cost} vs JAX {JAX_CPU_POISSON_512_COST}")

    cases, mdims = medium_inputs()
    for name, (spec, nl, li, golden) in MEDIUM_GOLDENS.items():
        before = fused_cg.fused_grid_cg_kernel.launches
        p = ot.Problem(spec).plan(dims=mdims, device="cuda")
        r = p.solve(dict(cases[name]), nIterations=nl, lIterations=li)
        grel = abs(r.final_cost - golden) / golden
        used = fused_cg.fused_grid_cg_kernel.launches - before
        log(json.dumps({"check": "golden", "case": f"{name} {nl}x{li}",
                        "final_cost": r.final_cost, "golden": golden, "rel_diff": grel,
                        "kernel_launches": used}))
        if grel > GOLDEN_RTOL or used != nl or p.fused_fallback is not None:
            raise RuntimeError(f"golden {name} failed")

    # 4. times on the card
    lits = 200
    ms_kernel = time_cuda(lambda: fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, 0.0), 5)
    ms_twin = time_cuda(
        lambda: fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, 0.0), 2
    )
    tplan = ot.Problem(poisson_image_editing).plan(dims={"W": n, "H": n}, device="cuda")
    u, c, g, prm = tplan._normalize_and_place(inputs)

    def assemble():
        fs = FunctionSet(tplan.compiled, c, g, prm)
        fs.masks(u)
        return tplan.solver.gn_system(u, fs)

    ms_assembly = time_cuda(assemble, 3)
    tplan.solve(dict(inputs), nIterations=1, lIterations=2000)
    solve_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr = tplan.solve(dict(inputs), nIterations=1, lIterations=2000)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"timing": f"poisson{n}x4", "gpu": gpu,
                    "kernel_ms_per_cg_iter": ms_kernel / lits,
                    "twin_ms_per_cg_iter": ms_twin / lits,
                    "kernel_ms_200_iters": ms_kernel, "twin_ms_200_iters": ms_twin,
                    "assembly_ms": ms_assembly, "solve_ms": solve_ms,
                    "solve_lin_iters": rr.num_linear_iterations}))

    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [dict(KERNEL_ENTRY, launches=launches, max_abs_err=main_err,
                                     ms=ms_kernel, plain_ms=ms_twin)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
