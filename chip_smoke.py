#!/usr/bin/env python3
"""Drive the PyTorch port (opt_tpu_torch) on one CUDA card, end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernel (a GN and an LM instance) from
opt_tpu_torch/ops/csrc with nvcc and holds each form against its plain
PyTorch twin at the main paths' shapes: poisson 512x512x4 and 2048x2048x4,
laplacian 512x512, and image_warping's mixed-unknown GN system and its first
LM system, each at 512x512x3 and 1024x1024x3. It then solves, through the
public API on the card, the poisson bench headline (512x512x4, one GN step,
up to 2000 CG iterations) and image_warping at 512x512 by GN and by LM
(8x400) and at 1024x1024 by GN (4x100), checks each final cost against the
JAX package's and each solve's one kernel launch per nonlinear step, checks
the medium golden costs, times kernels, twins, assembly and solves with CUDA
events, and prints one JSON line per result. It exits non-zero, with no
result line, when CUDA is not available or any check fails. It imports
neither JAX nor opt_tpu.
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
from opt_tpu_torch.models.specs import image_warping, laplacian, poisson_image_editing
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
IW_N = 512  # bench.py::bench_image_warping's grid side
IW_BIG_N = 1024  # bench.py's image_warping_1024 case
# Final costs of the image_warping main-path solves (bench.py inputs) from
# the JAX package on the CPU, each computed with
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import image_warping as s; n=N; r=np.random.RandomState(0);
#   f=np.float32; u=np.stack(np.meshgrid(np.arange(n),np.arange(n),indexing='ij'),-1).astype(f);
#   c=-np.ones((n,n,2),f); [c.__setitem__((i,j),[i+r.randn()*3,j+r.randn()*3])
#   for i,j in (r.randint(0,n,2) for _ in range(16))];
#   i={'Offset':u.copy(),'Angle':np.zeros((n,n),f),'UrShape':u,'Constraints':c,
#   'Mask':np.zeros((n,n),f),'w_fitSqrt':np.sqrt(100.0).astype(f),'w_regSqrt':np.sqrt(0.01).astype(f)};
#   print(ot.Problem(s,kind=KIND).plan(dims={'W':n,'H':n}).solve(i,nIterations=NL,lIterations=LI).final_cost)"
# with (N, KIND, NL, LI) as in the key; the JAX CPU runs took 3200, 2811 and
# 400 CG iterations.
JAX_CPU_IMAGE_WARPING_COSTS = {
    (512, "gaussNewtonGPU", 8, 400): 1.9825738668441772,
    (512, "LMGPU", 8, 400): 1.982566475868225,
    (1024, "gaussNewtonGPU", 4, 100): 2.0774598121643066,
}
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
GOLDEN_ATOL = 1e-8  # tests/test_golden_costs.py: near-zero goldens
# (spec, kind, nIterations, lIterations, golden) from tests/test_golden_costs.py
MEDIUM_GOLDENS = {
    "laplacian": (laplacian, "gaussNewtonGPU", 6, 40, 1.6753909587860107),
    "poisson_image_editing": (poisson_image_editing, "gaussNewtonGPU", 2, 120, 258.89776611328125),
    "image_warping": (image_warping, "LMGPU", 10, 60, 3.3203492039168836e-12),
}
# kernel vs twin after a fixed iteration count: both sum each dot's float32
# products in float64, but in another order, so the float32 iterates may
# part in the last bits
DELTA_RTOL = 1e-4
CG_TOL = 1e-12  # SOLVER_PARAMETER_DEFAULTS["cg_rz_tolerance"]
Q_TOL = 1e-4  # SOLVER_PARAMETER_DEFAULTS["q_tolerance"]
RESET_PERIOD = 10  # SOLVER_PARAMETER_DEFAULTS["residual_reset_period"]
TIMED_ITERS = 200
KERNEL_SOURCE = "opt_tpu_torch/ops/csrc/fused_grid_cg.cu"
K1 = "opt_tpu/ops/pallas_cg.py:328"
K6 = "opt_tpu/ops/pallas_cg.py:1430"


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


def bench_image_warping_inputs(n):
    """bench.py::bench_image_warping's inputs: RandomState(0), 16 fit
    constraints, w_fitSqrt = sqrt(100), w_regSqrt = sqrt(0.01)."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    for _ in range(16):
        i, j = rng.randint(0, n, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, n), f32), "UrShape": ur,
        "Constraints": con, "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def medium_inputs():
    """tests/test_specs.py::_cases draw order at N_GRID=32, N_VERT=200,
    up to the three specs the port has."""
    rng = np.random.RandomState(0)
    n, N, f32 = 32, 200, np.float32
    rng.rand(N, 3)  # pos3
    lap = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    rng.rand(N), rng.rand(N)  # curve_fitting data
    poi = {
        "X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32),
        "M": (rng.rand(n, n) > 0.5).astype(f32),
    }
    iw = {
        "Offset": rng.rand(n, n, 2).astype(f32), "Angle": np.zeros((n, n), f32),
        "UrShape": rng.rand(n, n, 2).astype(f32),
        "Constraints": -np.ones((n, n, 2), f32), "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": 3.16, "w_regSqrt": 1.0,
    }
    return {"laplacian": lap, "poisson_image_editing": poi, "image_warping": iw}, {"W": n, "H": n}


def system(spec, n, inputs):
    plan = ot.Problem(spec).plan(dims={"W": n, "H": n}, device="cuda")
    meta, r0, pre = plan.gn_system(inputs)
    if meta is None or plan.fused_fallback is not None:
        raise RuntimeError(f"{spec.__name__} {n}: no fused grid CG meta ({plan.fused_fallback})")
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), {}


def lm_system(spec, n, inputs):
    """The first LM step's system, with its real damping: (meta, b, pre_lm,
    LM keywords with the packed ctc)."""
    plan = ot.Problem(spec, kind="LMGPU").plan(dims={"W": n, "H": n}, device="cuda")
    meta, r0, pre, ctc = plan.lm_system(inputs)
    if meta is None or plan.fused_fallback is not None:
        raise RuntimeError(f"{spec.__name__} {n}: no fused grid CG meta ({plan.fused_fallback})")
    lm = dict(ctc=fused_cg.pack(ctc, meta), reset_period=RESET_PERIOD)
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), lm


def kernel_vs_twin(label, meta, b, pre, lits, tol, lm=None, q_tol=Q_TOL):
    """Kernel and twin on the same system. tol = 0 (and q_tol = -inf under
    LM) runs `lits` iterations with no exit and holds δ to the twin's;
    otherwise the real exits, which must give equal iteration counts."""
    lm_kw = dict(lm, q_tolerance=q_tol) if lm else {}
    dk, ik = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, tol, **lm_kw)
    trace = []
    dr, ir = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                              trace=trace, **lm_kw)
    torch.cuda.synchronize()
    ik = int(ik.item())
    err = float((dk - dr).abs().max())
    scale = float(dr.abs().max())
    finite = bool(torch.isfinite(dk).all())
    line = {"check": "kernel_vs_twin", "case": label, "form": "lm" if lm else "gn",
            "lits": lits, "tol": tol, "kernel_iters": ik, "twin_iters": ir,
            "max_abs_err": err, "max_abs_delta": scale, "rel_err": err / max(scale, 1e-30)}
    if lm:
        line["q_tol"] = q_tol
    if ik != ir:  # the twin's exit quantities where the two counts stop
        line["twin_at_exits"] = [
            {"iter": l, "rz": float(rz), "rz_floor": float(fl),
             "zeta": None if z is None else float(z), "q_tol": q_tol if lm else None}
            for (l, rz, fl, z) in trace if l in (ik, ir)
        ]
    log(json.dumps(line))
    if not finite:
        raise RuntimeError(f"{label}: kernel delta not finite")
    if ik != ir:
        raise RuntimeError(f"{label}: kernel ran {ik} iterations, the twin {ir}")
    no_exit = tol == 0.0 and (not lm or q_tol == float("-inf"))
    if no_exit:
        if ik != lits:
            raise RuntimeError(f"{label}: iteration counts {ik}/{ir}, expected {lits}")
        if err > DELTA_RTOL * scale:
            raise RuntimeError(f"{label}: max|dδ| {err} > {DELTA_RTOL}·max|δ| {scale}")
    return err


def bitwise_repeat(label, meta, b, pre, lits, lm=None):
    lm_kw = dict(lm, q_tolerance=Q_TOL) if lm else {}
    d1, i1 = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, CG_TOL, **lm_kw)
    d2, i2 = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, CG_TOL, **lm_kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2)) and int(i1.item()) == int(i2.item())
    log(json.dumps({"check": "bitwise_repeat", "case": label, "form": "lm" if lm else "gn",
                    "iters": int(i1.item()), "equal": same}))
    if not same:
        raise RuntimeError(f"{label}: two launches on the same input differ")


def main_path(label, spec, kind, n, inputs, nl, li, want, n_ch):
    """One solve through the public API with the launch counts set to 0
    just before it; returns (result, launches by form, plan)."""
    fused_cg.reset_launch_counts()
    plan = ot.Problem(spec, kind=kind).plan(dims={"W": n, "H": n}, device="cuda")
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    launches = dict(fused_cg.fused_grid_cg_kernel.launches)
    form = "lm" if kind == "LMGPU" else "gn"
    rel = abs(res.final_cost - want) / abs(want)
    log(json.dumps({"check": "main_path", "case": label, "final_cost": res.final_cost,
                    "jax_cpu_cost": want, "rel_diff": rel, "nonlinear_iters": res.num_iterations,
                    "lin_iters": res.num_linear_iterations, "kernel_launches": launches,
                    "fused_fallback": plan.fused_fallback, "solve_s": res.wall_time_s}))
    other = "gn" if form == "lm" else "lm"
    if (launches[form] != res.num_iterations or launches[other] != 0 or res.num_iterations < 1
            or plan.fused_fallback is not None):
        raise RuntimeError(f"{label}: not one {form} kernel launch per nonlinear step "
                           f"({launches} for {res.num_iterations}, fallback {plan.fused_fallback})")
    for u, X in res.unknowns.items():
        shape = (n, n, n_ch[u])
        if tuple(X.shape) != shape or not bool(torch.isfinite(X).all()):
            raise RuntimeError(f"{label}: unknown {u} is not finite of shape {shape}")
    if rel > GOLDEN_RTOL:
        raise RuntimeError(f"{label}: final cost {res.final_cost} vs JAX {want}")
    return res, launches, plan


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


def time_pair(label, meta, b, pre, gpu, lm=None, reps=(5, 2)):
    """ms per CG iteration of the kernel and of its twin, TIMED_ITERS
    iterations with no exit, CUDA events."""
    lm_kw = dict(lm, q_tolerance=float("-inf")) if lm else {}
    ms_k = time_cuda(lambda: fused_cg.fused_grid_cg_kernel(meta, b, pre, TIMED_ITERS, 0.0, **lm_kw),
                     reps[0])
    ms_t = time_cuda(lambda: fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], b, pre, TIMED_ITERS, 0.0, **lm_kw), reps[1])
    log(json.dumps({"timing": label, "form": "lm" if lm else "gn", "gpu": gpu,
                    "kernel_ms_per_cg_iter": ms_k / TIMED_ITERS,
                    "twin_ms_per_cg_iter": ms_t / TIMED_ITERS,
                    f"kernel_ms_{TIMED_ITERS}_iters": ms_k, f"twin_ms_{TIMED_ITERS}_iters": ms_t}))
    return ms_k, ms_t


def time_main_path(label, spec, kind, n, inputs, nl, li, gpu):
    """Assembly ms per nonlinear step (the step's system, CUDA events) and
    the whole solve's wall time (host clock, synchronised), after a warm-up
    solve."""
    plan = ot.Problem(spec, kind=kind).plan(dims={"W": n, "H": n}, device="cuda")
    u, c, g, prm = plan._normalize_and_place(inputs)
    sv = plan.solver
    sp = plan.solver_params
    state = sv.init(u, c, g, prm, sp)

    def assemble():
        fs = FunctionSet(plan.compiled, c, g, prm)
        fs.masks(u)
        if kind == "LMGPU":
            return sv.lm_system(u, fs, state, sp)
        return sv.gn_system(u, fs)

    ms_assembly = time_cuda(assemble, 3)
    plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    solve_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"timing": label, "gpu": gpu, "assembly_ms_per_step": ms_assembly,
                    "solve_ms": solve_ms, "nonlinear_iters": res.num_iterations,
                    "lin_iters": res.num_linear_iterations}))


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

    # 2. each kernel form against its twin at the main paths' shapes
    n = MAIN_N
    inputs = bench_poisson_inputs(n)
    meta, b, pre, _ = system(poisson_image_editing, n, inputs)
    log(f"poisson {n}x{n}x4: {meta['F'].shape[0]} fields, {len(meta['triples'])} triples")
    err_gn = kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 50, 0.0)
    kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 2000, CG_TOL)
    lmeta, lb, lpre, _ = system(laplacian, n, laplacian_inputs(n))
    kernel_vs_twin(f"laplacian{n}", lmeta, lb, lpre, 50, 0.0)
    kernel_vs_twin(f"laplacian{n}", lmeta, lb, lpre, 2000, CG_TOL)
    del lmeta, lb, lpre
    bmeta, bb, bpre, _ = system(poisson_image_editing, BIG_N, bench_poisson_inputs(BIG_N))
    kernel_vs_twin(f"poisson{BIG_N}x4", bmeta, bb, bpre, 50, 0.0)
    kernel_vs_twin(f"poisson{BIG_N}x4", bmeta, bb, bpre, 200, CG_TOL)
    del bmeta, bb, bpre
    bitwise_repeat(f"poisson{n}x4", meta, b, pre, 300)

    iw_in = bench_image_warping_inputs(IW_N)
    iw_big_in = bench_image_warping_inputs(IW_BIG_N)
    mmeta, mb, mpre, _ = system(image_warping, IW_N, iw_in)
    cross = sum(1 for (_d, i, j, _f) in mmeta["triples"] if i != j)
    log(f"image_warping {IW_N}x{IW_N}x3: {mmeta['F'].shape[0]} fields, "
        f"{len(mmeta['triples'])} triples, {cross} cross-channel")
    err_mixed = kernel_vs_twin(f"image_warping{IW_N}x3", mmeta, mb, mpre, 50, 0.0)
    kernel_vs_twin(f"image_warping{IW_N}x3", mmeta, mb, mpre, 400, CG_TOL)
    vmeta, vb, vpre, vlm = lm_system(image_warping, IW_N, iw_in)
    err_lm = kernel_vs_twin(f"image_warping{IW_N}x3", vmeta, vb, vpre, 50, 0.0, vlm,
                            q_tol=float("-inf"))
    kernel_vs_twin(f"image_warping{IW_N}x3", vmeta, vb, vpre, 400, CG_TOL, vlm)
    bitwise_repeat(f"image_warping{IW_N}x3", vmeta, vb, vpre, 400, vlm)
    gmeta, gb, gpre, _ = system(image_warping, IW_BIG_N, iw_big_in)
    err_k6 = kernel_vs_twin(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, 50, 0.0)
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, 100, CG_TOL)
    wmeta, wb, wpre, wlm = lm_system(image_warping, IW_BIG_N, iw_big_in)
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, 50, 0.0, wlm,
                   q_tol=float("-inf"))
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, 100, CG_TOL, wlm)

    # 3. the main paths through the public API, each with the launch counts
    # set to 0 just before it and read just after
    _res, l_poisson, _p = main_path(f"poisson{n}x4 GN 1x2000", poisson_image_editing,
                                    "gaussNewtonGPU", n, inputs, 1, 2000,
                                    JAX_CPU_POISSON_512_COST, {"X": 4})
    iw_ch = {"Offset": 2, "Angle": 1}
    runs = {}
    for (nn, kind, nl, li), want in JAX_CPU_IMAGE_WARPING_COSTS.items():
        label = f"image_warping{nn} {'LM' if kind == 'LMGPU' else 'GN'} {nl}x{li}"
        _r, runs[(nn, kind)], _p = main_path(
            label, image_warping, kind, nn, iw_in if nn == IW_N else iw_big_in, nl, li,
            want, iw_ch)

    cases, mdims = medium_inputs()
    for name, (spec, kind, nl, li, golden) in MEDIUM_GOLDENS.items():
        fused_cg.reset_launch_counts()
        p = ot.Problem(spec, kind=kind).plan(dims=mdims, device="cuda")
        r = p.solve(dict(cases[name]), nIterations=nl, lIterations=li)
        used = dict(fused_cg.fused_grid_cg_kernel.launches)
        ok = abs(r.final_cost - golden) <= GOLDEN_ATOL + GOLDEN_RTOL * abs(golden)
        log(json.dumps({"check": "golden", "case": f"{name} {kind} {nl}x{li}",
                        "final_cost": r.final_cost, "golden": golden,
                        "rel_diff": abs(r.final_cost - golden) / golden,
                        "kernel_launches": used, "nonlinear_iters": r.num_iterations}))
        form = "lm" if kind == "LMGPU" else "gn"
        if not ok or used[form] != r.num_iterations or p.fused_fallback is not None:
            raise RuntimeError(f"golden {name} failed")

    # 4. times on the card
    ms_gn, plain_gn = time_pair(f"poisson{n}x4", meta, b, pre, gpu)
    ms_mixed, plain_mixed = time_pair(f"image_warping{IW_N}x3", mmeta, mb, mpre, gpu)
    ms_lm, plain_lm = time_pair(f"image_warping{IW_N}x3", vmeta, vb, vpre, gpu, vlm)
    ms_k6, plain_k6 = time_pair(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, gpu,
                                reps=(3, 1))
    time_pair(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, gpu, wlm, reps=(3, 1))
    del gmeta, gb, gpre, wmeta, wb, wpre, wlm
    time_main_path(f"poisson{n}x4 GN 1x2000", poisson_image_editing, "gaussNewtonGPU", n,
                   inputs, 1, 2000, gpu)
    for (nn, kind, nl, li) in JAX_CPU_IMAGE_WARPING_COSTS:
        label = f"image_warping{nn} {'LM' if kind == 'LMGPU' else 'GN'} {nl}x{li}"
        time_main_path(label, image_warping, kind, nn, iw_in if nn == IW_N else iw_big_in,
                       nl, li, gpu)

    def entry(name, replaces, launches, err, ms, plain):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain}

    # each main-path launch counts in one entry; the LM form at 1024x1024x3
    # (K6's other case) is checked and timed above but has no main path here
    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [
        entry("fused_grid_cg GN (K1, grid GN form)", K1, l_poisson["gn"], err_gn, ms_gn, plain_gn),
        entry("fused_grid_cg GN, mixed unknowns (K1 variant a)", K1,
              runs[(IW_N, "gaussNewtonGPU")]["gn"], err_mixed, ms_mixed, plain_mixed),
        entry("fused_grid_cg LM (K1 variant b)", K1, runs[(IW_N, "LMGPU")]["lm"], err_lm,
              ms_lm, plain_lm),
        entry(f"fused_grid_cg GN beyond VMEM (K6), image_warping {IW_BIG_N}x{IW_BIG_N}x3", K6,
              runs[(IW_BIG_N, "gaussNewtonGPU")]["gn"], err_k6, ms_k6, plain_k6),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
