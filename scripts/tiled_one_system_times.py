#!/usr/bin/env python3
"""Time the tiled kernel's one-system instances of a source tree on the card.

    python3 scripts/tiled_one_system_times.py [--root TREE] [--label NAME] [--hbm | --dia | --vol]

Imports opt_tpu_torch from TREE (default: this checkout), builds its
kernels there, and times gn_tiled on poisson 512x512x4 (bench_poisson's
inputs), lm_tiled on image_warping 512x512's first LM system, and their
bfloat16 instances gn_bf16_tiled and lm_bf16_tiled: ms per CG iteration,
100 iterations with no exit, CUDA events, three launches after a warm-up.
With --hbm it times image_warping 1024x1024's first GN and LM systems
instead, on the route the tree takes (gn_hbm_tiled and lm_hbm_tiled where
the tree has the tiled kernel's hbm layout) and on the template (gn, lm),
in turns (route, template, template, route). With --dia it times arap's
first GN and LM systems on bench.py::bench_arap_graph's 192x192 grid mesh
(a graph without the remainder) the same way: gn_dia_tiled and
lm_dia_tiled where the tree has the graph kernel's stream layout, against
the template's gn and lm. With --vol it times volumetric 32x32x32's first
GN system (bench.py::bench_volumetric's inputs) with the Jacobi and with
the block-Jacobi preconditioner the same way: gn_vol_tiled and
gn_bj_vol_tiled where the tree has the 3-D grid kernel, against the
template's gn and gn_bj. Each launch's delta is also
held to the plain twin's on the same system (bitwise_equal). It prints
each instance's registers and spills from ptxas. Run it on two trees in
turns (A, B, B, A) in one command to compare two versions of the kernel on
one card; each JSON line names the tree's label and the card's name and
power limit."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--hbm", action="store_true",
                    help="image_warping 1024x1024 GN and LM, the route and the template")
    ap.add_argument("--dia", action="store_true",
                    help="arap on the 192x192 grid mesh GN and LM, the route and the template")
    ap.add_argument("--vol", action="store_true",
                    help="volumetric 32^3 GN, Jacobi and block-Jacobi, the route and the template")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("tiled_one_system_times: needs a CUDA card", file=sys.stderr)
        return 2
    import opt_tpu_torch as ot
    from opt_tpu_torch.models.specs import (arap_mesh_deformation, image_warping,
                                            poisson_image_editing, volumetric_mesh_deformation)
    from opt_tpu_torch.ops import fused_cg
    from opt_tpu_torch.ops._build import build_library, instance_registers

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info = build_library()
    regs = instance_registers(info["log"])
    n, f32 = (1024 if args.hbm else 512), np.float32
    rng = np.random.RandomState(0)
    mask = np.ones((n, n), f32)
    mask[n // 8: -n // 8, n // 8: -n // 8] = 0.0
    poisson = {"X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32), "M": mask}
    rng = np.random.RandomState(0)
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    for _ in range(16):
        i, j = rng.randint(0, n, 2)
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    warp = {"Offset": ur.copy(), "Angle": np.zeros((n, n), f32), "UrShape": ur,
            "Constraints": con, "Mask": np.zeros((n, n), f32),
            "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32)}
    bf16 = {"coefficient_dtype": "bfloat16"}
    cases = ((poisson_image_editing, "gaussNewtonGPU", poisson, {}),
             (image_warping, "LMGPU", warp, {}),
             (poisson_image_editing, "gaussNewtonGPU", poisson, bf16),
             (image_warping, "LMGPU", warp, bf16))
    dims = {"W": n, "H": n}
    if args.hbm:
        cases = ((image_warping, "gaussNewtonGPU", warp, {}),
                 (image_warping, "LMGPU", warp, {}))
    if args.dia:  # bench.py::bench_arap_graph's inputs, as chip_smoke.py checks them
        from chip_smoke import arap_grid_inputs

        dims, arap = arap_grid_inputs(192)
        cases = ((arap_mesh_deformation, "gaussNewtonGPU", arap, {}),
                 (arap_mesh_deformation, "LMGPU", arap, {}))
    if args.vol:  # bench.py::bench_volumetric's inputs, as chip_smoke.py checks them
        from chip_smoke import _vol, volumetric_inputs

        dims, vol = _vol(32), volumetric_inputs(32)
        cases = ((volumetric_mesh_deformation, "gaussNewtonGPU", vol, {}),
                 (volumetric_mesh_deformation, "gaussNewtonGPU", vol,
                  {"preconditioner": "block_jacobi"}))
    for spec, kind, inputs, ip in cases:
        plan = ot.Problem(spec, kind=kind).plan(
            dims=dims, init_params=ot.InitializationParameters(**ip))
        meta, r0, pre, kw = plan.cg_inputs(inputs)
        b, p = fused_cg.pack(r0, meta), fused_cg.pack(pre, meta)
        lm = {}
        if kind == "LMGPU":
            lm = dict(ctc=fused_cg.pack(kw["ctc"], meta), reset_period=kw["reset_period"],
                      q_tolerance=float("-inf"))
        if kw["pre_blocks"] is not None:
            lm["pre_blocks"] = fused_cg.pack_pre_blocks(kw["pre_blocks"], meta)
        twin = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, p, 100, 0.0,
                                                **lm)[0]
        route = fused_cg.launch_instance(meta, b, lm="ctc" in lm, pre_blocks=lm.get("pre_blocks"))
        turns = (False, True, True, False) if args.hbm or args.dia or args.vol else (False,)
        for template in turns:
            launch = (fused_cg.template_grid_cg_kernel if template
                      else fused_cg.fused_grid_cg_kernel)
            name = ("lm" if "ctc" in lm else "gn") + ("_bj" if "pre_blocks" in lm else "")
            name = name if template else route

            def call():
                return launch(meta, b, p, 100, 0.0, **lm)

            d, _it = call()
            torch.cuda.synchronize()
            same = bool(torch.equal(d, twin))
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(3):
                _d, it = call()
            e1.record()
            torch.cuda.synchronize()
            key = next((k for k in fused_cg.TILED_INSTANCES + fused_cg.INSTANCES
                        if fused_cg.instance_name(*k) == name), None)
            print(json.dumps({"tree": args.label, "instance": name, "gpu": gpu,
                              "grid": list(b.shape[1:]) if args.dia or args.vol else [n, n],
                              "iters": int(it.sum()),
                              "kernel_ms_per_cg_iter": e0.elapsed_time(e1) / 3 / int(it.sum()),
                              "bitwise_equal_to_twin": same,
                              "registers_spill_store_load_bytes": list(regs.get(key, ()))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
