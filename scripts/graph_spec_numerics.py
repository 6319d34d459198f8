#!/usr/bin/env python3
"""The numerics behind the three last graph specs' gates, on the CPU, in
both packages (the JAX package and its PyTorch port) and in float32 and
float64: what chip_smoke.py's JAX_CPU_SPEC_COSTS and ROADMAP.md queue 3
quote.

    JAX_PLATFORMS=cpu python3 scripts/graph_spec_numerics.py [--solves]

Prints one JSON line per result:
  * cotangent_discriminants: bench_cotangent's inputs (chip_smoke.py's
    cotangent_inputs(100)): the edges whose cot discriminant lies below
    1e-6 in float64, and the largest float32 weights beside their float64
    values;
  * initial_cost: cotangent's cost at those inputs and at the medium and
    small ones below, per package and precision;
  * first_step: cotangent's first LM step at tests/test_golden_costs.py's
    medium inputs and tests/test_specs.py's small ones, by CG depth, per
    package, in float64;
  * embedded_block_zeros: the share of embedded_mesh_deformation's
    remainder block entries that are non-zero, on a 30 x 30 grid mesh;
  * with --solves, solve: the three specs' bench solves (GRAPH_SPECS'
    depths) per package and precision: each step's cost and the CG count.

Each (package, precision) runs in its own process: jax_enable_x64 is
global. Takes about four minutes with --solves, one without."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPECS = {"cotangent10k": "cotangent_mesh_smoothing", "embedded10k": "embedded_mesh_deformation",
         "robust10k": "robust_nonrigid_alignment"}
DEPTHS = (10, 20, 30, 40)


def _package(pkg: str, f64: bool):
    """(make a plan, the spec module) of one package at one precision."""
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import opt_tpu as ot
        from opt_tpu.models import specs

        if f64:
            ot.enable_double_precision()
        return (lambda spec, kind, dims: ot.Problem(spec, kind=kind).plan(
            dims=dims, double_precision=f64)), specs
    import opt_tpu_torch as ot
    from opt_tpu_torch.models import specs

    return (lambda spec, kind, dims: ot.Problem(spec, kind=kind).plan(
        dims=dims, double_precision=f64, device="cpu")), specs


def one(pkg: str, f64: bool, solves: bool) -> None:
    """This process's package and precision: its lines."""
    import chip_smoke as cs
    import tests.test_golden_costs as tg
    import tests.test_specs as ts

    plan, specs = _package(pkg, f64)
    tag = {"package": pkg, "float64": f64}
    dims, inputs = cs.cotangent_inputs(cs.SPEC_SIDE)
    p = plan(specs.cotangent_mesh_smoothing, "LMGPU", dims)
    p.init(dict(inputs))
    print(json.dumps({"initial_cost": "cotangent10k", **tag, "cost": float(p.current_cost())}))
    for size, cases in (("medium", tg._medium_cases()), ("small", ts._cases())):
        mdims, minputs = cases["cotangent_mesh_smoothing"]
        p = plan(specs.cotangent_mesh_smoothing, "LMGPU", mdims)
        p.init(dict(minputs))
        print(json.dumps({"initial_cost": f"cotangent {size}", **tag,
                          "cost": float(p.current_cost())}))
        if f64:
            costs = [plan(specs.cotangent_mesh_smoothing, "LMGPU", mdims).solve(
                dict(minputs), nIterations=1, lIterations=li).costs[0] for li in DEPTHS]
            print(json.dumps({"first_step": f"cotangent {size}", **tag,
                              "cg_iterations": DEPTHS, "costs": [float(c) for c in costs]}))
    if solves:
        for label, name in SPECS.items():
            _spec, kind, make, nl, li, _form, _layout = cs.GRAPH_SPECS[label]
            sdims, sinputs = make(cs.SPEC_SIDE)
            r = plan(getattr(specs, name), kind, sdims).solve(dict(sinputs), nIterations=nl,
                                                               lIterations=li)
            print(json.dumps({"solve": label, **tag, "costs": [float(c) for c in r.costs],
                              "lin_iters": int(np.sum(r.num_linear_iterations))}))


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3] == "f64", "--solves" in sys.argv)
        return 0
    import chip_smoke as cs
    import opt_tpu_torch as ot
    from opt_tpu_torch.models.specs import embedded_mesh_deformation

    _dims, inputs = cs.cotangent_inputs(cs.SPEC_SIDE)
    g = inputs["G"]
    weights = {}
    for dt in (np.float32, np.float64):
        x = inputs["X"].astype(dt)
        with np.errstate(all="ignore"):
            nrm = [x[g[a]] - x[g[b]] for a, b in (("v0", "v2"), ("v1", "v2"), ("v0", "v3"),
                                                   ("v1", "v3"))]
            nrm = [v / np.sqrt((v * v).sum(-1, keepdims=True)) for v in nrm]
            cots, discs = [], []
            for u, v in ((nrm[0], nrm[1]), (nrm[2], nrm[3])):
                ab = (u * v).sum(-1)
                disc = (u * u).sum(-1) * (v * v).sum(-1) - ab * ab
                discs.append(disc)
                cots.append(ab / np.sqrt(np.where(disc > 0, disc, dt(1e-4))))
            w = dt(0.5) * (cots[0] + cots[1])
        weights[dt] = (np.where(w > 0, w, dt(1e-4)), np.fmin(discs[0], discs[1]))
    (w32, d32), (w64, d64) = weights[np.float32], weights[np.float64]
    top = np.argsort(-np.nan_to_num(w32))[:5]
    print(json.dumps({"cotangent_discriminants": "cotangent10k", "edges": int(w64.shape[0]),
                      "float64_below_1e-6": int((d64 < 1e-6).sum()),
                      "float32_below_1e-6": int((d32 < 1e-6).sum()),
                      "largest_float32_weights": w32[top].tolist(),
                      "their_float64_weights": w64[top].tolist(),
                      "their_float32_discriminants": d32[top].tolist(),
                      "their_float64_discriminants": d64[top].tolist()}))
    edims, einputs = cs.embedded_inputs(30)
    meta = ot.Problem(embedded_mesh_deformation, kind="LMGPU").plan(
        dims=edims, device="cpu").cg_inputs(dict(einputs))[0]
    nz = meta["rem"]["blk"] != 0
    print(json.dumps({"embedded_block_zeros": "embedded 30x30", "blocks": int(nz.shape[0]),
                      "non_zero_share": float(nz.float().mean()),
                      "positions_ever_non_zero": int(nz.any(0).sum()),
                      "of": int(nz[0].numel()), "channels": {k: int(v) for k, v in
                                                           meta["offs"].items()}}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for pkg in ("port", "jax"):
        for prec in ("f32", "f64"):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", pkg, prec]
            cmd += ["--solves"] if "--solves" in sys.argv else []
            out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                                 check=True)
            sys.stdout.write("".join(line + "\n" for line in out.stdout.splitlines()
                                     if line.startswith("{")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
