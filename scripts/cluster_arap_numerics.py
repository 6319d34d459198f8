#!/usr/bin/env python3
"""The JAX package's solve of chip_smoke.py's ARAP with rotation clusters
(cluster_arap_spec at cluster_arap_inputs(ARAP_SIDE, CLUSTER): 36,864
vertices, 576 clusters), GN GRAPH_NL x GRAPH_LI on the CPU, in float32 and
float64: what chip_smoke.py's JAX_CPU_CLUSTER_COSTS pins.

    JAX_PLATFORMS=cpu python3 scripts/cluster_arap_numerics.py

Prints one JSON line per precision: each step's cost, the CG count and the
seconds. Each precision runs in its own process (jax_enable_x64 is
global); about 30 s in all."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def solve(precision: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    f64 = precision == "float64"
    if f64:
        jax.config.update("jax_enable_x64", True)
    import opt_tpu as ot

    from chip_smoke import (ARAP_SIDE, CLUSTER, GRAPH_LI, GRAPH_NL, cluster_arap_inputs,
                            cluster_arap_spec)

    if f64:
        ot.enable_double_precision()
    dims, inputs = cluster_arap_inputs(ARAP_SIDE, CLUSTER)
    t0 = time.perf_counter()
    res = ot.Problem(cluster_arap_spec(ot)).plan(dims=dims, double_precision=f64).solve(
        dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
    return {"package": "jax", "precision": precision, "dims": dims,
            "fit_vertices": int(len(inputs["H"]["c"])), "costs": [float(c) for c in res.costs],
            "lin_iters": int(res.num_linear_iterations), "seconds": time.perf_counter() - t0}


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(solve(sys.argv[1])), flush=True)
        return 0
    for precision in ("float32", "float64"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), precision],
                             capture_output=True, text=True, check=True)
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
