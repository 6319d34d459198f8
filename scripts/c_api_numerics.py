#!/usr/bin/env python3
"""The JAX package's solve of chip_smoke.py's C API phase: the port's C
client (opt_tpu_torch/native/client.c) at each of C_API_SIZES, GN
C_API_NL x C_API_LI on the CPU (OPT_TPU_TORCH_DEVICE=cpu), then the same
solve through opt_tpu.api (init, then step until it returns 0) on the A the
client wrote: what chip_smoke.py's JAX_CPU_C_API pins.

    JAX_PLATFORMS=cpu python3 scripts/c_api_numerics.py

Prints one JSON line a size: the first 16 hex digits of the SHA-256 of A's
bytes (the client draws A with srand(42) and rand()), the JAX package's
final cost, the client's, and their relative difference. About 30 s."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import opt_tpu.api as api
    from chip_smoke import C_API_LI, C_API_NL, C_API_SIZES, C_API_SPEC
    from opt_tpu_torch.native.build import build_native, run_client

    build_native()
    for n in C_API_SIZES:
        with tempfile.TemporaryDirectory() as tmp:
            run = run_client(n, n, C_API_NL, C_API_LI, os.path.join(tmp, "out.bin"), device="cpu")
        if run["rc"] != 0 or "PASS" not in run["stdout"]:
            raise RuntimeError(f"client at {n}x{n}: rc {run['rc']}\n{run['stdout']}{run['stderr']}")
        A = run["A"]
        state = api.new_state()
        problem = api.problem_define(state, os.path.join(ROOT, C_API_SPEC))
        plan = api.problem_plan(state, problem, {"W": n, "H": n})
        api.set_solver_parameter(plan, "nIterations", C_API_NL)
        api.set_solver_parameter(plan, "lIterations", C_API_LI)
        api.problem_init(plan, {"X": A.copy(), "A": A.copy()})
        while api.problem_step(plan):
            pass
        jax_cost = float(np.float32(api.problem_current_cost(plan)))
        print(json.dumps({"n": n, "a_sha256": hashlib.sha256(A.tobytes()).hexdigest()[:16],
                          "jax_final_cost": jax_cost, "client_cpu_final_cost": run["final_cost"],
                          "rel_diff": abs(run["final_cost"] - jax_cost) / jax_cost}), flush=True)


if __name__ == "__main__":
    main()
