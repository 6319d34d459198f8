"""Double-precision solves through opt_tpu_torch (the reference's
OPT_DOUBLE_PRECISION path; tests/test_double_precision.py on the port):
the curve fit LM 15x40 at N = 256 in float64 converges past float32's floor
to the true parameters, and agrees with the JAX package's float64 fit; a
float64 laplacian solve through api.new_state(double_precision=True)
agrees with the JAX package's. The JAX side runs in one subprocess, because
jax x64 is process-global; the port flips no global."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import opt_tpu_torch as ott
import opt_tpu_torch.api as torch_api
from opt_tpu_torch.models.specs import curve_fitting, laplacian

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
LAP_N = 16


def curve_inputs(N):
    rng = np.random.RandomState(1)
    xs = rng.rand(N) * 0.1
    ys = 100.0 * np.cos(102.0 * xs) + 102.0 * np.sin(100.0 * xs)
    return {
        "funcParams": np.array([[99.7, 102.3]], np.float64),
        "data": np.stack([xs, ys], -1),
        "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)},
    }


def laplacian_inputs(n):
    rng = np.random.RandomState(2)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


# the JAX side, given the same inputs (the two functions above, by source)
_SCRIPT = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import opt_tpu as ot
import opt_tpu.api as api
from opt_tpu.models.specs import curve_fitting, laplacian


def main():
    ot.enable_double_precision()
    plan = ot.Problem(curve_fitting, kind="LMGPU").plan(dims={{"N": {N}, "U": 1}},
                                                         double_precision=True)
    res = plan.solve(curve_inputs({N}), nIterations=15, lIterations=40)
    state = api.new_state(double_precision=True)
    lap = api.problem_plan(state, api.problem_define(state, laplacian), {{"W": {n}, "H": {n}}})
    api.set_solver_parameter(lap, "nIterations", 2)
    api.set_solver_parameter(lap, "lIterations", 20)
    api.problem_init(lap, laplacian_inputs({n}))
    while api.problem_step(lap):
        pass
    print(json.dumps({{"params": np.asarray(res.unknowns["funcParams"])[0].tolist(),
                       "dtype": str(res.unknowns["funcParams"].dtype),
                       "final_cost": float(res.final_cost),
                       "laplacian_cost": float(api.problem_current_cost(lap))}}))
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    script = tmp_path_factory.mktemp("jax_f64") / "jax_f64.py"
    script.write_text(_SCRIPT.format(repo=REPO, N=N, n=LAP_N) + "\n"
                      + inspect.getsource(curve_inputs) + inspect.getsource(laplacian_inputs)
                      + "\nmain()\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_double_precision_curve_fit(jax_out):
    assert jax_out["dtype"] == "float64"

    plan = ott.Problem(curve_fitting, kind="LMGPU").plan(dims={"N": N, "U": 1}, device="cpu",
                                                         double_precision=True)
    res = plan.solve(curve_inputs(N), nIterations=15, lIterations=40)
    assert res.unknowns["funcParams"].dtype == torch.float64
    got = res.unknowns["funcParams"].numpy()[0]
    assert abs(got[0] - 100.0) < 1e-5 and abs(got[1] - 102.0) < 1e-5, got
    # double precision converges past float32's floor on this problem
    assert res.final_cost < 1e-15, res.final_cost
    np.testing.assert_allclose(got, jax_out["params"], rtol=0, atol=1e-9)


def test_double_precision_api_state_laplacian(jax_out):
    state = torch_api.new_state(double_precision=True, device="cpu")
    lap = torch_api.problem_plan(state, torch_api.problem_define(state, laplacian),
                                 {"W": LAP_N, "H": LAP_N})
    torch_api.set_solver_parameter(lap, "nIterations", 2)
    torch_api.set_solver_parameter(lap, "lIterations", 20)
    torch_api.problem_init(lap, laplacian_inputs(LAP_N))
    while torch_api.problem_step(lap):
        pass
    assert lap.unknowns["X"].dtype == torch.float64
    np.testing.assert_allclose(torch_api.problem_current_cost(lap), jax_out["laplacian_cost"],
                               rtol=1e-9)
