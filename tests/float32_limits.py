"""What float32 can hold in a parity test, derived from the float64 problem.

A parity test that compares two float32 results (the port's and the JAX
package's, or two loops of the port) at a tolerance below the float32
rounding of the problem fails on one host and passes on another: the
results part by their sum orders, which the host's vector units and
libraries choose. Such a test holds its property twice:

* in float64, at the test's tight tolerance, where the sum order moves
  nothing the tolerance can see (the JAX side in a process of its own,
  :func:`jax_float64`, as ``jax_enable_x64`` is process-global);
* in float32, each result against the float64 one, by a bound derived
  here from the float64 problem.

The bounds:

* :func:`cg_bound`: a PCG solve that leaves at its rz floor after k
  iterations on an operator whose Jacobi-scaled condition number is κ
  carries each iteration's float32 rounding (u = 2⁻²⁴ relative) amplified by
  at most κ: its step lies within k·κ·u of the float64 solve's, relative to
  the step's largest entry, and the cost after the step within k·κ·u of the
  float64 cost (first order in u). κ comes from the dense float64 Jacobian
  (:func:`jacobi_condition`); an LM system's damping only lowers it.
* :func:`capped_cg_reach`: a solve whose CG stops at its iteration cap
  before its rz floor. Its float32 rounding delays the convergence of CG
  (finite-precision CG follows exact CG on a nearby problem, later:
  Greenbaum 1989), so its capped step is the float64 one of fewer
  iterations; up to one fewer a step, the float64 solve capped one lower
  bounds that part. To it adds the k·κ·u reach above, relative to the
  whole solve's largest move of an unknown.
* the cotangent weights' bound is derived where it is used
  (``tests/test_torch_graph_specs.py``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

U32 = 2.0 ** -24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jacobi_condition(J) -> float:
    """κ₂ of D^-½ JᵀJ D^-½ (D = diag(JᵀJ)) for a dense float64 Jacobian J
    [rows, unknowns], over the unknowns that some residual reads."""
    A = np.asarray(J, np.float64).T @ np.asarray(J, np.float64)
    d = np.diag(A)
    keep = d > 0
    A = A[np.ix_(keep, keep)] / np.sqrt(np.outer(d[keep], d[keep]))
    ev = np.linalg.eigvalsh(A)
    return float(ev[-1] / ev[0])


def cg_bound(iterations: int, kappa: float) -> float:
    """k·κ·u: the relative float32 reach of a PCG solve of k iterations."""
    return float(iterations) * float(kappa) * U32


def capped_cg_reach(iterations: int, kappa: float, move: float, one_fewer: float) -> float:
    """The float32 reach of a solve capped below its rz floor: k·κ·u times
    ``move`` (the float64 solve's largest move of an unknown from its
    inputs) plus ``one_fewer``, the largest difference between the float64
    solve and the same solve capped one CG iteration a step lower."""
    return cg_bound(iterations, kappa) * float(move) + float(one_fewer)


def jax_float64(module: str, func: str) -> dict:
    """``module.func()`` (a dict of arrays) run in a fresh process with the
    JAX package in float64 on the CPU; returns its arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.npz")
        code = (
            "import importlib, jax, numpy as np\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', True)\n"
            "import opt_tpu as ot\n"
            "ot.enable_double_precision()\n"
            f"res = getattr(importlib.import_module({module!r}), {func!r})()\n"
            f"np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}
