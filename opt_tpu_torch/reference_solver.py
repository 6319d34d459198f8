"""Independent reference solver, the Ceres-comparison analogue.

PyTorch counterpart of ``opt_tpu/reference_solver.py``. The reference's
correctness oracle is cross-solver final-cost agreement: every example can
run the same problem through Opt (GN), Opt (LM) and a CPU Ceres solver and
compare final energies (examples/shared/CombinedSolverBase.h:62-65,
CeresSolverBase.h). Here the independent solver is
``scipy.optimize.least_squares`` (TRF, the trust-region family of Ceres),
fed the same energy through this package's compiled residual function on
the CPU, float32, with the sparse Jacobian of ``jacobian.dump_jacobian``,
and optimized entirely by scipy's own algorithm. It is a test oracle,
never on a solve's path.

Scope: small problems. Excluded unknowns are held at their initial values
(the solver's semantics: excluded rows never update), so the oracle
optimizes the same free variables as the solver.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def solve_scipy(spec_fn, dims: Dict[str, int], inputs: Dict[str, Any], max_nfev: int = 200,
                method: str = "trf"):
    """Run the energy through scipy.optimize.least_squares. Returns
    (final_cost, {unknown: numpy array}); the cost is ½ Σ r² over the
    non-excluded residual centres, as the solver's."""
    from scipy import sparse
    from scipy.optimize import least_squares

    from .compile import compile_spec
    from .functions import FunctionSet
    from .jacobian import dump_jacobian

    compiled = compile_spec(spec_fn, dims, torch.float32)
    unknowns, consts, graphs, params = compiled.normalize_inputs(inputs, device="cpu")
    fs = FunctionSet(compiled, consts, graphs, params)
    excl, row_masks = fs.masks(unknowns)

    names = list(compiled.unknown_names)
    shapes = {u: tuple(unknowns[u].shape) for u in names}
    sizes = {u: int(np.prod(shapes[u])) for u in names}
    # excluded unknowns stay at their initial values
    free = np.concatenate([
        np.ones(sizes[u], bool) if row_masks.get(u) is None
        else np.broadcast_to(row_masks[u].numpy() != 0, shapes[u]).reshape(-1)
        for u in names])

    def unpack(x):
        out, o = {}, 0
        for u in names:
            out[u] = torch.as_tensor(np.asarray(x[o : o + sizes[u]], np.float32)).reshape(shapes[u])
            o += sizes[u]
        return out

    # the cost masks squares by (1 - m): residuals scale by its square root
    scales = []
    for term, val in zip(compiled.terms, fs.F(unknowns)):
        m = compiled.term_cost_mask(term, excl)
        s = np.ones(tuple(val.shape), np.float64) if m is None else np.broadcast_to(
            np.sqrt(np.maximum(1.0 - m.double().numpy(), 0.0)), tuple(val.shape))
        scales.append(s.reshape(-1))
    row_scale = np.concatenate(scales)

    x0 = np.concatenate([unknowns[u].double().numpy().reshape(-1) for u in names])

    def embed(xf):
        x = x0.copy()
        x[free] = xf
        return x

    def resid(xf):
        with torch.no_grad():
            terms = fs.F(unpack(embed(xf)))
        return np.concatenate([t.double().numpy().reshape(-1) for t in terms]) * row_scale

    def jac(xf):
        d = dump_jacobian(compiled, unpack(embed(xf)), consts, graphs, params)
        J = sparse.coo_matrix(
            (np.asarray(d["vals"], np.float64) * row_scale[d["rows"]], (d["rows"], d["cols"])),
            shape=d["shape"]).tocsr()
        return J[:, free]

    res = least_squares(resid, x0[free], jac=jac, method=method, tr_solver="lsmr",
                        max_nfev=max_nfev)
    final_cost = 0.5 * float(np.sum(res.fun ** 2))
    x_full = embed(res.x)
    out, o = {}, 0
    for u in names:
        out[u] = np.asarray(x_full[o : o + sizes[u]], np.float32).reshape(shapes[u])
        o += sizes[u]
    return final_cost, out
