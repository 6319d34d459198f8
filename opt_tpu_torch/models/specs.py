"""Bundled energy specs, written against ``opt_tpu_torch``.

Spec functions are backend code (they call the DSL's tensor helpers), so
the port carries its own copies of the JAX package's ``models/specs.py``.
This slice has the two specs of the main path; the other ten come with
ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import opt_tpu_torch as ot


# ---------------------------------------------------------------------------
# tests/minimal/laplacian.t
# ---------------------------------------------------------------------------
def laplacian(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    w_fit = 0.2
    S.Energy(
        w_fit * (X(0, 0) - A(0, 0)),
        X(0, 0) - X(1, 0),
        X(0, 0) - X(0, 1),
    )


# ---------------------------------------------------------------------------
# examples/poisson_image_editing/poisson_image_editing.t
# ---------------------------------------------------------------------------
def poisson_image_editing(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 4, (W, H))
    T = S.Array("T", 4, (W, H))
    M = S.Array("M", 1, (W, H))
    S.UsePreconditioner(False)
    S.Exclude(ot.Not(ot.eq(M(0, 0), 0)))
    for dx, dy in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e = (X(0, 0) - X(dx, dy)) - (T(0, 0) - T(dx, dy))
        S.Energy(ot.Select(ot.InBounds(dx, dy), e, 0.0))


ALL_SPECS = {
    "laplacian": laplacian,
    "poisson_image_editing": poisson_image_editing,
}
