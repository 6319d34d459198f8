"""Bundled energy specs, written against ``opt_tpu_torch``.

Spec functions are backend code (they call the DSL's tensor helpers), so
the port carries its own copies of the JAX package's ``models/specs.py``.
This has the two specs of the poisson path and image_warping; the other
nine come with ROADMAP.md queue 1 item 9.
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


# ---------------------------------------------------------------------------
# examples/image_warping/image_warping.t — 2D ARAP warp
# ---------------------------------------------------------------------------
def image_warping(S):
    W, H = S.Dim("W"), S.Dim("H")
    Offset = S.Unknown("Offset", 2, (W, H))
    Angle = S.Unknown("Angle", 1, (W, H))
    UrShape = S.Array("UrShape", 2, (W, H))
    Constraints = S.Array("Constraints", 2, (W, H))
    Mask = S.Array("Mask", 1, (W, H))
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrt = S.Param("w_regSqrt")

    S.UsePreconditioner(True)
    S.Exclude(ot.Not(ot.eq(Mask(0, 0), 0)))

    for dx, dy in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e_reg = w_regSqrt * (
            (Offset(0, 0) - Offset(dx, dy))
            - ot.Rotate2D(Angle(0, 0), UrShape(0, 0) - UrShape(dx, dy))
        )
        valid = ot.And(
            ot.InBounds(dx, dy), ot.eq(Mask(dx, dy), 0), ot.eq(Mask(0, 0), 0)
        )
        S.Energy(ot.Select(valid, e_reg, 0.0))

    e_fit = Offset(0, 0) - Constraints(0, 0)
    valid = ot.All(ot.greatereq(Constraints(0, 0), 0))
    S.Energy(w_fitSqrt * ot.Select(valid, e_fit, 0.0))


ALL_SPECS = {
    "laplacian": laplacian,
    "poisson_image_editing": poisson_image_editing,
    "image_warping": image_warping,
}
