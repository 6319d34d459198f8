"""Bundled energy specs, written against ``opt_tpu_torch``.

Spec functions are backend code (they call the DSL's tensor helpers), so
the port carries its own copies of the JAX package's ``models/specs.py``.
This has the two specs of the poisson path, image_warping, the 3-D grid
spec volumetric_mesh_deformation, and the graph specs
arap_mesh_deformation and curve_fitting; the other six come with ROADMAP.md
queue 1 item 9.
"""

from __future__ import annotations

import torch

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
# tests/minimal_graph_only/curveFitting.t: y = a cos(bx) + b sin(ax)
# ---------------------------------------------------------------------------
def curve_fitting(S):
    N, U = S.Dim("N"), S.Dim("U")
    funcParams = S.Unknown("funcParams", 2, (U,))
    data = S.Image("data", 2, (N,))
    G = S.Graph("G", d=(N,), p=(U,))
    S.UsePreconditioner(True)
    x, y = data(G.d)[..., 0], data(G.d)[..., 1]
    a, b = funcParams(G.p)[..., 0], funcParams(G.p)[..., 1]
    S.Energy(y - (a * torch.cos(b * x) + b * torch.sin(a * x)))


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


# ---------------------------------------------------------------------------
# examples/volumetric_mesh_deformation/volumetric_mesh_deformation.t — 3D ARAP
# ---------------------------------------------------------------------------
def volumetric_mesh_deformation(S):
    W, H, D = S.Dim("W"), S.Dim("H"), S.Dim("D")
    Offset = S.Unknown("Offset", 3, (W, H, D))
    Angle = S.Unknown("Angle", 3, (W, H, D))
    UrShape = S.Array("UrShape", 3, (W, H, D))
    Constraints = S.Array("Constraints", 3, (W, H, D))
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrt = S.Param("w_regSqrt")
    S.UsePreconditioner(True)

    e_fit = Offset(0, 0, 0) - Constraints(0, 0, 0)
    valid = ot.greatereq(Constraints(0, 0, 0)[..., 0:1], -999999.9)
    S.Energy(ot.Select(valid, w_fitSqrt * e_fit, 0.0))

    for i, j, k in ot.Stencil(
        [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    ):
        arap = (Offset(0, 0, 0) - Offset(i, j, k)) - ot.Rotate3D(
            Angle(0, 0, 0), UrShape(0, 0, 0) - UrShape(i, j, k)
        )
        arapF = ot.Select(
            ot.InBounds(0, 0, 0), ot.Select(ot.InBounds(i, j, k), arap, 0.0), 0.0
        )
        S.Energy(w_regSqrt * arapF)


# ---------------------------------------------------------------------------
# examples/arap_mesh_deformation/arap_mesh_deformation.t — graph ARAP
# ---------------------------------------------------------------------------
def arap_mesh_deformation(S):
    N = S.Dim("N")
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrt = S.Param("w_regSqrt")
    Offset = S.Unknown("Offset", 3, (N,))
    Angle = S.Unknown("Angle", 3, (N,))
    UrShape = S.Array("UrShape", 3, (N,))
    Constraints = S.Array("Constraints", 3, (N,))
    G = S.Graph("G", v0=(N,), v1=(N,))
    S.UsePreconditioner(True)

    e_fit = Offset(0) - Constraints(0)
    valid = ot.greatereq(Constraints(0)[..., 0:1], -999999.9)
    S.Energy(ot.Select(valid, w_fitSqrt * e_fit, 0.0))

    arap = (Offset(G.v0) - Offset(G.v1)) - ot.Rotate3D(
        Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
    )
    S.Energy(w_regSqrt * arap)


ALL_SPECS = {
    "laplacian": laplacian,
    "curve_fitting": curve_fitting,
    "poisson_image_editing": poisson_image_editing,
    "image_warping": image_warping,
    "volumetric_mesh_deformation": volumetric_mesh_deformation,
    "arap_mesh_deformation": arap_mesh_deformation,
}
