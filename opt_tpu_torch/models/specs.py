"""Bundled energy specs, written against ``opt_tpu_torch``.

Spec functions are backend code (they call the DSL's tensor helpers), so
the port carries its own copies of the JAX package's ``models/specs.py``.
It has all twelve, in the JAX file's order: the grid specs (laplacian,
poisson_image_editing, image_warping, optical_flow,
intrinsic_image_decomposition, shape_from_shading and the 3-D
volumetric_mesh_deformation) and the graph specs (curve_fitting,
arap_mesh_deformation, cotangent_mesh_smoothing,
embedded_mesh_deformation and robust_nonrigid_alignment).
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
# examples/optical_flow/optical_flow.t — dense flow with sampled image
# ---------------------------------------------------------------------------
def optical_flow(S):
    W, H = S.Dim("W"), S.Dim("H")
    w_fitSqrt = S.Param("w_fit")
    w_regSqrt = S.Param("w_reg")
    X = S.Unknown("X", 2, (W, H))
    I = S.Array("I", 1, (W, H))
    I_hat_im = S.Array("I_hat", 1, (W, H))
    I_hat_dx = S.Array("I_hat_dx", 1, (W, H))
    I_hat_dy = S.Array("I_hat_dy", 1, (W, H))
    I_hat = S.SampledImage(I_hat_im, I_hat_dx, I_hat_dy)

    i, j = S.Index(0), S.Index(1)
    S.UsePreconditioner(False)
    e_fit = w_fitSqrt * (
        I(0, 0) - I_hat(i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1])
    )
    S.Energy(e_fit)
    for nx, ny in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e_reg = w_regSqrt * (X(0, 0) - X(nx, ny))
        S.Energy(ot.Select(ot.InBounds(nx, ny), e_reg, 0.0))


# ---------------------------------------------------------------------------
# examples/intrinsic_image_decomposition/intrinsic_image_decomposition.t
# ---------------------------------------------------------------------------
def intrinsic_image_decomposition(S):
    W, H = S.Dim("W"), S.Dim("H")
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrtAlbedo = S.Param("w_regSqrtAlbedo")
    w_regSqrtShading = S.Param("w_regSqrtShading")
    pNorm = S.Param("pNorm")
    r = S.Unknown("r", 3, (W, H))
    # const view of the unknown (the reference binds r_const to r's buffer)
    r_const = S.Array("r_const", 3, (W, H), alias="r")
    i = S.Array("i", 3, (W, H))
    s = S.Unknown("s", 1, (W, H))

    for x, y in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        diff = r(0, 0) - r(x, y)
        diff_const = r_const(0, 0) - r_const(x, y)
        laplacianCost = ot.L_p(diff, diff_const, pNorm, (W, H))
        laplacianCostF = ot.Select(
            ot.InBounds(0, 0), ot.Select(ot.InBounds(x, y), laplacianCost, 0.0), 0.0
        )
        S.Energy(w_regSqrtAlbedo * laplacianCostF)

    for x, y in ot.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        diff = s(0, 0) - s(x, y)
        laplacianCostF = ot.Select(
            ot.InBounds(0, 0), ot.Select(ot.InBounds(x, y), diff, 0.0), 0.0
        )
        S.Energy(w_regSqrtShading * laplacianCostF)

    fittingCost = r(0, 0) + s(0, 0) - i(0, 0)
    S.Energy(w_fitSqrt * fittingCost)


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


# ---------------------------------------------------------------------------
# examples/cotangent_mesh_smoothing/cotangent_mesh_smoothing.t
# ---------------------------------------------------------------------------
def cotangent_mesh_smoothing(S):
    N = S.Dim("N")
    w_fitSqrt = S.Param("w_fit")
    w_regSqrt = S.Param("w_reg")
    X = S.Unknown("X", 3, (N,))
    A = S.Array("A", 3, (N,))
    G = S.Graph("G", v0=(N,), v1=(N,), v2=(N,), v3=(N,))
    S.UsePreconditioner(True)

    def cot(v0, v1):
        adotb = ot.Dot3(v0, v1)
        disc = ot.Dot3(v0, v0) * ot.Dot3(v1, v1) - adotb * adotb
        disc = ot.Select(ot.greater(disc, 0.0), disc, 0.0001)
        return ot.Dot3(v0, v1) / ot.Sqrt(disc)

    S.Energy(w_fitSqrt * (X(0) - A(0)))

    a = ot.normalize(X(G.v0) - X(G.v2))
    b = ot.normalize(X(G.v1) - X(G.v2))
    c = ot.normalize(X(G.v0) - X(G.v3))
    d = ot.normalize(X(G.v1) - X(G.v3))
    w = 0.5 * (cot(a, b) + cot(c, d))
    w = ot.Sqrt(ot.Select(ot.greater(w, 0.0), w, 0.0001))
    S.Energy(w_regSqrt * w * (X(G.v1) - X(G.v0)))


# ---------------------------------------------------------------------------
# examples/embedded_mesh_deformation/embedded_mesh_deformation.t — float9 rot
# ---------------------------------------------------------------------------
def embedded_mesh_deformation(S):
    N = S.Dim("N")
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrt = S.Param("w_regSqrt")
    w_rotSqrt = S.Param("w_rotSqrt")
    Offset = S.Unknown("Offset", 3, (N,))
    RotMatrix = S.Unknown("RotMatrix", 9, (N,))
    UrShape = S.Image("UrShape", 3, (N,))
    Constraints = S.Image("Constraints", 3, (N,))
    G = S.Graph("G", v0=(N,), v1=(N,))
    S.UsePreconditioner(True)

    e_fit = Offset(0) - Constraints(0)
    valid = ot.greatereq(Constraints(0)[..., 0:1], -999999.9)
    S.Energy(ot.Select(valid, w_fitSqrt * e_fit, 0.0))

    R = RotMatrix(0)
    c0 = R[..., 0::3]  # column 0: entries 0,3,6
    c1 = R[..., 1::3]
    c2 = R[..., 2::3]
    S.Energy(w_rotSqrt * ot.Dot3(c0, c1))
    S.Energy(w_rotSqrt * ot.Dot3(c0, c2))
    S.Energy(w_rotSqrt * ot.Dot3(c1, c2))
    S.Energy(w_rotSqrt * (ot.Dot3(c0, c0) - 1.0))
    S.Energy(w_rotSqrt * (ot.Dot3(c1, c1) - 1.0))
    S.Energy(w_rotSqrt * (ot.Dot3(c2, c2) - 1.0))

    regCost = (Offset(G.v1) - Offset(G.v0)) - ot.Matrix3x3Mul(
        RotMatrix(G.v0), UrShape(G.v1) - UrShape(G.v0)
    )
    S.Energy(w_regSqrt * regCost)


# ---------------------------------------------------------------------------
# examples/robust_nonrigid_alignment/robust_nonrigid_alignment.t
# ---------------------------------------------------------------------------
def robust_nonrigid_alignment(S):
    N = S.Dim("N")
    w_fitSqrt = S.Param("w_fitSqrt")
    w_regSqrt = S.Param("w_regSqrt")
    w_confSqrt = 0.1
    Offset = S.Unknown("Offset", 3, (N,))
    Angle = S.Unknown("Angle", 3, (N,))
    RobustWeights = S.Unknown("RobustWeights", 1, (N,))
    UrShape = S.Array("UrShape", 3, (N,))
    Constraints = S.Array("Constraints", 3, (N,))
    ConstraintNormals = S.Array("ConstraintNormals", 3, (N,))
    G = S.Graph("G", v0=(N,), v1=(N,))
    S.UsePreconditioner(True)

    robustWeight = RobustWeights(0)
    e_fit = robustWeight * ot.Dot3(ConstraintNormals(0), Offset(0) - Constraints(0))
    # NB: the reference condition is a 3-vector (one per Constraints channel),
    # so the scalar e_fit/e_conf are broadcast to 3 identical residuals —
    # kept literally for final-energy parity (robust_nonrigid_alignment.t:18-25).
    validConstraint = ot.greatereq(Constraints(0), -999999.9)
    S.Energy(w_fitSqrt * ot.Select(validConstraint, e_fit, 0.0))

    e_conf = 1.0 - robustWeight * robustWeight
    e_conf = ot.Select(validConstraint, e_conf, 0.0)
    S.Energy(w_confSqrt * e_conf)

    arap = (Offset(G.v0) - Offset(G.v1)) - ot.Rotate3D(
        Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
    )
    S.Energy(w_regSqrt * arap)


# ---------------------------------------------------------------------------
# examples/shape_from_shading/shape_from_shading.t — SH shading + ComputedArray
# ---------------------------------------------------------------------------
DEPTH_DISCONTINUITY_THRE = 0.01


def shape_from_shading(S):
    W, H = S.Dim("W"), S.Dim("H")
    w_p = torch.sqrt(S.Param("w_p"))
    w_s = torch.sqrt(S.Param("w_s"))
    w_g = torch.sqrt(S.Param("w_g"))
    f_x, f_y = S.Param("f_x"), S.Param("f_y")
    u_x, u_y = S.Param("u_x"), S.Param("u_y")
    L = [S.Param(f"L_{i}") for i in range(1, 10)]
    X = S.Unknown("X", 1, (W, H))
    D_i = S.Array("D_i", 1, (W, H))
    Im = S.Array("Im", 1, (W, H))
    edgeMaskR = S.Array("edgeMaskR", 1, (W, H))
    edgeMaskC = S.Array("edgeMaskC", 1, (W, H))

    # NOTE: Index() must be *called inside* expressions that get inlined into
    # a ComputedArray (the call site picks up the composed stencil offset);
    # capturing it once at spec top level would freeze the centered
    # coordinates.
    def p(offX, offY):  # eq. 8: back-projected 3D point
        d = X(offX, offY)
        i = offX + S.Index(0)
        j = offY + S.Index(1)
        return torch.cat([((i - u_x) / f_x) * d, ((j - u_y) / f_y) * d, d], dim=-1)

    def normalAt(offX, offY):  # eq. 10
        i = offX + S.Index(0)
        j = offY + S.Index(1)
        n_x = X(offX, offY - 1) * (X(offX, offY) - X(offX - 1, offY)) / f_y
        n_y = X(offX - 1, offY) * (X(offX, offY) - X(offX, offY - 1)) / f_x
        n_z = (
            (n_x * (u_x - i) / f_x)
            + (n_y * (u_y - j) / f_y)
            - (X(offX - 1, offY) * X(offX, offY - 1) / (f_x * f_y))
        )
        sqLength = n_x * n_x + n_y * n_y + n_z * n_z
        inverseMagnitude = ot.Select(
            ot.greater(sqLength, 0.0),
            1.0 / torch.sqrt(torch.where(sqLength > 0, sqLength, 1.0)),
            1.0,
        )
        return inverseMagnitude * n_x, inverseMagnitude * n_y, inverseMagnitude * n_z

    def B(offX, offY):
        n_x, n_y, n_z = normalAt(offX, offY)
        return (
            L[0]
            + L[1] * n_y + L[2] * n_z + L[3] * n_x
            + L[4] * n_x * n_y + L[5] * n_y * n_z
            + L[6] * (-n_x * n_x - n_y * n_y + 2 * n_z * n_z)
            + L[7] * n_z * n_x + L[8] * (n_x * n_x - n_y * n_y)
        )

    def I(offX, offY):
        return Im(offX, offY) * 0.5 + 0.25 * (Im(offX - 1, offY) + Im(offX, offY - 1))

    def DepthValid(x, y):
        return ot.greater(D_i(x, y), 0)

    def B_I_expr():
        bi = B(0, 0) - I(0, 0)
        valid = ot.And(DepthValid(-1, 0), DepthValid(0, 0), DepthValid(0, -1))
        return ot.Select(ot.And(ot.InBoundsExpanded(0, 0, 1), valid), bi, 0.0)

    B_I = S.ComputedArray("B_I", (W, H), B_I_expr)

    S.Exclude(ot.Not(DepthValid(0, 0)))

    E_p = X(0, 0) - D_i(0, 0)
    S.Energy(ot.Select(DepthValid(0, 0), w_p * E_p, 0.0))

    E_g_h = (B_I(0, 0) - B_I(1, 0)) * edgeMaskR(0, 0)
    E_g_v = (B_I(0, 0) - B_I(0, 1)) * edgeMaskC(0, 0)
    S.Energy(ot.Select(ot.InBoundsExpanded(0, 0, 1), w_g * E_g_h, 0.0))
    S.Energy(ot.Select(ot.InBoundsExpanded(0, 0, 1), w_g * E_g_v, 0.0))

    def Continuous(x, y):
        return ot.less(torch.abs(X(0, 0) - X(x, y)), DEPTH_DISCONTINUITY_THRE)

    def valid_expr():
        return ot.And(
            DepthValid(0, 0), DepthValid(0, -1), DepthValid(0, 1),
            DepthValid(-1, 0), DepthValid(1, 0),
            Continuous(0, -1), Continuous(0, 1),
            Continuous(-1, 0), Continuous(1, 0),
            ot.InBoundsExpanded(0, 0, 1),
        )

    validArray = S.ComputedArray("valid", (W, H), valid_expr)
    valid = ot.eq(validArray(0, 0), 1)
    E_s = 4.0 * p(0, 0) - (p(-1, 0) + p(0, -1) + p(1, 0) + p(0, 1))
    S.Energy(ot.Select(valid, w_s * E_s, 0.0))


ALL_SPECS = {
    "laplacian": laplacian,
    "curve_fitting": curve_fitting,
    "poisson_image_editing": poisson_image_editing,
    "image_warping": image_warping,
    "optical_flow": optical_flow,
    "intrinsic_image_decomposition": intrinsic_image_decomposition,
    "volumetric_mesh_deformation": volumetric_mesh_deformation,
    "arap_mesh_deformation": arap_mesh_deformation,
    "cotangent_mesh_smoothing": cotangent_mesh_smoothing,
    "embedded_mesh_deformation": embedded_mesh_deformation,
    "robust_nonrigid_alignment": robust_nonrigid_alignment,
    "shape_from_shading": shape_from_shading,
}
