"""DSL standard library — the helpers visible in reference energy specs.

PyTorch counterpart of ``opt_tpu/lib.py`` (the reference's lib.t):
``Select``, ``All/Any/Not``, comparison helpers, ``Rotate2D/3D``, vector
math and robust norms, on tensors with a trailing channel axis.

Module-level ``InBounds``/``InBoundsExpanded``/``Index``/``Energy`` etc.
delegate to the spec builder currently running, so reference-style specs
port with minimal edits.
"""

from __future__ import annotations

import torch

from .spec import current_builder


def _t(v):
    return v if isinstance(v, torch.Tensor) else torch.tensor(v)


def _as_bool(v):
    v = _t(v)
    return v if v.dtype == torch.bool else v != 0


# ---------------------------------------------------------------------------
# logic / comparison
# ---------------------------------------------------------------------------


def Select(cond, a, b):
    """Elementwise cond ? a : b with broadcasting (reference ad.select).

    The double-``where`` form: each tensor operand is select-guarded before
    the outer select, so the untaken side passes neither values nor
    gradients. Reference apps fill invalid constraints with ±inf and gate on
    finite thresholds; a plain ``torch.where`` would forward the value
    correctly but let the untaken ±inf poison the derivative (0·inf = NaN in
    the product rules), exactly as under ``jnp.where``. A Python-number
    operand carries no derivative and stays a scalar (no device copy)."""
    cond = _as_bool(cond)
    a_g = torch.where(cond, a, 0.0) if isinstance(a, torch.Tensor) else a
    b_g = torch.where(cond, 0.0, b) if isinstance(b, torch.Tensor) else b
    return torch.where(cond, a_g, b_g)


def All(v):
    """Conjunction over the channel axis, keepdims (lib.t All)."""
    return torch.all(_as_bool(v), dim=-1, keepdim=True)


def Any(v):
    return torch.any(_as_bool(v), dim=-1, keepdim=True)


def And(*args):
    out = None
    for a in args:
        a = _as_bool(a)
        out = a if out is None else out & a
    return out


def Or(*args):
    out = None
    for a in args:
        a = _as_bool(a)
        out = a if out is None else out | a
    return out


def Not(v):
    return ~_as_bool(v)


def eq(a, b):
    return _t(a) == b


def neq(a, b):
    return _t(a) != b


def greater(a, b):
    return _t(a) > b


def less(a, b):
    return _t(a) < b


def greatereq(a, b):
    return _t(a) >= b


def lesseq(a, b):
    return _t(a) <= b


# ---------------------------------------------------------------------------
# vector / matrix math (lib.t:66-104)
# ---------------------------------------------------------------------------


def Dot(a, b):
    return torch.sum(_t(a) * b, dim=-1, keepdim=True)


Dot3 = Dot


def Slice(v, lo: int, hi: int):
    """Channel sub-range of a vector value (reference lib.t Slice)."""
    return _t(v)[..., int(lo) : int(hi)]


def Reduce(v):
    """Sum over the channel axis, keepdims (reference lib.t Reduce)."""
    return torch.sum(_t(v), dim=-1, keepdim=True)


def length(v, axis=-1):
    return torch.sqrt(torch.sum(v * v, dim=axis, keepdim=True))


def normalize(v):
    return v / length(v)


def Sqrt(v):
    return torch.sqrt(v)


def Rotate2D(angle, v):
    """2D rotation of channel-pair vectors by per-pixel angle (lib.t:92-96).

    angle: [..., 1]; v: [..., 2].
    """
    a = angle[..., 0] if angle.shape[-1] == 1 else angle
    ca, sa = torch.cos(a), torch.sin(a)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([ca * x - sa * y, sa * x + ca * y], dim=-1)


def RotationMatrix3D(angles):
    """Euler-angle rotation matrix [..., 3, 3], composed as lib.t:77-91."""
    alpha, beta, gamma = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, cb, cg = torch.cos(alpha), torch.cos(beta), torch.cos(gamma)
    sa, sb, sg = torch.sin(alpha), torch.sin(beta), torch.sin(gamma)
    rows = [
        torch.stack([cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca], -1),
        torch.stack([sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca], -1),
        torch.stack([-sb, cb * sa, cb * ca], -1),
    ]
    return torch.stack(rows, dim=-2)


def Rotate3D(angles, v):
    """Rotate [...,3] vectors by per-element Euler angles [...,3] (lib.t:77-91)."""
    return torch.einsum("...ij,...j->...i", RotationMatrix3D(angles), v)


def Matrix3x3Mul(m, v):
    """m: [..., 9] row-major 3x3; v: [..., 3] (lib.t Matrix3x3Mul)."""
    R = m.reshape(m.shape[:-1] + (3, 3))
    return torch.einsum("...ij,...j->...i", R, v)


# ---------------------------------------------------------------------------
# robust norms (lib.t:98-114)
# ---------------------------------------------------------------------------


def L_2_norm(v):
    return length(v)


def L_p(val, val_const, p, dims=None):
    """Robust p-norm residual weighting (lib.t:105-114): the weight
    sqrt((‖val_const‖+eps)^(p-2)) is constant during a nonlinear iteration
    (``detach``); `dims` is accepted for spec portability and ignored."""
    del dims
    eps = 1e-7
    dist = torch.sqrt(torch.sum(val_const * val_const, dim=-1, keepdim=True))
    w = torch.sqrt(torch.pow(dist + eps, p - 2.0))
    return w.detach() * val


# ---------------------------------------------------------------------------
# builder-contextual helpers (module-level versions of SpecBuilder methods)
# ---------------------------------------------------------------------------


def InBounds(*off):
    return current_builder().InBounds(*off)


def InBoundsExpanded(*args):
    return current_builder().InBoundsExpanded(*args)


def Index(axis, dims=None):
    return current_builder().Index(axis, dims)


def Energy(*terms):
    return current_builder().Energy(*terms)


def Exclude(cond):
    return current_builder().Exclude(cond)


def UsePreconditioner(flag):
    return current_builder().UsePreconditioner(flag)


def Stencil(offsets):
    """Iterate stencil offsets (lib.t:117-124)."""
    for off in offsets:
        yield tuple(off)
