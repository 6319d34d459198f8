"""Bilinear image sampling with user-supplied derivative images.

PyTorch counterpart of ``opt_tpu/ops/sampling.py`` (the reference's
``SampledImage``): a 2-D image is sampled at real-valued positions, and its
partial derivatives with respect to the sample position are not obtained
by differentiating the interpolation (which is only piecewise smooth) but
by bilinearly sampling the user's derivative images dx, dy. This is what
optical_flow relies on.

Out-of-bounds taps read as zero, and the corner indices are floor/ceil so
that integer positions hit texels exactly.

Where the JAX package attaches a ``custom_jvp`` rule, this module uses the
equivalent first-order form at a frozen position x̄ = ``frozen(x)``:

    sample(img, x̄, ȳ) + sample(dx, x̄, ȳ)·(x − x̄) + sample(dy, x̄, ȳ)·(y − ȳ)

whose value is the sample (x − x̄ is exactly zero) and whose tangent, under
``torch.func.jvp``/``vjp``/``vmap`` alike, is dx·ẋ + dy·ẏ. ``frozen`` drops
the tangent (``detach``) and marks the value (an ``aten.alias`` node in a
traced graph), so that the assembly planner's gate walk can tell the
sampler's own floor/ceil/casts/clamps, which implement a smooth
interpolant, from piecewise-constant gates of the user's residual.
"""

from __future__ import annotations

import torch


def frozen(x: torch.Tensor) -> torch.Tensor:
    """x with no tangent, marked as a sampling position (module docstring)."""
    return torch.ops.aten.alias(x.detach())


def is_frozen_marker(op: str) -> bool:
    """Whether an FX node's overload-packet name is :func:`frozen`'s marker."""
    return op == "alias"


def _get_zero_pad(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """img[xi, yi] with zero padding out of bounds.

    img: [W, H, C]; xi/yi: integer index fields of identical shape [...]. The
    first spatial dim is indexed by x, the second by y.
    """
    W, H = int(img.shape[0]), int(img.shape[1])
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    # out-of-bounds taps read texel (0, 0) and are zeroed below
    xc = torch.where(inb, xi, 0)
    yc = torch.where(inb, yi, 0)
    vals = img[xc, yc]  # a gather; [..., C]
    return torch.where(inb[..., None], vals, 0.0)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reference-faithful bilinear sample (floor/ceil corners, zero pad)."""
    x0 = torch.floor(x).to(torch.int64)
    x1 = torch.ceil(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    y1 = torch.ceil(y).to(torch.int64)
    xn = (x - x0.to(x.dtype))[..., None]
    yn = (y - y0.to(y.dtype))[..., None]
    v00 = _get_zero_pad(img, x0, y0)
    v10 = _get_zero_pad(img, x1, y0)
    v01 = _get_zero_pad(img, x0, y1)
    v11 = _get_zero_pad(img, x1, y1)
    top = (1.0 - xn) * v00 + xn * v10
    bot = (1.0 - xn) * v01 + xn * v11
    return (1.0 - yn) * top + yn * bot


def sample_with_derivs(img, dx_img, dy_img, x, y):
    """Bilinear sample of ``img`` at (x, y); d/dx, d/dy taken from dx/dy images.

    img, dx_img, dy_img: [W, H, C]. x, y: position fields of equal shape [...].
    Returns [..., C]. Gradients do not flow into the image arguments.
    """
    xb, yb = frozen(x), frozen(y)
    img, dx_img, dy_img = img.detach(), dx_img.detach(), dy_img.detach()
    out = _bilinear(img, xb, yb)
    gx = _bilinear(dx_img, xb, yb)
    gy = _bilinear(dy_img, xb, yb)
    return out + gx * (x - xb)[..., None] + gy * (y - yb)[..., None]


def central_difference_images(img: torch.Tensor):
    """Build dx/dy derivative images by central differences (zero beyond the
    border), for a SampledImage declared without them."""
    zeros_x = torch.zeros_like(img[:1])
    zeros_y = torch.zeros_like(img[:, :1])
    xp = torch.cat([img[1:], zeros_x], dim=0)
    xm = torch.cat([zeros_x, img[:-1]], dim=0)
    yp = torch.cat([img[:, 1:], zeros_y], dim=1)
    ym = torch.cat([zeros_y, img[:, :-1]], dim=1)
    return 0.5 * (xp - xm), 0.5 * (yp - ym)
