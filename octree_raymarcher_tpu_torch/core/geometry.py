"""Ray/box geometry for shading, on tensors with a trailing ``(..., 3)`` axis.

PyTorch counterpart of octree_raymarcher_tpu/core/geometry.py
(``inv_dir``, ``cube_normal``, ``cube_uv``, ``inverse_depth``).  Sums over the
three components are written out left to right, and divisions by constants
divide by a tensor, so that these plain versions and the shading kernel
(csrc/shade.cu) round the same way on the card.
"""

from __future__ import annotations

import torch

from .constants import EPS, FAR, NEAR


def const(x: torch.Tensor, c: float) -> torch.Tensor:
    """A 0-d tensor of ``c`` on x's device and dtype.  Dividing by it is a
    true division: PyTorch turns ``x / python_float`` into a multiply by the
    reciprocal on CUDA, which rounds differently."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp_min(length(v), 1e-12)[..., None]


def inv_dir(d):
    """Safe reciprocal of a ray direction; zero components map to huge values."""
    eps = 1e-30
    safe = torch.where(d.abs() < eps,
                       torch.where(d < 0, torch.full_like(d, -eps), torch.full_like(d, eps)),
                       d)
    return 1.0 / safe


def cube_normal(p, cmin, cmax):
    """Axis-aligned outward face normal of the box face nearest to point p.

    The reference truncates n*(1+EPS) to int32, keeping only components that
    reached the face; XLA's conversion saturates out-of-range values, so the
    clamp to +-2^31 reproduces it (it matters only for the zero-size cells
    of misses)."""
    center = (cmin + cmax) * 0.5
    half = (cmax - cmin) * 0.5
    n = (p - center) / torch.clamp_min(half, 1e-30)
    q = torch.trunc(torch.clamp(n * (1.0 + EPS), -2147483648.0, 2147483648.0))
    return q / torch.clamp_min(length(q), 1e-12)[..., None]


def cube_uv(p, cmin, cmax):
    """Per-face UV in [0,1]^2 of surface point p on the box (cubeUV); the
    last matching face wins, in the order -x, +x, -y, +y, -z, +z."""
    size = cmax[..., 0] - cmin[..., 0]
    uv = torch.zeros(p.shape[:-1] + (2,), dtype=p.dtype, device=p.device)
    faces = (
        (0, cmin, (1, 2)), (0, cmax, (1, 2)),
        (1, cmin, (0, 2)), (1, cmax, (0, 2)),
        (2, cmin, (0, 1)), (2, cmax, (0, 1)),
    )
    for axis, c, (i, j) in faces:
        on = (p[..., axis] - c[..., axis]).abs() <= EPS
        val = torch.stack([p[..., i] - c[..., i], p[..., j] - c[..., j]], dim=-1)
        uv = torch.where(on[..., None], val, uv)
    return uv.abs() / torch.clamp_min(size, 1e-30)[..., None]


def inverse_depth(dist):
    """Nonlinear inverse-depth encoding used for z-composition (NEAR/FAR)."""
    inv_near = 1.0 / NEAR
    inv_far = 1.0 / FAR
    return (1.0 / torch.clamp_min(dist, 1e-6) - inv_near) / const(dist, inv_far - inv_near)


__all__ = ["inv_dir", "cube_normal", "cube_uv", "inverse_depth", "dot", "length",
           "normalize", "const"]
