"""Ray/box geometry for shading, on tensors with a trailing ``(..., 3)`` axis.

PyTorch counterpart of octree_raymarcher_tpu/core/geometry.py
(``is_inside``, ``inv_dir``, ``escape_distance``, ``enter_distance``,
``cube_normal``, ``cube_uv``, ``inverse_depth``, ``depth_to_distance``).  Sums over the
three components are written out left to right, and divisions by constants
divide by a tensor, so that these plain versions and the shading kernel
(csrc/shade.cu) round the same way on the card.
"""

from __future__ import annotations

import torch

from .constants import BIGEPS, EPS, FAR, NEAR


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


def escape_distance(p, g, cmin, cmax):
    """Distance along the ray (direction reciprocal g) from p to exit the box.

    Degenerate results (< EPS, from rays grazing a face) clamp to BIGEPS so a
    marcher never stalls.  Unlike the march's in-loop escape, nothing is
    added after the clamp."""
    t = torch.maximum((cmin - p) * g, (cmax - p) * g)
    d = t.amin(dim=-1)
    return torch.where(d < EPS, torch.full_like(d, BIGEPS), d)


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


def vp_row(p, m):
    """One row ``m`` (4 floats) of a view-projection times [p, 1] for
    points p f32[N,3], summed in the CUDA kernels' fixed order
    ((p.x*m0 + p.y*m1) + p.z*m2) + m3 (csrc/shadow.cuh row_dot)."""
    m = [float(v) for v in m]
    return ((p[:, 0] * m[0] + p[:, 1] * m[1]) + p[:, 2] * m[2]) + m[3]


