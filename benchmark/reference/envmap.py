"""Direction-sampled environment map for ray misses (skybox parity).

PyTorch counterpart of octree_raymarcher_tpu/shade/envmap.py: the
reference's cubemap skybox at infinite depth (src/Skybox.cpp:84-107) as an
equirectangular map sampled by ray direction.  ``default_envmap`` is a numpy
copy; ``sample_env`` is the plain PyTorch version of the sky lookup inside
the shading kernel (csrc/shade.cu).

Convention: +y is up; u wraps around the y axis from +x toward +z
(u = atan2(z, x) / 2pi + 0.5), v = 0 at the zenith (+y) to 1 at the nadir.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import const, normalize


def sample_env(envmap, dirs, bilinear: bool = True):
    """Sample an equirect map f32[H, W, 3] by direction f32[N, 3] -> [N, 3]:
    bilinear over 4 taps with wraparound in u (floor modulo) and clamp in v,
    or with ``bilinear=False`` the one texel the direction falls in."""
    dirs = torch.as_tensor(dirs, dtype=torch.float32)
    e = torch.as_tensor(envmap, dtype=torch.float32, device=dirs.device)
    H, W = e.shape[0], e.shape[1]
    flat = e.reshape(-1, 3)
    n = normalize(dirs)

    u = torch.atan2(n[:, 2], n[:, 0]) / const(n, 2.0 * math.pi) + 0.5   # [0, 1) wrap
    # jnp.clip's maximum then minimum: a tie takes half the gradient
    cy = torch.minimum(torch.maximum(n[:, 1], const(n, -1.0)), const(n, 1.0))
    v = torch.acos(cy) / const(n, math.pi)  # 0=zenith

    def tap(xi, yi):
        xi = torch.remainder(xi, W)
        yi = yi.clamp(0, H - 1)
        return flat[(yi * W + xi).long()]

    if not bilinear:
        return tap((u * W).to(torch.int32), (v * H).to(torch.int32))

    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.to(torch.float32))[:, None]
    fy = (y - y0.to(torch.float32))[:, None]
    c00 = tap(x0, y0)
    c01 = tap(x0 + 1, y0)
    c10 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def default_envmap(
    height: int = 64,
    width: int = 128,
    zenith=(0.25, 0.45, 0.85),
    horizon=(0.75, 0.82, 0.92),
    ground=(0.35, 0.32, 0.28),
    sun_dir=(0.45, 0.6, 0.2),
    sun_color=(8.0, 7.2, 6.0),
    sun_sharpness: float = 400.0,
) -> np.ndarray:
    """Procedural sky: zenith->horizon gradient, darker ground hemisphere,
    and a smooth sun disc toward ``sun_dir`` (the stand-in for the
    reference's cubemap PNGs)."""
    vs = (np.arange(height) + 0.5) / height
    us = (np.arange(width) + 0.5) / width
    theta = vs * np.pi               # polar angle from zenith
    phi = (us - 0.5) * 2 * np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [
            st * np.cos(phi)[None, :],
            np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
            st * np.sin(phi)[None, :],
        ],
        axis=-1,
    )  # [H, W, 3]

    y = dirs[..., 1]
    sky_t = np.clip(y, 0.0, 1.0) ** 0.7
    col = (
        np.asarray(horizon)[None, None] * (1 - sky_t[..., None])
        + np.asarray(zenith)[None, None] * sky_t[..., None]
    )
    ground_t = np.clip(-y, 0.0, 1.0) ** 0.5
    col = col * (1 - ground_t[..., None]) + np.asarray(ground)[
        None, None
    ] * ground_t[..., None]

    s = np.asarray(sun_dir, dtype=np.float64)
    s = s / np.linalg.norm(s)
    cosang = np.clip((dirs * s[None, None]).sum(-1), -1.0, 1.0)
    sun = np.exp(sun_sharpness * (cosang - 1.0))
    col = col + np.asarray(sun_color)[None, None] * sun[..., None]
    return col.astype(np.float32)


__all__ = ["sample_env", "default_envmap"]
