"""The light bundle and the map-shadow compare in plain PyTorch ops (frozen
copy of the port's shade/shadow.py plain functions)."""

from __future__ import annotations

import numpy as np
import torch

from .constants import EPS
from .geometry import vp_row
from .march import MarchResult
from .transforms import look_at, ortho

def shadow_bundle(ldir64, H, W, dims, cs, margin: float = 1.1):
    """The world-center-relative ortho light-ray bundle and projection (host
    numpy).  Returns (origins_rel f32[H*W,3], dirs f32[H*W,3], pv_rel
    f32[4,4], extent_half f32[3])."""
    ldir64 = np.asarray(ldir64, dtype=np.float64)
    ldir64 = ldir64 / np.linalg.norm(ldir64)
    w, h, d = dims
    extent = np.array([w, h, d], dtype=np.float64) * cs
    radius = float(np.linalg.norm(extent) * 0.5 * margin)

    # The emitter plane sits behind the world so every ray crosses it.
    plane_rel = -ldir64 * (2.0 * radius)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(ldir64, up)) > 0.99:
        up = np.array([0.0, 0.0, 1.0])
    view_rel = look_at(plane_rel, (0.0, 0.0, 0.0), up)
    proj = ortho(-radius, radius, -radius, radius, 0.0, 8 * radius)
    pv_rel = (proj.astype(np.float64) @ view_rel.astype(np.float64)).astype(np.float32)

    right = np.cross(ldir64, up)
    right /= np.linalg.norm(right)
    upv = np.cross(right, ldir64)
    xs = ((np.arange(W) + 0.5) / W - 0.5) * 2 * radius
    ys = (0.5 - (np.arange(H) + 0.5) / H) * 2 * radius
    xx, yy = np.meshgrid(xs, ys)
    origins_rel = (
        plane_rel[None, None]
        + xx[..., None] * right[None, None]
        + yy[..., None] * upv[None, None]
    ).reshape(-1, 3).astype(np.float32)
    dirs = np.broadcast_to(ldir64.astype(np.float32), origins_rel.shape).copy()
    return origins_rel, dirs, pv_rel, (extent * 0.5).astype(np.float32)


def light_vp(pv_rel, center) -> np.ndarray:
    """``pv_rel @ translate(-center)`` in float32, the fourth column summed
    in the fixed order of the kernels."""
    pv = np.asarray(pv_rel, dtype=np.float32)
    c = -np.asarray(center, dtype=np.float32)
    vp = pv.copy()
    vp[:, 3] = ((pv[:, 0] * c[0] + pv[:, 1] * c[1]) + pv[:, 2] * c[2]) + pv[:, 3]
    return vp


def _hit_point(res: MarchResult, o, d):
    t_hit = torch.where(res.hit, res.t, 0.0)
    return o + d * (t_hit - EPS)[:, None]


def host_vp(vp) -> np.ndarray:
    """A light view-projection (tensor on any device, or array) as host
    float32 numpy; a CPU tensor or array is read without a device sync."""
    if isinstance(vp, torch.Tensor):
        vp = vp.detach().cpu().numpy()
    return np.asarray(vp, dtype=np.float32).reshape(4, 4)


def map_bias(bias_texels: float, W: int) -> float:
    """The map compare's bias in ndc z: ``bias_texels`` texels of a map W
    texels wide (a texel spans 1/(2W) along the ray), rounded to float32."""
    return float(np.float32(bias_texels / (2.0 * W)))


def map_shadow_plain(points, shadow_depth, vp, bias_texels: float = 4.0, hit=None):
    """The map-shadow factor in plain PyTorch ops: project ``points`` into
    the light, compare their ndc z with the depth map's nearest texel plus
    ``bias_texels`` texels of depth, and multiply by ``hit`` when given."""
    H, W = shadow_depth.shape
    vp = host_vp(vp)
    cx, cy, cz, cw = (vp_row(points, vp[i]) for i in range(4))
    den = torch.clamp_min(cw.abs(), 1e-12)
    sg = torch.sign(cw)
    u = (cx / den * sg) * 0.5 + 0.5
    v = (cy / den * sg) * 0.5 + 0.5
    nz = cz / den * sg
    # clamp-then-truncate equals the reference's truncate-then-clip for
    # every finite value
    xi = torch.clamp(u * float(W), 0.0, W - 1).to(torch.int64)
    yi = torch.clamp((1.0 - v) * float(H), 0.0, H - 1).to(torch.int64)
    pixel_z = shadow_depth.reshape(-1)[yi * W + xi]
    bias = map_bias(bias_texels, W)
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    shadowed = inside & (nz > pixel_z + bias)
    if hit is not None:
        shadowed = shadowed & hit
    return shadowed.to(torch.float32)


def map_project_plain(res: MarchResult, o, d, shadow_depth, vp, bias_texels: float = 4.0):
    """render()'s map-shadow factor in plain PyTorch ops: the hit points
    projected against the depth map, times the hit mask."""
    return map_shadow_plain(_hit_point(res, o, d), shadow_depth, vp, bias_texels, res.hit)
