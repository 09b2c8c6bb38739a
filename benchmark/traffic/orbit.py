"""The orbit: the general generator that every traffic mix of this folder
feeds.

``poses`` places N cameras evenly in yaw on the circle through the
configuration's phase-0 pose around the world's centre, at that pose's
height and pitch, each looking toward the centre, the whole set turned by a
phase (``phase``, drawn from the seed by the fit's mixes).  ``rotated``
keeps the set of poses and starts it at a pose drawn from the seed, so
that every seed renders the same frames in another order.  ``rays`` builds
each pose's rays on the device, as the reference's
``PerspectiveCamera.rays`` does, in the screen-block order of
``block_permutation`` (bench.py:108-122).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def phase(seed: int) -> float:
    """The orbit's turn in radians, in [0, 2 pi), from the seed."""
    return float(np.random.default_rng(seed & (2**63 - 1)).random()) * 2.0 * math.pi


def rotated(pose_list: list, seed: int) -> list:
    """``pose_list`` started at an index drawn from the seed and wrapped
    round: the same poses for every seed, in another order."""
    start = int(np.random.default_rng((seed & (2**63 - 1)) ^ 0x0FB17).integers(len(pose_list)))
    return pose_list[start:] + pose_list[:start]


def poses(camera: dict, n: int, turn: float) -> list:
    """[(position (x, y, z), yaw_deg)] of ``n`` poses; pose i sits at angle
    ``turn + 2 pi i / n`` from the phase-0 pose."""
    px0, py0, pz0 = (float(v) for v in camera["position0"])
    cx, cz = (float(v) for v in camera["centre_xz"])
    radius = math.hypot(px0 - cx, pz0 - cz)
    a0 = math.atan2(px0 - cx, pz0 - cz)
    out = []
    for i in range(n):
        a = a0 + turn + 2.0 * math.pi * i / n
        px, pz = cx + radius * math.sin(a), cz + radius * math.cos(a)
        yaw = math.degrees(math.atan2(cx - px, cz - pz))
        out.append(((px, py0, pz), yaw))
    return out


def basis(yaw_deg: float, pitch_deg: float):
    """Right, up and forward unit vectors (float32), as the camera's."""
    pitch = np.radians(np.clip(pitch_deg, -90.0, 90.0))
    yaw = np.radians(yaw_deg)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    forward = np.array([sy * cp, sp, cy * cp])
    forward = forward / np.linalg.norm(forward)
    right = np.array([cy, 0.0, -sy])
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)
    return right.astype(np.float32), up.astype(np.float32), forward.astype(np.float32)


def block_order(height: int, width: int, block: int, device) -> torch.Tensor:
    """int64[H * W]: row-major pixel indices in screen-block order (each
    block x block tile contiguous, row-major inside it)."""
    ys = torch.arange(height, device=device, dtype=torch.int64)[:, None].expand(height, width)
    xs = torch.arange(width, device=device, dtype=torch.int64)[None, :].expand(height, width)
    if block <= 0:
        return torch.arange(height * width, device=device)
    bx_n = (width + block - 1) // block
    key = (((ys // block) * bx_n + xs // block) * height + ys) * width + xs
    return torch.argsort(key.reshape(-1), stable=True)


def rays(camera: dict, position, yaw_deg: float, order: torch.Tensor, device):
    """(origins f32[N, 3], dirs f32[N, 3]) of one pose on ``device``,
    contiguous, in ``order``."""
    w, h = int(camera["width"]), int(camera["height"])
    right, up, forward = (torch.from_numpy(v).to(device)
                          for v in basis(yaw_deg, float(camera["pitch_deg"])))
    half_w = float(np.tan(np.radians(float(camera["fov_deg"])) * 0.5))
    half_h = half_w / (w / h)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2.0
    xx = (xs * np.float32(half_w))[None, :].expand(h, w)
    yy = (ys * np.float32(half_h))[:, None].expand(h, w)
    d = (xx[..., None] * right + yy[..., None] * up + forward).reshape(-1, 3)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d[order].contiguous()
    o = torch.tensor(position, dtype=torch.float32, device=device).expand(d.shape).contiguous()
    return o, d
