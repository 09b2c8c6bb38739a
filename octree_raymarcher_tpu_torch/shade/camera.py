"""Cameras: batched ray generation for perspective and orthographic views.

Capability parity: reference src/Camera.{h,cpp} (euler yaw/pitch/roll
perspective camera with +-90 deg pitch clamp, orthographic camera) — but
instead of producing GL matrices for a raster pass, cameras here directly
emit the ray grid (origins, directions) the marcher consumes, which is the
natural interface for a raymarcher.  A numpy copy of the JAX package's
shade/camera.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class PerspectiveCamera:
    position: tuple = (0.0, 0.0, 0.0)
    yaw_deg: float = 0.0       # rotation about +y; 0 looks along +z
    pitch_deg: float = 0.0     # clamped to [-90, 90]
    roll_deg: float = 0.0
    fov_deg: float = 90.0      # horizontal field of view
    width: int = 256
    height: int = 256
    near: float = 0.125
    far: float = 8192.0

    def basis(self):
        """Right/up/forward unit vectors from yaw/pitch/roll (y-up, z-forward)."""
        pitch = np.radians(np.clip(self.pitch_deg, -90.0, 90.0))
        yaw = np.radians(self.yaw_deg)
        roll = np.radians(self.roll_deg)

        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)

        # yaw about y then pitch about the local x axis; positive pitch looks up
        forward = _normalize(np.array([sy * cp, sp, cy * cp]))
        right0 = _normalize(np.array([cy, 0.0, -sy]))
        up0 = _normalize(np.cross(right0, forward))
        right = right0 * cr + up0 * sr
        up = -right0 * sr + up0 * cr
        return right.astype(np.float32), up.astype(np.float32), forward.astype(np.float32)

    def rays(self):
        """Returns (origins f32[N,3], dirs f32[N,3]) for N = width*height rays,
        row-major from the top-left pixel, one ray through each pixel center."""
        right, up, forward = self.basis()
        aspect = self.width / self.height
        half_w = np.tan(np.radians(self.fov_deg) * 0.5)
        half_h = half_w / aspect

        xs = (np.arange(self.width, dtype=np.float32) + 0.5) / self.width * 2.0 - 1.0
        ys = 1.0 - (np.arange(self.height, dtype=np.float32) + 0.5) / self.height * 2.0
        xx, yy = np.meshgrid(xs * half_w, ys * half_h)
        dirs = (
            xx[..., None] * right[None, None]
            + yy[..., None] * up[None, None]
            + forward[None, None]
        ).reshape(-1, 3)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(
            np.asarray(self.position, dtype=np.float32), dirs.shape
        ).copy()
        return origins.astype(np.float32), dirs.astype(np.float32)


@dataclasses.dataclass
class OrthoCamera:
    position: tuple = (0.0, 0.0, 0.0)  # view-plane center
    direction: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, 1.0, 0.0)
    width: float = 256.0    # world-units extent of the view plane
    height: float = 256.0
    xres: int = 256
    yres: int = 256

    def rays(self):
        fwd = _normalize(np.asarray(self.direction, dtype=np.float64))
        upv = np.asarray(self.up, dtype=np.float64)
        right = _normalize(np.cross(fwd, upv))
        up = _normalize(np.cross(right, fwd))

        xs = ((np.arange(self.xres) + 0.5) / self.xres - 0.5) * self.width
        ys = (0.5 - (np.arange(self.yres) + 0.5) / self.yres) * self.height
        xx, yy = np.meshgrid(xs, ys)
        origins = (
            np.asarray(self.position, dtype=np.float64)[None, None]
            + xx[..., None] * right[None, None]
            + yy[..., None] * up[None, None]
        ).reshape(-1, 3)
        dirs = np.broadcast_to(fwd, origins.shape)
        return origins.astype(np.float32), dirs.astype(np.float32).copy()


__all__ = ["PerspectiveCamera", "OrthoCamera"]
