"""Bounds pyramid: min/max heightfield mips — the empty-space-skipping oracle.

Per (x, z) column the worldgen needs "is everything in this quadrant above or
below the terrain?".  A BoundsPyramid answers that with a simplex-noise base
grid plus bottom-up 2:1 min/max reductions, queried at any octree level; below
base resolution it bilinearly interpolates the base with wraparound.

Capability parity: reference src/BoundsPyramid.{h,cpp} — rebuilt with
vectorized 2D pooling (numpy) instead of the scalar half-precision loops; all
arrays are float32 and queries accept whole coordinate batches at once,
because our grow() classifies an entire octree level per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .simplex import permutation_table, simplex2


@dataclasses.dataclass
class BoundsPyramid:
    size: int                 # base resolution (power of two)
    levels: int               # log2(size)
    amplitude: float
    shift: float
    base: np.ndarray          # float32[size, size], indexed [z, x], in [-1,1]
    mins: list                # mins[lv]: float32[2^lv, 2^lv], lv = 0..levels
    maxs: list                # maxs[lv] likewise; mins[levels] is `base`

    @staticmethod
    def generate(
        size: int,
        amplitude: float,
        period: float,
        xshift: float,
        yshift: float,
        zshift: float,
        seed: int = 0,
    ) -> "BoundsPyramid":
        assert size & (size - 1) == 0, "size must be a power of two"
        levels = int(size).bit_length() - 1
        perm = permutation_table(seed)

        xs = (np.arange(size, dtype=np.float32) + np.float32(xshift)) * np.float32(period)
        zs = (np.arange(size, dtype=np.float32) + np.float32(zshift)) * np.float32(period)
        zz, xx = np.meshgrid(zs, xs, indexing="ij")
        base = simplex2(xx, zz, perm)  # [z, x]

        mins = [None] * (levels + 1)
        maxs = [None] * (levels + 1)
        mins[levels] = base
        maxs[levels] = base
        cur_min = base
        cur_max = base
        for lv in range(levels - 1, -1, -1):
            s = 1 << lv
            cur_min = cur_min.reshape(s, 2, s, 2).min(axis=(1, 3))
            cur_max = cur_max.reshape(s, 2, s, 2).max(axis=(1, 3))
            mins[lv] = cur_min
            maxs[lv] = cur_max

        return BoundsPyramid(
            size=size,
            levels=levels,
            amplitude=float(amplitude),
            shift=float(yshift),
            base=base,
            mins=mins,
            maxs=maxs,
        )

    # -- queries (x, z normalized to [0, 1); arrays ok) --------------------
    def _bound(self, x, z, lv: int, quads: list):
        x = np.asarray(x, dtype=np.float32)
        z = np.asarray(z, dtype=np.float32)
        a = np.clip((x * self.size).astype(np.int64), 0, self.size - 1)
        b = np.clip((z * self.size).astype(np.int64), 0, self.size - 1)

        if lv <= self.levels:
            d = 1 << (self.levels - lv)
            q = quads[lv]
            v = q[b // d, a // d]
            return v * np.float32(self.amplitude) + np.float32(self.shift)

        # Finer than base resolution: bilinear interpolation with wraparound.
        mask = self.size - 1
        a0, b0 = a, b
        a1, b1 = (a0 + 1) & mask, (b0 + 1) & mask
        t = x * self.size - a0.astype(np.float32)
        s = z * self.size - b0.astype(np.float32)
        q = self.base
        v00 = q[b0, a0]
        v01 = q[b0, a1]
        v10 = q[b1, a0]
        v11 = q[b1, a1]
        v0 = v01 * t + (1.0 - t) * v00
        v1 = v11 * t + (1.0 - t) * v10
        v = v1 * s + (1.0 - s) * v0
        return v.astype(np.float32) * np.float32(self.amplitude) + np.float32(self.shift)

    def min(self, x, z, lv: int):
        return self._bound(x, z, lv, self.mins)

    def max(self, x, z, lv: int):
        return self._bound(x, z, lv, self.maxs)

    def height_range(self) -> tuple:
        return (
            float(self.mins[0][0, 0] * self.amplitude + self.shift),
            float(self.maxs[0][0, 0] * self.amplitude + self.shift),
        )


__all__ = ["BoundsPyramid"]
