"""Deterministic 2D simplex noise, vectorized.

The reference seeds its heightfield from glm::simplex
(src/BoundsPyramid.cpp:92-104).  Bit-parity with GLM is not required — only
determinism — so this is a standard Gustavson 2D simplex over a seeded
permutation table.  Output is clamped to [-1, 1].

A numpy copy of octree_raymarcher_tpu/worldgen/simplex.py (its numpy half):
the port generates bit-identical heightfields on the host.
"""

from __future__ import annotations

import numpy as np

_F2 = 0.5 * (np.sqrt(3.0) - 1.0)
_G2 = (3.0 - np.sqrt(3.0)) / 6.0

# 8 gradient directions (unit-ish), as in classic simplex implementations.
_GRAD = np.array(
    [
        [1, 1], [-1, 1], [1, -1], [-1, -1],
        [1, 0], [-1, 0], [0, 1], [0, -1],
    ],
    dtype=np.float32,
)


def permutation_table(seed: int) -> np.ndarray:
    """Seeded 512-entry permutation table (256 doubled for overflow-free lookup)."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(256).astype(np.int32)
    return np.concatenate([p, p])


def simplex2(x, z, perm: np.ndarray):
    """Vectorized 2D simplex noise in [-1, 1]. numpy in, numpy out (float32)."""
    x = np.asarray(x, dtype=np.float32)
    z = np.asarray(z, dtype=np.float32)

    s = (x + z) * np.float32(_F2)
    i = np.floor(x + s).astype(np.int64)
    j = np.floor(z + s).astype(np.int64)
    t = (i + j).astype(np.float32) * np.float32(_G2)
    x0 = x - (i.astype(np.float32) - t)
    z0 = z - (j.astype(np.float32) - t)

    xg = x0 > z0
    i1 = xg.astype(np.int64)
    j1 = 1 - i1

    x1 = x0 - i1.astype(np.float32) + np.float32(_G2)
    z1 = z0 - j1.astype(np.float32) + np.float32(_G2)
    x2 = x0 - np.float32(1.0 - 2.0 * _G2)
    z2 = z0 - np.float32(1.0 - 2.0 * _G2)

    ii = (i & 255).astype(np.int64)
    jj = (j & 255).astype(np.int64)
    gi0 = perm[ii + perm[jj]] % 8
    gi1 = perm[ii + i1 + perm[jj + j1]] % 8
    gi2 = perm[ii + 1 + perm[jj + 1]] % 8

    def corner(xc, zc, gi):
        tc = np.float32(0.5) - xc * xc - zc * zc
        g = _GRAD[gi]
        dot = g[..., 0] * xc + g[..., 1] * zc
        tc = np.maximum(tc, np.float32(0.0))
        t4 = tc * tc
        t4 = t4 * t4
        return t4 * dot

    n = corner(x0, z0, gi0) + corner(x1, z1, gi1) + corner(x2, z2, gi2)
    return np.clip(np.float32(70.0) * n, -1.0, 1.0).astype(np.float32)


__all__ = ["permutation_table", "simplex2"]
