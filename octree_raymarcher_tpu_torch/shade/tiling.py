"""Screen-block ray ordering for march-tile coherence.

Reordering rays into square screen blocks puts spatially-coherent rays
next to each other in the batch (the analog of the reference's raster-order
fragment locality).  On the GPU the march runs one ray per thread, so the
order decides which rays share a warp and how far their step counts
diverge."""

from __future__ import annotations

import numpy as np


def block_permutation(height: int, width: int, block: int = 128):
    """Permutation p (and inverse) turning row-major ray order into
    block-major: rays of each (block x block) screen tile are contiguous.
    Returns (perm, inv) int32 arrays of length height*width such that
    reordered = rays[perm] and original = reordered[inv]."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    by, bx = ys // block, xs // block
    # sort key: (block row, block col, y, x) — stable row-major inside a block
    key = (((by * ((width + block - 1) // block)) + bx).astype(np.int64) * height
           + ys) * width + xs
    perm = np.argsort(key.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


__all__ = ["block_permutation"]
