"""Level-synchronous octree construction from a bounds pyramid.

The reference builds each chunk's octree with a sequential BFS queue
(src/Octree.cpp:74-176).  Here one whole tree level is classified at once
against the pyramid's min/max bounds — EMPTY / solid LEAF / TWIG / BRANCH
masks, then a prefix-sum assigns child-block offsets — which is the natural
shape for vectorized hardware and makes worldgen cost O(levels) array passes
instead of O(nodes) queue pops.

Semantics preserved from the reference:
  * a cell whose quadrant's max height is below the cell bottom is EMPTY;
  * a cell whose quadrant's min height is above the cell top is a solid LEAF
    with a material derived from normalized chunk height (heightMaterial,
    src/Octree.cpp:69-72);
  * at depth-TWIG_DEPTH surviving cells become 4^3 twigs whose texels are
    column tests of the pyramid max height (src/Octree.cpp:120-154);
  * otherwise the cell becomes a BRANCH of 8 children.
"""

from __future__ import annotations

import numpy as np

from ..core.chunk import Chunk
from ..core.constants import TWIG_DEPTH, TWIG_SIZE, TWIG_WORDS
from ..core.nodes import BRANCH, EMPTY, LEAF, TWIG, pack
from .pyramid import BoundsPyramid


def height_material(ynorm) -> np.ndarray:
    """Material id from normalized chunk-local height: 1=stone .. 4=grass."""
    return np.clip(np.asarray(ynorm, dtype=np.float32) / np.float32(0.03), 1.0, 4.0).astype(
        np.uint16
    )


_OCTANT = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.float32
)  # child octant offsets in branch_index order (x + 2y + 4z)


def grow(position, size: float, depth: int, pyr: BoundsPyramid) -> Chunk:
    """Build one chunk's octree from the pyramid. Returns a compact Chunk."""
    position = np.asarray(position, dtype=np.float32)
    size = np.float32(size)
    chunk = Chunk.empty_chunk(position, float(size), depth)

    twig_level = depth - TWIG_DEPTH
    assert twig_level >= 0, "chunk depth must exceed TWIG_DEPTH"

    # Active cells of the current level.
    pos = position[None, :].copy()              # float32[n, 3] cell min corners
    offs = np.array([0], dtype=np.int64)        # node index of each cell

    for level in range(twig_level + 1):
        if len(offs) == 0:
            break
        cell = size / np.float32(1 << level)
        p = (pos - position) / size             # normalized [0,1)^3
        low = pyr.min(p[:, 0], p[:, 2], level)
        high = pyr.max(p[:, 0], p[:, 2], level)

        is_empty = high < pos[:, 1]
        is_leaf = (~is_empty) & (low > pos[:, 1] + cell)
        is_twig = (~is_empty) & (~is_leaf) & (level == twig_level)
        is_branch = (~is_empty) & (~is_leaf) & (~is_twig)

        words = np.zeros(len(offs), dtype=np.uint32)
        words[is_empty] = pack(EMPTY, 0)
        if is_leaf.any():
            words[is_leaf] = pack(
                np.full(int(is_leaf.sum()), LEAF, dtype=np.uint32),
                height_material(p[is_leaf, 1]).astype(np.uint32),
            )

        if is_twig.any():
            tp = pos[is_twig]                    # [m, 3]
            tpn = p[is_twig]                     # normalized
            m = len(tp)
            leafsize = cell / np.float32(TWIG_SIZE)
            # Column max heights per (x, z) texel at level+TWIG_DEPTH.
            dx = (np.arange(TWIG_SIZE, dtype=np.float32) * leafsize) / size
            qx = tpn[:, 0:1, None] + dx[None, :, None]            # [m, 4, 1]
            qz = tpn[:, 2:3, None] + dx[None, None, :]            # [m, 1, 4] -> broadcast
            qx = np.broadcast_to(qx, (m, TWIG_SIZE, TWIG_SIZE))
            qz = np.broadcast_to(qz, (m, TWIG_SIZE, TWIG_SIZE))
            h = pyr.max(qx.reshape(-1), qz.reshape(-1), level + TWIG_DEPTH).reshape(
                m, TWIG_SIZE, TWIG_SIZE
            )                                                     # [m, x, z]
            # Texel solid iff column max reaches the texel's base height.
            ybase = tp[:, 1:2, None] + (
                np.arange(TWIG_SIZE, dtype=np.float32) * leafsize
            ).reshape(1, TWIG_SIZE, 1)                            # [m, y, 1]
            solid = h[:, None, :, :] >= ybase[:, :, :, None]      # [m, y, x, z]
            mat = height_material(tpn[:, 1])                      # [m]
            texels = np.where(solid, mat[:, None, None, None], np.uint16(0)).astype(
                np.uint16
            )
            # twig word layout is z*16 + y*4 + x -> axis order [z, y, x]
            texels = np.ascontiguousarray(texels.transpose(0, 3, 1, 2))  # [m,y,x,z]->[m,z,y,x]
            texels = texels.reshape(m, TWIG_WORDS)

            base = chunk.ntwigs
            chunk.reserve_twigs(m)
            chunk.twig[base : base + m] = texels
            chunk.ntwigs += m
            words[is_twig] = pack(
                np.full(m, TWIG, dtype=np.uint32),
                (base + np.arange(m)).astype(np.uint32),
            )

        nb = int(is_branch.sum())
        if nb > 0:
            chunk.reserve_trees(8 * nb)
            child_base = chunk.ntrees + 8 * np.arange(nb, dtype=np.int64)
            words[is_branch] = pack(
                np.full(nb, BRANCH, dtype=np.uint32), child_base.astype(np.uint32)
            )
            chunk.ntrees += 8 * nb
            # Children become next level's active cells.
            half = cell / np.float32(2)
            bp = pos[is_branch]                                   # [nb, 3]
            child_pos = (bp[:, None, :] + _OCTANT[None, :, :] * half).reshape(-1, 3)
            child_offs = (child_base[:, None] + np.arange(8)[None, :]).reshape(-1)
        else:
            child_pos = np.zeros((0, 3), dtype=np.float32)
            child_offs = np.zeros((0,), dtype=np.int64)

        chunk.tree[offs] = words
        pos, offs = child_pos.astype(np.float32), child_offs

    return chunk


__all__ = ["grow", "height_material"]
