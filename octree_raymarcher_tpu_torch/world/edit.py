"""Functional octree mutation: box carve / fill / replace with dirty ranges.

Capability parity with the reference's interactive edit layer
(destroyCube/buildCube/replace, src/Octree.cpp:203-443, driven by the x/z/c
keys via World::modify, src/Main.cpp:340-368): an axis-aligned box is carved
out of or filled into a chunk's octree, splitting solid LEAF cells lazily
(into a twig at the brick level, else into 8 children), touching only the
voxels the box overlaps, and recording per-pool dirty ranges (reference
Ocdelta) so the device upload patches just the edited subrange.

The implementation is our own: iterative explicit-stack traversal (no
recursion limits), vectorized numpy texel masks inside twigs, half-open box
semantics [bmin, bmax).  Edits run host-side on the numpy Chunk — exactly
like the reference edits CPU-side then patches the GPU — and the device
patch of the pools is later work (ROADMAP queue A item 6).
"""

from __future__ import annotations

import numpy as np

from ..core.chunk import Chunk, Dirty
from ..core.constants import TWIG_DEPTH, TWIG_SIZE, TWIG_WORDS
from ..core.nodes import (
    BRANCH,
    EMPTY,
    LEAF,
    TWIG,
    node_payload,
    node_type,
    pack_scalar,
)

_OCTANT = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.float32
)  # child offsets in branch_index order (x + 2y + 4z), matching worldgen/grow.py


def boxes_intersect(amin, amax, bmin, bmax) -> bool:
    """Open-interval overlap of two boxes (shared faces don't count)."""
    return bool(np.all(np.asarray(amin) < np.asarray(bmax)) and
                np.all(np.asarray(amax) > np.asarray(bmin)))


def box_contains(outer_min, outer_max, inner_min, inner_max) -> bool:
    """True when [inner] lies entirely within [outer] (closed comparison)."""
    return bool(np.all(np.asarray(outer_min) <= np.asarray(inner_min)) and
                np.all(np.asarray(inner_max) <= np.asarray(outer_max)))


def _clip_box(chunk: Chunk, bmin, bmax):
    bmin = np.maximum(np.asarray(bmin, dtype=np.float32), chunk.bmin)
    bmax = np.minimum(np.asarray(bmax, dtype=np.float32), chunk.bmax)
    return bmin, bmax


def _texel_range(cmin, size, bmin, bmax):
    """Index ranges [i0, i1) of twig texels whose cells overlap the box."""
    leaf = size / TWIG_SIZE
    i0 = np.floor((bmin - cmin) / leaf).astype(np.int64)
    i1 = np.ceil((bmax - cmin) / leaf).astype(np.int64)
    i0 = np.clip(i0, 0, TWIG_SIZE)
    i1 = np.clip(i1, 0, TWIG_SIZE)
    return i0, i1


def _texel_mask(cmin, size, bmin, bmax) -> np.ndarray:
    """Bool[64] mask (twig word order z*16+y*4+x) of texels inside the box."""
    i0, i1 = _texel_range(cmin, size, bmin, bmax)
    m = np.zeros((TWIG_SIZE, TWIG_SIZE, TWIG_SIZE), dtype=bool)  # [z, y, x]
    m[i0[2]:i1[2], i0[1]:i1[1], i0[0]:i1[0]] = True
    return m.reshape(TWIG_WORDS)


def _split_leaf(chunk: Chunk, idx: int, level: int, dt: Dirty, dw: Dirty) -> None:
    """Lazily split a solid LEAF partially covered by an edit box: at the
    brick level it becomes a solid TWIG; above that, 8 solid LEAF children
    (reference destroyCube's split, src/Octree.cpp:234-275)."""
    mat = node_payload(int(chunk.tree[idx]))
    if level == chunk.depth - TWIG_DEPTH:
        ti = chunk.append_twig(
            np.full(TWIG_WORDS, mat, dtype=np.uint16), dw
        )
        chunk.tree[idx] = pack_scalar(TWIG, ti)
    else:
        base = chunk.append_trees(
            np.full(8, pack_scalar(LEAF, mat), dtype=np.uint32), dt
        )
        chunk.tree[idx] = pack_scalar(BRANCH, base)
    dt.touch(idx, idx + 1)


def destroy(chunk: Chunk, bmin, bmax) -> tuple[Dirty, Dirty]:
    """Carve the box out of the chunk (reference destroyCube,
    src/Octree.cpp:203-318).  Returns (tree dirty, twig dirty)."""
    dt, dw = Dirty(), Dirty()
    bmin, bmax = _clip_box(chunk, bmin, bmax)
    if not np.all(bmin < bmax):
        return dt, dw

    stack = [(0, chunk.position.astype(np.float32), np.float32(chunk.size), 0)]
    while stack:
        idx, cmin, size, level = stack.pop()
        cmax = cmin + size
        if not boxes_intersect(cmin, cmax, bmin, bmax):
            continue
        word = int(chunk.tree[idx])
        ty = node_type(word)
        if ty == EMPTY:
            continue
        if box_contains(bmin, bmax, cmin, cmax):
            chunk.tree[idx] = pack_scalar(EMPTY, 0)
            dt.touch(idx, idx + 1)
            continue
        if ty == LEAF:
            _split_leaf(chunk, idx, level, dt, dw)
            stack.append((idx, cmin, size, level))      # revisit as TWIG/BRANCH
            continue
        if ty == TWIG:
            ti = node_payload(word)
            mask = _texel_mask(cmin, size, bmin, bmax)
            if mask.any():
                chunk.twig[ti, mask] = 0
                dw.touch(ti, ti + 1)
            continue
        # BRANCH: recurse into the 8 children.
        base = node_payload(word)
        half = size * np.float32(0.5)
        for i in range(8):
            stack.append((base + i, cmin + _OCTANT[i] * half, half, level + 1))
    return dt, dw


def build(chunk: Chunk, bmin, bmax, material: int) -> tuple[Dirty, Dirty]:
    """Fill the box with ``material``, writing only empty space — solid
    leaves/texels keep their material (reference buildCube,
    src/Octree.cpp:320-436).  Returns (tree dirty, twig dirty)."""
    assert 0 < int(material) < (1 << 16), material
    dt, dw = Dirty(), Dirty()
    bmin, bmax = _clip_box(chunk, bmin, bmax)
    if not np.all(bmin < bmax):
        return dt, dw

    stack = [(0, chunk.position.astype(np.float32), np.float32(chunk.size), 0)]
    while stack:
        idx, cmin, size, level = stack.pop()
        cmax = cmin + size
        if not boxes_intersect(cmin, cmax, bmin, bmax):
            continue
        word = int(chunk.tree[idx])
        ty = node_type(word)
        if ty == LEAF:
            continue                                    # already solid
        if ty == EMPTY:
            if box_contains(bmin, bmax, cmin, cmax):
                chunk.tree[idx] = pack_scalar(LEAF, int(material))
                dt.touch(idx, idx + 1)
                continue
            # Partially covered empty cell: split and revisit.
            if level == chunk.depth - TWIG_DEPTH:
                ti = chunk.append_twig(np.zeros(TWIG_WORDS, dtype=np.uint16), dw)
                chunk.tree[idx] = pack_scalar(TWIG, ti)
            else:
                base = chunk.append_trees(
                    np.full(8, pack_scalar(EMPTY, 0), dtype=np.uint32), dt
                )
                chunk.tree[idx] = pack_scalar(BRANCH, base)
            dt.touch(idx, idx + 1)
            stack.append((idx, cmin, size, level))
            continue
        if ty == TWIG:
            ti = node_payload(word)
            mask = _texel_mask(cmin, size, bmin, bmax)
            write = mask & (chunk.twig[ti] == 0)        # only fill empty texels
            if write.any():
                chunk.twig[ti, write] = np.uint16(material)
                dw.touch(ti, ti + 1)
            continue
        base = node_payload(word)
        half = size * np.float32(0.5)
        for i in range(8):
            stack.append((base + i, cmin + _OCTANT[i] * half, half, level + 1))
    return dt, dw


def replace(chunk: Chunk, bmin, bmax, material: int) -> tuple[Dirty, Dirty]:
    """Overwrite the box with ``material`` = carve then fill (reference
    Ocroot::replace, src/Octree.cpp:438-443)."""
    dt, dw = destroy(chunk, bmin, bmax)
    dt2, dw2 = build(chunk, bmin, bmax, material)
    dt.merge(dt2)
    dw.merge(dw2)
    return dt, dw


__all__ = ["destroy", "build", "replace", "boxes_intersect", "box_contains"]
