"""Octree node word packing/unpacking as vectorized integer ops.

A node is one uint32: ``(type << 30) | (payload & 0x3FFFFFFF)``.
The same functions work on python ints and numpy arrays; the host worldgen,
the plain march and the CUDA kernels share one encoding (a numpy copy of
octree_raymarcher_tpu/core/nodes.py).

Capability parity: reference src/Octree.cpp:38-65 (packing, branch index,
octant cut) and src/Octree.cpp:22-30 (twig texel linear index).
"""

from __future__ import annotations

import numpy as np

from .constants import (
    BRANCH,
    EMPTY,
    LEAF,
    OFFSET_MASK,
    TWIG,
    TWIG_SIZE,
    TYPE_SHIFT,
)


def pack_scalar(node_type: int, payload: int) -> int:
    """Pack one (type, payload) into a python-int node word, with bounds checks."""
    assert 0 <= node_type <= 3, node_type
    assert 0 <= payload <= OFFSET_MASK, payload
    return (node_type << TYPE_SHIFT) | payload


def pack(node_type, payload):
    """Pack (type, payload) arrays into uint32 node words."""
    t = np.asarray(node_type).astype(np.uint32) if isinstance(node_type, (int, np.ndarray)) else node_type
    p = np.asarray(payload).astype(np.uint32) if isinstance(payload, (int, np.ndarray)) else payload
    shift = np.uint32(TYPE_SHIFT)
    mask = np.uint32(OFFSET_MASK)
    return (t << shift) | (p.astype(np.uint32) & mask)


def node_type(value):
    """Top 2 bits: EMPTY/LEAF/BRANCH/TWIG."""
    if isinstance(value, (int, np.integer)):
        return int(value) >> TYPE_SHIFT
    return value >> np.uint32(TYPE_SHIFT)


def node_payload(value):
    """Low 30 bits: child block index / twig index / material id."""
    if isinstance(value, (int, np.integer)):
        return int(value) & OFFSET_MASK
    return value & np.uint32(OFFSET_MASK)


def branch_index(xg, yg, zg):
    """Child slot for the (x>=mid, y>=mid, z>=mid) octant: x + 2y + 4z."""
    if isinstance(xg, (bool, int, np.bool_, np.integer)):
        return int(bool(xg)) + 2 * int(bool(yg)) + 4 * int(bool(zg))
    return (
        xg.astype(np.uint32)
        + yg.astype(np.uint32) * np.uint32(2)
        + zg.astype(np.uint32) * np.uint32(4)
    )


def branch_cut(i: int):
    """Inverse of branch_index for a scalar slot: -> (xg, yg, zg) bools."""
    return bool(i & 1), bool(i & 2), bool(i & 4)


def twig_word(x, y, z):
    """Linear texel index inside a 4^3 twig: z*16 + y*4 + x."""
    if isinstance(x, (int, np.integer)):
        assert 0 <= x < TWIG_SIZE and 0 <= y < TWIG_SIZE and 0 <= z < TWIG_SIZE
        return int(z) * TWIG_SIZE * TWIG_SIZE + int(y) * TWIG_SIZE + int(x)
    return z * (TWIG_SIZE * TWIG_SIZE) + y * TWIG_SIZE + x


__all__ = [
    "pack",
    "pack_scalar",
    "node_type",
    "node_payload",
    "branch_index",
    "branch_cut",
    "twig_word",
    "EMPTY",
    "LEAF",
    "BRANCH",
    "TWIG",
]
