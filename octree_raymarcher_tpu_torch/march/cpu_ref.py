"""Scalar host reference raymarcher — the correctness oracle.

A numpy copy of octree_raymarcher_tpu/march/cpu_ref.py.  Readable, per-ray,
pure-numpy restart-DDA over a host Chunk: point-locate the cell containing
the ray point, skip empty cells by their slab exit distance, voxel-step
inside twigs, stop at the first solid leaf/texel.  ``world/pick.py`` marches
the edit cursor's ray with ``chunkmarch``.

Algorithm parity: reference src/Traverse.cpp (CPU marcher) and
shaders/Chunkmarch.glsl:169-330 (GPU marcher) — the same three-level
traverse/twigmarch/treemarch/chunkmarch structure, with the GPU side's
degenerate-escape clamp (escape < EPS -> BIGEPS) so float behavior matches
the march kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.chunk import Chunk
from ..core.constants import BIGEPS, BRANCH, EMPTY, EPS, LEAF, TWIG, TWIG_DEPTH, TWIG_SIZE
from ..core.nodes import branch_index, node_payload, node_type, twig_word


@dataclasses.dataclass
class Hit:
    hit: bool
    t: float = np.inf          # distance along the ray to the hit point
    material: int = 0          # material id (leaf payload / twig texel)
    bmin: np.ndarray = None    # hit cell min corner
    size: float = 0.0          # hit cell edge
    steps: int = 0             # traversal cost counter (debug AOV)


def _inside(p, cmin, cmax) -> bool:
    return bool(np.all(p >= cmin) and np.all(p <= cmax))


def _escape(p, g, cmin, cmax) -> float:
    t = np.maximum((cmin - p) * g, (cmax - p) * g)
    d = float(np.min(t))
    return BIGEPS if d < EPS else d


def _enter(p, g, cmin, cmax):
    tmin = (cmin - p) * g
    tmax = (cmax - p) * g
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    tnear = float(np.max(t1))
    tfar = float(np.min(t2))
    return tnear, (tfar > tnear and tnear > 0)


def _safe_inv(d):
    eps = np.float32(1e-30)
    safe = np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)
    return (np.float32(1.0) / safe).astype(np.float32)


def descend(chunk: Chunk, p, max_depth: int = 32):
    """Point-locate: root-to-leaf descent to the cell containing p.

    Returns (node_index, cell_bmin, cell_size)."""
    bmin = chunk.position.copy()
    size = np.float32(chunk.size)
    idx = 0
    for _ in range(max_depth):
        word = int(chunk.tree[idx])
        if node_type(word) != BRANCH:
            break
        half = size * np.float32(0.5)
        mid = bmin + half
        ge = p >= mid
        idx = node_payload(word) + branch_index(bool(ge[0]), bool(ge[1]), bool(ge[2]))
        bmin = bmin + ge.astype(np.float32) * half
        size = half
    return idx, bmin, size


def twigmarch(chunk: Chunk, twig_idx: int, a, b, g, cmin, size, max_steps: int = 64):
    """Voxel-step inside one 4^3 twig. Returns Hit with t relative to `a`."""
    cmax = cmin + size
    leafsize = size / np.float32(1 << TWIG_DEPTH)
    texels = chunk.twig[twig_idx]
    t = np.float32(0.0)
    for step in range(max_steps):
        p = a + b * t
        if not _inside(p, cmin, cmax):
            break
        off = ((p - cmin) / leafsize).astype(np.int64)
        if np.any(off < 0) or np.any(off > TWIG_SIZE - 1):
            break
        mat = int(texels[twig_word(int(off[0]), int(off[1]), int(off[2]))])
        leafmin = cmin + off.astype(np.float32) * leafsize
        if mat != 0:
            return Hit(True, float(t), mat, leafmin, float(leafsize), step)
        t += _escape(p, g, leafmin, leafmin + leafsize) + np.float32(EPS)
    return Hit(False, float(t), steps=max_steps)


def treemarch(chunk: Chunk, a, b, g=None, max_steps: int = 512):
    """March one chunk from point a (assumed at/inside the chunk box).

    Returns Hit with t relative to `a`."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    g = _safe_inv(b) if g is None else g
    rmin = chunk.position
    rmax = chunk.position + np.float32(chunk.size)
    t = np.float32(0.0)
    steps = 0
    for _ in range(max_steps):
        steps += 1
        p = a + b * t
        if not _inside(p, rmin, rmax):
            break
        idx, bmin, size = descend(chunk, p)
        word = int(chunk.tree[idx])
        ty = node_type(word)
        if ty == LEAF:
            return Hit(True, float(t), node_payload(word), bmin, float(size), steps)
        esc = _escape(p, g, bmin, bmin + size) + np.float32(EPS)
        if ty == TWIG:
            h = twigmarch(chunk, node_payload(word), p, b, g, bmin, size)
            steps += h.steps
            if h.hit:
                return Hit(True, float(t + h.t), h.material, h.bmin, h.size, steps)
        elif ty != EMPTY:
            raise AssertionError(f"unexpected node type {ty} at {idx}")
        t += esc
    return Hit(False, float(t), steps=steps)


def chunkmarch(world, a, b, max_steps: int = 256):
    """March a multi-chunk world (toroidal chunk indexing).

    `world` needs: chunksize, dims (w,h,d), chunkcoordmin (ivec3), and
    chunk_at(ix,iy,iz) -> Chunk.  Returns Hit with t relative to `a`."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    g = _safe_inv(b)
    cs = np.float32(world.chunksize)
    lo = np.asarray(world.chunkcoordmin, dtype=np.float32) * cs
    hi = lo + np.asarray(world.dims, dtype=np.float32) * cs

    t = np.float32(0.0)
    if not _inside(a, lo, hi):
        tn, ok = _enter(a, g, lo, hi)
        if not ok:
            return Hit(False)
        t = np.float32(tn + EPS)

    steps = 0
    for _ in range(max_steps):
        steps += 1
        p = a + b * t
        if not _inside(p, lo, hi):
            break
        q = np.floor(p / cs).astype(np.int64)
        chunk = world.chunk_at(int(q[0]), int(q[1]), int(q[2]))
        cmin = chunk.position
        cmax = cmin + np.float32(chunk.size)
        if not _inside(p, cmin, cmax):
            break
        h = treemarch(chunk, p, b, g)
        steps += h.steps
        if h.hit:
            return Hit(True, float(t + h.t), h.material, h.bmin, h.size, steps)
        t += _escape(p, g, cmin, cmax) + np.float32(EPS)
    return Hit(False, float(t), steps=steps)


def render_depth(chunk: Chunk, origins, dirs, max_steps: int = 512):
    """Tiny helper: march a batch of rays against one chunk, return (hitmask,
    t, material) arrays.  Slow (python loop) — test/oracle use only."""
    n = len(origins)
    hits = np.zeros(n, dtype=bool)
    ts = np.full(n, np.inf, dtype=np.float32)
    mats = np.zeros(n, dtype=np.int32)
    for i in range(n):
        a = np.asarray(origins[i], dtype=np.float32)
        b = np.asarray(dirs[i], dtype=np.float32)
        g = _safe_inv(b)
        rmin, rmax = chunk.position, chunk.position + np.float32(chunk.size)
        t0 = np.float32(0.0)
        ok = True
        if not _inside(a, rmin, rmax):
            tn, ok = _enter(a, g, rmin, rmax)
            t0 = np.float32(tn + EPS)
        if not ok:
            continue
        h = treemarch(chunk, a + b * t0, b, g, max_steps)
        if h.hit:
            hits[i] = True
            ts[i] = t0 + h.t
            mats[i] = h.material
    return hits, ts, mats


__all__ = ["Hit", "descend", "twigmarch", "treemarch", "chunkmarch", "render_depth"]
