"""Host-side chunk arena: one octree + its twig (brick) pool.

A Chunk is the host mirror of the reference's Ocroot (src/Octree.h:56-76): a
cube of space at ``position`` with edge ``size``, an octree of max ``depth``
levels stored as a flat uint32 node pool, and a pool of 4^3 twig bricks of
uint16 material ids.  Pools grow by doubling on append.  Device residency is
handled separately (world/device.py) — this struct is pure numpy and is what
worldgen, edits, LOD and persistence operate on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import TWIG_WORDS
from .nodes import pack_scalar, EMPTY

_INITIAL_CAP = 16


@dataclasses.dataclass
class Dirty:
    """Dirty range [left, right) of a pool touched by an edit, for incremental
    device patching; ``realloc`` means the pool storage was reallocated and the
    device copy must be fully re-uploaded (reference Ocdelta, src/Octree.h:47-54)."""

    left: int = np.iinfo(np.int64).max
    right: int = 0
    realloc: bool = False

    def touch(self, left: int, right: int) -> None:
        self.left = min(self.left, left)
        self.right = max(self.right, right)

    def merge(self, other: "Dirty") -> None:
        self.left = min(self.left, other.left)
        self.right = max(self.right, other.right)
        self.realloc = self.realloc or other.realloc

    @property
    def empty(self) -> bool:
        return self.right <= self.left and not self.realloc


@dataclasses.dataclass
class Chunk:
    position: np.ndarray          # float32[3] world-space min corner
    size: float                   # cube edge length
    depth: int                    # octree depth (twigs live at depth-TWIG_DEPTH)
    tree: np.ndarray              # uint32[tree_cap] node pool
    twig: np.ndarray              # uint16[twig_cap, 64] brick pool
    ntrees: int                   # nodes in use
    ntwigs: int                   # twigs in use

    @staticmethod
    def empty_chunk(position, size: float, depth: int) -> "Chunk":
        tree = np.zeros(_INITIAL_CAP, dtype=np.uint32)
        tree[0] = pack_scalar(EMPTY, 0)
        return Chunk(
            position=np.asarray(position, dtype=np.float32),
            size=float(size),
            depth=int(depth),
            tree=tree,
            twig=np.zeros((_INITIAL_CAP, TWIG_WORDS), dtype=np.uint16),
            ntrees=1,
            ntwigs=0,
        )

    # -- pool growth -------------------------------------------------------
    def reserve_trees(self, n: int, dirty: Dirty | None = None) -> None:
        """Ensure capacity for n more nodes, doubling storage as needed."""
        need = self.ntrees + n
        cap = len(self.tree)
        if need > cap:
            while cap < need:
                cap *= 2
            grown = np.zeros(cap, dtype=np.uint32)
            grown[: self.ntrees] = self.tree[: self.ntrees]
            self.tree = grown
            if dirty is not None:
                dirty.realloc = True

    def reserve_twigs(self, n: int, dirty: Dirty | None = None) -> None:
        need = self.ntwigs + n
        cap = len(self.twig)
        if need > cap:
            while cap < need:
                cap *= 2
            grown = np.zeros((cap, TWIG_WORDS), dtype=np.uint16)
            grown[: self.ntwigs] = self.twig[: self.ntwigs]
            self.twig = grown
            if dirty is not None:
                dirty.realloc = True

    def append_twig(self, texels: np.ndarray, dirty: Dirty | None = None) -> int:
        self.reserve_twigs(1, dirty)
        i = self.ntwigs
        self.twig[i] = texels
        self.ntwigs += 1
        if dirty is not None:
            dirty.touch(i, i + 1)
        return i

    def append_trees(self, nodes: np.ndarray, dirty: Dirty | None = None) -> int:
        self.reserve_trees(len(nodes), dirty)
        i = self.ntrees
        self.tree[i : i + len(nodes)] = nodes
        self.ntrees += len(nodes)
        if dirty is not None:
            dirty.touch(i, i + len(nodes))
        return i

    # -- stats -------------------------------------------------------------
    @property
    def bmin(self) -> np.ndarray:
        return self.position

    @property
    def bmax(self) -> np.ndarray:
        return self.position + np.float32(self.size)

    def memory_report(self) -> dict:
        """Node/brick counts and pool utilization (reference Debug.cpp:131-176)."""
        return {
            "trees": self.ntrees,
            "tree_capacity": int(len(self.tree)),
            "tree_bytes": int(len(self.tree) * 4),
            "tree_utilization": self.ntrees / max(1, len(self.tree)),
            "twigs": self.ntwigs,
            "twig_capacity": int(len(self.twig)),
            "twig_bytes": int(self.twig.nbytes),
            "twig_utilization": self.ntwigs / max(1, len(self.twig)),
        }


__all__ = ["Chunk", "Dirty"]
