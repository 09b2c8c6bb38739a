"""Packed pools (frozen copy of the port's world/device.py host packing and
its tensor holder, without the device helpers)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import TWIG_WORDS

@dataclasses.dataclass
class PackedWorld:
    """Host pools in the DeviceWorld layout (numpy; u32 pools)."""

    tree: np.ndarray               # uint32[tree_cap] node pool
    twig: np.ndarray               # uint32[twig_cap * 64] flat twig texels
    twig_occ: np.ndarray           # uint32[twig_cap * 2] 64-bit occupancy masks
    chunk_bmin: np.ndarray         # float32[V, 3] chunk min corners
    chunk_tree: np.ndarray         # int32[V] chunk base offset into `tree`
    chunk_twig: np.ndarray         # int32[V] chunk base *twig index* offset
    chunkcoordmin: np.ndarray      # float32[3] min chunk coordinate
    chunksize: float
    dims: tuple                    # (w, h, d) chunks
    depth: int                     # max octree depth


@dataclasses.dataclass
class TorchWorld:
    """The fields of the JAX DeviceWorld, as tensors on one device."""

    tree: torch.Tensor             # int32[tree_cap] (u32 bits) node pool
    twig: torch.Tensor             # int32[twig_cap * 64] flat twig texels
    twig_occ: torch.Tensor         # int32[twig_cap * 2] occupancy masks
    chunk_bmin: torch.Tensor       # float32[V, 3]
    chunk_tree: torch.Tensor       # int32[V]
    chunk_twig: torch.Tensor       # int32[V]
    chunkcoordmin: torch.Tensor    # float32[3]
    chunksize: float
    dims: tuple
    depth: int

    @property
    def num_chunks(self) -> int:
        w, h, d = self.dims
        return w * h * d

    @property
    def device(self) -> torch.device:
        return self.tree.device

    @property
    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.tree, self.twig, self.twig_occ))

    @staticmethod
    def from_numpy(obj, device="cuda") -> "TorchWorld":
        """Carry a packed world across: ``obj`` is any object with the
        DeviceWorld attributes as numpy arrays (the JAX package's
        ``to_device(device=False)`` output, or :func:`pack_chunks`)."""
        dev = torch.device(device)

        def pool(a):
            a = np.ascontiguousarray(np.asarray(a))
            if a.dtype not in (np.uint32, np.int32):
                raise TypeError(f"pool dtype must be uint32 or int32, got {a.dtype}")
            return torch.from_numpy(a.view(np.int32).copy()).to(dev)

        def arr(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        return TorchWorld(
            tree=pool(obj.tree),
            twig=pool(obj.twig),
            twig_occ=pool(obj.twig_occ),
            chunk_bmin=arr(obj.chunk_bmin, np.float32).reshape(-1, 3),
            chunk_tree=arr(obj.chunk_tree, np.int32),
            chunk_twig=arr(obj.chunk_twig, np.int32),
            chunkcoordmin=arr(obj.chunkcoordmin, np.float32),
            chunksize=float(obj.chunksize),
            dims=tuple(int(v) for v in obj.dims),
            depth=int(obj.depth),
        )

    def to_numpy(self) -> PackedWorld:
        """The pools back on the host, u32 pools as uint32."""
        def pool(t):
            return t.cpu().numpy().view(np.uint32)

        return PackedWorld(
            tree=pool(self.tree), twig=pool(self.twig),
            twig_occ=pool(self.twig_occ),
            chunk_bmin=self.chunk_bmin.cpu().numpy(),
            chunk_tree=self.chunk_tree.cpu().numpy(),
            chunk_twig=self.chunk_twig.cpu().numpy(),
            chunkcoordmin=self.chunkcoordmin.cpu().numpy(),
            chunksize=self.chunksize, dims=self.dims, depth=self.depth,
        )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def occupancy_masks(twig_flat: np.ndarray) -> np.ndarray:
    """64-bit occupancy bitmask per twig, as uint32 pairs [lo, hi].

    The march inner loop only needs "is this texel solid?"; one bit per
    texel shrinks the per-step table 32x (materials are read once per ray,
    after the loop)."""
    words = twig_flat.reshape(-1, TWIG_WORDS) != 0          # [M, 64] bool
    bits = words.astype(np.uint64) << np.arange(TWIG_WORDS, dtype=np.uint64)
    mask64 = np.bitwise_or.reduce(bits, axis=1)             # [M]
    occ = np.empty(words.shape[0] * 2, dtype=np.uint32)
    occ[0::2] = (mask64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    occ[1::2] = (mask64 >> np.uint64(32)).astype(np.uint32)
    return occ


def pack_chunks(
    chunks: list,
    dims: tuple,
    chunkcoordmin=(0, 0, 0),
    tree_slack: float = 1.0,
    twig_slack: float = 1.0,
) -> PackedWorld:
    """Assemble host chunks (storage order: index = x + z*w + y*w*d) into
    pools as numpy arrays, bit-identical to the JAX package's pack_chunks.

    ``*_slack > 1`` over-allocates pool capacity so in-place edits can grow
    chunks without reallocating the arena.
    """
    w, h, d = dims
    assert len(chunks) == w * h * d, (len(chunks), dims)
    depth = max(c.depth for c in chunks)
    chunksize = chunks[0].size

    tree_offs, twig_offs = [], []
    tree_total, twig_total = 0, 0
    for c in chunks:
        assert c.size == chunksize, "all chunks must share one size"
        tree_offs.append(tree_total)
        twig_offs.append(twig_total)
        tree_total += _round_up(c.ntrees, 8)
        twig_total += c.ntwigs

    tree_cap = _round_up(max(1, int(tree_total * tree_slack)), 128)
    twig_cap = _round_up(max(1, int(twig_total * twig_slack)), 2)

    tree = np.zeros(tree_cap, dtype=np.uint32)
    twig = np.zeros(twig_cap * TWIG_WORDS, dtype=np.uint32)
    for c, to, wo in zip(chunks, tree_offs, twig_offs):
        tree[to : to + c.ntrees] = c.tree[: c.ntrees]
        twig[wo * TWIG_WORDS : (wo + c.ntwigs) * TWIG_WORDS] = (
            c.twig[: c.ntwigs].astype(np.uint32).reshape(-1)
        )

    return PackedWorld(
        tree=tree,
        twig=twig,
        twig_occ=occupancy_masks(twig),
        chunk_bmin=np.stack([c.position for c in chunks]).astype(np.float32),
        chunk_tree=np.asarray(tree_offs, dtype=np.int32),
        chunk_twig=np.asarray(twig_offs, dtype=np.int32),
        chunkcoordmin=np.asarray(chunkcoordmin, dtype=np.float32),
        chunksize=float(chunksize),
        dims=(w, h, d),
        depth=depth,
    )
