"""Pool arena allocator and the batched device pool patch (kernel K7).

The host half is a numpy copy of octree_raymarcher_tpu/world/alloc.py
(reference LinkedFreeChunkList / Allocator / RootAllocator,
src/Allocator.cpp:7-266): each chunk owns a block in the tree pool and one
in the twig pool, tracked by a sorted coalescing free list; a block that
outgrows its slot is freed and re-placed first-fit, doubling the arena when
full (reference Region::grow, src/Allocator.cpp:138-159).  ``pack`` gives
pools bit-identical to the JAX package's ``WorldAllocator.pack``.

The device half replaces the JAX package's per-range donated
``dynamic_update_slice`` programs (``_patch``/``_patch_blend``, B8).  An edit
batch is planned on the host first: the bookkeeping of every chunk, in the
batch's order, then rows (target array, destination word, source word,
length) over one stream of words, laid out for K7 (:func:`layout`: pieces of
at most PIECE_WORDS, each source congruent to its destination mod 4).  The
pools grow once, to the batch's final capacity; the words go to the card
through one pinned buffer the allocator owns, in one non-blocking copy; and
K7 (``csrc/patch.cu``) writes every range with the rows in its launch's
parameter block, one launch per ROW_CAPS[-1] rows, deriving each twig's
occupancy words from the twig words it writes.  On a CPU world
:func:`patch_plain` does the same with slice assignments.  The pools are
updated in place (the JAX package donates them).

Every chunk's writes in a batch carry its final host content to its final
block (a chunk named twice keeps the block its first placement chose, since
its size does not change in between), so the union of the ranges the JAX
package writes one by one is written here once, as disjoint ranges, and the
pools end bit-identical to the JAX package's, stale words in freed spans
included.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..core.chunk import Chunk, Dirty
from ..core.constants import TWIG_WORDS
from ..kernels import Kernel, ptr
from .device import PackedWorld, TorchWorld, occupancy_masks, resolve_device

PATCH_KERNEL = Kernel("ort_patch")

# Target arrays of a patch row (csrc/patch.cu enum Target).
TREE, TWIG, CHUNK_BMIN, CHUNK_TREE, CHUNK_TWIG = range(5)
# The longest range one K7 block copies (csrc/patch.cu kPieceWords, a
# multiple of its 4 * 256 threads): each thread holds two int4 words of a
# piece in flight, and a one-chunk edit still spreads over dozens of SMs.
PIECE_WORDS = 2048
# The row capacities of K7's parameter block (csrc/patch.cu kRowCaps): a
# launch carries the smallest that holds its rows (1, 8 or 32 KB).
ROW_CAPS = (64, 512, 2044)
VEC_WORDS = 4                       # words in one 16-byte load of K7
INT32_MAX = np.iinfo(np.int32).max


class FreeList:
    """Sorted [offset, size) spans with coalescing release and first-fit take
    (reference LinkedFreeChunkList, src/Allocator.cpp:191-266)."""

    def __init__(self, capacity: int):
        self.spans: list[list[int]] = [[0, capacity]] if capacity > 0 else []
        self.capacity = capacity

    def take(self, size: int) -> int | None:
        """First-fit allocate; returns offset or None when nothing fits."""
        assert size > 0
        for i, (off, sz) in enumerate(self.spans):
            if sz >= size:
                if sz == size:
                    self.spans.pop(i)
                else:
                    self.spans[i] = [off + size, sz - size]
                return off
        return None

    def give(self, offset: int, size: int) -> None:
        """Release a span, merging with adjacent free neighbours."""
        assert size > 0
        lo = 0
        hi = len(self.spans)
        while lo < hi:                      # insertion point by offset
            mid = (lo + hi) // 2
            if self.spans[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        self.spans.insert(lo, [offset, size])
        # merge right then left
        if lo + 1 < len(self.spans) and offset + size == self.spans[lo + 1][0]:
            self.spans[lo][1] += self.spans[lo + 1][1]
            self.spans.pop(lo + 1)
        if lo > 0 and self.spans[lo - 1][0] + self.spans[lo - 1][1] == offset:
            self.spans[lo - 1][1] += self.spans[lo][1]
            self.spans.pop(lo)

    def extend(self, new_capacity: int) -> None:
        """Grow the arena; the new tail becomes one free span."""
        assert new_capacity > self.capacity
        self.give(self.capacity, new_capacity - self.capacity)
        self.capacity = new_capacity

    @property
    def free(self) -> int:
        return sum(sz for _, sz in self.spans)

    def check(self) -> None:
        """Invariants: spans sorted, non-overlapping, and never adjacent
        (give() must have coalesced them)."""
        for a, b in zip(self.spans, self.spans[1:]):
            assert a[0] + a[1] < b[0], (a, b)
        for off, sz in self.spans:
            assert sz > 0 and 0 <= off and off + sz <= self.capacity, (off, sz)


@dataclasses.dataclass
class Block:
    offset: int   # element offset into the pool
    size: int     # reserved elements (>= used)
    used: int     # elements currently meaningful


class PoolAllocator:
    """Per-key block bookkeeping over one arena (reference Allocator,
    src/Allocator.cpp:63-114, collapsed to one region that grows by
    extending the arena)."""

    def __init__(self, capacity: int, slack: float = 1.5, align: int = 8):
        self.freelist = FreeList(capacity)
        self.blocks: dict[int, Block] = {}
        self.slack = slack
        self.align = align
        self.grown = False   # capacity changed since last device sync

    def _reserve_size(self, used: int) -> int:
        n = max(1, int(used * self.slack))
        return ((n + self.align - 1) // self.align) * self.align

    def place(self, key: int, used: int) -> Block:
        """(Re)place ``key`` with room for ``used`` elements.  Keeps the
        current block when it still fits; otherwise frees it and takes a new
        first-fit span, doubling the arena until one fits."""
        blk = self.blocks.get(key)
        if blk is not None and blk.size >= used:
            blk.used = used
            return blk
        if blk is not None:
            self.freelist.give(blk.offset, blk.size)
        want = self._reserve_size(used)
        off = self.freelist.take(want)
        while off is None:
            self.freelist.extend(max(self.freelist.capacity * 2, want * 2))
            self.grown = True
            off = self.freelist.take(want)
        blk = Block(offset=off, size=want, used=used)
        self.blocks[key] = blk
        return blk

    def free(self, key: int) -> None:
        blk = self.blocks.pop(key, None)
        if blk is not None:
            self.freelist.give(blk.offset, blk.size)

    @property
    def capacity(self) -> int:
        return self.freelist.capacity

    def occupancy(self) -> dict:
        """Pool stats for the metrics HUD (reference Main.cpp:277-311)."""
        used = sum(b.size for b in self.blocks.values())
        return {
            "capacity": self.capacity,
            "reserved": used,
            "utilization": used / max(1, self.capacity),
            "blocks": len(self.blocks),
            "free_spans": len(self.freelist.spans),
        }


# ---------------------------------------------------------------- the batch
@dataclasses.dataclass
class PatchBatch:
    """The pool writes of one edit batch.

    ``desc`` int64[R, 4] rows are (target array, destination word, source
    word, length) over the int32 ``words``, laid out by :func:`layout`;
    chunk_bmin is addressed as the int32 bits of its float32[V*3].  A TWIG
    row starts and ends on a twig boundary, and its occupancy words are
    derived from the words it writes.  The ``*_s`` fields are host seconds of
    :meth:`WorldAllocator.modify_batch`'s steps: plan, grow, check_batch, the
    staging buffer's wait and growth (``alloc_s``), its fill, the copy's
    enqueue and K7's launch enqueue."""

    desc: np.ndarray
    words: np.ndarray
    chunks: int
    plan_s: float = 0.0
    grow_s: float = 0.0
    check_s: float = 0.0
    alloc_s: float = 0.0
    fill_s: float = 0.0
    copy_s: float = 0.0
    launch_s: float = 0.0

    @property
    def words_written(self) -> int:
        """Pool and chunk-table words written, occupancy words included."""
        lengths = self.desc[:, 3]
        return int(lengths.sum() + lengths[self.desc[:, 0] == TWIG].sum() // 32)


def _union(ranges):
    """Disjoint sorted [lo, hi) ranges covering the union of ``ranges``."""
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def layout(ranges) -> tuple[np.ndarray, np.ndarray]:
    """K7's rows and word stream for ``ranges`` [(target, dst, int32
    words)]: each range is cut into pieces of at most PIECE_WORDS, and its
    words start at a source congruent to ``dst`` mod 4 (mod TWIG_WORDS on
    the twig pool, whose ranges start on a twig), zero words padding the
    stream in between that no row covers."""
    desc, segs, src = [], [], 0
    for target, dst, seg in ranges:
        pad = (dst - src) % (TWIG_WORDS if target == TWIG else VEC_WORDS)
        if pad:
            segs.append(np.zeros(pad, np.int32))
            src += pad
        desc += [(target, dst + k, src + k, min(PIECE_WORDS, seg.size - k))
                 for k in range(0, seg.size, PIECE_WORDS)]
        segs.append(seg)
        src += seg.size
    return (np.asarray(desc, dtype=np.int64).reshape(-1, 4),
            np.concatenate(segs) if segs else np.zeros(0, np.int32))


def launch_groups(n_rows: int) -> list[tuple[int, int, int]]:
    """(first row, end row, row capacity) of each K7 launch of a batch of
    ``n_rows`` rows: ROW_CAPS[-1] rows a launch, each carried by the
    smallest capacity that holds them."""
    return [(lo, min(n_rows, lo + ROW_CAPS[-1]),
             next(c for c in ROW_CAPS if c >= min(n_rows - lo, ROW_CAPS[-1])))
            for lo in range(0, n_rows, ROW_CAPS[-1])]


def pack_rows(desc: np.ndarray) -> np.ndarray:
    """The rows as K7 takes them in its parameter block: C-contiguous
    int32[R, 4] (target, dst, src, length), 16 bytes a row."""
    rows = np.ascontiguousarray(desc, dtype=np.int32)
    if not np.array_equal(rows, desc):
        raise ValueError("patch rows must fit int32 (check_batch)")
    return rows


def occupancy_words(twig_words: torch.Tensor) -> torch.Tensor:
    """:func:`~.device.occupancy_masks` in torch: int32[M*2] (u32 bits) for
    int32[M*64] twig words; bit k of word 2t+h is word 32h+k of twig t != 0."""
    nz = (twig_words.view(-1, 2, 32) != 0).to(torch.int64)
    bits = (nz << torch.arange(32, device=twig_words.device)).sum(dim=-1).reshape(-1)
    return (bits - ((bits >> 31) << 32)).to(torch.int32)


def _targets(world: TorchWorld) -> tuple:
    return (world.tree, world.twig, world.chunk_bmin.view(torch.int32).view(-1),
            world.chunk_tree, world.chunk_twig)


def check_batch(world: TorchWorld, desc: np.ndarray, n_words: int) -> None:
    """Raise unless every row fits int32, lies inside its target and the
    word stream, is at most PIECE_WORDS long with its source congruent to
    its destination mod 4, and covers whole twigs on the twig pool."""
    if desc.ndim != 2 or desc.shape[1] != 4 or desc.dtype != np.int64:
        raise ValueError(f"descriptors must be int64[R, 4], got {desc.dtype}{desc.shape}")
    tgt, dst, src, n = desc.T
    if ((dst + n > INT32_MAX) | (src + n > INT32_MAX)).any():
        raise ValueError("patch rows must fit int32: a row ends past 2**31 - 1")
    sizes = np.asarray([t.numel() for t in _targets(world)], dtype=np.int64)
    if ((tgt < 0) | (tgt >= len(sizes))).any():
        raise ValueError("descriptor names an unknown target array")
    bad = (n <= 0) | (n > PIECE_WORDS) | (dst < 0) | (src < 0)
    bad |= (dst + n > sizes[tgt]) | (src + n > n_words)
    bad |= (src - dst) % VEC_WORDS != 0
    bad |= (tgt == TWIG) & ((dst % TWIG_WORDS != 0) | (n % TWIG_WORDS != 0))
    if bad.any():
        raise ValueError(f"descriptor out of bounds or out of layout: {desc[bad][0].tolist()}")


def patch_plain(world: TorchWorld, desc: torch.Tensor, words: torch.Tensor) -> None:
    """K7's plain version: ``target[dst:dst+n] = words[src:src+n]`` for each
    descriptor row, and the occupancy words of each TWIG row."""
    targets = _targets(world)
    for tgt, dst, src, n in desc.tolist():
        seg = words[src:src + n]
        targets[tgt][dst:dst + n] = seg
        if tgt == TWIG:
            world.twig_occ[dst // 32:(dst + n) // 32] = occupancy_words(seg)


def kernel_pointers(world: TorchWorld, staged: torch.Tensor) -> list[int]:
    """K7's pool and word pointers, in its C entry's order; raises unless
    each lies on a 16-byte boundary."""
    tree, twig, bmin, ctree, ctwig = _targets(world)
    ptrs = [ptr(t) for t in (tree, twig, world.twig_occ, bmin, ctree, ctwig, staged)]
    if any(p % 16 for p in ptrs):
        raise ValueError("K7 needs its pools and words on 16-byte boundaries")
    return ptrs


def patch(world: TorchWorld, desc: np.ndarray, staged: torch.Tensor) -> None:
    """Apply a batch's rows ``desc`` over its ``staged`` words to
    ``world``'s pools in place: K7 on a CUDA world, its rows packed into
    each launch (:func:`launch_groups`), :func:`patch_plain` on a CPU one."""
    if (staged.device != world.device or staged.dtype != torch.int32
            or not staged.is_contiguous()):
        raise ValueError(f"staged words must be contiguous int32 on {world.device}")
    if not world.tree.is_cuda:
        patch_plain(world, torch.from_numpy(desc), staged)
        return
    rows = pack_rows(desc)
    ptrs = kernel_pointers(world, staged)
    for lo, hi, cap in launch_groups(rows.shape[0]):
        PATCH_KERNEL(*ptrs, rows[lo:].ctypes.data, hi - lo, cap)


def dev_alias(fn):
    """Let ``fn``, whose device world is the reference's ``dev``, take it
    as ``world=`` too; its signature is otherwise the reference's."""
    @functools.wraps(fn)
    def call(*args, **kw):
        if "world" in kw:
            if "dev" in kw:
                raise TypeError(f"{fn.__name__}() got both dev and its alias world")
            kw["dev"] = kw.pop("world")
        return fn(*args, **kw)
    return call


def _grow_pool(t: torch.Tensor, n: int) -> torch.Tensor:
    """A zeroed pool of ``n`` words holding ``t`` at its head (rare: the
    arena doubled)."""
    if t.shape[0] >= n:
        return t
    out = torch.zeros(n, dtype=t.dtype, device=t.device)
    out[:t.shape[0]].copy_(t)
    return out


class WorldAllocator:
    """Pairs the tree and twig pool allocators and patches chunk edits into a
    TorchWorld (reference RootAllocator::{alloc,subst},
    src/Allocator.cpp:7-61 + World::modify, src/World.cpp:268-274).

    Build once with ``WorldAllocator.pack(chunks, dims)`` (or
    ``World.to_device``), then ``world = wa.modify_batch(world, items)``
    after host edits; ``last_batch`` holds the batch last applied."""

    def __init__(self, tree: PoolAllocator, twig: PoolAllocator):
        self.tree = tree
        self.twig = twig
        self.last_batch: PatchBatch | None = None
        self._pinned: torch.Tensor | None = None     # the staging buffer
        self._copied: torch.cuda.Event | None = None  # recorded after its last copy

    # -- construction ------------------------------------------------------
    @staticmethod
    def pack(chunks: list[Chunk], dims: tuple, chunkcoordmin=(0, 0, 0),
             slack: float = 1.5, device="cuda") -> tuple["WorldAllocator", TorchWorld]:
        """Place every chunk and upload the pools to ``device``; the pools are
        bit-identical to the JAX package's ``pack``."""
        dev = resolve_device(device)
        w, h, d = dims
        assert len(chunks) == w * h * d
        wa = WorldAllocator(
            PoolAllocator(1, slack=slack, align=8),
            PoolAllocator(1, slack=slack, align=2),
        )
        tree_offs, twig_offs = [], []
        for i, c in enumerate(chunks):
            tree_offs.append(wa.tree.place(i, c.ntrees).offset)
            twig_offs.append(wa.twig.place(i, max(1, c.ntwigs)).offset)

        tree = np.zeros(wa.tree.capacity, dtype=np.uint32)
        twig = np.zeros(wa.twig.capacity * TWIG_WORDS, dtype=np.uint32)
        for c, to, wo in zip(chunks, tree_offs, twig_offs):
            tree[to : to + c.ntrees] = c.tree[: c.ntrees]
            twig[wo * TWIG_WORDS : (wo + c.ntwigs) * TWIG_WORDS] = (
                c.twig[: c.ntwigs].astype(np.uint32).reshape(-1)
            )
        wa.tree.grown = wa.twig.grown = False
        packed = PackedWorld(
            tree=tree,
            twig=twig,
            twig_occ=occupancy_masks(twig),
            chunk_bmin=np.stack([c.position for c in chunks]).astype(np.float32),
            chunk_tree=np.asarray(tree_offs, dtype=np.int32),
            chunk_twig=np.asarray(twig_offs, dtype=np.int32),
            chunkcoordmin=np.asarray(chunkcoordmin, dtype=np.float32),
            chunksize=float(chunks[0].size),
            dims=(w, h, d),
            depth=max(c.depth for c in chunks),
        )
        return wa, TorchWorld.from_numpy(packed, device=dev)

    @staticmethod
    def from_state(obj) -> "WorldAllocator":
        """Carry an allocator across: ``obj`` is any object with the JAX
        package's WorldAllocator attributes (``tree``/``twig`` with
        ``freelist.spans``, ``freelist.capacity``, ``blocks`` of
        offset/size/used, ``slack``, ``align`` and ``grown``)."""
        def pool(p) -> PoolAllocator:
            out = PoolAllocator(int(p.freelist.capacity), slack=float(p.slack),
                                align=int(p.align))
            out.freelist.spans = [[int(o), int(s)] for o, s in p.freelist.spans]
            out.blocks = {int(k): Block(int(b.offset), int(b.size), int(b.used))
                          for k, b in p.blocks.items()}
            out.grown = bool(p.grown)
            return out

        return WorldAllocator(pool(obj.tree), pool(obj.twig))

    # -- incremental update ------------------------------------------------
    def plan(self, items) -> PatchBatch:
        """Run the bookkeeping of ``items`` [(key, chunk, Dirty tree, Dirty
        twig)] in order, as the JAX package's ``modify`` does one by one, and
        return the batch of pool writes it calls for."""
        ranges: dict[int, tuple[list, list]] = {}
        final: dict[int, Chunk] = {}
        for key, chunk, dtree, dtwig in items:
            if dtree.empty and dtwig.empty:
                continue
            old_t = self.tree.blocks.get(key)
            old_w = self.twig.blocks.get(key)
            blk_t = self.tree.place(key, chunk.ntrees)
            blk_w = self.twig.place(key, max(1, chunk.ntwigs))
            moved_t = old_t is None or blk_t.offset != old_t.offset
            moved_w = old_w is None or blk_w.offset != old_w.offset
            tr, tw = ranges.setdefault(key, ([], []))
            # Full re-upload when moved/realloc'd, else the dirty range.
            for moved, dirty, n, out in ((moved_t, dtree, chunk.ntrees, tr),
                                         (moved_w, dtwig, chunk.ntwigs, tw)):
                if moved or dirty.realloc:
                    lo, hi = 0, n
                else:
                    lo, hi = max(0, dirty.left), min(n, dirty.right)
                if hi > lo:
                    out.append((lo, hi))
            final[key] = chunk

        writes = []
        for key, chunk in final.items():
            t_off = self.tree.blocks[key].offset
            w_off = self.twig.blocks[key].offset
            tr, tw = ranges[key]
            writes += [(TREE, t_off + lo, chunk.tree[lo:hi].view(np.int32))
                       for lo, hi in _union(tr)]
            writes += [(TWIG, (w_off + lo) * TWIG_WORDS,
                        chunk.twig[lo:hi].astype(np.uint32).reshape(-1).view(np.int32))
                       for lo, hi in _union(tw)]
            writes += [(CHUNK_BMIN, 3 * key, np.asarray(chunk.position, np.float32).view(np.int32)),
                       (CHUNK_TREE, key, np.asarray([t_off], np.int32)),
                       (CHUNK_TWIG, key, np.asarray([w_off], np.int32))]
        desc, words = layout(writes)
        return PatchBatch(desc=desc, words=words, chunks=len(final))

    def grow(self, world: TorchWorld) -> TorchWorld:
        """``world`` with its pools at this allocator's capacities (new
        zeroed tensors holding the old content when the arena doubled)."""
        if not (self.tree.grown or self.twig.grown):
            return world
        self.tree.grown = self.twig.grown = False
        return dataclasses.replace(
            world,
            tree=_grow_pool(world.tree, self.tree.capacity),
            twig=_grow_pool(world.twig, self.twig.capacity * TWIG_WORDS),
            twig_occ=_grow_pool(world.twig_occ, self.twig.capacity * 2),
        )

    def stage(self, batch: PatchBatch, device: torch.device) -> torch.Tensor:
        """``batch.words`` on ``device``.  For a GPU they go through one
        pinned host buffer that this allocator owns and grows by doubling,
        in one non-blocking copy on the current stream; before the host
        writes a batch into the buffer it waits for the event recorded
        after the previous batch's copy, which may still be reading it.
        Sets the batch's ``alloc_s``, ``fill_s`` and ``copy_s``."""
        if device.type != "cuda":
            return torch.from_numpy(batch.words)
        t0 = time.perf_counter()
        n = batch.words.size
        if self._copied is not None:
            self._copied.synchronize()
        if self._pinned is None or self._pinned.numel() < n:
            size = max(n, 2 * self._pinned.numel()) if self._pinned is not None else n
            self._pinned = torch.empty(size, dtype=torch.int32, pin_memory=True)
        t1 = time.perf_counter()
        self._pinned.numpy()[:n] = batch.words
        t2 = time.perf_counter()
        out = torch.empty(n, dtype=torch.int32, device=device)
        out.copy_(self._pinned[:n], non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record()
        batch.alloc_s, batch.fill_s, batch.copy_s = t1 - t0, t2 - t1, time.perf_counter() - t2
        return out

    def modify_batch(self, world: TorchWorld, items) -> TorchWorld:
        """Apply an edit batch [(key, chunk, Dirty tree, Dirty twig)] to
        ``world``: bookkeeping, one growth, one staging copy and K7's
        launches (or :func:`patch_plain` on a CPU world).  Returns the world,
        whose pools are updated in place unless they grew."""
        t0 = time.perf_counter()
        batch = self.plan(items)
        t1 = time.perf_counter()
        world = self.grow(world)
        t2 = time.perf_counter()
        self.last_batch = None
        if batch.chunks == 0:
            return world
        check_batch(world, batch.desc, batch.words.size)
        t3 = time.perf_counter()
        staged = self.stage(batch, world.device)
        t4 = time.perf_counter()
        patch(world, batch.desc, staged)
        batch.plan_s, batch.grow_s, batch.check_s = t1 - t0, t2 - t1, t3 - t2
        batch.launch_s = time.perf_counter() - t4
        self.last_batch = batch
        return world

    @dev_alias
    def modify(self, dev: TorchWorld, key: int, chunk: Chunk, dtree: Dirty,
               dtwig: Dirty) -> TorchWorld:
        """Apply one edited chunk's dirty ranges (a batch of one) to the
        device world ``dev`` (``world=`` is an alias)."""
        return self.modify_batch(dev, [(key, chunk, dtree, dtwig)])

    def occupancy(self) -> dict:
        return {"tree": self.tree.occupancy(), "twig": self.twig.occupancy()}


__all__ = ["FreeList", "PoolAllocator", "WorldAllocator", "Block", "PatchBatch",
           "PATCH_KERNEL", "PIECE_WORDS", "ROW_CAPS", "check_batch", "dev_alias",
           "kernel_pointers", "launch_groups", "layout", "occupancy_words", "pack_rows", "patch",
           "patch_plain"]
