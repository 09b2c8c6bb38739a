"""World orchestration: generation, toroidal indexing, edits, streaming, IO.

The counterpart of octree_raymarcher_tpu/world/world.py (reference
src/World.{h,cpp}): ``World.generate`` builds a w*h*d grid of chunks over
per-(x,z)-column bounds pyramids with a water flood (World::init +
g_pyramid/g_chunk, src/World.cpp:19-43,296-321), ``index``/``index_float``
are the positive-modulo toroidal lookups (src/World.cpp:276-293),
``destroy/build/replace`` edit a world-space box across every chunk it
touches and ``apply`` patches a whole edit batch into the device pools with
one staging copy and one launch of kernel K7 (World::modify,
src/World.cpp:268-274 + Main.cpp:321-338), ``shift`` streams the world by
regenerating the entering slab in place (src/World.cpp:334-378), and
``save/load`` persist all chunks in the JAX package's npz format.  The host
code is a numpy copy; the pools it packs are bit-identical to the JAX
package's.

Storage order matches the device chunk table: index = x + z*w + y*(w*d).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.chunk import Chunk, Dirty
from ..core.constants import TWIG_WORDS
from ..worldgen.grow import grow
from ..worldgen.pyramid import BoundsPyramid
from . import edit as edit_ops
from .alloc import WorldAllocator, dev_alias
from .device import TorchWorld, pack_chunks
from .device import to_device as upload

WATER = 6               # water material id (reference World.cpp:316-321)
PYRAMID_RESOLUTION = 256


@dataclasses.dataclass
class World:
    dims: tuple                      # (w, h, d) chunks
    chunksize: float
    depth: int
    chunks: list                     # Chunk[w*h*d], storage order x + z*w + y*w*d
    pyramids: dict                   # {(cx, cz): BoundsPyramid} by world chunk coord
    chunkcoordmin: np.ndarray        # int64[3] minimum world chunk coordinate
    seed: int = 0
    water_level: float = 6.0
    amplitude: float = 64.0

    # -- generation --------------------------------------------------------
    @staticmethod
    def generate(
        dims: tuple = (4, 4, 4),
        chunksize: float = 128.0,
        depth: int = 8,
        seed: int = 0,
        water_level: float = 6.0,
        amplitude: float = 64.0,
        chunkcoordmin=(0, 0, 0),
    ) -> "World":
        w, h, d = dims
        world = World(
            dims=dims,
            chunksize=float(chunksize),
            depth=int(depth),
            chunks=[None] * (w * h * d),
            pyramids={},
            chunkcoordmin=np.asarray(chunkcoordmin, dtype=np.int64),
            seed=seed,
            water_level=float(water_level),
            amplitude=float(amplitude),
        )
        cx0, cy0, cz0 = (int(v) for v in world.chunkcoordmin)
        for cz in range(cz0, cz0 + d):
            for cx in range(cx0, cx0 + w):
                world.pyramids[(cx, cz)] = world._make_pyramid(cx, cz)
        for cy in range(cy0, cy0 + h):
            for cz in range(cz0, cz0 + d):
                for cx in range(cx0, cx0 + w):
                    world.chunks[world.index(cx, cy, cz)] = world._make_chunk(
                        cx, cy, cz
                    )
        return world

    def _make_pyramid(self, cx: int, cz: int) -> BoundsPyramid:
        return BoundsPyramid.generate(
            size=PYRAMID_RESOLUTION,
            amplitude=self.amplitude,
            period=1.0 / PYRAMID_RESOLUTION,
            xshift=cx * PYRAMID_RESOLUTION,
            yshift=self.amplitude / 4.0,
            zshift=cz * PYRAMID_RESOLUTION,
            seed=self.seed,
        )

    def _make_chunk(self, cx: int, cy: int, cz: int) -> Chunk:
        cs = self.chunksize
        pos = np.asarray([cx * cs, cy * cs, cz * cs], dtype=np.float32)
        c = grow(pos, cs, self.depth, self.pyramids[(cx, cz)])
        if self.water_level > 0:
            # Flood water into empty space below the water line
            # (reference g_chunk, src/World.cpp:316-321).
            edit_ops.build(
                c,
                pos,
                [pos[0] + cs, self.water_level, pos[2] + cs],
                WATER,
            )
        return c

    # -- toroidal indexing (reference src/World.cpp:276-293) ---------------
    def index(self, cx: int, cy: int, cz: int) -> int:
        w, h, d = self.dims
        return (int(cx) % w) + (int(cz) % d) * w + (int(cy) % h) * (w * d)

    def index_float(self, p) -> tuple:
        """World-space point -> integer chunk coordinate."""
        q = np.floor(np.asarray(p, dtype=np.float64) / self.chunksize)
        return int(q[0]), int(q[1]), int(q[2])

    def chunk_at(self, cx: int, cy: int, cz: int) -> Chunk:
        """Toroidal chunk lookup by chunk coordinate (the host oracle
        marcher's world protocol, march/cpu_ref.py chunkmarch)."""
        return self.chunks[self.index(cx, cy, cz)]

    def chunk_at_point(self, p) -> Chunk | None:
        cx, cy, cz = self.index_float(p)
        lo = self.chunkcoordmin
        w, h, d = self.dims
        if not (lo[0] <= cx < lo[0] + w and lo[1] <= cy < lo[1] + h
                and lo[2] <= cz < lo[2] + d):
            return None
        return self.chunks[self.index(cx, cy, cz)]

    # -- device residency --------------------------------------------------
    def pack(self):
        """The packed pools and chunk table as numpy arrays (pack_chunks)."""
        return pack_chunks(self.chunks, self.dims, chunkcoordmin=self.chunkcoordmin)

    def to_torch(self, device="cuda") -> TorchWorld:
        """Pack the chunks and upload the pools to ``device`` (no room for
        edits: use :meth:`to_device` for an edited world)."""
        return TorchWorld.from_numpy(self.pack(), device=device)

    def to_device(self, slack: float = 1.5, device="cuda") -> tuple[WorldAllocator, TorchWorld]:
        """Place the chunks with an allocator (blocks with ``slack`` room to
        grow) and upload the pools to ``device``."""
        return WorldAllocator.pack(
            self.chunks, self.dims, chunkcoordmin=self.chunkcoordmin,
            slack=slack, device=device,
        )

    # -- edits (reference Main.cpp:321-368 modify/destroy/build/replace) ---
    def _edit(self, op, bmin, bmax, *args):
        """Apply a box edit to every chunk the box touches; returns
        [(chunk_index, Dirty tree, Dirty twig)] of modified chunks."""
        bmin = np.asarray(bmin, dtype=np.float64)
        bmax = np.asarray(bmax, dtype=np.float64)
        lo = np.floor(bmin / self.chunksize).astype(np.int64)
        hi = np.ceil(bmax / self.chunksize).astype(np.int64)
        cmin = self.chunkcoordmin
        w, h, d = self.dims
        out = []
        for cy in range(max(lo[1], cmin[1]), min(hi[1], cmin[1] + h)):
            for cz in range(max(lo[2], cmin[2]), min(hi[2], cmin[2] + d)):
                for cx in range(max(lo[0], cmin[0]), min(hi[0], cmin[0] + w)):
                    i = self.index(cx, cy, cz)
                    dt, dw = op(self.chunks[i], bmin, bmax, *args)
                    if not (dt.empty and dw.empty):
                        out.append((i, dt, dw))
        return out

    def destroy(self, bmin, bmax):
        return self._edit(edit_ops.destroy, bmin, bmax)

    def build(self, bmin, bmax, material: int):
        return self._edit(edit_ops.build, bmin, bmax, material)

    def replace(self, bmin, bmax, material: int):
        return self._edit(edit_ops.replace, bmin, bmax, material)

    @dev_alias
    def apply(self, wa: WorldAllocator, dev: TorchWorld, edits) -> TorchWorld:
        """Patch the device world ``dev`` (``world=`` is an alias) with the
        dirty ranges of an edit batch [(chunk_index, Dirty tree, Dirty
        twig)]: one staging copy and one K7 launch for the whole batch (see
        world/alloc.py)."""
        return wa.modify_batch(dev, [(i, self.chunks[i], dt, dw) for i, dt, dw in edits])

    # -- streaming (reference World::shift, src/World.cpp:334-378) ---------
    def shift(self, axis: int, sign: int) -> list:
        """Scroll the world one chunk along ``axis`` (0/1/2 = x/y/z): the
        toroidal storage keeps every surviving chunk in place; the entering
        slab is regenerated (with fresh pyramids when (x,z) changes).
        Returns the regenerated chunk indices for device re-upload."""
        assert axis in (0, 1, 2) and sign in (-1, 1)
        w, h, d = self.dims
        self.chunkcoordmin[axis] += sign
        lo = self.chunkcoordmin
        # Entering slab: the face of the new extent in the move direction.
        coord = (lo[axis] + (w, h, d)[axis] - 1) if sign > 0 else lo[axis]
        xs = range(lo[0], lo[0] + w) if axis != 0 else [coord]
        ys = range(lo[1], lo[1] + h) if axis != 1 else [coord]
        zs = range(lo[2], lo[2] + d) if axis != 2 else [coord]
        # Refresh pyramids for new (x,z) columns.
        if axis != 1:
            for cx in xs:
                for cz in zs:
                    if (cx, cz) not in self.pyramids:
                        self.pyramids[(cx, cz)] = self._make_pyramid(cx, cz)
        touched = []
        for cy in ys:
            for cz in zs:
                for cx in xs:
                    i = self.index(cx, cy, cz)
                    self.chunks[i] = self._make_chunk(cx, cy, cz)
                    touched.append(i)
        # Evict pyramids that scrolled out of the live (x,z) window.
        x0, z0 = int(lo[0]), int(lo[2])
        self.pyramids = {
            k: v
            for k, v in self.pyramids.items()
            if x0 <= k[0] < x0 + w and z0 <= k[1] < z0 + d
        }
        return touched

    @dev_alias
    def apply_shift(self, wa: WorldAllocator, dev: TorchWorld, touched) -> TorchWorld:
        """Re-upload regenerated chunks (one K7 batch) and slide the device
        coordinate min of ``dev`` (``world=`` is an alias) in place."""
        world = wa.modify_batch(dev, [(i, self.chunks[i], Dirty(realloc=True),
                                       Dirty(realloc=True)) for i in touched])
        world.chunkcoordmin.copy_(upload(self.chunkcoordmin, world.device))
        return world

    # -- persistence (reference Ocroot::write/read, src/Octree.cpp:178-201) -
    def save(self, path: str) -> None:
        """All chunks in one npz, the JAX package's format."""
        arrays = {
            "dims": np.asarray(self.dims, dtype=np.int64),
            "chunksize": np.float64(self.chunksize),
            "depth": np.int64(self.depth),
            "chunkcoordmin": self.chunkcoordmin,
            "seed": np.int64(self.seed),
            "water_level": np.float64(self.water_level),
            "amplitude": np.float64(self.amplitude),
        }
        for i, c in enumerate(self.chunks):
            arrays[f"c{i}_pos"] = c.position
            arrays[f"c{i}_tree"] = c.tree[: c.ntrees]
            arrays[f"c{i}_twig"] = c.twig[: c.ntwigs]
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "World":
        z = np.load(path)
        dims = tuple(int(v) for v in z["dims"])
        w, h, d = dims
        world = World(
            dims=dims,
            chunksize=float(z["chunksize"]),
            depth=int(z["depth"]),
            chunks=[None] * (w * h * d),
            pyramids={},
            chunkcoordmin=z["chunkcoordmin"].astype(np.int64),
            seed=int(z["seed"]),
            water_level=float(z["water_level"]),
            amplitude=float(z["amplitude"]),
        )
        for i in range(w * h * d):
            tree = z[f"c{i}_tree"]
            twig = z[f"c{i}_twig"].reshape(-1, TWIG_WORDS)
            world.chunks[i] = Chunk(
                position=z[f"c{i}_pos"].astype(np.float32),
                size=world.chunksize,
                depth=world.depth,
                tree=tree.astype(np.uint32).copy(),
                twig=twig.astype(np.uint16).copy(),
                ntrees=len(tree),
                ntwigs=len(twig),
            )
        # Pyramids are regenerable from (seed, coord).
        lo = world.chunkcoordmin
        for cz in range(lo[2], lo[2] + d):
            for cx in range(lo[0], lo[0] + w):
                world.pyramids[(cx, cz)] = world._make_pyramid(cx, cz)
        return world

    # -- observability (reference Debug.cpp:131-176, Main.cpp:264-311) -----
    def memory_report(self) -> dict:
        reps = [c.memory_report() for c in self.chunks]
        return {
            "chunks": len(reps),
            "trees": sum(r["trees"] for r in reps),
            "twigs": sum(r["twigs"] for r in reps),
            "tree_bytes": sum(r["tree_bytes"] for r in reps),
            "twig_bytes": sum(r["twig_bytes"] for r in reps),
        }


__all__ = ["World", "WATER", "PYRAMID_RESOLUTION"]
