"""World orchestration: generation and toroidal indexing.

A numpy copy of the generation half of octree_raymarcher_tpu/world/world.py:
``World.generate`` builds a w*h*d grid of chunks over per-(x,z)-column
bounds pyramids with a water flood (reference World::init + g_pyramid/g_chunk,
src/World.cpp:19-43,296-321), and ``index`` is the
positive-modulo toroidal lookup (src/World.cpp:276-293).  The pools it packs
are bit-identical to the JAX package's.  ``to_torch`` uploads them.

Storage order matches the device chunk table: index = x + z*w + y*(w*d).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.chunk import Chunk
from ..worldgen.grow import grow
from ..worldgen.pyramid import BoundsPyramid
from . import edit as edit_ops
from .device import TorchWorld, pack_chunks

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

    # -- device residency --------------------------------------------------
    def pack(self):
        """The packed pools and chunk table as numpy arrays (pack_chunks)."""
        return pack_chunks(self.chunks, self.dims, chunkcoordmin=self.chunkcoordmin)

    def to_torch(self, device="cuda") -> TorchWorld:
        """Pack the chunks and upload the pools to ``device``."""
        return TorchWorld.from_numpy(self.pack(), device=device)


__all__ = ["World", "WATER", "PYRAMID_RESOLUTION"]
