"""The terrain world and its pools, worked out again from the configuration.

A frozen copy of the port's ``World.generate`` and ``World.pack``
(world/world.py): per-(x, z) bounds pyramids, one grown octree a chunk, the
water flood below the water line, then the pools of ``pack_chunks``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import PackedWorld, TorchWorld, pack_chunks
from .edit import build
from .grow import grow
from .pyramid import BoundsPyramid

WATER = 6               # water material id (reference World.cpp:316-321)
PYRAMID_RESOLUTION = 256


def generate(dims, chunksize: float, depth: int, seed: int, water_level: float,
             amplitude: float) -> PackedWorld:
    """The packed pools of the world with these settings (chunk coordinates
    from the origin), on the host."""
    w, h, d = (int(v) for v in dims)
    cs = float(chunksize)
    pyramids = {(cx, cz): BoundsPyramid.generate(
        size=PYRAMID_RESOLUTION, amplitude=float(amplitude), period=1.0 / PYRAMID_RESOLUTION,
        xshift=cx * PYRAMID_RESOLUTION, yshift=float(amplitude) / 4.0,
        zshift=cz * PYRAMID_RESOLUTION, seed=int(seed))
        for cz in range(d) for cx in range(w)}
    chunks = [None] * (w * h * d)
    for cy in range(h):
        for cz in range(d):
            for cx in range(w):
                pos = np.asarray([cx * cs, cy * cs, cz * cs], dtype=np.float32)
                c = grow(pos, cs, int(depth), pyramids[(cx, cz)])
                if water_level > 0:
                    build(c, pos, [pos[0] + cs, float(water_level), pos[2] + cs], WATER)
                chunks[cx + cz * w + cy * (w * d)] = c
    return pack_chunks(chunks, (w, h, d))


def world_on(packed: PackedWorld, device) -> TorchWorld:
    """The packed pools as tensors on ``device``."""
    return TorchWorld.from_numpy(packed, device=torch.device(device))
