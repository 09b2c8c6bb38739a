"""Worlds and rays built to break a march that keeps the octree path of its
last step (csrc/march_step.cuh), and checks that each scene has the trait
it is named for.

The scenes are made with the port's host code alone (no JAX), so the card
tests (tests/test_torch_cuda.py) use them as they are; the JAX parity tests
(tests/test_torch_march.py, tests/test_torch_diff.py) carry the same packed
pools into the JAX package.

* ``shifted``: the small world scrolled one chunk along +x and one along
  -z, so ``chunkcoordmin`` is not 0 and chunk indices wrap.
* ``nonresident``: ``shifted`` with one chunk's table entry left at the
  bmin it had before the scroll: rays that enter it end there.
* ``edited``: filled boxes (one with cell-aligned faces) and a carved box,
  so coarse LEAF cells sit beside twigs at the depth limit.
* ``faces``: axis-aligned rays whose origins lie exactly on texel, cell and
  chunk faces and edges.
* ``depth10``: one chunk of depth 10 (texels of 1/32) with filled and
  carved boxes, so paths run ten levels deep.
* ``depth12``: one chunk of depth 12 (texels of 1/128): twigs at level
  10, below the levels a ray's path keeps.
* ``size24``: chunks of 24 units, not a power of two, so the divisions by
  the chunk and cell sizes round.
"""

import functools

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu_torch.core.chunk import Chunk
from octree_raymarcher_tpu_torch.ops.march import march_plain
from octree_raymarcher_tpu_torch.shade import PerspectiveCamera
from octree_raymarcher_tpu_torch.world.device import TorchWorld
from octree_raymarcher_tpu_torch.world.edit import build, destroy
from octree_raymarcher_tpu_torch.world.world import World

BASE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
            amplitude=16.0)
SCENES = ("shifted", "nonresident", "edited", "faces", "depth10", "depth12", "size24")


@functools.lru_cache(maxsize=None)
def make_scene(name: str):
    """(host World, its packed pools as world/device.py PackedWorld)."""
    if name in ("shifted", "nonresident"):
        w = World.generate(**BASE)
        w.shift(0, +1)
        w.shift(2, -1)
        packed = w.pack()
        if name == "nonresident":
            # the chunk at chunk coordinate (2, 0, -1) keeps the bmin of the
            # chunk coordinate (0, 0, -1) it held before the scroll
            packed.chunk_bmin = packed.chunk_bmin.copy()
            packed.chunk_bmin[w.index(2, 0, -1), 0] -= 2 * w.chunksize
        return w, packed
    if name in ("edited", "faces"):
        w = World.generate(**BASE)
        w.build((8.0, 16.0, 8.0), (40.0, 40.0, 56.0), 5)       # cell-aligned faces
        w.build((41.3, 10.0, 3.7), (50.6, 25.2, 30.1), 3)
        w.destroy((10.5, 20.0, 8.25), (20.0, 45.0, 40.75))
        return w, w.pack()
    if name == "depth10":
        c = Chunk.empty_chunk(np.zeros(3, np.float32), 32.0, 10)
        build(c, (0.0, 0.0, 0.0), (32.0, 4.0, 32.0), 2)          # coarse floor
        build(c, (5.03125, 4.0, 6.5), (9.71875, 7.40625, 8.96875), 3)
        build(c, (16.0, 4.0, 16.0), (24.0, 12.0, 24.0), 4)       # coarse cube
        destroy(c, (18.34375, 2.5, 17.5), (21.0625, 10.28125, 19.90625))
        build(c, (12.5, 4.0, 20.25), (13.03125, 9.0, 27.5), 6)   # thin wall
        w = World(dims=(1, 1, 1), chunksize=32.0, depth=10, chunks=[c], pyramids={},
                  chunkcoordmin=np.zeros(3, np.int64))
        return w, w.pack()
    if name == "depth12":
        c = Chunk.empty_chunk(np.zeros(3, np.float32), 32.0, 12)
        build(c, (0.0, 0.0, 0.0), (32.0, 4.0, 32.0), 2)          # coarse floor
        build(c, (10.0625, 4.0, 10.1015625), (10.9453125, 4.6015625, 10.7109375), 3)
        build(c, (20.0, 4.0, 12.0), (24.0, 8.0, 20.0), 4)
        destroy(c, (21.0078125, 3.5, 13.03125), (21.5, 8.5, 13.4765625))
        w = World(dims=(1, 1, 1), chunksize=32.0, depth=12, chunks=[c], pyramids={},
                  chunkcoordmin=np.zeros(3, np.int64))
        return w, w.pack()
    if name == "size24":
        w = World.generate(**dict(BASE, chunksize=24.0, water_level=3.0, amplitude=12.0))
        return w, w.pack()
    raise ValueError(name)


def scene_world(name: str):
    """The scene's packed pools."""
    return make_scene(name)[1]


def scene_torch(name: str, device="cpu") -> TorchWorld:
    return TorchWorld.from_numpy(scene_world(name), device=device)


@functools.lru_cache(maxsize=None)
def scene_rays(name: str):
    """(origins, dirs) float32[N, 3]: a camera over the scene and random
    rays, or for ``faces`` the face-aligned rays."""
    rng = np.random.default_rng(SCENES.index(name) + 40)
    if name == "faces":
        o, d = [], []
        for y in (1.0, 4.0, 6.0, 8.0, 12.0, 16.0):
            for z in (0.0, 4.0, 8.0, 9.0, 31.0, 32.0, 40.0, 64.0):
                o += [(-5.0, y, z), (70.0, y, z)]
                d += [(1.0, 0.0, 0.0), (-1.0, 0.0, 0.0)]
                o += [(z, y, -5.0), (z, y, 70.0)]
                d += [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0)]
        for x in (0.0, 2.0, 8.0, 16.0, 30.0, 32.0, 33.0, 48.0):
            for z in (1.0, 8.0, 12.0, 32.0, 44.0, 63.0):
                o.append((x, 40.0, z))
                d.append((0.0, -1.0, 0.0))
        return np.asarray(o, np.float32), np.asarray(d, np.float32)
    if name == "depth10":
        cam = PerspectiveCamera(position=(16.0, 20.0, -10.0), pitch_deg=-35.0, fov_deg=60.0,
                                width=32, height=24)
        lo, hi = (-4.0, 1.0, -4.0), (36.0, 16.0, 36.0)
    elif name == "depth12":
        cam = PerspectiveCamera(position=(10.5, 6.0, 7.5), pitch_deg=-40.0, fov_deg=50.0,
                                width=32, height=24)
        lo, hi = (8.0, 4.2, 8.0), (24.0, 9.0, 22.0)
    else:
        cmin = {"shifted": (1, 0, -1), "nonresident": (1, 0, -1)}.get(name, (0, 0, 0))
        cs = 24.0 if name == "size24" else 32.0
        x0, z0 = cs * cmin[0], cs * cmin[2]
        cam = PerspectiveCamera(position=(x0 + cs, 0.95 * cs, z0 - 0.6 * cs), pitch_deg=-20.0,
                                fov_deg=70.0, width=40, height=24)
        lo, hi = (x0 - 10.0, 5.0, z0 - 10.0), (x0 + 2 * cs + 10.0, 60.0, z0 + 2 * cs + 10.0)
    co, cd = cam.rays()
    n = 400
    ro = np.stack([rng.uniform(lo[i], hi[i], n) for i in range(3)], axis=1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return np.concatenate([co, ro]), np.concatenate([cd, rd])


def shade_batch(seed: int = 3, groups: int = 12):
    """A march result built to hold the shading kernel's branches apart:
    ``groups`` whole 32-ray warps (in launch order) that are in turn all
    hit, all miss and mixed.  Each hit point lies on a face of its cell (so
    the atlas sample reads a texel off that face); material ids include 0,
    the table's last row (7), ids past it (8, 11) and negative ones, and
    misses carry an infinite t and arbitrary ids, which shading must not
    read.  Returns numpy arrays: the MarchResult's fields, origins, dirs and
    the eye."""
    rng = np.random.default_rng(seed)
    n = 32 * groups
    hit = np.zeros(n, bool)
    for g in range(groups):
        kind = g % 3
        if kind == 0:
            hit[32 * g:32 * g + 32] = True
        elif kind == 2:
            hit[32 * g:32 * g + 32] = rng.uniform(size=32) < 0.5
            hit[32 * g] = True
            hit[32 * g + 1] = False
    size = rng.choice(np.float32([0.5, 1.0, 2.0]), n)
    bmin = (rng.integers(-20, 20, (n, 3)) * size[:, None]).astype(np.float32)
    face = rng.integers(0, 6, n)
    p = bmin + rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32) * size[:, None]
    rows = np.arange(n)
    p[rows, face // 2] = bmin[rows, face // 2] + (face % 2) * size
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(2.0, 60.0, n).astype(np.float32)
    o = (p - d * (t - np.float32(1.0 / 4096.0))[:, None]).astype(np.float32)
    res = {"hit": hit, "t": np.where(hit, t, np.float32(np.inf)).astype(np.float32),
           "material": rng.choice(np.int32([0, 1, 2, 4, 6, 7, 8, 11, -1, -5]), n),
           "cell_bmin": bmin, "cell_size": size.astype(np.float32),
           "steps": np.zeros(n, np.int32), "texel": np.full(n, -1, np.int32)}
    eye = rng.uniform(-5.0, 5.0, 3).astype(np.float32)
    return res, o, d, eye


def texel_batch(distinct: bool, warps: int = 64, atlas_res: int = 32, env_hw=(64, 128)):
    """A march result for the texel gradients' keyed sums: warps (in launch
    order) alternate between all hit and all miss.  Every hit lies on the
    top face of the unit cell at the origin with material 3, and every
    miss looks at one bilinear cell of an ``env_hw`` sky map.  Either every
    hit samples one atlas texel (of resolution ``atlas_res``) and every miss
    the same four sky taps (the hottest keys), or, ``distinct``, the 32
    lanes of a warp take 32 distinct texels and 128 distinct taps.  The
    points and directions are jittered inside their texel and bilinear
    cell.  Returns numpy arrays: the MarchResult's fields, origins, dirs and
    the eye."""
    rng = np.random.default_rng(12 if distinct else 11)
    n = 32 * warps
    lane = np.arange(n) % 32
    hit = (np.arange(n) // 32) % 2 == 0
    r = atlas_res
    ui = lane % r if distinct else np.full(n, 5)
    vi = lane // r if distinct else np.full(n, 7)
    # the top face's uv is (1 - x, 1 - z) of the point
    jit = rng.uniform(-0.3, 0.3, (n, 2))
    p = np.stack([1.0 - (ui + 0.5 + jit[:, 0]) / r, np.ones(n),
                  1.0 - (vi + 0.5 + jit[:, 1]) / r], axis=1).astype(np.float32)
    down = np.stack([rng.uniform(-0.3, 0.3, n), -np.ones(n), rng.uniform(-0.3, 0.3, n)], 1)
    h, w = env_hw
    # misses: sky-map coordinates x = u*W - 0.5, y = v*H - 0.5 a quarter
    # texel into a bilinear cell, four columns apart a lane when distinct
    x = (4 * lane if distinct else np.full(n, 40)) + 0.25 + rng.uniform(-0.1, 0.1, n)
    y = 20.25 + rng.uniform(-0.1, 0.1, n)
    phi = ((x + 0.5) / w - 0.5) * 2.0 * np.pi
    theta = (y + 0.5) / h * np.pi
    sky = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)], 1)
    d = np.where(hit[:, None], down, sky)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(2.0, 20.0, n).astype(np.float32)
    o = np.where(hit[:, None], p - d * (t - np.float32(1.0 / 4096.0))[:, None],
                 rng.uniform(-5.0, 5.0, (n, 3))).astype(np.float32)
    res = {"hit": hit, "t": np.where(hit, t, np.float32(np.inf)).astype(np.float32),
           "material": np.where(hit, 3, 0).astype(np.int32),
           "cell_bmin": np.zeros((n, 3), np.float32), "cell_size": np.ones(n, np.float32),
           "steps": np.zeros(n, np.int32), "texel": np.full(n, -1, np.int32)}
    return res, o, d, np.float32([0.5, 6.0, -3.0])


def warp_kinds(hit) -> dict:
    """The count of all-hit, all-miss and mixed 32-ray warps of a hit mask."""
    w = np.asarray(hit).reshape(-1, 32)
    return {"all_hit": int(w.all(axis=1).sum()), "all_miss": int((~w.any(axis=1)).sum()),
            "mixed": int((w.any(axis=1) & ~w.all(axis=1)).sum())}


def _march(name, **kw):
    o, d = (torch.from_numpy(x) for x in scene_rays(name))
    return march_plain(scene_torch(name), o, d, 512, True, **kw)


@pytest.mark.parametrize("name", SCENES)
def test_scene_has_its_trait(name):
    world = scene_torch(name)
    res = _march(name)
    hit = res.hit.numpy()
    assert 0.05 < hit.mean() < 0.98, hit.mean()
    cs, depth = world.chunksize, world.depth
    texel = cs / 2 ** depth
    size = res.cell_size.numpy()[hit]
    if name in ("shifted", "nonresident"):
        coordmin = world.chunkcoordmin.numpy()
        assert tuple(coordmin) == (1.0, 0.0, -1.0)
        # a chunk whose storage slot is not its coordinate: the index wraps
        q = np.floor(world.chunk_bmin.numpy() / cs).astype(int)
        slot = q[:, 0] % 2 + (q[:, 2] % 2) * 2
        assert (slot == np.arange(4)).all() and (q[:, 0] >= 2).any() and (q[:, 2] < 0).any()
    if name == "nonresident":
        free = _march(name, assume_resident=True)
        ended = free.hit.numpy() & ~hit
        assert ended.sum() >= 10, ended.sum()
        # the resident march stops where the resident steps stop
        assert (res.steps.numpy() <= free.steps.numpy()).all()
    if name in ("edited", "depth10", "depth12"):
        tex = res.texel.numpy()[hit]
        assert (tex >= 0).sum() > 20 and (tex < 0).sum() > 20
        assert (size[tex < 0] >= 8 * texel).sum() > 10, "no shallow LEAF hits"
        assert np.isclose(size[tex >= 0], texel).all()
    if name in ("depth10", "depth12"):
        assert depth == int(name[5:]) and np.isclose(size, texel).sum() > 20
    if name == "size24":
        assert cs == 24.0 and np.isclose(size, 0.75).sum() > 20
    if name == "faces":
        o, d = scene_rays(name)
        assert ((np.abs(d) == 1.0).sum(axis=1) == 1).all()
        # every origin lies on texel faces on both axes across the ray
        across = np.abs(o) * (np.abs(d) == 0)
        assert (across == np.round(across)).all()
