"""The port's native bridge (utils/native.py): the C++ free list and scalar
marcher, built from native/src with g++ into build/torch_native/.

* The native free list against the port's world/alloc.py ``FreeList`` on a
  seeded fuzz of takes, gives and extends: the same offsets, capacity, free
  total and spans after every operation.
* ``native_march`` against the port's plain march (``march_plain``) on the
  two random single-chunk worlds of tests/test_march_parity.py:163-212:
  where they disagree, the ray must be boundary-grazing, i.e. some nudge of
  its origin by 4 EPS makes the port's oracle (march/cpu_ref.py) agree with
  the plain march.
* ``native_march`` over a multi-chunk world's pools hits the cell that
  ``pick`` (the Python oracle over the host chunks) picks.

Skipped, as tests/test_native.py is, when the library cannot be built (no
g++).
"""

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu_torch.core.constants import EPS
from octree_raymarcher_tpu_torch.march import cpu_ref
from octree_raymarcher_tpu_torch.ops.march import march_plain
from octree_raymarcher_tpu_torch.utils import native
from octree_raymarcher_tpu_torch.world.alloc import FreeList
from octree_raymarcher_tpu_torch.world.device import TorchWorld, single_chunk_world
from octree_raymarcher_tpu_torch.world.pick import pick
from octree_raymarcher_tpu_torch.world.world import World
from octree_raymarcher_tpu_torch.worldgen import BoundsPyramid, grow

PERTURB = 4 * EPS


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native library did not build (g++ and native/src needed)")
    return native.load()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_freelist_matches_python(lib, seed):
    rng = np.random.default_rng(seed)
    py = FreeList(1024)
    nat = native.NativeFreeList(1024)
    held = []
    for _ in range(400):
        op = rng.random()
        if op < 0.5 or not held:
            size = int(rng.integers(1, 64))
            a, b = py.take(size), nat.take(size)
            assert a == b
            if a is not None:
                held.append((a, size))
        elif op < 0.9:
            off, size = held.pop(int(rng.integers(0, len(held))))
            py.give(off, size)
            nat.give(off, size)
        else:
            new_cap = py.capacity + int(rng.integers(64, 256))
            py.extend(new_cap)
            nat.extend(new_cap)
        assert (py.capacity, py.free, py.spans) == (nat.capacity, nat.free, nat.spans)
    nat.check()


def _world_adapter(chunk):
    class W:  # the host world the scalar oracle walks: one chunk
        chunksize = chunk.size
        dims = (1, 1, 1)
        chunkcoordmin = np.round(np.asarray(chunk.position) / chunk.size).astype(int)

        @staticmethod
        def chunk_at(x, y, z):
            return chunk

    return W


def _perturbations(d):
    d = np.asarray(d, dtype=np.float64)
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(d, a)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(d, u)
    return [vec * PERTURB for vec in (u, -u, v, -v, d, -d)]


@pytest.mark.parametrize("seed", [11, 23])
def test_native_march_matches_plain_up_to_grazing(lib, seed):
    rng = np.random.default_rng(1234 + seed)
    pyr = BoundsPyramid.generate(size=32, amplitude=10.0, period=1.0 / 32, xshift=3.0,
                                 yshift=8.0, zshift=-2.0, seed=seed)
    chunk = grow([0.0, 0.0, 0.0], 32.0, depth=5, pyr=pyr)
    world = TorchWorld.from_numpy(single_chunk_world(chunk), device="cpu")
    n = 160
    origins = np.stack([rng.uniform(-8, 40, n), rng.uniform(2, 30, n),
                        rng.uniform(-8, 40, n)], axis=1).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    nres = native.native_march(world, origins, dirs)
    pres = march_plain(world, torch.from_numpy(origins), torch.from_numpy(dirs), 640)
    phit, pt, pmat = pres.hit.numpy(), pres.t.numpy(), pres.material.numpy()
    nhit, nt = nres["hit"].numpy(), nres["t"].numpy()
    assert phit.any() and (~phit).any()
    agree = (nhit == phit) & (~phit | np.isclose(nt, pt, rtol=2e-3, atol=2e-3))
    W = _world_adapter(chunk)
    for i in np.nonzero(~agree)[0]:
        explained = False
        for dp in _perturbations(dirs[i]):
            h = cpu_ref.chunkmarch(W, np.asarray(origins[i], np.float64) + dp, dirs[i])
            if h.hit == bool(phit[i]) and (not h.hit or (
                    np.isclose(h.t, pt[i], rtol=5e-3, atol=5e-2) and h.material == pmat[i])):
                explained = True
                break
        assert explained, f"native vs plain march at ray {i}: o={origins[i]}, d={dirs[i]}"
    assert agree.mean() > 0.95, agree.mean()
    both = nhit & phit
    assert (nres["material"].numpy()[both] == pmat[both]).mean() > 0.99


def test_native_march_agrees_with_pick(lib):
    w = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                       amplitude=16.0)
    pools = w.to_torch("cpu")
    rng = np.random.default_rng(5)
    hits = 0
    for _ in range(40):
        o = np.float32([rng.uniform(0, 64), rng.uniform(25, 40), rng.uniform(0, 64)])
        d = rng.normal(size=3).astype(np.float32)
        d[1] = -abs(d[1]) - 0.3
        a = pick(w, o, d)
        d = d / max(np.linalg.norm(d), 1e-12)
        r = native.native_march(pools, o[None], d[None])
        assert (a is None) == (not bool(r["hit"][0]))
        if a is None:
            continue
        hits += 1
        np.testing.assert_allclose(o + d * np.float32(r["t"][0]), a.point, atol=1e-3)
        np.testing.assert_array_equal(r["cell_bmin"][0].numpy(), a.cell_bmin)
        assert (float(r["cell_size"][0]), int(r["material"][0])) == (a.cell_size, a.material)
    assert hits > 20
