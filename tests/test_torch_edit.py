"""The port's edited-world session against the JAX package, on the CPU.

The allocator (FreeList, PoolAllocator, WorldAllocator.pack/from_state), the
batched pool patch (plan + patch_plain, the CPU path of kernel K7), edits,
shift, save/load, pick, LOD/defrag and the scripted session, on the small
world of tests/test_world_edit.py.  After every edit batch of a seeded fuzz
the port's pools, occupancy words and chunk table equal the JAX package's
DeviceWorld bit for bit.  No JAX render is compiled: the edited golden is
compared with the stored thumbnail."""

import copy
import os

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.core.chunk import Chunk as JaxChunk
from octree_raymarcher_tpu.world.lod import defrag as jax_defrag
from octree_raymarcher_tpu.world.lod import defrag_dense as jax_defrag_dense
from octree_raymarcher_tpu.world.lod import lod as jax_lod
from octree_raymarcher_tpu.world.lod import lod_dense as jax_lod_dense
from octree_raymarcher_tpu.world.alloc import FreeList as JaxFreeList
from octree_raymarcher_tpu.world.alloc import PoolAllocator as JaxPoolAllocator
from octree_raymarcher_tpu.world.alloc import WorldAllocator as JaxWorldAllocator
from octree_raymarcher_tpu.world.edit import build as jax_build
from octree_raymarcher_tpu.world.edit import destroy as jax_destroy
from octree_raymarcher_tpu.world.pick import cursor_box as jax_cursor_box
from octree_raymarcher_tpu.world.pick import pick as jax_pick
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu.worldgen import BoundsPyramid as JaxBoundsPyramid
from octree_raymarcher_tpu.worldgen import grow as jax_grow
from octree_raymarcher_tpu_torch.core.chunk import Chunk
from octree_raymarcher_tpu_torch.demo import run_session
from octree_raymarcher_tpu_torch.shade import PerspectiveCamera, RenderConfig, render
from octree_raymarcher_tpu_torch.world.lod import defrag, defrag_dense, lod, lod_dense
from octree_raymarcher_tpu_torch.world.alloc import (
    TWIG,
    FreeList,
    PoolAllocator,
    WorldAllocator,
    occupancy_words,
    patch_plain,
)
from octree_raymarcher_tpu_torch.world.device import TorchWorld, occupancy_masks
from octree_raymarcher_tpu_torch.world.edit import build, destroy
from octree_raymarcher_tpu_torch.world.pick import cursor_box, pick
from octree_raymarcher_tpu_torch.world.world import World
from octree_raymarcher_tpu_torch.worldgen import BoundsPyramid, grow

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "edited_2x1x2_d5.npy")
SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)
POOL_FIELDS = ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree", "chunk_twig",
               "chunkcoordmin")


@pytest.fixture(scope="module")
def generated():
    return JaxWorld.generate(**SCENE), World.generate(**SCENE)


@pytest.fixture
def worlds(generated):
    """Fresh copies of the JAX and port worlds (tests edit them)."""
    return copy.deepcopy(generated[0]), copy.deepcopy(generated[1])


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def assert_pools_equal(jdev, tworld: TorchWorld):
    got = tworld.to_numpy()
    for k in POOL_FIELDS:
        want, have = _bits(getattr(jdev, k)), _bits(getattr(got, k))
        assert want.shape == have.shape, (k, want.shape, have.shape)
        np.testing.assert_array_equal(want, have, err_msg=k)
    assert tuple(jdev.dims) == tworld.dims and int(jdev.depth) == tworld.depth


def assert_chunks_equal(jchunks, tchunks, depth=True):
    for a, b in zip(jchunks, tchunks, strict=True):
        assert (a.ntrees, a.ntwigs, a.size) == (b.ntrees, b.ntwigs, b.size)
        assert not depth or a.depth == b.depth
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.tree[: a.ntrees], b.tree[: b.ntrees])
        np.testing.assert_array_equal(a.twig[: a.ntwigs], b.twig[: b.ntwigs])


def assert_alloc_equal(jwa, twa: WorldAllocator):
    for jp, tp in ((jwa.tree, twa.tree), (jwa.twig, twa.twig)):
        assert jp.freelist.spans == tp.freelist.spans
        assert jp.freelist.capacity == tp.freelist.capacity
        assert {k: (b.offset, b.size, b.used) for k, b in jp.blocks.items()} == \
               {k: (b.offset, b.size, b.used) for k, b in tp.blocks.items()}


# ------------------------------------------------------------- allocator
@pytest.mark.parametrize("kind", ["freelist", "pool"])
def test_allocator_ops_match(kind):
    """One seeded op sequence gives the same spans and blocks on both sides."""
    rng = np.random.default_rng(11)
    if kind == "freelist":
        a, b = JaxFreeList(256), FreeList(256)
        held = []
        for _ in range(300):
            if held and rng.uniform() < 0.45:
                off, sz = held.pop(int(rng.integers(len(held))))
                a.give(off, sz)
                b.give(off, sz)
            elif rng.uniform() < 0.05:
                cap = a.capacity + int(rng.integers(1, 64))
                a.extend(cap)
                b.extend(cap)
            else:
                sz = int(rng.integers(1, 24))
                off = a.take(sz)
                assert b.take(sz) == off
                if off is not None:
                    held.append((off, sz))
            assert a.spans == b.spans and a.free == b.free
        b.check()
        return
    a, b = JaxPoolAllocator(16, slack=1.5, align=8), PoolAllocator(16, slack=1.5, align=8)
    for _ in range(300):
        key = int(rng.integers(12))
        if rng.uniform() < 0.2:
            a.free(key)
            b.free(key)
        else:
            used = int(rng.integers(1, 90))
            ja, tb = a.place(key, used), b.place(key, used)
            assert (ja.offset, ja.size, ja.used) == (tb.offset, tb.size, tb.used)
        assert a.freelist.spans == b.freelist.spans and a.grown == b.grown
    assert a.occupancy() == b.occupancy()


@pytest.mark.parametrize("slack", [1.0, 1.5])
def test_pack_bit_equal_and_from_state(worlds, slack):
    jw, tw = worlds
    jwa, jdev = JaxWorldAllocator.pack(jw.chunks, jw.dims, slack=slack, device=False)
    twa, tworld = WorldAllocator.pack(tw.chunks, tw.dims, slack=slack, device="cpu")
    assert_pools_equal(jdev, tworld)
    assert_alloc_equal(jwa, twa)
    carried = WorldAllocator.from_state(jwa)
    assert_alloc_equal(jwa, carried)
    assert (carried.tree.slack, carried.tree.align, carried.twig.align) == (slack, 8, 2)


def test_occupancy_words_match_masks():
    rng = np.random.default_rng(3)
    twig = (rng.uniform(size=64 * 29) < 0.4) * rng.integers(1, 0xFFFF, 64 * 29)
    twig = twig.astype(np.uint32)
    twig[64 * 5:64 * 6] = 0
    got = occupancy_words(torch.from_numpy(twig.view(np.int32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, occupancy_masks(twig))


def test_patch_plain_random_descriptors():
    """patch_plain against a numpy reference on random descriptor sets: the
    twig rows keep the occupancy pool equal to occupancy_masks(twig)."""
    rng = np.random.default_rng(8)
    twa, world = WorldAllocator.pack(World.generate(**SCENE).chunks, SCENE["dims"],
                                     device="cpu")
    want = world.to_numpy()
    n_twig = want.twig.size // 64
    desc, words = [], []
    src = 0
    for lo in rng.choice(n_twig - 3, size=6, replace=False):
        n = 64 * int(rng.integers(1, 4))
        seg = (rng.uniform(size=n) < 0.5) * rng.integers(1, 7, n)
        desc.append((TWIG, 64 * int(lo), src, n))
        words.append(seg.astype(np.int32))
        src += n
    for target, pool in ((0, want.tree), (3, want.chunk_tree)):
        n = int(rng.integers(1, 5))
        desc.append((target, pool.size - n, src, n))        # ends at the pool's end
        words.append(rng.integers(0, 1 << 30, n).astype(np.int32))
        src += n
    flat = np.concatenate(words)
    for tgt, dst, s, n in desc:
        pool = {0: want.tree, 1: want.twig, 3: want.chunk_tree}[tgt]
        pool[dst:dst + n] = flat[s:s + n].view(pool.dtype)
    patch_plain(world, torch.tensor(desc, dtype=torch.int64), torch.from_numpy(flat))
    got = world.to_numpy()
    np.testing.assert_array_equal(got.tree, want.tree)
    np.testing.assert_array_equal(got.twig, want.twig)
    np.testing.assert_array_equal(got.chunk_tree, want.chunk_tree)
    np.testing.assert_array_equal(got.twig_occ, occupancy_masks(got.twig))


# ------------------------------------------------------------- edit fuzz
def _fuzz_batches(rng):
    """About 12 seeded edit batches as (op, bmin, bmax, material) lists:
    random boxes, boxes across the x = 32 and z = 32 seams, fractional
    builds in open air that grow chunks past their blocks, and one batch
    that names chunk 0 twice (a carve, then a fill reaching into the hole)."""
    out = []
    for k in range(9):
        c = rng.uniform([0, 0, 0], [64, 32, 64])
        if k % 3 == 0:
            c[0] = 32.0 + rng.uniform(-3, 3)
        if k % 4 == 1:
            c[2] = 32.0 + rng.uniform(-3, 3)
        half = rng.uniform(0.5, 7.0, 3)
        op = ("destroy", "build", "replace")[k % 3]
        out.append([(op, c - half, c + half, int(rng.integers(1, 7)))])
    out.insert(3, [("build", np.array([0.3, 14.3, 0.7]), np.array([30.6, 30.2, 29.4]), 2)])
    out.insert(7, [("build", np.array([33.2, 12.1, 33.5]), np.array([63.4, 31.7, 62.6]), 5)])
    out.append([("destroy", np.array([2.5, 0.5, 2.5]), np.array([9.5, 12.5, 9.5]), 0),
                ("build", np.array([4.25, 2.5, 4.25]), np.array([13.75, 8.5, 13.75]), 3)])
    return out


def _run(world, batch):
    edits = []
    for op, bmin, bmax, mat in batch:
        if op == "destroy":
            edits += world.destroy(bmin, bmax)
        elif op == "build":
            edits += world.build(bmin, bmax, mat)
        else:
            edits += world.replace(bmin, bmax, mat)
    return edits


@pytest.mark.parametrize("slack", [1.0, 1.5])
def test_edit_fuzz_pools_bit_equal(worlds, slack):
    jw, tw = worlds
    jwa, jdev = jw.to_device(slack=slack)
    twa, tworld = tw.to_device(slack=slack, device="cpu")
    caps = (twa.tree.capacity, twa.twig.capacity)
    twice = 0
    for batch in _fuzz_batches(np.random.default_rng(2024)):
        jedits, tedits = _run(jw, batch), _run(tw, batch)
        assert [(i, dt.left, dt.right, dt.realloc, dw.left, dw.right, dw.realloc)
                for i, dt, dw in jedits] == [
               (i, dt.left, dt.right, dt.realloc, dw.left, dw.right, dw.realloc)
               for i, dt, dw in tedits]
        keys = [i for i, _, _ in tedits]
        twice += len(keys) != len(set(keys))
        jdev = jw.apply(jwa, jdev, jedits)
        tworld = tw.apply(twa, tworld, tedits)
        assert_chunks_equal(jw.chunks, tw.chunks)
        assert_alloc_equal(jwa, twa)
        assert_pools_equal(jdev, tworld)
        assert tworld.tree.shape[0] == twa.tree.capacity
        assert tworld.twig_occ.shape[0] == 2 * twa.twig.capacity
    assert twice >= 1
    assert (twa.tree.capacity, twa.twig.capacity) > caps     # the pools grew


def test_modify_growth_relocates_block():
    """test_world_edit.py's growth case on both sides: a chunk outgrows its
    slot, the arena doubles, the block moves, the pools stay equal."""
    jchunks = [JaxChunk.empty_chunk((i * 8.0, 0.0, 0.0), 8.0, 3) for i in range(2)]
    tchunks = [Chunk.empty_chunk((i * 8.0, 0.0, 0.0), 8.0, 3) for i in range(2)]
    jwa, jdev = JaxWorldAllocator.pack(jchunks, (2, 1, 1), slack=1.0)
    twa, tworld = WorldAllocator.pack(tchunks, (2, 1, 1), slack=1.0, device="cpu")
    cap0 = twa.tree.capacity
    jdev = jwa.modify(jdev, 0, jchunks[0], *jax_build(jchunks[0], (0.5,) * 3, (7.5,) * 3, 2))
    tworld = twa.modify(tworld, 0, tchunks[0], *build(tchunks[0], (0.5,) * 3, (7.5,) * 3, 2))
    jdev = jwa.modify(jdev, 1, jchunks[1], *jax_destroy(jchunks[1], (1,) * 3, (2,) * 3))
    tworld = twa.modify(tworld, 1, tchunks[1], *destroy(tchunks[1], (1,) * 3, (2,) * 3))
    assert twa.tree.capacity > cap0
    assert tworld.tree.shape[0] == twa.tree.capacity
    assert_pools_equal(jdev, tworld)


def test_shift_and_save_load_cross(worlds, tmp_path):
    jw, tw = worlds
    jwa, jdev = jw.to_device()
    twa, tworld = tw.to_device(device="cpu")
    jt, tt = jw.shift(0, +1), tw.shift(0, +1)
    assert jt == tt and len(tt) == 2
    jdev = jw.apply_shift(jwa, jdev, jt)
    coordmin = tworld.chunkcoordmin
    tworld = tw.apply_shift(twa, tworld, tt)
    assert tworld.chunkcoordmin is coordmin                  # slid in place
    np.testing.assert_array_equal(tworld.chunkcoordmin.numpy(), [1, 0, 0])
    assert_chunks_equal(jw.chunks, tw.chunks)
    assert_pools_equal(jdev, tworld)
    assert sorted(jw.pyramids) == sorted(tw.pyramids)

    tw.save(str(tmp_path / "port.npz"))
    jw.save(str(tmp_path / "jax.npz"))
    from_port, from_jax = JaxWorld.load(str(tmp_path / "port.npz")), World.load(
        str(tmp_path / "jax.npz"))
    assert_chunks_equal(from_port.chunks, tw.chunks)
    assert_chunks_equal(jw.chunks, from_jax.chunks)
    np.testing.assert_array_equal(from_jax.chunkcoordmin, jw.chunkcoordmin)
    assert from_jax.memory_report() == JaxWorld.load(str(tmp_path / "jax.npz")).memory_report()
    assert (from_jax.seed, from_jax.water_level, from_jax.amplitude) == (7, 4.0, 16.0)


def test_pick_matches(generated):
    jw, tw = generated
    rng = np.random.default_rng(32)
    n_hit = 0
    for _ in range(32):
        o = rng.uniform([-10, 20, -10], [74, 40, 74]).astype(np.float32)
        d = (rng.uniform([8, 0, 8], [56, 10, 56]) - o).astype(np.float32)
        a, b = jax_pick(jw, o, d, cursor_scale=6.0), pick(tw, o, d, cursor_scale=6.0)
        assert (a is None) == (b is None)
        if a is None:
            continue
        n_hit += 1
        assert (a.hit, a.cell_size, a.material, a.t) == (b.hit, b.cell_size, b.material, b.t)
        np.testing.assert_array_equal(a.point, b.point)
        np.testing.assert_array_equal(a.cell_bmin, b.cell_bmin)
        for x, y in zip(jax_cursor_box(a), cursor_box(b)):
            np.testing.assert_array_equal(x, y)
    assert n_hit >= 16


def _lod_chunk(pyramid, grow_fn, destroy_fn, build_fn):
    """The carved terrain chunk of tests/test_lod.py."""
    pyr = pyramid.generate(size=64, amplitude=16.0, period=1.0 / 64, xshift=0, yshift=4.0,
                           zshift=0, seed=3)
    c = grow_fn((0.0, 0.0, 0.0), 32.0, 5, pyr)
    destroy_fn(c, (3, 3, 3), (29, 12, 29))
    build_fn(c, (8, 20, 8), (24, 26, 24), 5)
    return c


@pytest.mark.parametrize("fns", [(jax_defrag, defrag), (jax_lod, lod),
                                 (jax_defrag_dense, defrag_dense), (jax_lod_dense, lod_dense)],
                         ids=["defrag", "lod", "defrag_dense", "lod_dense"])
def test_lod_defrag_bit_equal(fns):
    a = fns[0](_lod_chunk(JaxBoundsPyramid, jax_grow, jax_destroy, jax_build))
    b = fns[1](_lod_chunk(BoundsPyramid, grow, destroy, build))
    assert_chunks_equal([a], [b])
    assert a.tree.shape == b.tree.shape and a.twig.shape == b.twig.shape


def test_edited_golden(worlds):
    """The edited scene of tests/test_golden.py through the port's CPU path
    against the stored thumbnail."""
    _, tw = worlds
    wa, world = tw.to_device(device="cpu")
    world = tw.apply(wa, world, tw.replace((10, 8, 10), (54, 22, 54), 5))
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                            fov_deg=70.0, width=96, height=54)
    o, d = cam.rays()
    rgb = render(world, o, d, np.asarray(cam.position, np.float32),
                 cfg=RenderConfig(shadow="none"), device="cpu")["rgb"].numpy()
    thumb = rgb.astype(np.float64).reshape(54, 96, 3)[:48, :96].reshape(
        8, 6, 8, 12, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(thumb, np.load(GOLDEN), atol=2e-2)


def test_run_session_cpu(worlds, tmp_path):
    """Four 64x36 frames: one edit, the shift and the LOD swap; the patched
    world marches as a fresh pack of the same chunks does."""
    _, tw = worlds
    wa, world = tw.to_device(device="cpu")
    seen = []
    stats = run_session(tw, wa, world, frames=4, res=(64, 36), out=str(tmp_path),
                        device="cpu", on_batch=lambda k, b, wd: seen.append(k))
    assert seen == ["edit", "shift", "lod"]
    assert len(stats["frame_s"]) == 4 and stats["save_s"] is not None
    assert sorted(os.listdir(tmp_path))[:2] == ["frame_000.png", "frame_001.png"]
    _, fresh = tw.to_device(device="cpu")
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), pitch_deg=-20.0, fov_deg=70.0,
                            width=48, height=27)
    o, d = cam.rays()
    eye = np.asarray(cam.position, np.float32)
    a = render(stats["world"], o, d, eye, device="cpu")
    b = render(fresh, o, d, eye, device="cpu")
    assert torch.equal(a["hit"], b["hit"]) and torch.equal(a["material"], b["material"])
    torch.testing.assert_close(a["rgb"], b["rgb"], rtol=0, atol=0)
    # the npz keeps one depth for all chunks (the JAX format), so the LOD
    # chunk loads with the world's
    assert_chunks_equal(World.load(str(tmp_path / "world.npz")).chunks, tw.chunks,
                        depth=False)
