"""The port's host world (numpy copies) and upload against the JAX package.

The port's World.generate + pack_chunks must give pools bit-equal to the JAX
package's, and TorchWorld.from_numpy must carry either package's packed pools
across unchanged (u32 pools as int32 views of the same bits)."""

import numpy as np
import pytest

from octree_raymarcher_tpu.world.device import occupancy_masks as jax_occupancy_masks
from octree_raymarcher_tpu.world.device import pack_chunks as jax_pack_chunks
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.world.device import (
    TorchWorld,
    occupancy_masks,
    pack_chunks,
)
from octree_raymarcher_tpu_torch.world.world import World

POOL_FIELDS = ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree",
               "chunk_twig", "chunkcoordmin")
# The golden scene of tests/test_golden.py.
SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)


@pytest.fixture(scope="module")
def worlds():
    return JaxWorld.generate(**SCENE), World.generate(**SCENE)


def _assert_packed_equal(a, b):
    for k in POOL_FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x.view(y.dtype) if x.dtype != y.dtype else x, y,
                                      err_msg=k)
    assert float(a.chunksize) == float(b.chunksize)
    assert tuple(a.dims) == tuple(b.dims) and int(a.depth) == int(b.depth)


def test_generated_pools_bit_equal(worlds):
    jw, tw = worlds
    for jc, tc in zip(jw.chunks, tw.chunks):
        assert (jc.ntrees, jc.ntwigs) == (tc.ntrees, tc.ntwigs)
        np.testing.assert_array_equal(jc.tree[: jc.ntrees], tc.tree[: tc.ntrees])
        np.testing.assert_array_equal(jc.twig[: jc.ntwigs], tc.twig[: tc.ntwigs])
    packed = pack_chunks(tw.chunks, tw.dims)
    _assert_packed_equal(jax_pack_chunks(jw.chunks, jw.dims), packed)
    assert packed.tree.dtype == np.uint32 and packed.twig_occ.dtype == np.uint32
    assert tw.index(3, -1, 5) == jw.index(3, -1, 5)


@pytest.mark.parametrize("source", ["pack_chunks", "allocator"])
def test_from_numpy_round_trips(worlds, source):
    """Either JAX packing (pack_chunks, or World.to_device(device=False)'s
    allocator layout) crosses into a TorchWorld and back bit for bit."""
    jw, _ = worlds
    if source == "pack_chunks":
        ref = jax_pack_chunks(jw.chunks, jw.dims)
    else:
        _, ref = jw.to_device(device=False)
    tw = TorchWorld.from_numpy(ref, device="cpu")
    assert tw.tree.dtype == tw.twig.dtype == tw.twig_occ.dtype
    assert str(tw.tree.dtype) == "torch.int32"
    assert tw.device.type == "cpu"
    _assert_packed_equal(ref, tw.to_numpy())
    # int32 views decode the node type and payload as the u32 words do
    words = np.asarray(ref.tree)
    t = tw.tree
    np.testing.assert_array_equal(((t >> 30) & 3).numpy(), words >> 30)
    np.testing.assert_array_equal((t & ((1 << 30) - 1)).numpy(), words & ((1 << 30) - 1))


def test_to_torch_matches_pack(worlds):
    _, tw = worlds
    _assert_packed_equal(pack_chunks(tw.chunks, tw.dims), tw.to_torch("cpu").to_numpy())


def test_occupancy_masks_match(rng):
    twig = (rng.uniform(size=64 * 37) < 0.3).astype(np.uint32) * rng.integers(
        1, 7, size=64 * 37).astype(np.uint32)
    np.testing.assert_array_equal(occupancy_masks(twig), jax_occupancy_masks(twig))
