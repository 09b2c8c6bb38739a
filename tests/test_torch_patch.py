"""The layout and packing of the pool patch (kernel K7), on the CPU.

K7 (csrc/patch.cu) carries a batch's rows in its launch's parameter block
and moves 16-byte words, so the host lays the word stream out for it:
pieces of at most PIECE_WORDS, each source congruent to its destination mod
4 (a multiple of 64 on the twig pool), zero padding between ranges, int32
rows, ROW_CAPS rows a launch.  These tests hold that layout, the packing
and the checks, and hold ``patch_plain`` on the new layout to the JAX
package's ``WorldAllocator.modify`` on dirty ranges at every start offset
mod 4.  K7 itself runs only on the card (tests/test_torch_cuda.py)."""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.core.chunk import Dirty as JaxDirty
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.core.chunk import Dirty
from octree_raymarcher_tpu_torch.world.alloc import (
    CHUNK_BMIN,
    CHUNK_TREE,
    CHUNK_TWIG,
    PIECE_WORDS,
    ROW_CAPS,
    TREE,
    TWIG,
    check_batch,
    launch_groups,
    layout,
    pack_rows,
    patch,
)
from octree_raymarcher_tpu_torch.world.world import World

from test_torch_edit import SCENE, assert_alloc_equal, assert_pools_equal

PATCH_CU = (Path(__file__).resolve().parent.parent / "octree_raymarcher_tpu_torch" / "csrc"
            / "patch.cu")


@pytest.fixture(scope="module")
def generated():
    return JaxWorld.generate(**SCENE), World.generate(**SCENE)


def _covered(desc, n_words):
    """Per stream word, how many rows read it."""
    cover = np.zeros(n_words, np.int64)
    for _, _, src, n in desc.tolist():
        cover[src:src + n] += 1
    return cover


def assert_layout(desc, words):
    """Every row at most PIECE_WORDS, its source congruent to its
    destination mod 4 (mod 64 on the twig pool); no stream word read twice,
    and every word no row reads is zero."""
    tgt, dst, src, n = desc.T
    assert ((n >= 1) & (n <= PIECE_WORDS)).all()
    assert ((src - dst) % 4 == 0).all()
    assert (src[tgt == TWIG] % 64 == 0).all()
    cover = _covered(desc, words.size)
    assert cover.max() <= 1
    assert not words[cover == 0].any()


def _edit_batches(world, rng, count):
    """The port's batches of ``count`` seeded carve/fill/replace edits."""
    out = []
    wa, dev = world.to_device(device="cpu")
    for k in range(count):
        c = rng.uniform([0, 0, 0], [64, 32, 64])
        half = rng.uniform(0.5, 9.0, 3)
        op = (world.destroy, lambda a, b: world.build(a, b, 3),
              lambda a, b: world.replace(a, b, 5))[k % 3]
        dev = world.apply(wa, dev, op(c - half, c + half))
        if wa.last_batch is not None:
            out.append(wa.last_batch)
    dev = world.apply_shift(wa, dev, world.shift(0, +1))
    out.append(wa.last_batch)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_stream_layout(generated, seed):
    """plan's streams on edits and a shift: the layout K7 needs, and the
    words each row reads are the chunk words it writes."""
    tw = copy.deepcopy(generated[1])
    batches = _edit_batches(tw, np.random.default_rng(seed), 6)
    assert len(batches) >= 4
    residues = set()
    for b in batches:
        assert_layout(b.desc, b.words)
        residues |= set((b.desc[b.desc[:, 0] == TREE, 1] % 4).tolist())
        assert b.words.size < b.desc[:, 3].sum() + 64 * b.desc.shape[0]
    assert len(residues) > 1


def test_layout_pieces_and_pads():
    """layout cuts ranges at PIECE_WORDS, pads each start to its
    destination's residue, and keeps every range's words in order."""
    rng = np.random.default_rng(1)
    ranges = [(TREE, 16 * k + k % 4, rng.integers(1, 1 << 30, 1 + k).astype(np.int32))
              for k in range(9)]
    ranges += [(TWIG, 64 * 5, rng.integers(1, 9, 64 * 70).astype(np.int32)),
               (CHUNK_BMIN, 3 * 7, np.float32([1.0, 2.0, 3.0]).view(np.int32)),
               (CHUNK_TREE, 7, np.int32([11])), (CHUNK_TWIG, 7, np.int32([12])),
               (TREE, 1001, rng.integers(1, 1 << 30, 2 * PIECE_WORDS + 3).astype(np.int32))]
    desc, words = layout(ranges)
    assert_layout(desc, words)
    twig_rows = desc[desc[:, 0] == TWIG]
    assert twig_rows[:, 3].tolist() == [PIECE_WORDS, PIECE_WORDS, 64 * 70 - 2 * PIECE_WORDS]
    assert desc[(desc[:, 0] == TREE) & (desc[:, 1] >= 1001), 3].tolist() == [
        PIECE_WORDS, PIECE_WORDS, 3]
    for target, dst, seg in ranges:
        rows = desc[(desc[:, 0] == target) & (desc[:, 1] >= dst) & (desc[:, 1] < dst + seg.size)]
        got = np.concatenate([words[s:s + n] for _, _, s, n in rows.tolist()])
        np.testing.assert_array_equal(got, seg)


def test_pack_rows_round_trip():
    """Rows go to K7 as C-contiguous int32, 16 bytes a row, and come back
    equal; a value past int32 raises rather than wraps."""
    rng = np.random.default_rng(2)
    desc = np.stack([rng.integers(0, 5, 300), rng.integers(0, 2**31 - 2**12, 300),
                     rng.integers(0, 2**31 - 2**12, 300), rng.integers(1, PIECE_WORDS, 300)],
                    axis=1).astype(np.int64)
    rows = pack_rows(desc)
    assert rows.dtype == np.int32 and rows.flags.c_contiguous and rows.nbytes == 16 * 300
    np.testing.assert_array_equal(rows.astype(np.int64), desc)
    np.testing.assert_array_equal(np.frombuffer(rows.tobytes(), np.int32).reshape(-1, 4), desc)
    desc[7, 1] = 2**31
    with pytest.raises(ValueError, match="int32"):
        pack_rows(desc)


@pytest.mark.parametrize("n", [1, ROW_CAPS[0], ROW_CAPS[0] + 1, ROW_CAPS[1], ROW_CAPS[1] + 1,
                               ROW_CAPS[2], ROW_CAPS[2] + 1, 3 * ROW_CAPS[2] + 70])
def test_launch_groups(n):
    """Launches cover the rows in order, ROW_CAPS[-1] a launch at most, each
    in the smallest capacity that holds it: at the cap one launch, at cap + 1
    two."""
    groups = launch_groups(n)
    assert [lo for lo, _, _ in groups] == list(range(0, n, ROW_CAPS[-1]))
    assert groups[-1][1] == n
    for lo, hi, cap in groups:
        assert cap == min(c for c in ROW_CAPS if c >= hi - lo)
    assert len(groups) == -(-n // ROW_CAPS[-1])
    if n == ROW_CAPS[-1]:
        assert groups == [(0, n, ROW_CAPS[-1])]
    if n == ROW_CAPS[-1] + 1:
        assert groups == [(0, n - 1, ROW_CAPS[-1]), (n - 1, n, ROW_CAPS[0])]


def test_kernel_constants_match():
    """PIECE_WORDS and ROW_CAPS are csrc/patch.cu's kPieceWords and
    kRowCaps, and the largest parameter block fits CUDA's 32,764 bytes."""
    src = PATCH_CU.read_text()
    assert int(re.search(r"kPieceWords = (\d+);", src).group(1)) == PIECE_WORDS
    caps = re.search(r"kRowCaps\[3\] = \{([\d, ]+)\};", src).group(1)
    assert tuple(int(c) for c in caps.split(",")) == ROW_CAPS
    assert PIECE_WORDS % (4 * 256) == 0
    assert 7 * 8 + 16 * ROW_CAPS[-1] <= 32764


def test_check_batch_int32(generated):
    """A destination past int32 raises in check_batch, even where the
    target is that long."""
    _, world = generated[1].to_device(device="cpu")
    huge = torch.zeros(1, dtype=torch.int32).expand(2**31 + 256)
    world.tree = huge
    desc = np.asarray([(TREE, 2**31, 0, 4)], np.int64)
    with pytest.raises(ValueError, match="int32"):
        check_batch(world, desc, 4)
    desc = np.asarray([(TREE, 2**31 - 8, 0, 8)], np.int64)
    with pytest.raises(ValueError, match="int32"):
        check_batch(world, desc, 8)
    check_batch(world, np.asarray([(TREE, 2**31 - 12, 0, 8)], np.int64), 8)


@pytest.mark.parametrize("row, why", [
    ((TREE, 5, 0, 3), "source not congruent to the destination mod 4"),
    ((TREE, 4, 0, PIECE_WORDS + 4), "longer than a piece"),
    ((TWIG, 32, 32, 64), "twig row not on a twig"),
    ((TWIG, 64, 64, 96), "twig row not whole twigs"),
    ((CHUNK_TREE, 64, 0, 1), "past its target"),
    ((CHUNK_TWIG, 0, 4096, 1), "past the word stream"),
    ((TREE, 0, 0, 0), "empty"),
])
def test_check_batch_rejects(generated, row, why):
    """Each rule of the layout K7 needs, broken once, raises."""
    _, world = generated[1].to_device(device="cpu")
    check_batch(world, np.asarray([(TREE, 1, 1, 3), (TWIG, 128, 128, 64)], np.int64), 192)
    with pytest.raises(ValueError):
        check_batch(world, np.asarray([row], np.int64), 4096)


def _mutate(rng, jchunk, tchunk, lo, hi, tlo, thi):
    """The same new words in both chunks' tree [lo, hi) and twigs
    [tlo, thi) (some twigs left empty)."""
    tree = rng.integers(0, 1 << 32, hi - lo, dtype=np.uint64).astype(np.uint32)
    jchunk.tree[lo:hi] = tree
    tchunk.tree[lo:hi] = tree
    shape = tchunk.twig[tlo:thi].shape
    twig = (rng.uniform(size=shape) < 0.4) * rng.integers(1, 9, shape)
    twig[rng.uniform(size=shape[0]) < 0.3] = 0
    jchunk.twig[tlo:thi] = twig.astype(jchunk.twig.dtype)
    tchunk.twig[tlo:thi] = twig.astype(tchunk.twig.dtype)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_dirty_fuzz_pools_bit_equal(generated, offset):
    """Beside test_torch_edit.py's edit fuzz: seeded dirty ranges whose
    tree range starts at ``offset`` mod 4 (and twig ranges of any length,
    some realloc'd) through plan, layout and patch_plain give pools bit-equal
    to the JAX package's WorldAllocator.modify after every batch."""
    rng = np.random.default_rng(100 + offset)
    jw, tw = copy.deepcopy(generated[0]), copy.deepcopy(generated[1])
    jwa, jdev = jw.to_device()
    twa, tworld = tw.to_device(device="cpu")
    starts = set()
    for _ in range(6):
        items = []
        for key in rng.choice(len(tw.chunks), size=int(rng.integers(1, 3)), replace=False):
            key = int(key)
            jc, tc = jw.chunks[key], tw.chunks[key]
            lo = 4 * int(rng.integers(0, (tc.ntrees - 12) // 4)) + offset
            hi = lo + int(rng.integers(1, 10))
            tlo = int(rng.integers(0, max(1, tc.ntwigs - 40)))
            thi = min(tc.ntwigs, tlo + int(rng.integers(1, 40)))
            _mutate(rng, jc, tc, lo, hi, tlo, thi)
            realloc = bool(rng.uniform() < 0.2)
            jdev = jwa.modify(jdev, key, jc, JaxDirty(lo, hi), JaxDirty(tlo, thi, realloc))
            items.append((key, tc, Dirty(lo, hi), Dirty(tlo, thi, realloc)))
        tworld = twa.modify_batch(tworld, items)
        batch = twa.last_batch
        assert_layout(batch.desc, batch.words)
        tree_rows = batch.desc[batch.desc[:, 0] == TREE]
        starts |= set((tree_rows[:, 1] % 4).tolist())
        assert_alloc_equal(jwa, twa)
        assert_pools_equal(jdev, tworld)
    assert offset in starts


def test_patch_cpu_world_is_patch_plain(generated):
    """patch on a CPU world takes the batch's rows and staged words through
    patch_plain; staged words of the wrong type raise."""
    w = copy.deepcopy(generated[1])
    wa, world = w.to_device(device="cpu")
    desc, words = layout([(TREE, 9, np.int32([5, 6, 7])), (TWIG, 64, np.ones(64, np.int32))])
    patch(world, desc, torch.from_numpy(words))
    assert world.tree[9:12].tolist() == [5, 6, 7]
    assert world.twig_occ[2:4].tolist() == [-1, -1]
    with pytest.raises(ValueError):
        patch(world, desc, torch.from_numpy(words).to(torch.int64))
