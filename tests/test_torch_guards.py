"""The port's NaN/OOB guards (ops/guards.py) on every case of
tests/test_guards.py:34-91, with the reference's messages, plus the output
checks that clean inputs cannot reach.

The world, rays and params are the reference test's, built by both
packages; the checked march's hit and material equal the JAX march's
exactly and its t within rtol 1e-6 (as tests/test_torch_march.py)."""

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.ops import march as jax_march
from octree_raymarcher_tpu.world import single_chunk_world as jax_single_chunk_world
from octree_raymarcher_tpu.worldgen import BoundsPyramid as JaxBoundsPyramid
from octree_raymarcher_tpu.worldgen import grow as jax_grow
from octree_raymarcher_tpu_torch.core.chunk import Chunk
from octree_raymarcher_tpu_torch.diff import init_params_from_world, sample_segments
from octree_raymarcher_tpu_torch.diff.segments import SegmentBatch
from octree_raymarcher_tpu_torch.ops import guards
from octree_raymarcher_tpu_torch.ops.guards import GuardError, composite_checked, march_checked
from octree_raymarcher_tpu_torch.ops.march import march
from octree_raymarcher_tpu_torch.shade import render
from octree_raymarcher_tpu_torch.world.device import TorchWorld, single_chunk_world
from octree_raymarcher_tpu_torch.worldgen import BoundsPyramid, grow

PYR = dict(size=16, amplitude=6.0, period=1.0 / 16, xshift=0.0, yshift=4.0, zshift=0.0,
           seed=2)


@pytest.fixture(scope="module")
def worlds():
    jw = jax_single_chunk_world(jax_grow([0.0, 0.0, 0.0], 16.0, depth=4,
                                         pyr=JaxBoundsPyramid.generate(**PYR)))
    tw = TorchWorld.from_numpy(single_chunk_world(
        grow([0.0, 0.0, 0.0], 16.0, depth=4, pyr=BoundsPyramid.generate(**PYR))), device="cpu")
    return jw, tw


def _rays(n=32):
    rng = np.random.default_rng(0)
    o = rng.uniform(0, 16, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_guard_error_is_a_runtime_error():
    assert issubclass(GuardError, RuntimeError)


def test_checked_march_passes_clean_inputs(worlds):
    jw, tw = worlds
    o, d = _rays()
    r = march_checked(tw, o, d, device="cpu")
    plain = march(tw, o, d, device="cpu")
    ref = jax_march(jw, o, d)
    for k in ("hit", "t", "material", "texel"):
        assert torch.equal(getattr(r, k), getattr(plain, k)), k
    np.testing.assert_array_equal(r.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(r.material.numpy(), np.asarray(ref.material))
    hit = r.hit.numpy()
    np.testing.assert_allclose(r.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
    assert hit.any()


@pytest.mark.parametrize("case, msg", [
    ("nan_dir", "march: non-finite ray direction"),
    ("inf_origin", "march: non-finite ray origin"),
    ("zero_dir", "march: zero-length ray direction"),
])
def test_checked_march_rejects_bad_rays(worlds, monkeypatch, case, msg):
    """The input checks raise before any march runs."""
    _, tw = worlds
    o, d = _rays()
    if case == "nan_dir":
        d[3, 1] = np.nan
    elif case == "inf_origin":
        o[0, 0] = np.inf
    else:
        d[5] = 0.0

    def no_march(*args, **kwargs):
        raise AssertionError("the march ran before the input checks")

    monkeypatch.setattr(guards, "march_tiled", no_march)
    with pytest.raises(GuardError, match=msg):
        march_checked(tw, o, d, device="cpu")


def test_checks_run_in_the_reference_order(worlds):
    """A ray with a NaN origin and a zero direction reports the origin."""
    _, tw = worlds
    o, d = _rays()
    o[1, 2] = np.nan
    d[1] = 0.0
    with pytest.raises(GuardError, match="non-finite ray origin"):
        march_checked(tw, o, d, device="cpu")


@pytest.mark.parametrize("field, value, msg", [
    ("t", -1.0, "march: non-finite or negative hit distance"),
    ("t", float("nan"), "march: non-finite or negative hit distance"),
    ("material", 0, "march: hit reported material 0 (void)"),
    ("texel", "cap", "march: texel index outside the twig pool"),
    ("texel", -2, "march: texel index outside the twig pool"),
])
def test_checked_march_output_checks(worlds, monkeypatch, field, value, msg):
    """The output checks (unreachable with a sound world) raise on a
    corrupt march result, and only on hit rays where the reference's do."""
    _, tw = worlds
    o, d = _rays()
    res = march(tw, o, d, device="cpu")
    i = int(torch.nonzero(res.hit)[0])
    bad = getattr(res, field).clone()
    bad[i] = tw.twig.shape[0] if value == "cap" else value
    setattr(res, field, bad)
    monkeypatch.setattr(guards, "march_tiled", lambda *a, **k: res)
    with pytest.raises(GuardError, match=msg.replace("(", r"\(").replace(")", r"\)")):
        march_checked(tw, o, d, device="cpu")
    if field != "texel":
        # the same value on a missed ray passes
        j = int(torch.nonzero(~res.hit)[0])
        res2 = march(tw, o, d, device="cpu")
        bad = getattr(res2, field).clone()
        bad[j] = value
        setattr(res2, field, bad)
        monkeypatch.setattr(guards, "march_tiled", lambda *a, **k: res2)
        march_checked(tw, o, d, device="cpu")


def test_empty_world_renders_all_misses():
    """A world of one all-EMPTY chunk: every ray misses, nothing NaNs."""
    empty = Chunk.empty_chunk((0.0, 0.0, 0.0), 16.0, depth=4)
    world = TorchWorld.from_numpy(single_chunk_world(empty), device="cpu")
    o, d = _rays()
    r = march_checked(world, o, d, device="cpu")
    assert not r.hit.any()
    out = render(world, o, d, (0.0, 0.0, 0.0), device="cpu")
    assert torch.isfinite(out["rgb"]).all()


def test_checked_march_defaults_to_the_card(worlds, monkeypatch):
    _, tw = worlds
    o, d = _rays()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        march_checked(tw, o, d)


@pytest.fixture(scope="module")
def segs_params(worlds):
    _, tw = worlds
    o, d = _rays()
    return sample_segments(tw, o, d, max_segments=4, device="cpu"), init_params_from_world(tw)


def test_checked_composite_flags_bad_slots(segs_params):
    segs, params = segs_params
    out = composite_checked(segs, params)  # clean case passes
    assert torch.isfinite(out["rgb"]).all()
    bad = SegmentBatch(torch.where(segs.slot >= 0, segs.slot + params.num_slots, segs.slot),
                       segs.t0, segs.t1, segs.count)
    with pytest.raises(GuardError, match="slot out of range"):
        composite_checked(bad, params)


@pytest.mark.parametrize("case, msg", [
    ("t1_lt_t0", "composite: segment with t1 < t0"),
    ("neg_t0", "composite: negative segment start"),
    ("nan_density", "composite: non-finite rgb"),
])
def test_checked_composite_rejects(segs_params, case, msg):
    segs, params = segs_params
    valid = segs.slot >= 0
    assert valid.any()
    t0, t1 = segs.t0.clone(), segs.t1.clone()
    if case == "t1_lt_t0":
        t1 = torch.where(valid, t0 - 1.0, t1)
    elif case == "neg_t0":
        t0 = torch.where(valid, t0 - 1e4, t0)
        t1 = torch.where(valid, t0 + 1.0, t1)
    else:
        params = type(params)(torch.full_like(params.density_raw, float("nan")),
                              params.albedo_raw)
    with pytest.raises(GuardError, match=msg):
        composite_checked(SegmentBatch(segs.slot, t0, t1, segs.count), params)
    # an invalid slot's extents are not checked
    if case != "nan_density":
        bad = ~valid
        t0i = torch.where(bad, -5.0, segs.t0)
        t1i = torch.where(bad, -9.0, segs.t1)
        composite_checked(SegmentBatch(segs.slot, t0i, t1i, segs.count), params)
