"""The stage-compacted march and segment sampler of the port (the plain
versions of K9 and K10, ops/march_compact.py and diff/segments_compact.py)
against the JAX package's, case by case as tests/test_march_compact.py and
tests/test_diff_compact.py hold the JAX package's own.

The march results (hit, t, material, cell, texel) must be exact, and the
segments exact against the port's own sampler; against the JAX package's
sampler slot and count are exact and t0, t1 within tests/test_torch_diff.py's
rtol 1e-5 / atol 1e-4 (XLA may fuse a multiply-add of the extraction that
the port rounds twice).  ``steps`` is the coarse charge (exact <=
charge <= exact + the largest stage bound) and the lane count is the port's
own, at the warp (32 lanes; the JAX package counts its tiles), so both are
held to their bounds, not to the JAX package's values.  Frames are held as
tests/test_torch_shadow.py holds the shadowed frames: hit and material
exact, rgb within 1e-5 on at least 99.9% of the pixels (a shadow factor may
flip on a ray that grazes a cell, queue C4).

The JAX references run one tile a stage (``tile`` at least the batch) and
share their shapes, so each stage length compiles once; its compacted map
frame marches a 512x512 light bundle in 32 tiles a stage, minutes on the
CPU, so the map frame is held against the JAX package's plain map frame and
its compacted light pass against ``render_shadowmap(compact=True)`` at
64x64."""

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.diff.segments_compact import (
    sample_segments_compact as jax_sample_segments_compact,
)
from octree_raymarcher_tpu.ops import march_compact as JMC
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import render_frame as jax_render_frame
from octree_raymarcher_tpu.shade.render import render_shadowmap as jax_render_shadowmap
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.diff import VoxelParams, fit
from octree_raymarcher_tpu_torch.diff.optim import sample_views
from octree_raymarcher_tpu_torch.diff.segments import sample_segments
from octree_raymarcher_tpu_torch.diff.segments_compact import (
    USED_BITS,
    sample_segments_compact,
    sample_segments_compact_plain,
    sampler_schedule,
    sampler_stage_plain,
)
from octree_raymarcher_tpu_torch.ops import march_compact as MC
from octree_raymarcher_tpu_torch.ops.march import march
from octree_raymarcher_tpu_torch.shade.lights import LightRig
from octree_raymarcher_tpu_torch.shade.render import (
    RenderConfig,
    render_frame,
    render_shadowmap,
)
from octree_raymarcher_tpu_torch.world.device import TorchWorld

MARCH_WORLD = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=3, water_level=0.0,
                   amplitude=2.0)
SAMPLER_WORLD = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=3, water_level=2.0,
                     amplitude=8.0)
FRAME_WORLD = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                   amplitude=16.0)
N = 1500          # rays of the march cases: not a multiple of 32
TILE = 2048       # the JAX references' tile: one tile a stage
STEPS = 256
FIELDS = ("hit", "t", "material", "cell_bmin", "cell_size", "texel")
AGREE = 0.999


def _skewed_rays(rng, n):
    """tests/test_march_compact.py's rays: short down-rays, a few long
    grazers skimming the surface band, and misses."""
    o = np.stack([rng.uniform(2, 62, n), np.full(n, 24.0),
                  rng.uniform(2, 62, n)], axis=1).astype(np.float32)
    d = np.broadcast_to(np.array([0.0, -1.0, 0.0], np.float32), (n, 3)).copy()
    for k, i in enumerate(range(0, n, max(1, n // 4))):
        o[i] = (0.5, 3.0 + 0.1 * k, 0.5)
        d[i] = np.array([1.0, 0.004, 1.0], np.float32)
        d[i] /= np.linalg.norm(d[i])
    d[1::7] = np.array([0.0, 1.0, 0.0], np.float32)
    return o, d


def _sampler_rays(rng, n):
    """tests/test_diff_compact.py's rays: steep hitters, grazers, misses."""
    o = np.stack([rng.uniform(2, 62, n), np.full(n, 30.0),
                  rng.uniform(2, 62, n)], axis=1).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), np.full(n, -1.0),
                  rng.uniform(-0.3, 0.3, n)], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(0, n, max(1, n // 5)):
        o[i] = (0.5, 4.0, 0.5)
        d[i] = np.array([1.0, -0.02, 0.9], np.float32)
        d[i] /= np.linalg.norm(d[i])
    d[2::9] = np.array([0.0, 1.0, 0.0], np.float32)
    return o, d


def _worlds(spec):
    """The JAX package's packed world and the same pools carried across
    (texel indices are pool offsets, so the port marches the same pools)."""
    _, jdev = JaxWorld.generate(**spec).to_device()
    return jdev, TorchWorld.from_numpy(jdev, device="cpu")


@pytest.fixture(scope="module")
def mworld():
    return _worlds(MARCH_WORLD)


@pytest.fixture(scope="module")
def mrays():
    return _skewed_rays(np.random.default_rng(0), N)


def _assert_march_equal(got, ref, fields=FIELDS):
    for k in fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)


def _exact(tworld, o, d, **kw):
    """The exact steps and iterations of one march (port, exact AOV)."""
    return march(tworld, o, d, STEPS, steps_aov=True, device="cpu", **kw)


# ---- schedules ----------------------------------------------------------------------

@pytest.mark.parametrize("max_steps", [1, 4, 64, 127, 130, 256, 512, 640])
@pytest.mark.parametrize("stride", [4, 8, 16, 32, 64])
def test_default_schedule_matches_jax(max_steps, stride):
    got = MC.default_schedule(max_steps, stride)
    assert got == JMC.default_schedule(max_steps, stride)
    MC._validate_schedule(got, max_steps)
    assert sum(-(-s // 4) * 4 for s in got) == -(-max_steps // 4) * 4


@pytest.mark.parametrize("schedule,max_steps,stride", [
    ((16, 16), 256, 16),          # too few iterations
    ((16,) * 17, 256, 16),        # too many
    ((6, 250), 256, 16),          # a non-final stage off the unroll
    (None, 64, 13),               # a stride off the unroll
])
def test_schedule_errors_match_jax(mworld, schedule, max_steps, stride):
    _, tworld = mworld
    o = np.zeros((8, 3), np.float32)
    d = np.tile(np.array([[0, -1, 0]], np.float32), (8, 1))
    with pytest.raises(ValueError) as want:
        if schedule is None:
            JMC.default_schedule(max_steps, stride)
        else:
            JMC._validate_schedule(schedule, max_steps)
    with pytest.raises(ValueError) as got:
        MC.march_frame_compact(tworld, o, d, max_steps, stride=stride, schedule=schedule,
                               device="cpu")
    assert str(got.value) == str(want.value)


# ---- the frame march ------------------------------------------------------------------

def test_compact_bit_identical_to_jax_and_march(mworld, mrays):
    jdev, tworld = mworld
    o, d = mrays
    ref, _ = JMC.march_frame_compact(jdev, o, d, STEPS, tile=TILE, stride=16)
    got, lane_iters = MC.march_frame_compact(tworld, o, d, STEPS, stride=16, device="cpu")
    _assert_march_equal(got, ref)
    _assert_march_equal(got, march(tworld, o, d, STEPS, device="cpu"))
    assert lane_iters.dtype == torch.int64 and lane_iters.shape == ()


def test_compact_lane_count(mworld, mrays):
    """lane_iters is at most the uncompacted warp-lane cost of the same rays
    (each warp of 32 consecutive rays in source order gated by its worst
    ray, stage-quantized as tests/test_march_compact.py quantizes it), and
    under 0.8 of it on this skewed set."""
    _, tworld = mworld
    o, d = mrays
    _, lane_iters = MC.march_frame_compact(tworld, o, d, STEPS, stride=16, device="cpu")
    ex = _exact(tworld, o, d).steps.numpy().astype(np.int64)
    sp = np.concatenate([ex, np.zeros((-N) % 32, np.int64)]).reshape(-1, 32)
    uncompacted = int((np.ceil(sp.max(axis=1) / 16) * 16 * 32).sum())
    assert int(lane_iters) <= uncompacted, (int(lane_iters), uncompacted)
    assert int(lane_iters) < 0.8 * uncompacted, (int(lane_iters), uncompacted)
    # and never below the lanes the steps themselves fill
    assert int(lane_iters) >= int(ex.sum())


def test_compact_live_start(mworld, mrays):
    jdev, tworld = mworld
    o, d = mrays
    live = (np.arange(N) % 3 != 0).astype(np.int32)
    ref, _ = JMC.march_frame_compact(jdev, o, d, STEPS, tile=TILE, stride=16, live_start=live)
    got, _ = MC.march_frame_compact(tworld, o, d, STEPS, stride=16, live_start=live,
                                    device="cpu")
    _assert_march_equal(got, ref)
    assert not got.hit.numpy()[live == 0].any()


def test_compact_custom_schedule(mworld, mrays):
    jdev, tworld = mworld
    o, d = mrays
    sched = (16, 16, 32, 64, 128)
    ref, _ = JMC.march_frame_compact(jdev, o, d, STEPS, tile=TILE, schedule=sched)
    got, _ = MC.march_frame_compact(tworld, o, d, STEPS, schedule=sched, device="cpu")
    _assert_march_equal(got, ref)


def test_compact_steps_are_coarse_counts(mworld, mrays):
    _, tworld = mworld
    o, d = mrays
    sched = (16,) * 8 + (32,) * 4
    exact = _exact(tworld, o, d).steps.numpy()
    got, _ = MC.march_frame_compact(tworld, o, d, STEPS, schedule=sched, device="cpu")
    coarse = got.steps.numpy()
    assert (coarse >= exact).all()
    assert (coarse <= exact + max(sched)).all()
    assert (coarse > exact).any()


def test_compact_matches_on_assume_resident(mworld, mrays):
    jdev, tworld = mworld
    o, d = mrays
    ref, _ = JMC.march_frame_compact(jdev, o, d, STEPS, tile=TILE, stride=16,
                                     assume_resident=True)
    got, _ = MC.march_frame_compact(tworld, o, d, STEPS, stride=16, assume_resident=True,
                                    device="cpu")
    _assert_march_equal(got, ref)


def test_compact_stages_then_finish(mworld, mrays):
    """compact_begin, compact_stages over a part of the schedule, then
    compact_finish: the rays still live end as misses, as the JAX package's
    compact_finish decodes them, and the result is one march's of the
    iterations run."""
    _, tworld = mworld
    o, d = mrays
    st, n = MC.compact_begin(tworld, o, d, device="cpu")
    assert n == N and int(st.live_count) == int(st.history[0])
    MC.compact_stages(tworld, st, (16, 16))
    got = MC.compact_finish(tworld, st, n)
    _assert_march_equal(got, march(tworld, o, d, 32, device="cpu"))
    assert len(st.history) == 3


def test_partition_is_stable(mworld):
    """K10's plain version: live rays to a dense prefix in their order,
    next-phase rays appended after the rows already there."""
    rng = np.random.default_rng(1)
    m = 300
    flag = torch.from_numpy(rng.integers(0, 3, m).astype(np.uint8))
    src = MC.Rows(torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32)),
                  torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32)),
                  torch.arange(m, dtype=torch.float32), None,
                  torch.arange(m, dtype=torch.int32))
    live_dst, next_dst = MC.Rows.empty(m, "cpu", True), MC.Rows.empty(m, "cpu", False)
    live_in = torch.tensor([250])
    live, nxt = MC.partition(flag, src, live_in, live_dst, next_dst, torch.tensor([7]))
    f = flag.numpy()[:250]
    want_live = np.nonzero(f == 1)[0]
    want_next = np.nonzero(f == 2)[0]
    assert int(live) == len(want_live) and int(nxt) == 7 + len(want_next)
    np.testing.assert_array_equal(live_dst.orig[:int(live)].numpy(), want_live)
    np.testing.assert_array_equal(live_dst.charge[:int(live)].numpy(), want_live)
    np.testing.assert_array_equal(live_dst.t[:int(live)].numpy(), want_live)
    np.testing.assert_array_equal(next_dst.orig[7:int(nxt)].numpy(), want_next)
    np.testing.assert_array_equal(next_dst.o[7:int(nxt)].numpy(), src.o.numpy()[want_next])


# ---- the segment sampler ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sworld():
    return _worlds(SAMPLER_WORLD)


@pytest.fixture(scope="module")
def srays():
    return _sampler_rays(np.random.default_rng(0), 900)


@pytest.mark.parametrize("K,max_steps,schedule", [(6, 256, None), (3, 128, (16, 16, 32, 64))])
def test_compact_sampler_identical_to_jax_and_plain(sworld, srays, K, max_steps, schedule):
    jdev, tworld = sworld
    o, d = srays
    ref, jex = jax_sample_segments_compact(jdev, o, d, max_segments=K, max_steps=max_steps,
                                           tile=1024, stride=16, schedule=schedule)
    got, executed = sample_segments_compact(tworld, o, d, K, max_steps, schedule=schedule,
                                            device="cpu")
    plain = sample_segments(tworld, o, d, K, max_steps, device="cpu")
    for k in ("slot", "count"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    for k in ("t0", "t1"):      # tests/test_torch_diff.py's tolerance against the JAX sampler
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    for k in ("slot", "t0", "t1", "count"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(plain, k).numpy(),
                                      err_msg=k)
    assert len(executed) == K == len(jex)
    ex = [int(v) for v in executed]
    assert ex[0] > 0 and max(ex[1:]) <= ex[0]
    assert int(got.count.max()) >= 2


@pytest.mark.parametrize("K,max_steps,stride,stages", [(1, 512, 16, 20), (32, 512, 16, 26),
                                                       (6, 256, 16, 15), (4, 8, 4, 4)])
def test_merged_schedule_covers_k_phases(K, max_steps, stride, stages):
    """The phase-merged schedule of a given per-phase schedule: its stages,
    then doubling stages up to K phase caps (at K = 1 the per-phase
    schedule itself)."""
    per_phase = MC.default_schedule(max_steps, stride)
    sched, cap = sampler_schedule(max_steps, K, stride, per_phase)
    assert cap == sum(per_phase)
    assert sched[:len(per_phase)] == per_phase
    assert len(sched) == stages and sum(sched) == K * cap
    step, left, tail = max(per_phase), (K - 1) * cap, []
    while left:
        step *= 2
        tail.append(min(step, left))
        left -= tail[-1]
    assert sched[len(per_phase):] == tuple(tail)


@pytest.mark.parametrize("K,max_steps,schedule,want", [
    (32, 512, None, ((512, 1024, 2048, 4096, 8192, 512), 512)),
    (1, 512, None, ((512,), 512)),
    (3, 130, None, ((132, 264), 132)),
    (3, 128, (16, 16, 32, 64), ((16, 16, 32, 64, 128, 128), 128))])
def test_sampler_schedule(K, max_steps, schedule, want):
    """The sampler's stages: without a schedule one phase cap (K4's), then
    doubling stages up to K caps; a given per-phase schedule sets the cap
    and the first stages; a stride the unroll does not divide is refused,
    as default_schedule refuses it."""
    assert sampler_schedule(max_steps, K, 16, schedule) == want
    with pytest.raises(ValueError):
        sampler_schedule(max_steps, K, 6)


def test_compact_sampler_phase_cap_mid_stage(sworld, srays):
    """max_steps 8 with K = 4 and the stages (4, 4, 8, 16) of the per-phase
    schedule (4, 4): from the third stage on a stage is longer than the
    phase cap, so a phase that starts mid-stage reaches its cap of 8
    iterations inside a stage; the segments stay K4's plain version's, bit
    for bit, and differ from an uncapped run's."""
    _, tworld = sworld
    o, d = srays
    assert sampler_schedule(8, 4, 4, (4, 4))[0] == (4, 4, 8, 16)
    got, executed = sample_segments_compact(tworld, o, d, 4, 8, schedule=(4, 4), device="cpu")
    want = sample_segments(tworld, o, d, 4, 8, device="cpu")
    for k in ("slot", "t0", "t1", "count"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    uncapped = sample_segments(tworld, o, d, 4, 512, device="cpu")
    assert not torch.equal(got.count, uncapped.count)
    assert int(got.count.max()) >= 2 and int(executed[0]) > 0


def test_compact_sampler_lanes_per_phase(sworld, srays):
    """The lanes-per-phase rule on a hand-built batch of two warps of
    hitters: a warp's 32 x trip in a stage goes to the phase its first ray
    was in at the stage's start, whatever the phases of its other lanes."""
    _, tworld = sworld
    o, d = srays
    steep = torch.nonzero(torch.from_numpy(d[:, 1] < -0.9)).flatten()[:64]
    o64, d64 = torch.from_numpy(o)[steep], torch.from_numpy(d)[steep]
    K = 30                        # no lane reaches K in a stage of 16 iterations

    def lanes(states, m=64):
        rows, _, flag, live, _ = MC.begin_rows(tworld, o64[:m], d64[:m], None, True)
        L = int(live)
        assert L == m
        rows.charge[:L] = torch.tensor(states[:L], dtype=torch.int32) << USED_BITS
        sink = MC.SegmentSink(torch.full((m, K), -1, dtype=torch.int32),
                              torch.zeros((m, K)), torch.zeros((m, K)),
                              torch.zeros(m, dtype=torch.int32), int(tworld.twig.shape[0]), 8)
        ex = torch.zeros(K, dtype=torch.int64)
        sampler_stage_plain(tworld, rows, flag, live, 16, False, False, ex, sink, 512)
        return [int(v) for v in ex]

    total = lanes([0] * 64)
    first = lanes([0] * 32, m=32)[0]
    mixed = lanes([2] + [0, 1, 3] * 10 + [4] + [0] + [3] * 31)
    assert 0 < first < total[0] and total[0] % 32 == 0 and sum(total) == total[0]
    assert mixed[2] == first and mixed[0] == total[0] - first
    assert sum(mixed) == total[0] and all(v == 0 for k, v in enumerate(mixed) if k not in (0, 2))
    assert lanes([5] * 64)[5] == total[0]


def test_compact_sampler_plain_is_the_public_path(sworld, srays):
    _, tworld = sworld
    o, d = srays
    a, ea = sample_segments_compact(tworld, o, d, 4, 128, device="cpu")
    b, eb = sample_segments_compact_plain(tworld, o, d, 4, 128)
    for k in ("slot", "t0", "t1", "count"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert [int(v) for v in ea] == [int(v) for v in eb]


# ---- frames, the shadow map and the fit -------------------------------------------------

@pytest.fixture(scope="module")
def fscene():
    jdev, tworld = _worlds(FRAME_WORLD)
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                            fov_deg=70.0, width=96, height=54)
    o, d = cam.rays()
    return jdev, tworld, o, d, np.asarray(cam.position, dtype=np.float32)


@pytest.mark.parametrize("shadow", ["none", "ray", "map"])
def test_compact_frame_matches_jax(fscene, shadow):
    jdev, tworld, o, d, eye = fscene
    jcfg = JaxRenderConfig(shadow=shadow, max_steps=128)
    if shadow == "map":     # the JAX package's plain map frame (see the module docstring)
        ref = jax_render_frame(jdev, o, d, eye, cfg=jcfg, tile=8192)
    else:
        ref = jax_render_frame(jdev, o, d, eye, cfg=jcfg, tile=8192, compact=True)
        assert "lane_iters" in ref
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = render_frame(tworld, o, d, eye, cfg=RenderConfig(shadow=shadow, max_steps=128),
                       compact=True, device="cpu")
    plain = render_frame(tworld, o, d, eye, cfg=RenderConfig(shadow=shadow, max_steps=128),
                         device="cpu")
    assert out["lane_iters"].dtype == torch.int64 and int(out["lane_iters"]) > 0
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["material"], ref["material"])
    same = np.isclose(got["rgb"], ref["rgb"], rtol=1e-5, atol=1e-5).all(axis=1)
    assert same.mean() >= AGREE, same.mean()
    for k in ("rgb", "depth", "hit", "material", "point", "normal"):
        np.testing.assert_array_equal(got[k], plain[k].numpy(), err_msg=k)


def test_compact_shadowmap_returns_three_values(fscene):
    jdev, tworld, *_ = fscene
    jdepth, _, jex = jax_render_shadowmap(jdev, JaxLightRig.default(), resolution=(64, 64),
                                          max_steps=128, compact=True, compact_tile=4096)
    depth, vp, lane_iters = render_shadowmap(tworld, LightRig.default(), resolution=(64, 64),
                                             max_steps=128, compact=True)
    plain, vp0 = render_shadowmap(tworld, LightRig.default(), resolution=(64, 64),
                                  max_steps=128)
    assert torch.equal(depth, plain) and torch.equal(vp, vp0)
    assert lane_iters.shape == () and int(lane_iters) > 0 and int(jex) > 0
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-6, atol=1e-6)


def test_fit_with_compact_sampler_identical(sworld, srays):
    """fit(compact=True) samples through the stage-compacted sampler: the
    same segments, so the same loss history (the port's counterpart of
    tests/test_diff_compact.py's fit test)."""
    _, tworld = sworld
    o, d = srays
    target = np.clip(np.random.default_rng(2).uniform(0, 1, (o.shape[0], 3)), 0, 1)
    views = [(o, d, target.astype(np.float32))]
    c0 = sample_views(tworld, views, max_segments=4, max_steps=128, device="cpu")
    c1 = sample_views(tworld, views, max_segments=4, max_steps=128, compact=True, device="cpu")
    for (s0, _), (s1, _) in zip(c0, c1):
        for k in ("slot", "t0", "t1", "count"):
            assert torch.equal(getattr(s0, k), getattr(s1, k)), k
    slots = int(tworld.twig.shape[0]) + 8
    p0 = VoxelParams.from_numpy(np.full(slots, 2.0, np.float32),
                                np.full((slots, 3), 0.5, np.float32), "cpu")
    _, h0 = fit(tworld, views, p0, steps=3, max_segments=4, device="cpu")
    _, h1 = fit(tworld, views, p0, steps=3, max_segments=4, compact=True, device="cpu")
    assert h0 == h1 and all(np.isfinite(h0))


def test_compact_cuda_needs_a_card(mworld, mrays):
    _, tworld = mworld
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py runs the kernels")
    with pytest.raises(RuntimeError, match="is_available"):
        MC.march_frame_compact(tworld, *mrays)

