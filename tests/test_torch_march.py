"""The port's march (plain PyTorch version of kernel K1) against the JAX
reference march with the exact steps AOV.

hit, material, texel, cell and steps must be exact and t within rtol 1e-6
(XLA may fuse a multiply-add that eager PyTorch rounds twice, so t can
drift by a few ulps over a ray's steps).  Any ray that disagrees must be
boundary-grazing under the rule of tests/test_march_parity.py: nudging its
origin by <= 4*EPS must make the scalar oracle give the port's answer.  At
most 2% of rays may be grazing."""

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.core.constants import EPS
from octree_raymarcher_tpu.march import cpu_ref
from octree_raymarcher_tpu.ops.march_jnp import march as jax_march
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.world.device import pack_chunks as jax_pack_chunks
from octree_raymarcher_tpu.world.device import single_chunk_world
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu.worldgen import BoundsPyramid as JaxBoundsPyramid
from octree_raymarcher_tpu.worldgen import grow as jax_grow
from octree_raymarcher_tpu_torch.ops.march import MARCH_KERNEL, march, march_plain
from octree_raymarcher_tpu_torch.world.device import TorchWorld, pack_chunks
from octree_raymarcher_tpu_torch.world.world import World
from octree_raymarcher_tpu_torch.worldgen import BoundsPyramid, grow

PERTURB = 4 * EPS   # boundary-grazing classification radius
FIELDS = ("hit", "material", "texel", "cell_bmin", "cell_size", "steps")
SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)


# -- the classification rule of tests/test_march_parity.py:58-117 ----------
def _agrees(h, hit, t, mat, rtol=2e-3, atol=2e-3):
    if h.hit != hit:
        return False
    if not h.hit:
        return True
    return np.isclose(h.t, t, rtol=rtol, atol=atol) and h.material == int(mat)


def _perturbations(d):
    """Origin nudges perpendicular to (and along) the ray direction."""
    d = np.asarray(d, dtype=np.float64)
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(d, a)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(d, u)
    return [vec * PERTURB for vec in (u, -u, v, -v, d, -d)]


def _grazing(oracle_world, origin, direction, hit, t, mat):
    """True when some <= PERTURB origin nudge makes the scalar oracle give
    (hit, t, mat): the ray is EPS-sensitive there."""
    return any(
        _agrees(cpu_ref.chunkmarch(oracle_world, np.asarray(origin, np.float64) + dp,
                                   direction),
                hit, t, mat, rtol=5e-3, atol=5e-2)
        for dp in _perturbations(direction)
    )


class _OneChunk:
    """The scalar oracle's world protocol over one chunk at the origin."""

    def __init__(self, chunk):
        self.chunk = chunk
        self.chunksize = chunk.size
        self.dims = (1, 1, 1)
        self.chunkcoordmin = np.zeros(3, dtype=int)

    def chunk_at(self, x, y, z):
        return self.chunk


def _assert_parity(jax_world, torch_world, oracle_world, o, d, max_frac=0.02, **kw):
    ref = jax_march(jax_world, o, d, steps_aov=True, **kw)
    got = march(torch_world, o, d, steps_aov=True, device="cpu", **kw)
    ref = {k: np.asarray(getattr(ref, k)) for k in FIELDS + ("t",)}
    got = {k: getattr(got, k).numpy() for k in FIELDS + ("t",)}
    ok = np.ones(len(o), dtype=bool)
    for k in FIELDS:
        eq = ref[k] == got[k]
        ok &= eq.reshape(len(o), -1).all(axis=1)
    both = np.isfinite(ref["t"]) & np.isfinite(got["t"])
    ok &= np.where(both, np.isclose(got["t"], ref["t"], rtol=1e-6, atol=0),
                   np.isinf(ref["t"]) & np.isinf(got["t"]))
    bad = np.nonzero(~ok)[0]
    unexplained = [int(i) for i in bad if not _grazing(
        oracle_world, o[i], d[i], bool(got["hit"][i]), got["t"][i], got["material"][i])]
    assert not unexplained, (
        f"{len(unexplained)}/{len(o)} rays differ from the JAX march and are not "
        f"boundary-grazing; first: ray {unexplained[0]}, o={o[unexplained[0]]}, "
        f"d={d[unexplained[0]]}")
    assert len(bad) <= max(2, int(len(o) * max_frac)), f"{len(bad)} grazing rays"
    return ref, got


@pytest.fixture(scope="module")
def scene():
    jw = JaxWorld.generate(**SCENE)
    tw = World.generate(**SCENE)
    return jw, jax_pack_chunks(jw.chunks, jw.dims), tw.to_torch("cpu")


def _random_rays(rng, n, lo, hi):
    o = np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n),
                  rng.uniform(lo[2], hi[2], n)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_camera_rays_parity(scene):
    jw, jdev, tworld = scene
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0,
                            pitch_deg=-20.0, fov_deg=70.0, width=96, height=54)
    o, d = cam.rays()
    ref, got = _assert_parity(jdev, tworld, jw, o, d, max_steps=512)
    assert ref["hit"].mean() > 0.3 and got["steps"].sum() > 0


@pytest.mark.parametrize("seed", [11, 23])
def test_fuzz_parity(rng, seed):
    """Random single-chunk worlds x random rays (test_march_parity.py's
    three-way fuzz, with the port as the third leg)."""
    kw = dict(size=32, amplitude=10.0, period=1.0 / 32, xshift=3.0, yshift=8.0,
              zshift=-2.0, seed=seed)
    jchunk = jax_grow([0.0, 0.0, 0.0], 32.0, depth=5, pyr=JaxBoundsPyramid.generate(**kw))
    tchunk = grow([0.0, 0.0, 0.0], 32.0, depth=5, pyr=BoundsPyramid.generate(**kw))
    tworld = TorchWorld.from_numpy(pack_chunks([tchunk], (1, 1, 1)), device="cpu")
    o, d = _random_rays(rng, 160, (-8, 2, -8), (40, 30, 40))
    _assert_parity(single_chunk_world(jchunk), tworld, _OneChunk(jchunk), o, d)


def test_resume_parity(scene, rng):
    """t_start/live_start resume: the entry test is skipped, ray i starts at
    max(t_start[i], 0) and dead rays report a miss at no cost."""
    jw, jdev, tworld = scene
    o, d = _random_rays(rng, 300, (-10, 5, -10), (74, 60, 74))
    t_start = rng.uniform(-2.0, 30.0, len(o)).astype(np.float32)
    live = (rng.uniform(size=len(o)) < 0.7).astype(np.int32)
    ref = jax_march(jdev, o, d, steps_aov=True, t_start=t_start, live_start=live)
    got = march(tworld, o, d, steps_aov=True, t_start=t_start, live_start=live,
                device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-6)
    assert not got.hit.numpy()[live == 0].any()
    assert (got.steps.numpy()[live == 0] == 0).all()
    # live_start on the entry path too
    ref = jax_march(jdev, o, d, steps_aov=True, live_start=live)
    got = march(tworld, o, d, steps_aov=True, live_start=live, device="cpu")
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))


@pytest.mark.parametrize("max_steps", [5, 7])
def test_odd_step_cap(scene, max_steps):
    """The reference loop runs in unrolls of 4, so the cap is
    4*ceil(max_steps/4); rays live at the cap are misses."""
    jw, jdev, tworld = scene
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), pitch_deg=-20.0,
                            fov_deg=70.0, width=40, height=24)
    o, d = cam.rays()
    ref, got = _assert_parity(jdev, tworld, jw, o, d, max_steps=max_steps)
    assert got["steps"].max() == 4 * ((max_steps + 3) // 4)


def test_steps_aov_off_and_resident(scene, rng):
    """steps_aov=False returns zeros; assume_resident gives the same march
    on a static world; the CPU path never launches the kernel."""
    _, _, tworld = scene
    o, d = _random_rays(rng, 200, (-10, 5, -10), (74, 60, 74))
    before = MARCH_KERNEL.launches
    a = march(tworld, o, d, max_steps=64, steps_aov=True, device="cpu")
    b = march(tworld, o, d, max_steps=64, assume_resident=True, device="cpu")
    assert (b.steps.numpy() == 0).all()
    for k in ("hit", "t", "material", "texel", "cell_bmin"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), getattr(b, k).numpy())
    c = march_plain(tworld, torch.as_tensor(o), torch.as_tensor(d), 64, True)
    np.testing.assert_array_equal(a.steps.numpy(), c.steps.numpy())
    assert MARCH_KERNEL.launches == before
