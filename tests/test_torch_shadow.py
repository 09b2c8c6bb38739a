"""The port's shadows (plain PyTorch versions of K1 and K3) against the JAX
reference's, per pixel and through the goldens.

Tolerances and why:
* ``shadow_bundle`` is host numpy in both packages: bit for bit.
* The light depth map: allclose at rtol 1e-6 where both light rays hit
  (XLA sums vp*[p,1] in its own order and may fuse the multiply-adds; the
  port fixes one order and rounds each product), and the hit masks equal on
  >= 99.9% of texels.
* Shadow factors (map and ray) equal on >= 99.9% of pixels: a pixel at the
  bias threshold or a shadow ray that grazes a cell boundary may flip on an
  ulp of the start point or of the projected depth.
* rgb allclose at rtol/atol 1e-5 on pixels whose shadow factor agrees (as
  tests/test_torch_render.py), and the goldens at their 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.ops.march_jnp import march as jax_march
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import map_shadow as jax_map_shadow
from octree_raymarcher_tpu.shade.render import ray_shadow as jax_ray_shadow
from octree_raymarcher_tpu.shade.render import render as jax_render
from octree_raymarcher_tpu.shade.render import render_shadowmap as jax_render_shadowmap
from octree_raymarcher_tpu.shade.render import shadow_bundle as jax_shadow_bundle
from octree_raymarcher_tpu.core.geometry import cube_normal as jax_cube_normal
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.ops.march import MARCH_KERNEL, march
from octree_raymarcher_tpu_torch.shade import shadow as S
from octree_raymarcher_tpu_torch.shade.lights import LightRig
from octree_raymarcher_tpu_torch.shade.render import (
    RenderConfig,
    map_shadow,
    ray_shadow,
    render,
    render_frame,
    render_shadowmap,
    shadow_bundle,
)
from octree_raymarcher_tpu_torch.world.world import World

from test_golden import _check, _thumb

SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)
AGREE = 0.999


@pytest.fixture(scope="module")
def scene():
    jw = JaxWorld.generate(**SCENE)
    _, jdev = jw.to_device()
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0,
                            pitch_deg=-20.0, fov_deg=70.0, width=96, height=54)
    o, d = cam.rays()
    eye = np.asarray(cam.position, dtype=np.float32)
    return jdev, World.generate(**SCENE).to_torch("cpu"), cam, o, d, eye


@pytest.fixture(scope="module")
def jax_shadowmap(scene):
    jdev = scene[0]
    return jax_render_shadowmap(jdev, JaxLightRig.default(), resolution=(64, 64),
                                max_steps=512)


@pytest.fixture(scope="module")
def jax_frames(scene):
    jdev, _, _, o, d, eye = scene
    return {s: jax_render(jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(eye),
                          cfg=JaxRenderConfig(shadow=s)) for s in ("ray", "map")}


@pytest.mark.parametrize("light", [(1.0, -1.0, 0.0), (0.3, -1.0, -0.2), (0.0, -1.0, 0.01)])
def test_shadow_bundle_bit_exact(light):
    for res in ((64, 64), (32, 48)):
        ref = jax_shadow_bundle(np.asarray(light), *res, (2, 1, 2), 32.0, 1.1)
        got = shadow_bundle(np.asarray(light), *res, (2, 1, 2), 32.0, 1.1)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_shadowmap_matches_jax(scene, jax_shadowmap):
    _, tworld, *_ = scene
    ref_depth, ref_vp = (np.asarray(x) for x in jax_shadowmap)
    depth, vp = render_shadowmap(tworld, LightRig.default(), resolution=(64, 64),
                                 max_steps=512)
    depth = depth.numpy()
    np.testing.assert_allclose(vp.numpy(), ref_vp, rtol=1e-6, atol=1e-6)
    hit_ref, hit_got = ref_depth != 1.0, depth != 1.0
    print(f"light-depth hit mask disagreement {(hit_ref != hit_got).mean():.6f} "
          f"of {hit_ref.size} texels")
    assert (hit_ref == hit_got).mean() >= AGREE
    both = hit_ref & hit_got
    assert both.mean() > 0.3
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-6, atol=0)


def test_shadowmap_cache_and_ignored_options(scene):
    """The host bundle cache keys on the light direction and resolution;
    tile/compact_tile options change nothing, and the compacted light pass
    gives the same map (and its lane count)."""
    _, tworld, *_ = scene
    S._shadow_bundle_cache.clear()
    rig = LightRig.default()
    d1, _ = render_shadowmap(tworld, rig, resolution=(32, 32))
    n1 = len(S._shadow_bundle_cache)
    d1b, _, lane_iters = render_shadowmap(tworld, rig, resolution=(32, 32), tile=100,
                                          compact=True, compact_tile=64)
    assert int(lane_iters) > 0
    assert len(S._shadow_bundle_cache) == n1 == 1
    np.testing.assert_array_equal(d1.numpy(), d1b.numpy())
    rig2 = LightRig.default()
    rig2.directional.direction = np.asarray([0.3, -1.0, -0.2], np.float32)
    d2, _ = render_shadowmap(tworld, rig2, resolution=(32, 32))
    assert len(S._shadow_bundle_cache) == 2
    assert not np.allclose(d1.numpy(), d2.numpy())


def test_map_shadow_matches_jax(scene, jax_shadowmap):
    jdev, tworld, _, o, d, _ = scene
    res = jax_march(jdev, o, d, max_steps=512)
    t_hit = np.where(np.asarray(res.hit), np.asarray(res.t), 0.0).astype(np.float32)
    p = (o + d * (t_hit - np.float32(1.0 / 4096))[:, None]).astype(np.float32)
    depth, vp = jax_shadowmap
    ref = np.asarray(jax_map_shadow(jnp.asarray(p), depth, vp, 4.0))
    got = map_shadow(p, np.array(depth), np.array(vp), 4.0, device="cpu").numpy()
    print(f"map-shadow factor flips {(got != ref).mean():.6f} of {len(ref)} pixels")
    assert (got == ref).mean() >= AGREE
    assert ref.sum() >= 10


def test_map_shadow_runs_where_asked(jax_shadowmap):
    """The caller's ``device`` decides where map_shadow runs, not its
    inputs: host arrays give the plain version only with device="cpu", and
    the default asks for the card."""
    depth, vp = (np.array(x) for x in jax_shadowmap)
    p = np.random.default_rng(0).uniform(-8.0, 72.0, (500, 3)).astype(np.float32)
    before = S.MAP_PROJECT_KERNEL.launches
    got = map_shadow(p, depth, vp, device="cpu")
    assert got.device.type == "cpu" and got.shape == (500,)
    want = S.map_shadow_plain(torch.from_numpy(p), torch.from_numpy(depth), vp)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert S.MAP_PROJECT_KERNEL.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            map_shadow(p, depth, vp)


def test_ray_shadow_matches_jax(scene):
    jdev, tworld, _, o, d, _ = scene
    res = jax_march(jdev, o, d, max_steps=512)
    t_hit = np.where(np.asarray(res.hit), np.asarray(res.t), 0.0).astype(np.float32)
    p = jnp.asarray(o) + jnp.asarray(d) * (jnp.asarray(t_hit) - np.float32(1.0 / 4096))[:, None]
    n = jax_cube_normal(p, res.cell_bmin, res.cell_bmin + res.cell_size[:, None])
    cfg = JaxRenderConfig(shadow="ray")
    ref = np.asarray(jax_ray_shadow(jdev, res, p, n, JaxLightRig.default(), cfg))
    tres = march(tworld, o, d, max_steps=512, device="cpu")
    got = ray_shadow(tworld, tres, np.array(p), np.array(n), LightRig.default(),
                     RenderConfig(shadow="ray")).numpy()
    print(f"ray-shadow factor flips {(got != ref).mean():.6f} of {len(ref)} pixels")
    assert (got == ref).mean() >= AGREE
    assert 0.05 < ref.mean() < 0.95


@pytest.mark.parametrize("shadow", ["ray", "map"])
def test_shadowed_render_matches_jax_and_golden(scene, jax_frames, shadow):
    _, tworld, cam, o, d, eye = scene
    ref = {k: np.asarray(v) for k, v in jax_frames[shadow].items()}
    got = {k: v.numpy() for k, v in
           render(tworld, o, d, eye, cfg=RenderConfig(shadow=shadow), device="cpu").items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["material"], ref["material"])
    # a pixel whose shadow factor flipped differs by the light's diffuse term
    same = np.isclose(got["rgb"], ref["rgb"], rtol=1e-5, atol=1e-5).all(axis=1)
    print(f"{shadow} frame: rgb beyond 1e-5 on {1.0 - same.mean():.6f} of {len(same)} pixels")
    assert same.mean() >= AGREE, same.mean()
    for k in ("depth", "point", "normal"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    golden = {"ray": "rayshadow_2x1x2_d5", "map": "mapshadow_2x1x2_d5"}[shadow]
    frame = render_frame(tworld, o, d, eye, cfg=RenderConfig(shadow=shadow), tile=1000,
                         compact=True, device="cpu")
    np.testing.assert_array_equal(frame["rgb"].numpy(), got["rgb"])
    _check(golden, _thumb(frame["rgb"].numpy(), cam.height, cam.width))


def test_render_with_precomputed_shadowmap(scene):
    _, tworld, _, o, d, eye = scene
    cfg = RenderConfig(shadow="map")
    inner = render(tworld, o, d, eye, cfg=cfg, device="cpu")
    smap = render_shadowmap(tworld, LightRig.default(), max_steps=cfg.max_steps)
    outer = render(tworld, o, d, eye, cfg=cfg, shadowmap=smap, device="cpu")
    for k in inner:
        np.testing.assert_array_equal(inner[k].numpy(), outer[k].numpy(), err_msg=k)
    # a map from another light changes the frame: the argument is honoured
    rig = LightRig.default()
    rig.directional.direction = np.asarray([-0.5, -1.0, 0.4], np.float32)
    other = render(tworld, o, d, eye, cfg=cfg, shadowmap=render_shadowmap(tworld, rig),
                   device="cpu")
    assert not np.array_equal(other["rgb"].numpy(), inner["rgb"].numpy())


def test_plain_versions_launch_nothing(scene):
    """The K3 plain versions are what CPU tensors run; the CPU path counts no
    launch of any kernel."""
    _, tworld, _, o, d, eye = scene
    before = (MARCH_KERNEL.launches, S.RAY_PREP_KERNEL.launches,
              S.SHADOW_RESOLVE_KERNEL.launches, S.MAP_PROJECT_KERNEL.launches)
    res = march(tworld, o, d, max_steps=512, device="cpu")
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    ldir = S.light_dir(LightRig.default())
    a = S.ray_prep(res, ot, dt, ldir)
    b = S.ray_prep_plain(res, ot, dt, ldir)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(a[2], res.hit.to(torch.int32))
    np.testing.assert_allclose(np.linalg.norm(ldir), 1.0, rtol=1e-6)
    after = (MARCH_KERNEL.launches, S.RAY_PREP_KERNEL.launches,
             S.SHADOW_RESOLVE_KERNEL.launches, S.MAP_PROJECT_KERNEL.launches)
    assert after == before
