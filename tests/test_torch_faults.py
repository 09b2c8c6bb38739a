"""The port against the JAX package where the two once differed, and the
plain versions of the fused map-shadow frame, on the CPU.

* The march's ``unroll`` (march_jnp.py:348-366 and :602): the loop bound
  ``unroll * ceil(max_steps / unroll)`` and the budget's stage length
  ``max(unroll, (steps_stride // unroll) * unroll)``, with ``march`` taking
  its arguments in the reference's order.
* ``sample_env(..., bilinear=False)``, the nearest texel.
* The reference's keyword ``dev`` of ``WorldAllocator.modify``,
  ``World.apply`` and ``World.apply_shift`` (``world=`` stays an alias).
* The map-shadow frame, whose light depth now comes out of the march
  (``march_depth``) and whose map projection runs inside the shading
  (``shade_hits(shadowmap=...)``): their plain versions against the JAX
  ``_shadowmap_device``, ``render`` and ``map_shadow``.

Tolerances and why:
* The march: hit, material, texel, cell and steps exact, t at rtol 1e-6
  (as tests/test_torch_diff.py: XLA may fuse a multiply-add that the port
  rounds twice).
* ``sample_env``: the nearest texel exact; bilinear at atol 1e-5 on texel
  values in [0, 1] (atan2 and acos from another libm move u and v by an
  ulp, which the texel coordinate u*W - 0.5 turns into W ulps of a weight).
* Pools after the edits: bit for bit.
* The light depth map: hit masks equal on >= 99.9% of texels and depths at
  rtol 1e-6 where both hit; shadow factors equal on >= 99.9% of pixels; rgb
  within 1e-5 on >= 99.9% of pixels; depth, point and normal at 1e-5 (as
  tests/test_torch_shadow.py: XLA sums vp*[p,1] in its own order, so a
  pixel at the bias threshold may flip).  Between the port's own routes
  (fused or not) everything is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.ops.march_jnp import march as jax_march
from octree_raymarcher_tpu.ops.march_jnp import march_tiled as jax_march_tiled
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.shade.envmap import sample_env as jax_sample_env
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import _shadowmap_device as jax_shadowmap_device
from octree_raymarcher_tpu.shade.render import map_shadow as jax_map_shadow
from octree_raymarcher_tpu.shade.render import render as jax_render
from octree_raymarcher_tpu.shade.render import render_shadowmap as jax_render_shadowmap
from octree_raymarcher_tpu.shade.render import shadow_bundle as jax_shadow_bundle
from octree_raymarcher_tpu.world.edit import build as jax_build
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.ops.march import (
    MARCH_DEPTH_KERNEL,
    MARCH_KERNEL,
    budget_stride,
    loop_bound,
    march,
    march_depth,
    march_plain,
    march_tiled,
)
from octree_raymarcher_tpu_torch.shade import shadow as S
from octree_raymarcher_tpu_torch.shade.envmap import sample_env
from octree_raymarcher_tpu_torch.shade.lights import LightRig
from octree_raymarcher_tpu_torch.shade.materials import MaterialTable
from octree_raymarcher_tpu_torch.shade.render import (
    SHADE_KERNEL,
    SHADE_MAP_KERNEL,
    RenderConfig,
    render,
    render_shadowmap,
    shade_hits,
    shade_hits_plain,
)
from octree_raymarcher_tpu_torch.world.edit import build
from octree_raymarcher_tpu_torch.world.world import World

from test_torch_diff import dworld, grazing  # noqa: F401  (module fixtures)
from test_torch_edit import assert_pools_equal

SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)
AGREE = 0.999
MARCH_FIELDS = ("hit", "material", "texel", "cell_bmin", "cell_size")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_march_equal(got, ref, steps: bool):
    for k in MARCH_FIELDS + (("steps",) if steps else ()):
        np.testing.assert_array_equal(_np(getattr(got, k)), _np(getattr(ref, k)), err_msg=k)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), rtol=1e-6)


# ---- the march's unroll ------------------------------------------------------------

@pytest.mark.parametrize("max_steps", [5, 10])
@pytest.mark.parametrize("unroll", [1, 8])
def test_march_unroll_matches_jax(dworld, grazing, unroll, max_steps):
    """max_steps not a multiple of the unroll: the bound is the reference's
    unroll * ceil(max_steps / unroll), through march_tiled and through a
    positional march call in the reference's order (max_steps, unroll,
    steps_aov)."""
    jw, tw = dworld
    o, d = grazing
    ref = jax_march_tiled(jw, o, d, max_steps, tile=8192, unroll=unroll)
    got = march_tiled(tw, o, d, max_steps, tile=8192, unroll=unroll, device="cpu")
    _assert_march_equal(got, ref, steps=False)
    ref = jax_march(jw, o, d, max_steps, unroll, True)
    got = march(tw, o, d, max_steps, unroll, True, device="cpu")
    _assert_march_equal(got, ref, steps=True)
    assert loop_bound(max_steps, unroll) == unroll * -(-max_steps // unroll)
    if loop_bound(max_steps, unroll) != loop_bound(max_steps):
        # the unroll decides the outcome of some ray on these grazing views
        four = march(tw, o, d, max_steps, device="cpu")
        assert (_np(four.hit) != _np(got.hit)).any() or (_np(four.t) != _np(got.t)).any()


@pytest.mark.parametrize("unroll", [1, 8])
def test_budgeted_march_unroll_matches_jax(dworld, grazing, unroll):
    """A budget whose steps_stride (13) is not a multiple of the unroll: the
    stage length is max(unroll, (13 // unroll) * unroll)."""
    jw, tw = dworld
    o, d = grazing
    budget = np.random.default_rng(unroll).integers(0, 60, len(o)).astype(np.int32)
    kw = dict(max_steps=30, unroll=unroll, step_budget=budget, steps_stride=13)
    ref = jax_march(jw, o, d, **kw)
    got = march(tw, o, d, device="cpu", **kw)
    _assert_march_equal(got, ref, steps=True)
    stride = budget_stride(13, unroll)
    assert stride == {1: 13, 8: 8}[unroll]
    steps = _np(got.steps)
    assert (steps % stride == 0).all() and steps.max() > 0


# ---- sample_env's nearest texel --------------------------------------------------------

@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_env_matches_jax(bilinear):
    """The inputs of tests/test_shade_assets.py's equirect test (zenith and
    nadir rows, the +x texel) and seeded random directions."""
    H, W = 8, 16
    env = np.zeros((H, W, 3), dtype=np.float32)
    env[0, :] = (1, 0, 0)
    env[-1, :] = (0, 1, 0)
    env[H // 2, W // 2] = (0, 0, 1)
    rng = np.random.default_rng(3)
    cardinal = np.asarray([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    dirs = np.concatenate([cardinal, rng.normal(size=(500, 3)).astype(np.float32)])
    for e in (env, rng.uniform(0, 1, (H, W, 3)).astype(np.float32)):
        ref = np.asarray(jax_sample_env(e, dirs, bilinear=bilinear))
        got = sample_env(e, dirs, bilinear=bilinear).numpy()
        if bilinear:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, ref)
    if not bilinear:
        np.testing.assert_array_equal(sample_env(env, cardinal, bilinear=False).numpy(),
                                      [[1, 0, 0], [0, 1, 0], [0, 0, 1]])


# ---- the dev keyword --------------------------------------------------------------------

@pytest.mark.parametrize("keyword", ["dev", "world"])
def test_dev_keyword_matches_jax(keyword):
    """modify, apply and apply_shift by keyword: the reference's ``dev`` and
    the alias ``world`` give the JAX package's pools."""
    jw, tw = JaxWorld.generate(**SCENE), World.generate(**SCENE)
    jwa, jdev = jw.to_device()
    twa, tdev = tw.to_device(device="cpu")

    jdev = jw.apply(jwa, dev=jdev, edits=jw.destroy((10, 8, 10), (30, 20, 30)))
    tdev = tw.apply(twa, edits=tw.destroy((10, 8, 10), (30, 20, 30)), **{keyword: tdev})
    assert_pools_equal(jdev, tdev)

    jd = jax_build(jw.chunks[1], (2.0, 2.0, 2.0), (9.0, 20.0, 9.0), 3)
    td = build(tw.chunks[1], (2.0, 2.0, 2.0), (9.0, 20.0, 9.0), 3)
    jdev = jwa.modify(dev=jdev, key=1, chunk=jw.chunks[1], dtree=jd[0], dtwig=jd[1])
    tdev = twa.modify(key=1, chunk=tw.chunks[1], dtree=td[0], dtwig=td[1], **{keyword: tdev})
    assert_pools_equal(jdev, tdev)

    jt, tt = jw.shift(2, +1), tw.shift(2, +1)
    jdev = jw.apply_shift(jwa, dev=jdev, touched=jt)
    tdev = tw.apply_shift(twa, touched=tt, **{keyword: tdev})
    assert_pools_equal(jdev, tdev)

    # the reference's signatures: the world once, and no argument left out
    with pytest.raises(TypeError, match="dev"):
        tw.apply(twa, tdev, [], world=tdev)
    with pytest.raises(TypeError, match="dev"):
        twa.modify(key=0, chunk=tw.chunks[0], dtree=td[0], dtwig=td[1])
    with pytest.raises(TypeError, match="edits"):
        tw.apply(twa, **{keyword: tdev})
    with pytest.raises(TypeError, match="touched"):
        tw.apply_shift(twa, **{keyword: tdev})
    with pytest.raises(TypeError, match="dtwig"):
        twa.modify(tdev, 0, tw.chunks[0], td[0])


# ---- the map-shadow frame's plain versions ---------------------------------------------

@pytest.fixture(scope="module")
def map_scene():
    jw = JaxWorld.generate(**SCENE)
    _, jdev = jw.to_device()
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                            fov_deg=70.0, width=64, height=36)
    o, d = cam.rays()
    eye = np.asarray(cam.position, dtype=np.float32)
    return jdev, World.generate(**SCENE).to_torch("cpu"), o, d, eye


LIGHT = np.asarray([0.3, -1.0, -0.2], np.float32)   # a second sun, not the default's


def _rig() -> LightRig:
    rig = LightRig.default()
    rig.directional.direction = LIGHT.copy()
    return rig


@pytest.fixture(scope="module")
def jax_map_frames(map_scene):
    """The JAX map-shadowed frames under the second sun: with a 256x200 map
    of it given ("given", with that map), and with the map its render makes
    ("own")."""
    jdev, _, o, d, eye = map_scene
    rig = JaxLightRig.default()
    rig = rig.replace(directional=rig.directional.replace(direction=LIGHT.copy()))
    smap = jax_render_shadowmap(jdev, rig, resolution=(256, 200), max_steps=512)
    args = (jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(eye), rig)
    cfg = JaxRenderConfig(shadow="map")
    frames = {"given": jax_render(*args, cfg=cfg, shadowmap=smap),
              "own": jax_render(*args, cfg=cfg)}
    return (tuple(np.asarray(x) for x in smap),
            {name: {k: np.asarray(v) for k, v in f.items()} for name, f in frames.items()})


def test_light_depth_march_matches_jax_shadowmap_device(map_scene):
    """render_shadowmap (the light-depth march) against the JAX package's
    _shadowmap_device on a non-square bundle; the light-depth march equals
    shadow_resolve of march_plain bit for bit."""
    jdev, tworld, *_ = map_scene
    H, W = 48, 40
    ldir = LIGHT.astype(np.float64)
    origins_rel, dirs, pv_rel, extent_half = jax_shadow_bundle(ldir, H, W, (2, 1, 2), 32.0, 1.1)
    ref_depth, ref_vp = (np.asarray(x) for x in jax_shadowmap_device(
        jdev, jnp.asarray(origins_rel), jnp.asarray(dirs), jnp.asarray(pv_rel),
        jnp.asarray(extent_half), H, W, H * W, 512))
    rig = _rig()
    before = (MARCH_KERNEL.launches, MARCH_DEPTH_KERNEL.launches,
              S.SHADOW_RESOLVE_KERNEL.launches)
    depth, vp = render_shadowmap(tworld, rig, resolution=(H, W), max_steps=512)
    depth = depth.numpy()
    np.testing.assert_allclose(vp.numpy(), ref_vp, rtol=1e-6, atol=1e-6)
    hit_ref, hit_got = ref_depth != 1.0, depth != 1.0
    assert (hit_ref == hit_got).mean() >= AGREE
    both = hit_ref & hit_got
    assert both.mean() > 0.3
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-6, atol=0)

    origins, bdirs, vp_np = S._bundle(tworld, rig, H, W, 1.1)
    res = march_plain(tworld, origins, bdirs, 512)
    composed = S.shadow_resolve_plain(origins, bdirs, res.hit, res.t, vp_np)
    fused = march_depth(tworld, origins, bdirs, vp_np[2], 512, device="cpu")
    np.testing.assert_array_equal(fused.numpy(), composed.numpy())
    np.testing.assert_array_equal(depth.reshape(-1), composed.numpy())
    assert (MARCH_KERNEL.launches, MARCH_DEPTH_KERNEL.launches,
            S.SHADOW_RESOLVE_KERNEL.launches) == before


@pytest.mark.parametrize("shadowmap", ["given", "own"])
def test_map_frame_matches_jax(map_scene, jax_map_frames, shadowmap):
    """render(shadow="map") with the JAX frame's map given, and with the map
    its own light pass makes, against the JAX render."""
    _, tworld, o, d, eye = map_scene
    smap, frames = jax_map_frames
    ref = frames[shadowmap]
    rig = _rig()
    given = smap if shadowmap == "given" else None
    got = render(tworld, o, d, eye, rig, cfg=RenderConfig(shadow="map"), shadowmap=given,
                 device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["material"], ref["material"])
    same = np.isclose(got["rgb"], ref["rgb"], rtol=1e-5, atol=1e-5).all(axis=1)
    assert same.mean() >= AGREE, same.mean()
    for k in ("depth", "point", "normal"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the map shadows some of the frame: it is honoured
    lit = render(tworld, o, d, eye, rig, cfg=RenderConfig(shadow="none"), device="cpu")
    assert (got["rgb"] < lit["rgb"].numpy() - 1e-4).any()


def test_map_shading_matches_jax_map_shadow(map_scene, jax_map_frames):
    """shade_hits with the depth map (the plain version of the map-shadowed
    K2) equals shade_hits fed map_project_plain's factor bit for bit, and
    that factor agrees with the JAX map_shadow times the hit mask."""
    _, tworld, o, d, eye = map_scene
    (depth, vp), _ = jax_map_frames
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    res = march(tworld, ot, dt, 512, device="cpu")
    lights, mats, cfg = _rig(), MaterialTable.default(), RenderConfig(shadow="map")
    before = (SHADE_KERNEL.launches, SHADE_MAP_KERNEL.launches,
              S.MAP_PROJECT_KERNEL.launches)
    factor = S.map_project_plain(res, ot, dt, torch.from_numpy(depth), vp, cfg.shadow_bias)
    fused = shade_hits(res, ot, dt, eye, lights, mats, cfg, shadowmap=(depth, vp))
    split = shade_hits_plain(res, ot, dt, torch.from_numpy(eye), lights, mats, cfg,
                             shadow_factor=factor)
    for k in fused:
        np.testing.assert_array_equal(fused[k].numpy(), split[k].numpy(), err_msg=k)
    assert (SHADE_KERNEL.launches, SHADE_MAP_KERNEL.launches,
            S.MAP_PROJECT_KERNEL.launches) == before
    p = split["point"].numpy()
    ref = np.asarray(jax_map_shadow(jnp.asarray(p), depth, vp, cfg.shadow_bias))
    ref = ref * res.hit.numpy()
    assert (factor.numpy() == ref).mean() >= AGREE
    assert ref.sum() >= 10
    with pytest.raises(ValueError, match="not both"):
        shade_hits(res, ot, dt, eye, lights, mats, cfg, shadow_factor=factor,
                   shadowmap=(depth, vp))
