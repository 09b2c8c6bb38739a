"""The port's shaded frame (plain PyTorch versions of kernels K1 + K2)
against the JAX reference render, per pixel and through the goldens.

rgb and depth are allclose at rtol 1e-5 / atol 1e-5: both sides run the same
float32 formulas, but XLA may contract multiply-adds that eager PyTorch
rounds twice, and the march's t may differ by a few ulps (test_torch_march);
grass shininess 1000 magnifies an ulp of the specular base ~1000x in
relative terms.  hit and material are exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.ops.march_jnp import march as jax_march
from octree_raymarcher_tpu.shade import default_atlas as jax_default_atlas
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.shade.envmap import default_envmap as jax_default_envmap
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.materials import MaterialTable as JaxMaterialTable
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import render as jax_render
from octree_raymarcher_tpu.shade.render import shade_hits as jax_shade_hits
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.ops.march import MarchResult
from octree_raymarcher_tpu_torch.shade import default_atlas, default_envmap
from octree_raymarcher_tpu_torch.shade.lights import LightRig
from octree_raymarcher_tpu_torch.shade.materials import MaterialTable
from octree_raymarcher_tpu_torch.shade.render import (
    SHADE_KERNEL,
    RenderConfig,
    render,
    render_frame,
    shade_hits,
)
from octree_raymarcher_tpu_torch.world.world import World

from test_golden import _check, _thumb

SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    jw = JaxWorld.generate(**SCENE)
    _, jdev = jw.to_device()
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0,
                            pitch_deg=-20.0, fov_deg=70.0, width=96, height=54)
    o, d = cam.rays()
    eye = np.asarray(cam.position, dtype=np.float32)
    return jdev, World.generate(**SCENE).to_torch("cpu"), cam, o, d, eye


def _assert_aovs_close(got, ref):
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(got["material"].numpy(), np.asarray(ref["material"]))
    for k in ("rgb", "depth", "point", "normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured_env"])
def test_render_matches_jax_and_golden(scene, textured):
    jdev, tworld, cam, o, d, eye = scene
    jkw, tkw = {}, {}
    if textured:
        jkw = dict(atlas=jnp.asarray(jax_default_atlas(resolution=16, seed=0)),
                   envmap=jnp.asarray(jax_default_envmap(32, 64)))
        tkw = dict(atlas=default_atlas(resolution=16, seed=0),
                   envmap=default_envmap(32, 64))
        np.testing.assert_array_equal(tkw["atlas"], np.asarray(jkw["atlas"]))
        np.testing.assert_array_equal(tkw["envmap"], np.asarray(jkw["envmap"]))
    ref = jax_render(jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(eye),
                     cfg=JaxRenderConfig(shadow="none"), **jkw)
    got = render(tworld, o, d, eye, cfg=RenderConfig(shadow="none"), device="cpu", **tkw)
    _assert_aovs_close(got, ref)
    golden = "textured_env_2x1x2_d5" if textured else "plain_2x1x2_d5"
    _check(golden, _thumb(got["rgb"].numpy(), cam.height, cam.width))


def test_shade_hits_custom_tables(scene, rng):
    """shade_hits alone, on the JAX march's result, with a rig and a
    material table other than the defaults carried across by from_numpy;
    material ids beyond the table are clipped as the reference clips them."""
    jdev, _, _, o, d, eye = scene
    res = jax_march(jdev, o, d, max_steps=512)
    mat = np.where(np.asarray(res.hit), rng.integers(0, 11, len(o)), 0).astype(np.int32)
    res = res.replace(material=jnp.asarray(mat))
    jrig = JaxLightRig.default()
    jrig = jrig.replace(point=jrig.point.replace(position=np.float32([30.0, 40.0, 10.0]),
                                                 linear=0.05),
                        spot=jrig.spot.replace(cos_gamma=np.float32(0.7)))
    jmat = JaxMaterialTable.default()
    jmat = jmat.replace(shininess=jmat.shininess.at[4].set(64.0))
    cfg_j = JaxRenderConfig(sky=(0.1, 0.2, 0.3))
    shadow = (rng.uniform(size=len(o)) < 0.3).astype(np.float32)
    ref = jax_shade_hits(res, o, d, jnp.asarray(eye), jrig, jmat, cfg_j,
                         shadow_factor=jnp.asarray(shadow))
    tres = MarchResult(**{f.name: torch.from_numpy(np.array(getattr(res, f.name)))
                          for f in dataclasses.fields(MarchResult)})
    got = shade_hits(tres, o, d, eye, LightRig.from_numpy(jrig),
                     MaterialTable.from_numpy(jmat), RenderConfig(sky=(0.1, 0.2, 0.3)),
                     shadow_factor=torch.as_tensor(shadow))
    _assert_aovs_close(got, ref)


def test_render_frame_is_render_and_counts_no_launch(scene):
    _, tworld, _, o, d, eye = scene
    before = SHADE_KERNEL.launches
    a = render(tworld, o, d, eye, device="cpu")
    b = render_frame(tworld, o, d, eye, tile=1000, fused=True, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    # the compacted march: the same frame, its steps the coarse charge
    c = render_frame(tworld, o, d, eye, tile=1000, compact=True, device="cpu")
    for k in a:
        if k != "steps":
            np.testing.assert_array_equal(a[k].numpy(), c[k].numpy(), err_msg=k)
    assert int(c["lane_iters"]) > 0
    assert SHADE_KERNEL.launches == before


@pytest.mark.parametrize("shadow", ["ray", "map"])
def test_shadow_modes_not_ported(scene, shadow):
    """The shadow modes were the part of render() not ported in the first
    slice; they run now (parity with JAX is in test_torch_shadow.py): the
    frame darkens some lit pixels and keeps the hit mask, and an unknown
    mode still raises."""
    _, tworld, _, o, d, eye = scene
    lit = render(tworld, o, d, eye, cfg=RenderConfig(shadow="none"), device="cpu")
    out = render(tworld, o, d, eye, cfg=RenderConfig(shadow=shadow), device="cpu")
    assert torch.equal(out["hit"], lit["hit"])
    darker = (out["rgb"] < lit["rgb"] - 1e-6).any(dim=1)
    assert bool(darker.any()) and not bool((out["rgb"] > lit["rgb"] + 1e-6).any())
    with pytest.raises(ValueError, match="unknown shadow mode"):
        render(tworld, o, d, eye, cfg=RenderConfig(shadow="soft"), device="cpu")
