"""The port's differentiable hard frame against jax.grad of the JAX package's
``render``, on the CPU (the plain versions, under torch autograd).

The small golden scene (2x1x2 chunks, depth 5, seed 7) at 40x24, the
loss ``mean(rgb**2) + mean(depth)``, and the gradients with respect to all
50 floats of the light rig, the table's diffuse, specular and shininess,
the eye, the ray origins and directions, and (textured) the atlas and the
sky map.  The reference's march carries t through an int32 loop state, so
its gradient holds the march fixed; the port's ``render`` marches detached
rays and matches it.  Per shadow mode:

* ``none`` and ``ray``: both give gradients (no gradient crosses the shadow
  rays' march);
* ``map`` with a given shadowmap: both give gradients; without one, the
  light pass reads the direction on the host, so JAX's grad raises when the
  rig is traced and the port raises when the direction requires grad; with
  the rig not differentiated both give the table's and the eye's.

Tolerance: rtol 1e-4 and atol 1e-6 * max|g| per gradient, as both sum the
rays' terms in their own order.  The per-ray gradients of the origins and
directions skip the hits that lie in a light's plane (|n . (light - p)| <
1e-3: terrain faces at the height of the point light): there n . l is 0 to
an ulp, XLA contracts the hit point's multiply-add (ROADMAP.md C, reference
traits) and the side of max(n . l, 0) that an ulp picks decides the
gradient.  They are under 2% of the rays.  Also: a rig of numpy leaves and one of
tensors give bit-equal frames, and ``render_soft``'s sky-map gradient is
nonzero and equals a finite difference (the twin of
tests/test_shade_assets.py:97-135).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.shade import default_atlas as jax_default_atlas
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu.shade.envmap import default_envmap as jax_default_envmap
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.materials import MaterialTable as JaxMaterialTable
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import render as jax_render
from octree_raymarcher_tpu.shade.render import render_shadowmap as jax_render_shadowmap
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch.diff import init_params_from_world, render_soft
from octree_raymarcher_tpu_torch.ops.march import march
from octree_raymarcher_tpu_torch.shade import default_envmap
from octree_raymarcher_tpu_torch.shade.lights import VECTOR_LAYOUT, LightRig
from octree_raymarcher_tpu_torch.shade.materials import MaterialTable
from octree_raymarcher_tpu_torch.shade.render import RenderConfig, render, shade_hits
from octree_raymarcher_tpu_torch.world.world import World

SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)
RTOL = 1e-4
KEYS = ("rig", "diffuse", "specular", "shininess", "eye", "origins", "dirs")


@pytest.fixture(scope="module")
def scene():
    jw = JaxWorld.generate(**SCENE)
    _, jdev = jw.to_device()
    jdev = jax.tree_util.tree_map(jnp.asarray, jdev)
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                            fov_deg=70.0, width=40, height=24)
    o, d = cam.rays()
    eye = np.asarray(cam.position, dtype=np.float32)
    return jdev, World.generate(**SCENE).to_torch("cpu"), o, d, eye


def _jax_state(seed: int = 0):
    """The default rig and table, nudged from a numpy seed so that no
    gradient is a default's accident."""
    rng = np.random.default_rng(seed)
    rig = JaxLightRig.default()
    rig = rig.replace(point=rig.point.replace(
        diffuse=np.float32(rig.point.diffuse * rng.uniform(0.8, 1.2, 3)),
        linear=np.float32(0.14 * rng.uniform(0.8, 1.2))))
    t = JaxMaterialTable.default()
    t = t.replace(diffuse=t.diffuse * jnp.asarray(rng.uniform(0.9, 1.1, (8, 3)), jnp.float32))
    return rig, t


@functools.partial(jax.jit, static_argnames=("shadow",))
def _jax_grads(world, rig, mats, eye, o, d, atlas, env, sm, shadow):
    def loss(rig, mats, eye, o, d, atlas, env):
        out = jax_render(world, o, d, eye, rig, mats, JaxRenderConfig(shadow=shadow),
                         atlas=atlas, shadowmap=sm, envmap=env)
        return jnp.mean(out["rgb"] ** 2) + jnp.mean(out["depth"])

    argnums = (0, 1, 2, 3, 4) + ((5, 6) if atlas is not None else ())
    return jax.grad(loss, argnums=argnums)(rig, mats, eye, o, d, atlas, env)


def _rig_vector(g) -> np.ndarray:
    return np.concatenate([np.asarray(getattr(getattr(g, lt), f), np.float32).reshape(w)
                           for lt, f, w in VECTOR_LAYOUT])


def _port_grads(tworld, rig, mats, o, d, eye, shadow, atlas=None, env=None, sm=None):
    """torch.autograd.grad of the loss through the port's render on the
    CPU, as numpy in _jax_grads's order."""
    trig = LightRig.from_numpy(rig, device="cpu", requires_grad=True)
    tmats = MaterialTable.from_numpy(mats, requires_grad=True)
    te, to, td = (torch.tensor(x, requires_grad=True) for x in (eye, o, d))
    extra = [torch.tensor(np.asarray(x), requires_grad=True) for x in (atlas, env)
             if x is not None]
    out = render(tworld, to, td, te, trig, tmats, RenderConfig(shadow=shadow),
                 atlas=extra[0] if extra else None, envmap=extra[1] if extra else None,
                 shadowmap=sm, device="cpu")
    loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["depth"])
    inputs = trig.leaves() + [tmats.diffuse, tmats.specular, tmats.shininess, te, to, td] + extra
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    n = len(VECTOR_LAYOUT)
    got = {"rig": torch.cat([g.reshape(-1) for g in grads[:n]]).numpy(),
           "skip": _in_light_plane(out, rig)}
    got.update({k: g.numpy() for k, g in zip(KEYS[1:], grads[n:n + 6])})
    if extra:
        got["atlas"], got["envmap"] = grads[-2].numpy(), grads[-1].numpy()
    return got


def _in_light_plane(out, rig) -> np.ndarray:
    """The hits in the plane of the point light or the spotlight through
    their face normal."""
    p, n = out["point"].detach().numpy(), out["normal"].detach().numpy()
    near = np.zeros(len(p), bool)
    for light in (rig.point, rig.spot):
        near |= np.abs(((np.asarray(light.position, np.float32) - p) * n).sum(1)) < 1e-3
    return near & out["hit"].numpy()


def _assert_grads(got, ref, skip=None):
    for k, want in ref.items():
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        assert scale > 0.0, k
        a = got[k]
        if k in ("origins", "dirs") and skip is not None:
            assert skip.mean() < 0.02, skip.mean()
            a, want = a[~skip], want[~skip]
        np.testing.assert_allclose(a, want, rtol=RTOL, atol=1e-6 * scale, err_msg=k)


def _reference(jg, textured: bool) -> dict:
    ref = {"rig": _rig_vector(jg[0]), "diffuse": jg[1].diffuse, "specular": jg[1].specular,
           "shininess": jg[1].shininess, "eye": jg[2], "origins": jg[3], "dirs": jg[4]}
    if textured:
        ref["atlas"], ref["envmap"] = jg[5], jg[6]
    return ref


@pytest.mark.parametrize("shadow,textured", [("none", False), ("none", True), ("ray", False)],
                         ids=["none", "none_textured", "ray"])
def test_render_grad_matches_jax(scene, shadow, textured):
    jdev, tworld, o, d, eye = scene
    rig, mats = _jax_state()
    atlas = env = None
    if textured:
        atlas = jax_default_atlas(resolution=16, seed=0)
        env = jax_default_envmap(32, 64)
    jg = _jax_grads(jdev, rig, mats, jnp.asarray(eye), jnp.asarray(o), jnp.asarray(d),
                    None if atlas is None else jnp.asarray(atlas),
                    None if env is None else jnp.asarray(env), None, shadow)
    got = _port_grads(tworld, rig, mats, o, d, eye, shadow, atlas, env)
    _assert_grads(got, _reference(jg, textured), got["skip"])


@pytest.mark.parametrize("textured", [False, True], ids=["none", "none_textured"])
def test_ambient_grad_is_zeros_as_jax(scene, textured):
    """The table's ambient is looked up and never read by the shading:
    jax.grad of the JAX render gives it zeros, and so do the port's render
    and shade_hits, asked for it alone (no allow_unused)."""
    jdev, tworld, o, d, eye = scene
    rig, mats = _jax_state()
    atlas = env = None
    if textured:
        atlas = jax_default_atlas(resolution=16, seed=0)
        env = jax_default_envmap(32, 64)
    jg = _jax_grads(jdev, rig, mats, jnp.asarray(eye), jnp.asarray(o), jnp.asarray(d),
                    None if atlas is None else jnp.asarray(atlas),
                    None if env is None else jnp.asarray(env), None, "none")
    want = np.asarray(jg[1].ambient)
    assert want.shape == np.asarray(mats.ambient).shape and not want.any()
    tex = {} if atlas is None else {"atlas": torch.from_numpy(np.asarray(atlas)),
                                    "envmap": torch.from_numpy(np.asarray(env))}
    res = march(tworld, torch.from_numpy(o), torch.from_numpy(d), 512, device="cpu")
    for name in ("render", "shade_hits"):
        tmats = MaterialTable.from_numpy(mats, requires_grad=True)
        if name == "render":
            out = render(tworld, o, d, eye, LightRig.from_numpy(rig), tmats, RenderConfig(),
                         device="cpu", **tex)
        else:
            out = shade_hits(res, o, d, eye, LightRig.from_numpy(rig), tmats, RenderConfig(),
                             **tex)
        loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["depth"])
        (g,) = torch.autograd.grad(loss, [tmats.ambient])
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


def test_render_grad_map_with_shadowmap_matches_jax(scene):
    """With the light's depth map given, the map frame differentiates in
    everything, the rig included, in both packages."""
    jdev, tworld, o, d, eye = scene
    rig, mats = _jax_state()
    depth, vp = jax_render_shadowmap(jdev, rig, resolution=(128, 128))
    jg = _jax_grads(jdev, rig, mats, jnp.asarray(eye), jnp.asarray(o), jnp.asarray(d),
                    None, None, (depth, vp), "map")
    sm = (torch.from_numpy(np.asarray(depth)), np.asarray(vp))
    got = _port_grads(tworld, rig, mats, o, d, eye, "map", sm=sm)
    _assert_grads(got, _reference(jg, False), got["skip"])


def test_render_grad_map_refuses_the_direction(scene):
    """Without a depth map the light pass reads the direction on the host:
    jax.grad of the reference's render raises when the rig is traced, and
    the port raises when the direction requires grad."""
    jdev, tworld, o, d, eye = scene
    rig, mats = _jax_state()

    def jax_loss(rig):
        out = jax_render(jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(eye), rig, mats,
                         JaxRenderConfig(shadow="map"))
        return jnp.mean(out["rgb"] ** 2)

    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.grad(jax_loss)(rig)
    trig = LightRig.from_numpy(rig, device="cpu", requires_grad=True)
    with pytest.raises(ValueError, match="direction"):
        render(tworld, o, d, eye, trig, MaterialTable.from_numpy(mats),
               RenderConfig(shadow="map"), device="cpu")


def test_render_grad_map_without_rig_matches_jax(scene):
    """Without a depth map and with the rig held fixed, both packages
    differentiate the map frame in the table, the eye and the rays."""
    jdev, tworld, o, d, eye = scene
    rig, mats = _jax_state()

    @jax.jit
    def jax_grads(world, mats, eye, o, d):
        def loss(mats, eye, o, d):
            out = jax_render(world, o, d, eye, rig, mats, JaxRenderConfig(shadow="map"))
            return jnp.mean(out["rgb"] ** 2) + jnp.mean(out["depth"])
        return jax.grad(loss, argnums=(0, 1, 2, 3))(mats, eye, o, d)

    jg = jax_grads(jdev, mats, jnp.asarray(eye), jnp.asarray(o), jnp.asarray(d))
    tmats = MaterialTable.from_numpy(mats, requires_grad=True)
    te, to, td = (torch.tensor(x, requires_grad=True) for x in (eye, o, d))
    out = render(tworld, to, td, te, LightRig.from_numpy(rig), tmats,
                 RenderConfig(shadow="map"), device="cpu")
    loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["depth"])
    g = torch.autograd.grad(loss, [tmats.diffuse, tmats.specular, tmats.shininess, te, to, td])
    got = {k: v.numpy() for k, v in zip(KEYS[1:], g)}
    _assert_grads(got, {"diffuse": jg[0].diffuse, "specular": jg[0].specular,
                        "shininess": jg[0].shininess, "eye": jg[1], "origins": jg[2],
                        "dirs": jg[3]}, _in_light_plane(out, rig))


@pytest.mark.parametrize("shadow", ["none", "ray"])
def test_tensor_rig_frame_bit_equal_to_numpy_rig(scene, shadow):
    """A rig of tensors that require grad renders the frame a rig of numpy
    leaves does, bit for bit (the host float32 casts of the numpy path)."""
    _, tworld, o, d, eye = scene
    rig, _ = _jax_state(1)
    cfg = RenderConfig(shadow=shadow)
    a = render(tworld, o, d, eye, LightRig.from_numpy(rig), cfg=cfg, device="cpu")
    b = render(tworld, o, d, eye, LightRig.from_numpy(rig, device="cpu", requires_grad=True),
               cfg=cfg, device="cpu")
    assert b["rgb"].requires_grad
    for k in ("rgb", "depth", "point", "normal"):
        assert torch.equal(a[k], b[k].detach()), k


def test_render_soft_envmap_gradient_matches_finite_difference():
    """Soft-composite gradients flow into the sky map's texels: nonzero, and
    the strongest equals a central finite difference (as
    tests/test_shade_assets.py:97-135 holds the JAX package)."""
    w = World.generate(dims=(1, 1, 1), chunksize=32.0, depth=5, seed=5, water_level=0.0,
                       amplitude=10.0)
    world = w.to_torch("cpu")
    cam = PerspectiveCamera(position=(16.0, 24.0, -14.0), pitch_deg=0.0, fov_deg=70.0,
                            width=16, height=12)
    origins, dirs = cam.rays()
    params = init_params_from_world(world)
    env0 = torch.from_numpy(default_envmap(16, 32)).to(torch.float64)

    def loss(e):
        rgb = render_soft(world, params, origins, dirs, max_segments=8,
                          envmap=e.to(torch.float32), device="cpu")["rgb"]
        return torch.mean(rgb.to(torch.float64) ** 2)

    env = env0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(env), [env])
    g = g.numpy()
    assert np.abs(g).sum() > 0
    idx = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-2
    ep, em = env0.clone(), env0.clone()
    ep[idx] += eps
    em[idx] -= eps
    with torch.no_grad():
        fd = (float(loss(ep)) - float(loss(em))) / (2 * eps)
    assert np.isclose(fd, g[idx], rtol=5e-2, atol=1e-5), (fd, g[idx])
