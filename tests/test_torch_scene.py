"""The port's VoxelScene (models/scene.py) and entry twin (entry.py)
against the JAX package's VoxelScene and ``__graft_entry__.entry``.

Shapes: ``VoxelScene.demo(16, depth 4, seed 3)``, the entry's scene, and a
16x12 perspective camera over it.  Tolerances:
* pools and density_raw exact; albedo_raw at rtol 1e-6 (a libm log);
* forward_hard and the entry frame at rtol 1e-5 / atol 1e-5, the port's
  render tolerance (tests/test_torch_render.py);
* forward_soft at rtol 1e-5 / atol 1e-6, the composite tolerance
  (tests/test_torch_diff.py);
* one make_train_step step: loss and params at rtol 1e-3, the fit tolerance
  (Adam's epsilon placement and the order of sums differ between optax and
  torch.optim), and each param's update within 1e-3 of the learning rate.

The JAX side of forward_soft and of the train step samples with
``sample_segments_ref``, the reference's one-loop sampler, which it holds
equal to ``sample_segments`` (tests/test_diff.py) and which compiles in a
second where the 32-phase sampler takes ~45 s on the CPU: the soft reference
is ``composite(sample_segments_ref(world, o, d, 32), params)``, and the step
reference is VoxelScene.make_train_step's body (mean squared rgb error,
``jax.value_and_grad``, ``optax.adam``) over those segments."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as jax_entry
from octree_raymarcher_tpu.diff import composite as jax_composite
from octree_raymarcher_tpu.diff import sample_segments_ref as jax_sample_segments_ref
from octree_raymarcher_tpu.models.scene import VoxelScene as JaxVoxelScene
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu_torch import entry
from octree_raymarcher_tpu_torch.diff import sample_segments
from octree_raymarcher_tpu_torch.models import VoxelScene
from octree_raymarcher_tpu_torch.shade.lights import LightRig
from octree_raymarcher_tpu_torch.shade.materials import MaterialTable

POOLS = ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree", "chunk_twig", "chunkcoordmin")
LR = 0.05


@pytest.fixture(scope="module")
def scenes():
    return (JaxVoxelScene.demo(chunk_size=16.0, depth=4, seed=3),
            VoxelScene.demo(chunk_size=16.0, depth=4, seed=3, device="cpu"))


@pytest.fixture(scope="module")
def rays():
    cam = PerspectiveCamera(position=(8.0, 12.0, -4.0), pitch_deg=-35.0, fov_deg=70.0,
                            width=16, height=12)
    o, d = cam.rays()
    target = np.random.default_rng(0).uniform(size=(o.shape[0], 3)).astype(np.float32)
    return o, d, np.asarray(cam.position, np.float32), target


def _assert_scene_equals(got: VoxelScene, ref: JaxVoxelScene):
    for k in POOLS:
        want = np.asarray(getattr(ref.world, k))
        have = getattr(got.world, k).numpy()
        if want.dtype == np.uint32:
            have = have.view(np.uint32)
        np.testing.assert_array_equal(have, want, err_msg=k)
    assert (got.world.chunksize, got.world.dims, got.world.depth) == (
        float(ref.world.chunksize), tuple(ref.world.dims), int(ref.world.depth))
    np.testing.assert_array_equal(got.params.density_raw.numpy(),
                                  np.asarray(ref.params.density_raw))
    np.testing.assert_allclose(got.params.albedo_raw.numpy(),
                               np.asarray(ref.params.albedo_raw), rtol=1e-6)
    np.testing.assert_array_equal(got.lights.to_vector(),
                                  LightRig.from_numpy(ref.lights).to_vector())
    np.testing.assert_array_equal(got.materials.to_matrix().numpy(),
                                  MaterialTable.from_numpy(ref.materials).to_matrix().numpy())


def test_demo_equals_reference(scenes):
    ref, got = scenes
    _assert_scene_equals(got, ref)
    assert got.params.num_slots == int(ref.params.density_raw.shape[0])


def test_from_numpy_carries_the_reference_scene(scenes):
    ref, demo = scenes
    got = VoxelScene.from_numpy(ref.world, ref.params, ref.lights, ref.materials, device="cpu")
    _assert_scene_equals(got, ref)
    for k in POOLS:
        assert torch.equal(getattr(got.world, k), getattr(demo.world, k)), k
    assert torch.equal(got.params.albedo_raw, demo.params.albedo_raw)


def test_forward_hard_matches_reference(scenes, rays):
    ref, got = scenes
    o, d, eye, _ = rays
    want = np.asarray(jax.jit(ref.forward_hard)(jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(eye)))
    have = got.forward_hard(o, d, eye).numpy()
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_segs(scenes, rays):
    ref, _ = scenes
    o, d, _, _ = rays
    return jax.jit(lambda w, a, b: jax_sample_segments_ref(w, a, b, 32))(
        ref.world, jnp.asarray(o), jnp.asarray(d))


def test_forward_soft_matches_reference(scenes, rays, jax_segs):
    ref, got = scenes
    o, d, _, _ = rays
    segs = sample_segments(got.world, o, d, 32, device="cpu")
    np.testing.assert_array_equal(segs.slot.numpy(), np.asarray(jax_segs.slot))
    want = np.asarray(jax_composite(jax_segs, ref.params)["rgb"])
    have = got.forward_soft(got.params, o, d).detach().numpy()
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)
    loss = got.loss(got.params, o, d, rays[3])
    np.testing.assert_allclose(float(loss), float(np.mean((want - rays[3]) ** 2)), rtol=1e-5)


def test_train_step_matches_reference(scenes, rays, jax_segs):
    ref, got = scenes
    o, d, _, target = rays
    opt = optax.adam(LR)

    @jax.jit
    def jax_step(params, state, segs, tgt):
        def loss_fn(p):
            return jnp.mean((jax_composite(segs, p)["rgb"] - tgt) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    want_p, _, want_loss = jax_step(ref.params, opt.init(ref.params), jax_segs,
                                    jnp.asarray(target))
    train_step, state = got.make_train_step(LR)
    before = [t.clone() for t in (got.params.density_raw, got.params.albedo_raw)]
    new, state, loss = train_step(got.world, got.params, state, o, d, target)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3)
    for name, b in zip(("density_raw", "albedo_raw"), before):
        have = getattr(new, name).numpy()
        want = np.asarray(getattr(want_p, name))
        np.testing.assert_allclose(have, want, rtol=1e-3, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(have - b.numpy(), want - b.numpy(), atol=1e-3 * LR,
                                   err_msg=name)
        # the params passed in are not changed
        assert torch.equal(getattr(got.params, name), b)
    # a second step from the returned state moves the loss down
    _, _, loss2 = train_step(got.world, new, state, o, d, target)
    assert float(loss2) < float(loss)


def test_entry_frame_matches_reference():
    fn, args = entry.entry(device="cpu")
    have = fn(*args)
    assert tuple(have.shape) == (64 * 64, 3)
    jfn, jargs = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    np.testing.assert_allclose(have.numpy(), want, rtol=1e-5, atol=1e-5)


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        VoxelScene.demo(16.0, 4, 3)
