"""The port's differentiable path (plain PyTorch versions of K1 with a
budget, K4, K5 and K6) against the JAX reference's.

Tolerances and why:
* The budgeted march: hit, material, texel and the charge (``.steps``)
  exact, t at rtol 1e-6 (XLA may fuse a multiply-add that the port rounds
  twice; a few ulps over a ray's steps).
* The sampler: count and slot exact on the scenes below (>= 99.9% of slots
  on the oblique camera, where an ulp of a resume cursor may split a
  grazing ray differently), t0/t1 at rtol 1e-5 / atol 1e-4 (the
  reference's own tolerance between its two samplers).
* The composite forward at rtol 1e-5 (sums over K in another order, exp and
  log1p from another libm), gradients at rtol 1e-4 / atol 1e-6, the
  finite-difference check at atol 1e-4, the soft golden at 3e-2.
* Fit losses at rtol 1e-3 for the first 10 steps: Adam's epsilon placement
  and the order of sums differ between optax and torch.optim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.diff import VoxelParams as JaxVoxelParams
from octree_raymarcher_tpu.diff import composite as jax_composite
from octree_raymarcher_tpu.diff import fit as jax_fit
from octree_raymarcher_tpu.diff import init_params_from_world as jax_init_params
from octree_raymarcher_tpu.diff import sample_segments_ref as jax_sample_segments_ref
from octree_raymarcher_tpu.diff.segments import sample_segments_frame as jax_sample_segments_frame
from octree_raymarcher_tpu.core import geometry as jax_geometry
from octree_raymarcher_tpu.ops.march_jnp import march as jax_march
from octree_raymarcher_tpu.shade import OrthoCamera, PerspectiveCamera
from octree_raymarcher_tpu.world import single_chunk_world as jax_single_chunk_world
from octree_raymarcher_tpu.worldgen import BoundsPyramid as JaxBoundsPyramid
from octree_raymarcher_tpu.worldgen import grow as jax_grow
from octree_raymarcher_tpu_torch.diff import (
    SegmentBatch,
    VoxelParams,
    composite,
    fit,
    init_params_from_world,
    load_state,
    render_soft,
    sample_segments,
    sample_segments_frame,
    sample_segments_ref,
    save_state,
)
from octree_raymarcher_tpu_torch.diff.composite import (
    COMPOSITE_BWD_KERNEL,
    COMPOSITE_FWD_KERNEL,
    composite_backward_plain,
    composite_plain,
)
from octree_raymarcher_tpu_torch.diff.optim import photometric_loss, sample_views
from octree_raymarcher_tpu_torch.diff.segments import SEGMENTS_KERNEL
from octree_raymarcher_tpu_torch.core import geometry as G
from octree_raymarcher_tpu_torch.ops.march import march, march_tiled
from octree_raymarcher_tpu_torch.world.device import TorchWorld, single_chunk_world
from octree_raymarcher_tpu_torch.world.world import World
from octree_raymarcher_tpu_torch.worldgen import BoundsPyramid, grow

from test_golden import _check, _thumb
from test_torch_march import jax_device_world
from test_torch_scenes import SCENES, make_scene, scene_rays

PYR = dict(size=32, amplitude=8.0, period=1.0 / 32, xshift=0.0, yshift=12.0, zshift=0.0,
           seed=11)


@pytest.fixture(scope="module")
def dworld():
    """tests/test_diff.py's world, built by both packages."""
    jchunk = jax_grow([0.0, 0.0, 0.0], 32.0, depth=5, pyr=JaxBoundsPyramid.generate(**PYR))
    tchunk = grow([0.0, 0.0, 0.0], 32.0, depth=5, pyr=BoundsPyramid.generate(**PYR))
    return (jax_single_chunk_world(jchunk),
            TorchWorld.from_numpy(single_chunk_world(tchunk), device="cpu"))


@pytest.fixture(scope="module")
def rays():
    """tests/test_diff.py's ortho camera (256 rays, straight down) followed
    by its oblique perspective camera (144 rays crossing cell and chunk
    boundaries at angles), in one batch so each JAX program compiles once."""
    ortho = OrthoCamera(position=(16.0, 40.0, 16.0), direction=(0, -1, 0), up=(0, 0, 1),
                        width=31.0, height=31.0, xres=16, yres=16).rays()
    oblique = PerspectiveCamera(position=(16.0, 30.0, -20.0), yaw_deg=10.0, pitch_deg=-35.0,
                                fov_deg=70.0, width=12, height=12).rays()
    return tuple(np.concatenate([a, b]) for a, b in zip(ortho, oblique))


N_ORTHO = 256
K = 24


@pytest.fixture(scope="module")
def jax_segs(dworld, rays):
    """JAX sample_segments at K=24 through its module-level jit (the one
    fit() uses), so the fit test reuses the compiled sampler."""
    return jax_sample_segments_frame(dworld[0], *rays, max_segments=K)


@pytest.fixture(scope="module")
def grazing():
    """tests/test_diff.py's low, shallow view: long marches that a small
    budget cuts."""
    cam = PerspectiveCamera(position=(-6.0, 14.0, -6.0), yaw_deg=40.0, pitch_deg=-8.0,
                            fov_deg=60.0, width=12, height=12)
    return cam.rays()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _trainable(params):
    """Leaf copies of ``params`` that require grad."""
    return VoxelParams(params.density_raw.detach().clone().requires_grad_(True),
                       params.albedo_raw.detach().clone().requires_grad_(True))


def _adam_step(params, opt, cached):
    """One step of fit()'s loop."""
    opt.zero_grad(set_to_none=True)
    photometric_loss(params, cached).backward()
    opt.step()


def _assert_segments(got, ref, slot_agree=1.0):
    np.testing.assert_array_equal(_np(got.count), _np(ref.count))
    slot_eq = _np(got.slot) == _np(ref.slot)
    if slot_agree == 1.0:
        np.testing.assert_array_equal(_np(got.slot), _np(ref.slot))
    else:
        assert slot_eq.mean() >= slot_agree, slot_eq.mean()
    both = slot_eq & (_np(got.slot) >= 0)
    for k in ("t0", "t1"):
        np.testing.assert_allclose(_np(getattr(got, k))[both], _np(getattr(ref, k))[both],
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    return slot_eq


def test_box_geometry_matches_jax():
    """is_inside, escape_distance and enter_distance, which the sampler and
    its oracle use, against the JAX package's."""
    rng = np.random.default_rng(9)
    p = rng.uniform(-4, 12, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d[:20, 0] = 0.0                                   # axis-parallel rays
    cmin = rng.uniform(0, 4, (500, 3)).astype(np.float32)
    cmax = cmin + rng.uniform(0.5, 4, (500, 1)).astype(np.float32)
    g = np.array(jax_geometry.inv_dir(d))
    tp, tg, tmin, tmax = (torch.from_numpy(x) for x in (p, g, cmin, cmax))
    np.testing.assert_array_equal(_np(G.inv_dir(torch.from_numpy(d))), g)
    np.testing.assert_array_equal(_np(G.is_inside(tp, tmin, tmax)),
                                  np.asarray(jax_geometry.is_inside(p, cmin, cmax)))
    np.testing.assert_array_equal(_np(G.escape_distance(tp, tg, tmin, tmax)),
                                  np.asarray(jax_geometry.escape_distance(p, g, cmin, cmax)))
    for a, b in zip(G.enter_distance(tp, tg, tmin, tmax),
                    jax_geometry.enter_distance(p, g, cmin, cmax)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---- B3b: the budgeted march ---------------------------------------------------

@pytest.mark.parametrize("stride,max_steps", [(8, 32), (13, 30)])
def test_budgeted_march_matches_jax(dworld, grazing, stride, max_steps):
    jw, tw = dworld
    o, d = grazing
    budget = np.random.default_rng(stride).integers(0, 60, len(o)).astype(np.int32)
    kw = dict(max_steps=max_steps, step_budget=budget, steps_stride=stride)
    ref = jax_march(jw, o, d, **kw)
    got = march(tw, o, d, device="cpu", **kw)
    for k in ("hit", "material", "texel", "steps", "cell_bmin", "cell_size"):
        np.testing.assert_array_equal(_np(getattr(got, k)), _np(getattr(ref, k)), err_msg=k)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), rtol=1e-6)
    steps = _np(got.steps)
    s = max(4, (stride // 4) * 4)
    assert (steps % s == 0).all() and steps.max() > 0
    # the budget binds: some rays that hit without it miss with it
    free = march(tw, o, d, max_steps=max_steps, device="cpu")
    assert (_np(free.hit) & ~_np(got.hit)).any()
    # march_tiled takes the reference's unroll/steps_stride keywords
    tiled = march_tiled(tw, o, d, max_steps, tile=16, unroll=8, steps_stride=stride,
                        device="cpu")
    np.testing.assert_array_equal(_np(tiled.t), _np(free.t))


@pytest.mark.parametrize("budget", [None, 20])
def test_expose_live_t_matches_jax(dworld, grazing, budget):
    jw, tw = dworld
    o, d = grazing
    kw = dict(max_steps=10, _expose_live_t=True)
    if budget is not None:
        kw.update(step_budget=np.full(len(o), budget, np.int32), steps_stride=8)
    ref = jax_march(jw, o, d, **kw)
    got = march(tw, o, d, device="cpu", **kw)
    np.testing.assert_array_equal(_np(got.hit), _np(ref.hit))
    np.testing.assert_array_equal(np.isfinite(_np(got.t)), np.isfinite(_np(ref.t)))
    live = np.isfinite(_np(ref.t)) & ~_np(ref.hit)
    assert live.any()
    np.testing.assert_allclose(_np(got.t), _np(ref.t), rtol=1e-6)
    with pytest.raises(ValueError, match="steps_aov"):
        march(tw, o, d, steps_aov=True, step_budget=np.ones(len(o), np.int32), device="cpu")


# ---- B4: the segment sampler -----------------------------------------------------

def _columns(segs, k, rows=slice(None)):
    """The first k segments of each ray: the K-phase sampler's phases do
    not depend on K, so these are what a K=k run records."""
    return SegmentBatch(slot=_np(segs.slot)[rows, :k], t0=_np(segs.t0)[rows, :k],
                        t1=_np(segs.t1)[rows, :k],
                        count=np.minimum(_np(segs.count)[rows], k))


def test_sampler_matches_jax(dworld, rays, jax_segs):
    """K=16 on the ortho rays: exact count and slot."""
    _, tw = dworld
    o, d = (x[:N_ORTHO] for x in rays)
    got = sample_segments(tw, o, d, max_segments=16, device="cpu")
    _assert_segments(got, _columns(jax_segs, 16, slice(0, N_ORTHO)))
    assert _np(got.count).max() >= 2
    frame = sample_segments_frame(tw, o, d, max_segments=16, tile=64, device="cpu")
    for k in ("slot", "t0", "t1", "count"):
        np.testing.assert_array_equal(_np(getattr(frame, k)), _np(getattr(got, k)))


def test_sampler_oblique_camera(dworld, rays, jax_segs):
    """K=24 on the oblique rays: >= 99.9% slot agreement."""
    _, tw = dworld
    o, d = (x[N_ORTHO:] for x in rays)
    got = sample_segments(tw, o, d, max_segments=K, device="cpu")
    ref = _columns(jax_segs, K, slice(N_ORTHO, None))
    slot_eq = _assert_segments(got, ref, slot_agree=0.999)
    print(f"oblique K=24: slot disagreement {1.0 - slot_eq.mean():.6f}")


def test_budgeted_sampler_at_cap(dworld, grazing):
    """step_budget=24, steps_stride=8 against JAX sample_segments (through
    its jitted frame wrapper) and the one-loop oracles: the rays the budget cuts agree segment for segment."""
    jw, tw = dworld
    o, d = grazing
    kw = dict(max_segments=16, step_budget=24, steps_stride=8)
    got = sample_segments(tw, o, d, device="cpu", **kw)
    jax_ref = jax_sample_segments_ref(jw, o, d, **kw)
    _assert_segments(got, jax_ref)
    # Each phase entered charges at least one stride, so a budget of 24 at
    # stride 8 records at most 3 segments: the JAX K-phase sampler at K=4
    # (a quarter of its compile time) holds all of them.
    assert _np(got.count).max() <= 3
    kw4 = dict(kw, max_segments=4)
    _assert_segments(_columns(got, 4), jax_sample_segments_frame(jw, o, d, **kw4))
    _assert_segments(sample_segments_ref(tw, o, d, **kw), jax_ref)
    free = sample_segments(tw, o, d, max_segments=16, device="cpu")
    assert (_np(got.count) < _np(free.count)).any(), "budget never bound"
    # without a budget the port's oracle equals its fast sampler here
    _assert_segments(sample_segments_ref(tw, o, d, max_segments=16), free)


@pytest.mark.parametrize("name", SCENES)
def test_scene_sampler_matches_jax(name):
    """The scenes of tests/test_torch_scenes.py at K=4 (each phase resumes
    with the path it left): JAX sample_segments and sample_segments_plain,
    exact count, >= 99.9% slot agreement as on the oblique camera."""
    _, packed = make_scene(name)
    o, d = scene_rays(name)
    ref = jax_sample_segments_frame(jax_device_world(packed), o, d, max_segments=4)
    got = sample_segments(TorchWorld.from_numpy(packed, device="cpu"), o, d, max_segments=4,
                          device="cpu")
    _assert_segments(got, ref, slot_agree=0.999)
    assert _np(got.count).max() == 4 and _np(got.count).min() == 0


def test_segments_plan():
    """K4's launch plan for every K from 1 to 512: a window of at most
    WINDOW columns, and a block's staging (three planes of 32 rows per warp
    at an odd row pitch) within 48 KB."""
    from octree_raymarcher_tpu_torch.diff.segments import THREADS, WINDOW, segments_plan

    for K in range(1, 513):
        plan = segments_plan(K)
        assert plan.cols == min(K, WINDOW)
        assert plan.smem == (THREADS // 32) * 3 * 32 * (plan.cols | 1) * 4 <= 48 * 1024


# ---- B5: the compositor ---------------------------------------------------------

@pytest.fixture(scope="module")
def segs(jax_segs):
    """The JAX sampler's segments, in both packages' types."""
    tsegs = SegmentBatch(*(torch.from_numpy(np.array(getattr(jax_segs, k)))
                           for k in ("slot", "t0", "t1", "count")))
    return jax_segs, tsegs


def _params(jw, tw, density, seed=0):
    """The same random params in both packages (numpy from a seed)."""
    jp = jax_init_params(jw, solid_density=density)
    rng = np.random.default_rng(seed)
    dr = np.asarray(jp.density_raw) + rng.normal(0, 0.5, jp.density_raw.shape).astype(np.float32)
    ar = np.asarray(jp.albedo_raw) + rng.normal(0, 0.5, jp.albedo_raw.shape).astype(np.float32)
    return (JaxVoxelParams(density_raw=jnp.asarray(dr), albedo_raw=jnp.asarray(ar)),
            VoxelParams.from_numpy(dr, ar, device="cpu"))


def test_init_params_match_jax(dworld):
    jw, tw = dworld
    for density in (40.0, 3.0):
        ref = jax_init_params(jw, solid_density=density)
        got = init_params_from_world(tw, solid_density=density)
        np.testing.assert_array_equal(_np(got.density_raw), np.asarray(ref.density_raw))
        np.testing.assert_allclose(_np(got.albedo_raw), np.asarray(ref.albedo_raw), rtol=1e-6)
    # material words >= 2^31 clip to the last table row, as unsigned
    twig = np.asarray(jw.twig).copy()
    twig[5] = np.uint32(0x80000004)
    packed = tw.to_numpy()
    packed.twig = twig
    got = init_params_from_world(TorchWorld.from_numpy(packed, device="cpu"))
    ref = jax_init_params(jw.replace(twig=twig))
    np.testing.assert_allclose(_np(got.albedo_raw), np.asarray(ref.albedo_raw), rtol=1e-6)
    dr, ar = got.to_numpy()
    back = VoxelParams.from_numpy(dr, ar, device="cpu")
    assert torch.equal(back.albedo_raw, got.albedo_raw)


def test_composite_forward_matches_jax(dworld, segs):
    jw, tw = dworld
    jsegs, tsegs = segs
    jp, tp = _params(jw, tw, 3.0)
    sky = np.random.default_rng(2).uniform(0, 1, (tsegs.slot.shape[0], 3)).astype(np.float32)
    for sky_rgb in (None, sky):
        ref = jax_composite(jsegs, jp, sky_rgb=sky_rgb)
        got = composite(tsegs, tp, sky_rgb=sky_rgb)
        for k in ("rgb", "depth", "opacity", "weights"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _loss(out, wk, sky):
    """A loss that touches every output of composite and the sky."""
    return ((out["rgb"] ** 2).mean() + 1e-3 * out["depth"].mean()
            + (out["opacity"] ** 3).sum() * 0.01 + (out["weights"] * wk).sum()
            + (out["rgb"] * sky).sum() * 0.1)


def test_composite_gradients_match_jax(dworld, segs):
    jw, tw = dworld
    jsegs, tsegs = segs
    jp, tp = _params(jw, tw, 3.0, seed=1)
    rng = np.random.default_rng(3)
    n, K = tsegs.slot.shape
    sky = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    wk = rng.normal(size=(n, K)).astype(np.float32)

    def jloss(p, s):
        return _loss(jax_composite(jsegs, p, sky_rgb=s), wk, s)

    gp, gs = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(sky))
    tparams = _trainable(tp)
    ts = torch.from_numpy(sky).requires_grad_(True)
    _loss(composite(tsegs, tparams, sky_rgb=ts), torch.from_numpy(wk), ts).backward()
    for got, ref in ((tparams.density_raw.grad, gp.density_raw),
                     (tparams.albedo_raw.grad, gp.albedo_raw), (ts.grad, gs)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(gp.density_raw)).max() > 1e-3


def test_composite_backward_plain_matches_autograd(dworld, segs):
    """K6's plain version against torch.autograd of K5's plain version."""
    jw, tw = dworld
    _, tsegs = segs
    _, tp = _params(jw, tw, 2.0, seed=4)
    rng = np.random.default_rng(5)
    n, K = tsegs.slot.shape
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((n, 3), (n,), (n,), (n, K))]
    bg = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    dr = tp.density_raw.clone().requires_grad_(True)
    ar = tp.albedo_raw.clone().requires_grad_(True)
    bgr = bg.clone().requires_grad_(True)
    outs = composite_plain(tsegs.slot, tsegs.t0, tsegs.t1, dr, ar, bgr, 8192.0)
    torch.autograd.backward(outs, g)
    got = composite_backward_plain(tsegs.slot, tsegs.t0, tsegs.t1, tp.density_raw,
                                   tp.albedo_raw, bg, 8192.0, *g)
    for a, b in zip(got, (dr.grad, ar.grad, bgr.grad)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-6)
    # no upstream gradient for some outputs
    got = composite_backward_plain(tsegs.slot, tsegs.t0, tsegs.t1, tp.density_raw,
                                   tp.albedo_raw, bg, 8192.0, g[0], None, None, None)
    dr.grad = None
    outs = composite_plain(tsegs.slot, tsegs.t0, tsegs.t1, dr, ar, bg, 8192.0)
    outs[0].backward(g[0])
    np.testing.assert_allclose(_np(got[0]), _np(dr.grad), rtol=1e-4, atol=1e-6)


def test_gradient_matches_finite_difference(dworld, rays):
    """tests/test_diff.py's finite-difference check, on the port."""
    _, tw = dworld
    o, d = (x[:N_ORTHO] for x in rays)
    tsegs = sample_segments(tw, o, d, max_segments=16, device="cpu")
    params = init_params_from_world(tw, solid_density=3.0)
    target = torch.zeros((o.shape[0], 3))

    def loss(p):
        return torch.mean((composite(tsegs, p)["rgb"] - target) ** 2)

    tp = _trainable(params)
    loss(tp).backward()
    g = tp.density_raw.grad.numpy()
    slot = tsegs.slot.numpy()
    touched = np.unique(slot[slot >= 0])
    check = np.random.default_rng(0).choice(touched, size=min(8, len(touched)), replace=False)
    eps = 1e-3
    base = params.density_raw.numpy()
    for s in check:
        lp, lm = base.copy(), base.copy()
        lp[s] += eps
        lm[s] -= eps
        fd = (float(loss(VoxelParams(torch.from_numpy(lp), params.albedo_raw)))
              - float(loss(VoxelParams(torch.from_numpy(lm), params.albedo_raw)))) / (2 * eps)
        assert np.isclose(fd, g[s], atol=1e-4, rtol=5e-2), (s, fd, g[s])


def test_soft_golden_and_launches():
    w = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                       amplitude=16.0).to_torch("cpu")
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), pitch_deg=-20.0, fov_deg=70.0,
                            width=48, height=27)
    o, d = cam.rays()
    before = (SEGMENTS_KERNEL.launches, COMPOSITE_FWD_KERNEL.launches,
              COMPOSITE_BWD_KERNEL.launches)
    out = render_soft(w, init_params_from_world(w), o, d, device="cpu")
    _check("soft_2x1x2_d5", _thumb(out["rgb"].numpy(), 27, 48, k=3), atol=3e-2)
    assert (SEGMENTS_KERNEL.launches, COMPOSITE_FWD_KERNEL.launches,
            COMPOSITE_BWD_KERNEL.launches) == before


# ---- the fit -------------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_setup(dworld, rays):
    """Target: the soft render under ground-truth params; start: albedo
    perturbed by numpy noise from a seed (tests/test_diff.py:124-139)."""
    jw, tw = dworld
    o, d = rays
    gt = init_params_from_world(tw, solid_density=50.0)
    target = render_soft(tw, gt, o, d, max_segments=K, device="cpu")["rgb"].detach().numpy()
    noise = np.random.default_rng(0).normal(size=gt.albedo_raw.shape).astype(np.float32)
    dr, ar = gt.to_numpy()
    return [(o, d, target)], dr, ar + 2.0 * noise


def test_fit_converges(dworld, fit_setup):
    _, tw = dworld
    views, dr, ar = fit_setup
    _, history = fit(tw, views, VoxelParams.from_numpy(dr, ar, "cpu"), steps=60, lr=0.1,
                     max_segments=K, device="cpu")
    assert history[-1] < history[0] * 0.1, history[::10]


def test_fit_losses_match_jax(dworld, fit_setup, jax_segs):
    jw, tw = dworld
    views, dr, ar = fit_setup
    _, ref = jax_fit(jw, views, JaxVoxelParams(density_raw=jnp.asarray(dr),
                                               albedo_raw=jnp.asarray(ar)), steps=10, lr=0.1,
                     max_segments=K)
    _, got = fit(tw, views, VoxelParams.from_numpy(dr, ar, "cpu"), steps=10, lr=0.1,
                 max_segments=K, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_checkpoint_resume_equals_uninterrupted(dworld, fit_setup, tmp_path):
    _, tw = dworld
    views, dr, ar = fit_setup
    p0 = VoxelParams.from_numpy(dr, ar, "cpu")
    full, _ = fit(tw, views, p0, steps=10, lr=0.1, max_segments=K, device="cpu")

    cached = sample_views(tw, views, K, device="cpu")
    params = _trainable(p0)
    opt = torch.optim.Adam([params.density_raw, params.albedo_raw], lr=0.1)
    for _ in range(5):
        _adam_step(params, opt, cached)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, 5, params, opt)

    fresh = _trainable(VoxelParams.from_numpy(np.zeros_like(dr), np.zeros_like(ar), "cpu"))
    opt2 = torch.optim.Adam([fresh.density_raw, fresh.albedo_raw], lr=0.1)
    step, restored, opt2 = load_state(path, fresh, opt2)
    assert step == 5
    # the optimiser must step the restored leaves
    with torch.no_grad():
        fresh.density_raw.copy_(restored.density_raw)
        fresh.albedo_raw.copy_(restored.albedo_raw)
    for _ in range(5):
        _adam_step(fresh, opt2, cached)
    np.testing.assert_array_equal(_np(fresh.density_raw), _np(full.density_raw))
    np.testing.assert_array_equal(_np(fresh.albedo_raw), _np(full.albedo_raw))
    with pytest.raises(ValueError, match="trees"):
        load_state(path, fresh)
