"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided in
the fixture, not at import).  The file imports neither JAX nor the JAX
package, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernels are built with -fmad=false, so the march (K1, with and without
a budget), the shadow passes (K3), the segment sampler (K4) and the pool
patch (K7) agree bit for bit; the shading (K2) and the composite forward (K5) to within libm ulps
(exp, log1p, powf); the composite backward (K6) to rtol 1e-4 / atol 1e-6
relative to the largest gradient, because its scatter sums in its own order
(runs, warp groups, block tables, then atomics in run-to-run order)
(tolerance as in chip_smoke.py); K2's VJP (K8) against torch.autograd.grad
of the plain shading within 1e-3 |plain| + 1e-5 max|plain|, K6's tolerance,
for the same reason."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from octree_raymarcher_tpu_torch import entry

from octree_raymarcher_tpu_torch.diff.composite import (
    COMPOSITE_BWD_KERNEL,
    COMPOSITE_FWD_KERNEL,
    VoxelParams,
    composite,
    composite_backward_plain,
    composite_plain,
    composite_plan,
    init_params_from_world,
)
from octree_raymarcher_tpu_torch.diff.segments import (
    SEGMENTS_KERNEL,
    SegmentBatch,
    sample_segments,
    sample_segments_plain,
    segments_plan,
)
from octree_raymarcher_tpu_torch.ops.guards import GuardError, composite_checked, march_checked
from octree_raymarcher_tpu_torch.ops.march import (
    MARCH_DEPTH_KERNEL,
    MARCH_KERNEL,
    march,
    march_depth,
    march_depth_plain,
    march_plain,
)
from octree_raymarcher_tpu_torch.parallel import (
    init_distributed,
    local_address,
    make_mesh,
    make_sharded_train_step,
    make_zero_train_step,
    march_sharded,
    render_frame_sharded,
    render_sharded,
)
from octree_raymarcher_tpu_torch.shade import (
    LightRig,
    MaterialTable,
    PerspectiveCamera,
    RenderConfig,
    default_atlas,
    default_envmap,
    render,
    shade_hits,
    shade_hits_plain,
)
from octree_raymarcher_tpu_torch.shade import shadow as S
from octree_raymarcher_tpu_torch.ops.march import MarchResult
from octree_raymarcher_tpu_torch.shade.render import (
    SHADE_BWD_KERNELS,
    SHADE_KERNEL,
    SHADE_KERNELS,
    SHADE_MAP_KERNEL,
    SHADE_MAP_TEX_KERNEL,
    SHADE_TEX_KERNEL,
    SHADE_WIDE_KERNELS,
    shade_hits_vjp_plain,
)
from octree_raymarcher_tpu_torch.world.alloc import (
    CHUNK_BMIN,
    CHUNK_TREE,
    CHUNK_TWIG,
    PATCH_KERNEL,
    PIECE_WORDS,
    ROW_CAPS,
    TREE,
    TWIG,
    PatchBatch,
    check_batch,
    launch_groups,
    layout,
    patch,
    patch_plain,
)
from octree_raymarcher_tpu_torch.world.device import TorchWorld
from octree_raymarcher_tpu_torch.world.world import World

from test_torch_scenes import SCENES, scene_rays, scene_torch, shade_batch, warp_kinds

pytestmark = pytest.mark.cuda

FIELDS = ("hit", "t", "material", "texel", "cell_bmin", "cell_size", "steps")


@pytest.fixture(scope="module")
def gpu_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dev = torch.device("cuda")
    world = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7,
                           water_level=4.0, amplitude=16.0).to_torch(dev)
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), pitch_deg=-20.0, fov_deg=70.0,
                            width=96, height=54)
    o, d = cam.rays()
    rng = np.random.default_rng(5)
    n = 3000
    fo = np.stack([rng.uniform(-10, 74, n), rng.uniform(5, 60, n),
                   rng.uniform(-10, 74, n)], axis=1).astype(np.float32)
    fd = rng.normal(size=(n, 3)).astype(np.float32)
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    o = torch.from_numpy(np.concatenate([o, fo])).to(dev)
    d = torch.from_numpy(np.concatenate([d, fd])).to(dev)
    eye = torch.tensor(cam.position, dtype=torch.float32, device=dev)
    return world, o, d, eye, rng


@pytest.mark.parametrize("resident", [False, True])
def test_march_kernel_matches_plain(gpu_scene, resident):
    world, o, d, _, rng = gpu_scene
    before = MARCH_KERNEL.launches
    got = march(world, o, d, max_steps=512, steps_aov=True, assume_resident=resident,
                device="cuda")
    ref = march_plain(world, o, d, 512, True, None, None, resident)
    assert MARCH_KERNEL.launches == before + 1
    for k in FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(ref, k), rtol=0, atol=0,
                                   msg=k)
    n = o.shape[0]
    t_start = torch.from_numpy(rng.uniform(-1, 20, n).astype(np.float32)).cuda()
    live = torch.from_numpy((rng.uniform(size=n) < 0.6).astype(np.int32)).cuda()
    got = march(world, o, d, max_steps=7, steps_aov=True, t_start=t_start,
                live_start=live, assume_resident=resident, device="cuda")
    ref = march_plain(world, o, d, 7, True, t_start, live, resident)
    for k in FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(ref, k), rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured_env"])
def test_shade_kernel_matches_plain(gpu_scene, textured):
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    kw = {}
    if textured:
        kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)).cuda(),
                  envmap=torch.from_numpy(default_envmap(32, 64)).cuda())
    lights, mats, cfg = LightRig.default(), MaterialTable.default(), RenderConfig()
    kernel = SHADE_TEX_KERNEL if textured else SHADE_KERNEL
    before = kernel.launches
    got = shade_hits(res, o, d, eye, lights, mats, cfg, **kw)
    ref = shade_hits_plain(res, o, d, eye, lights, mats, cfg, **kw)
    assert kernel.launches == before + 1
    for k in ("rgb", "depth", "point", "normal"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)


def _exact(got, ref, names):
    for k in names:
        torch.testing.assert_close(getattr(got, k), getattr(ref, k), rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("expose", [False, True])
def test_march_budget_matches_plain(gpu_scene, expose):
    world, o, d, _, rng = gpu_scene
    n = o.shape[0]
    budget = torch.from_numpy(rng.integers(0, 80, n).astype(np.int32)).cuda()
    got = march(world, o, d, max_steps=64, step_budget=budget, steps_stride=8,
                _expose_live_t=expose, device="cuda")
    ref = march_plain(world, o, d, 64, False, None, None, False, budget, 8, expose)
    _exact(got, ref, FIELDS)
    assert int(got.steps.max()) > 0


def test_shadow_kernels_match_plain(gpu_scene):
    world, o, d, _, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    ldir = S.light_dir(LightRig.default())
    before = S.RAY_PREP_KERNEL.launches
    for x, y in zip(S.ray_prep(res, o, d, ldir), S.ray_prep_plain(res, o, d, ldir)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert S.RAY_PREP_KERNEL.launches == before + 1
    depth, vp = S.render_shadowmap(world, LightRig.default(), resolution=(64, 64))
    origins, dirs, vp_np = S._bundle(world, LightRig.default(), 64, 64, 1.1)
    lres = march(world, origins, dirs, max_steps=512, device="cuda")
    torch.testing.assert_close(S.shadow_resolve(origins, dirs, lres.hit, lres.t, vp_np),
                               S.shadow_resolve_plain(origins, dirs, lres.hit, lres.t, vp_np),
                               rtol=0, atol=0)
    torch.testing.assert_close(S.map_project(res, o, d, depth, vp_np),
                               S.map_project_plain(res, o, d, depth, vp_np), rtol=0, atol=0)
    pts = torch.randn(o.shape[0], 3, device="cuda") * 20 + 32
    torch.testing.assert_close(S.map_shadow(pts, depth, vp), S.map_shadow_plain(pts, depth, vp_np),
                               rtol=0, atol=0)
    # CUDA points with a host depth map still run K3 on the card
    before = S.MAP_PROJECT_KERNEL.launches
    host = S.map_shadow(pts.cpu().numpy(), depth.cpu().numpy(), vp)
    assert S.MAP_PROJECT_KERNEL.launches == before + 1 and host.is_cuda
    torch.testing.assert_close(host, S.map_shadow_plain(pts, depth, vp_np), rtol=0, atol=0)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured_env"])
def test_map_shade_kernel_matches_split(gpu_scene, textured):
    """K2 given the depth map (it projects its own hit points) equals K2
    fed K3 map_project's factor, bit for bit, and its plain version."""
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    lights, mats, cfg = LightRig.default(), MaterialTable.default(), RenderConfig(shadow="map")
    kw = {}
    if textured:
        kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)).cuda(),
                  envmap=torch.from_numpy(default_envmap(32, 64)).cuda())
    shadowed = 0.0
    for resolution in ((512, 512), (256, 200)):
        smap = S.render_shadowmap(world, lights, resolution=resolution)
        kernel = SHADE_MAP_TEX_KERNEL if textured else SHADE_MAP_KERNEL
        before = (SHADE_KERNEL.launches, SHADE_TEX_KERNEL.launches, kernel.launches)
        fused = shade_hits(res, o, d, eye, lights, mats, cfg, shadowmap=smap, **kw)
        assert (SHADE_KERNEL.launches, SHADE_TEX_KERNEL.launches,
                kernel.launches) == (before[0], before[1], before[2] + 1)
        factor = S.map_project(res, o, d, smap[0], S.host_vp(smap[1]), cfg.shadow_bias)
        split = shade_hits(res, o, d, eye, lights, mats, cfg, shadow_factor=factor, **kw)
        for k in ("rgb", "depth", "point", "normal"):
            torch.testing.assert_close(fused[k], split[k], rtol=0, atol=0, msg=k)
        ref = shade_hits_plain(res, o, d, eye, lights, mats, cfg, shadowmap=smap, **kw)
        for k in ("rgb", "depth", "point", "normal"):
            torch.testing.assert_close(fused[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)
        shadowed += float(factor.sum())
    assert shadowed > 0


def _warp_batch(textured: bool, tables: str):
    """The warp-group batch of test_torch_shade.py on the card, with the
    light rig and material table on the host or (table and eye) on the card."""
    res, o, d, eye = shade_batch()
    assert min(warp_kinds(res["hit"]).values()) >= 4
    dev = torch.device("cuda")
    tres = MarchResult(**{k: torch.from_numpy(v).to(dev) for k, v in res.items()})
    mats = MaterialTable.default(device=dev if tables == "card" else "cpu")
    eye = torch.from_numpy(eye).to(dev) if tables == "card" else eye
    kw = {}
    if textured:
        kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)[:5]).to(dev),
                  envmap=torch.from_numpy(default_envmap(32, 64)).to(dev))
    return (tres, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev), eye,
            LightRig.default(), mats, kw)


@pytest.mark.parametrize("tables", ["host", "card"])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "atlas5_env"])
def test_shade_kernel_warp_groups(gpu_scene, textured, tables):
    """K2 against its plain version on warps that are all hit, all miss and
    mixed, with the tables on the host (by value) or on the card (by
    pointer); one launch of the instantiation the inputs pick."""
    res, o, d, eye, lights, mats, kw = _warp_batch(textured, tables)
    cfg = RenderConfig(sky=(0.1, 0.2, 0.3))
    kernel = SHADE_TEX_KERNEL if textured else SHADE_KERNEL
    before = kernel.launches
    got = shade_hits(res, o, d, eye, lights, mats, cfg, **kw)
    assert kernel.launches == before + 1
    ref = shade_hits_plain(res, o, d, torch.as_tensor(eye).cuda(), lights, mats, cfg, **kw)
    for k in ("rgb", "depth", "point", "normal"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("tables", ["host", "card"])
def test_map_shade_kernel_warp_groups_match_split(gpu_scene, tables):
    """The map-shadowed textured K2 on the warp-group batch equals K2 fed
    map_project's factor bit for bit."""
    world = gpu_scene[0]
    res, o, d, eye, lights, mats, kw = _warp_batch(True, tables)
    cfg = RenderConfig(shadow="map")
    smap = S.render_shadowmap(world, lights, resolution=(256, 256))
    fused = shade_hits(res, o, d, eye, lights, mats, cfg, shadowmap=smap, **kw)
    factor = S.map_project(res, o, d, smap[0], S.host_vp(smap[1]), cfg.shadow_bias)
    split = shade_hits(res, o, d, eye, lights, mats, cfg, shadow_factor=factor, **kw)
    for k in ("rgb", "depth", "point", "normal"):
        torch.testing.assert_close(fused[k], split[k], rtol=0, atol=0, msg=k)


def test_shade_hits_host_tables_upload_nothing(gpu_scene):
    """A shade_hits call whose eye, light rig and material table are on the
    host launches K2 once and copies nothing to the card: they travel in
    the kernel's parameter block."""
    from torch.profiler import ProfilerActivity, profile

    world, o, d, _, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    atlas = torch.from_numpy(default_atlas(resolution=16)).cuda()
    envmap = torch.from_numpy(default_envmap(32, 64)).cuda()
    args = (res, o, d, np.float32([32.0, 30.0, -20.0]), LightRig.default(),
            MaterialTable.default(), RenderConfig())
    shade_hits(*args, atlas=atlas, envmap=envmap)
    torch.cuda.synchronize()
    before = SHADE_TEX_KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        shade_hits(*args, atlas=atlas, envmap=envmap)
        torch.cuda.synchronize()
    assert SHADE_TEX_KERNEL.launches == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("shade_kernel" in x for x in names) == 1, names
    assert not any("HtoD" in x for x in names), names


def _random_table(rows: int, seed: int = 0) -> MaterialTable:
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(0, 1, (rows, 3)), rng.uniform(0, 1, (rows, 3)),
            rng.uniform(0, 1, (rows, 3)), rng.uniform(1, 100, rows)]
    return MaterialTable(*(torch.from_numpy(c.astype(np.float32)) for c in cols))


def _rig_grad(rig) -> torch.Tensor:
    """The gradient of a rig of tensor leaves as its 50 floats (zeros for a
    leaf the shading does not read)."""
    return torch.cat([(torch.zeros_like(v) if v.grad is None else v.grad).reshape(-1)
                      for v in rig.leaves()])


def _close_k6(a, b, name):
    """K6's tolerance: |a - b| <= 1e-3 |b| + 1e-5 max|b|."""
    scale = float(b.abs().max())
    bad = int(((a - b).abs() > 1e-3 * b.abs() + 1e-5 * scale).sum())
    assert bad == 0, (name, bad, float((a - b).abs().max()), scale)


def _k8_against_plain(res, o, d, eye, lights, mats, cfg, kw, shadowmap=None, seed=0):
    """shade_hits with every differentiable input requiring grad (K2's wide
    instantiation, the rig on the card, then K8, one launch each) against
    shade_hits_vjp_plain on the same rays."""
    dev = o.device
    n = o.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g_rgb = torch.randn((n, 3), generator=gen, device=dev)
    g_depth = torch.randn(n, generator=gen, device=dev)
    rig = LightRig.from_numpy(lights, device=dev, requires_grad=True)
    table = MaterialTable.from_numpy(mats, device=dev, requires_grad=True)
    leaves = {"eye": torch.as_tensor(eye, device=dev).clone().requires_grad_(True),
              "origins": o.clone().requires_grad_(True), "dirs": d.clone().requires_grad_(True)}
    tex = {k: v.clone().requires_grad_(True) for k, v in kw.items()}
    key = (shadowmap is not None, bool(kw))
    counts = (SHADE_KERNELS[key], SHADE_WIDE_KERNELS[key], SHADE_BWD_KERNELS[key])
    before = tuple(k.launches for k in counts)
    out = shade_hits(res, leaves["origins"], leaves["dirs"], leaves["eye"], rig, table, cfg,
                     shadowmap=shadowmap, **tex)
    torch.autograd.backward([out["rgb"], out["depth"]], [g_rgb, g_depth])
    assert tuple(k.launches for k in counts) == (before[0], before[1] + 1, before[2] + 1)
    want = shade_hits_vjp_plain(res, o, d, torch.as_tensor(eye, device=dev), lights, mats,
                                cfg, g_rgb, g_depth, shadowmap=shadowmap, **kw)
    got = {"rig": _rig_grad(rig),
           "diffuse": table.diffuse.grad, "specular": table.specular.grad,
           "shininess": table.shininess.grad,
           **{k: v.grad for k, v in leaves.items()}, **{k: v.grad for k, v in tex.items()}}
    for k, g in got.items():
        _close_k6(g, want[k].to(dev), k)
    return got


@pytest.mark.parametrize("mode", ["plain", "textured", "map", "map_textured"])
def test_shade_bwd_kernel_matches_plain(gpu_scene, mode):
    """K8, in each of K2's four instantiations, against torch.autograd.grad
    of shade_hits_plain on the scene's rays and the free rays, with random
    upstream gradients of rgb and depth."""
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    kw = {}
    if "textured" in mode:
        kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)).cuda(),
                  envmap=torch.from_numpy(default_envmap(32, 64)).cuda())
    lights = LightRig.default()
    shadowmap = None
    cfg = RenderConfig()
    if mode.startswith("map"):
        cfg = RenderConfig(shadow="map")
        shadowmap = S.render_shadowmap(world, lights, resolution=(256, 256))
    got = _k8_against_plain(res, o, d, eye, lights, MaterialTable.default(), cfg, kw,
                            shadowmap)
    assert float(got["rig"].abs().sum()) > 0 and float(got["diffuse"].abs().sum()) > 0


def test_shade_bwd_kernel_one_row_table(gpu_scene):
    """Every hit on one table row (the hot slot of K8's row sums), textured."""
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)).cuda(),
              envmap=torch.from_numpy(default_envmap(32, 64)).cuda())
    got = _k8_against_plain(res, o, d, eye, LightRig.default(), _random_table(1), RenderConfig(),
                            kw, seed=1)
    assert float(got["shininess"].abs().sum()) > 0


@pytest.mark.parametrize("rows,where", [(40, "host"), (300, "card"), (65536, "card")])
def test_shade_kernel_wide_tables(gpu_scene, rows, where):
    """K2 with a table past the parameter block's 32 rows (its wide
    instantiation: the rows by pointer, read per hit through __ldg) against
    its plain version, ids spread over the table and past both ends; and K8
    on the same table."""
    res, o, d, eye = shade_batch(seed=rows)
    rng = np.random.default_rng(rows)
    res["material"] = rng.integers(-3, rows + 3, len(o)).astype(np.int32)
    dev = torch.device("cuda")
    tres = MarchResult(**{k: torch.from_numpy(v).to(dev) for k, v in res.items()})
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    mats = _random_table(rows, seed=rows)
    table = mats.to(dev) if where == "card" else mats
    cfg = RenderConfig(sky=(0.1, 0.2, 0.3))
    before = (SHADE_KERNEL.launches, SHADE_WIDE_KERNELS[(False, False)].launches)
    got = shade_hits(tres, o, d, eye, LightRig.default(), table, cfg)
    assert (SHADE_KERNEL.launches, SHADE_WIDE_KERNELS[(False, False)].launches) == (
        before[0], before[1] + 1)
    ref = shade_hits_plain(tres, o, d, torch.from_numpy(eye).to(dev), LightRig.default(),
                           mats, cfg)
    for k in ("rgb", "depth", "point", "normal"):
        bad = int(((got[k] - ref[k]).abs() > 1e-5 + 1e-4 * ref[k].abs()).sum())
        assert bad == 0, k
    _k8_against_plain(tres, o, d, eye, LightRig.default(), mats, cfg, {}, seed=rows)


def test_shade_card_rig_matches_host_rig(gpu_scene):
    """A rig of card tensors (by pointer, the wide instantiation) shades as
    the host rig (by value) does."""
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    kw = dict(atlas=torch.from_numpy(default_atlas(resolution=16)).cuda(),
              envmap=torch.from_numpy(default_envmap(32, 64)).cuda())
    counts = (SHADE_TEX_KERNEL, SHADE_WIDE_KERNELS[(False, True)])
    before = tuple(k.launches for k in counts)
    host = shade_hits(res, o, d, eye, LightRig.default(), MaterialTable.default(),
                      RenderConfig(), **kw)
    assert tuple(k.launches for k in counts) == (before[0] + 1, before[1])
    card = shade_hits(res, o, d, eye, LightRig.from_numpy(LightRig.default(), device="cuda"),
                      MaterialTable.default(), RenderConfig(), **kw)
    assert tuple(k.launches for k in counts) == (before[0] + 1, before[1] + 1)
    for k in ("rgb", "depth", "point", "normal"):
        assert torch.equal(host[k], card[k]), k


def test_shade_no_grad_path_launches_no_bwd(gpu_scene):
    """With nothing requiring grad, shade_hits launches K2 alone, outside
    autograd: no K8, no graph, nothing saved."""
    world, o, d, eye, _ = gpu_scene
    res = march(world, o, d, max_steps=512, device="cuda")
    def counts():
        return (SHADE_KERNEL.launches, sum(k.launches for k in SHADE_WIDE_KERNELS.values()),
                sum(k.launches for k in SHADE_BWD_KERNELS.values()))

    before = counts()
    out = shade_hits(res, o, d, eye, LightRig.default(), MaterialTable.default(device="cuda"),
                     RenderConfig())
    assert out["rgb"].grad_fn is None and not out["rgb"].requires_grad
    assert counts() == (before[0] + 1, before[1], before[2])
    rig = LightRig.from_numpy(LightRig.default(), device="cuda", requires_grad=True)
    with torch.no_grad():
        out = shade_hits(res, o, d, eye, rig, MaterialTable.default(), RenderConfig())
    assert out["rgb"].grad_fn is None


def _light_depth_exact(world, o, d, vp, resident):
    """K1's light-depth instantiation against K3 shadow_resolve of K1's hit
    record and against the plain composition, bit for bit."""
    before = (MARCH_KERNEL.launches, MARCH_DEPTH_KERNEL.launches)
    got = march_depth(world, o, d, vp[2], 512, assume_resident=resident, device="cuda")
    assert (MARCH_KERNEL.launches, MARCH_DEPTH_KERNEL.launches) == (before[0], before[1] + 1)
    res = march(world, o, d, 512, assume_resident=resident, device="cuda")
    torch.testing.assert_close(got, S.shadow_resolve(o, d, res.hit, res.t, vp), rtol=0, atol=0)
    torch.testing.assert_close(got, march_depth_plain(world, o, d, vp[2], 512,
                                                      assume_resident=resident),
                               rtol=0, atol=0)
    return res


@pytest.mark.parametrize("name", ["gpu_scene", *SCENES])
def test_light_depth_march_matches_resolve(gpu_scene, name):
    """On the light bundle of the scene's world and on the scene's own rays
    (with a light view-projection), with and without the residency test."""
    if name == "gpu_scene":
        world, o, d = gpu_scene[:3]
    else:
        world, o, d = _scene_on_card(name)
    lights = LightRig.default()
    origins, dirs, vp = S._bundle(world, lights, 64, 48, 1.1)
    for resident in (False, True):
        lres = _light_depth_exact(world, origins, dirs, vp, resident)
        _light_depth_exact(world, o, d, vp, resident)
    assert bool(lres.hit.any())
    depth, _ = S.render_shadowmap(world, lights, resolution=(64, 48))
    torch.testing.assert_close(depth.reshape(-1),
                               S.shadow_resolve(origins, dirs, *_hit_t(world, origins, dirs), vp),
                               rtol=0, atol=0)


def _hit_t(world, o, d):
    res = march(world, o, d, 512, device="cuda")
    return res.hit, res.t


@pytest.mark.parametrize("budget", [None, 40])
def test_segments_kernel_matches_plain(gpu_scene, budget):
    world, o, d, _, _ = gpu_scene
    before = SEGMENTS_KERNEL.launches
    kw = dict(max_segments=12, max_steps=256, step_budget=budget, steps_stride=8)
    got = sample_segments(world, o, d, device="cuda", **kw)
    ref = sample_segments_plain(world, o, d, **kw)
    assert SEGMENTS_KERNEL.launches == before + 1
    _exact(got, ref, ("slot", "t0", "t1", "count"))
    assert int(got.count.max()) >= 2


def _scene_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    o, d = (torch.from_numpy(x).cuda() for x in scene_rays(name))
    return scene_torch(name, "cuda"), o, d


@pytest.mark.parametrize("name", SCENES)
def test_scene_march_kernel_matches_plain(name):
    """K1, which reuses each ray's octree path from step to step, on the
    scenes built to break that (tests/test_torch_scenes.py): bit for bit
    equal to march_plain with and without the residency test, resumed from
    t_start mid-march and inside twigs, and with a budget."""
    world, o, d = _scene_on_card(name)
    for resident in (False, True):
        got = march(world, o, d, max_steps=512, steps_aov=True, assume_resident=resident,
                    device="cuda")
        ref = march_plain(world, o, d, 512, True, None, None, resident)
        _exact(got, ref, FIELDS)
    # resume: rays still live after a few steps from their current t, and
    # rays that hit a texel from just before it, inside its twig
    part = march_plain(world, o, d, 6, False, None, None, False, None, 16, True)
    mid = torch.isfinite(part.t) & ~part.hit
    full = march_plain(world, o, d, 512, False, None, None, False)
    in_twig = full.hit & (full.texel >= 0)
    t_start = torch.where(mid, part.t, torch.where(in_twig, full.t * 0.999, 0.0))
    live = (mid | in_twig).to(torch.int32)
    assert int(mid.sum()) > 10 and int(in_twig.sum()) > 10
    got = march(world, o, d, max_steps=512, steps_aov=True, t_start=t_start, live_start=live,
                device="cuda")
    ref = march_plain(world, o, d, 512, True, t_start, live, False)
    _exact(got, ref, FIELDS)
    budget = torch.arange(o.shape[0], device=o.device, dtype=torch.int32) % 97
    got = march(world, o, d, max_steps=128, step_budget=budget, steps_stride=8, device="cuda")
    ref = march_plain(world, o, d, 128, False, None, None, False, budget, 8, False)
    _exact(got, ref, FIELDS)


@pytest.mark.parametrize("name", SCENES)
def test_scene_segments_kernel_matches_plain(name):
    """K4 carries each ray's octree path across its phases and writes its
    rows through staged windows: equal to sample_segments_plain at K = 1, 32
    and 300 (many windows, the last one partial), with and without a
    budget."""
    world, o, d = _scene_on_card(name)
    for K in (1, 32, 300):
        assert segments_plan(K).cols <= K
        for budget in (None, 40):
            kw = dict(max_segments=K, max_steps=256, step_budget=budget, steps_stride=8)
            before = SEGMENTS_KERNEL.launches
            got = sample_segments(world, o, d, device="cuda", **kw)
            assert SEGMENTS_KERNEL.launches == before + 1
            _exact(got, sample_segments_plain(world, o, d, **kw), ("slot", "t0", "t1", "count"))


# Synthetic segment batches for K5/K6 (also held against JAX on the CPU in
# tests/test_torch_composite.py): name -> (N, K, P, share of segments on the
# 8 hot slots).  Every batch has N not a multiple of 32, invalid slots in
# the middle of rows and as trailing padding, and runs of one slot within a
# ray (across invalid segments too); "k1_p5" has P < 8, "k7_all_hot" every
# valid segment on the hot slots.
COMPOSITE_CASES = {
    "k1_p5": (45, 1, 5, 0.0),
    "k7_all_hot": (70, 7, 300, 1.0),
    "k33_mixed": (100, 33, 500, 0.4),
}


def composite_case(n, K, P, hot, seed=0):
    """(slot, t0, t1, density_raw, albedo_raw, bg, [g_rgb, g_depth,
    g_opacity, g_weights]) as numpy arrays made from ``seed``."""
    rng = np.random.default_rng(seed)
    slot = np.where(rng.uniform(size=(n, K)) < hot,
                    rng.integers(max(P - 8, 0), P, (n, K)), rng.integers(0, P, (n, K)))
    for k in range(1, K):                       # runs: repeat the previous slot
        rep = rng.uniform(size=n) < 0.5
        slot[rep, k] = slot[rep, k - 1]
    slot[rng.uniform(size=(n, K)) < 0.25] = -1  # invalid anywhere in a row
    count = rng.integers(0, K + 1, n)
    slot[np.arange(K)[None, :] >= count[:, None]] = -1
    t0 = np.cumsum(rng.uniform(0.0, 0.3, (n, K)), axis=1) + rng.uniform(0.0, 5.0, (n, 1))
    t1 = t0 + rng.uniform(-0.05, 0.3, (n, K))   # a few empty (t1 < t0) segments
    f32 = np.float32
    grads = [rng.normal(size=s).astype(f32) for s in ((n, 3), (n,), (n,), (n, K))]
    return (slot.astype(np.int32), t0.astype(f32), t1.astype(f32),
            rng.normal(0.0, 2.0, P).astype(f32), rng.normal(0.0, 1.0, (P, 3)).astype(f32),
            rng.uniform(0.0, 1.0, (n, 3)).astype(f32), grads)


def _scene_batch(gpu_scene):
    """K4's segments on the small scene, with noisy world params."""
    world, o, d, _, rng = gpu_scene
    segs = sample_segments(world, o, d, max_segments=16, device="cuda")
    p0 = init_params_from_world(world, solid_density=3.0)
    noise = [torch.from_numpy(rng.normal(0, 0.5, tuple(t.shape)).astype(np.float32)).cuda()
             for t in (p0.density_raw, p0.albedo_raw)]
    n, K = segs.slot.shape
    bg = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).cuda()
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
         for s in ((n, 3), (n,), (n,), (n, K))]
    return segs, VoxelParams(p0.density_raw + noise[0], p0.albedo_raw + noise[1]), bg, g


def _synthetic_batch(n, K, P, hot):
    arrays = composite_case(n, K, P, hot)
    slot, t0, t1, dr, ar, bg = (torch.from_numpy(x).cuda() for x in arrays[:6])
    g = [torch.from_numpy(x).cuda() for x in arrays[6]]
    segs = SegmentBatch(slot, t0, t1, (slot >= 0).sum(dim=1, dtype=torch.int32))
    return segs, VoxelParams(dr, ar), bg, g


def _k6_close(got, want):
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * max(scale, 1.0))


@pytest.mark.parametrize("case", ["scene", *COMPOSITE_CASES, "k300_scratch"])
def test_composite_kernels_match_plain(gpu_scene, case):
    """K5 and K6 against their plain versions: on K4's segments of the
    scene, on the synthetic batches, and at a K past the on-chip plan (K6's
    prefix sums in global scratch); K6 with all four upstream gradients and
    with rgb's alone (fit's path)."""
    if case == "scene":
        segs, p, bg, g = _scene_batch(gpu_scene)
    else:
        shape = (50, 300, 400, 0.3) if case == "k300_scratch" else COMPOSITE_CASES[case]
        segs, p, bg, g = _synthetic_batch(*shape)
    n, K = segs.slot.shape
    assert composite_plan(K, True).prefix_on_chip == (case != "k300_scratch")
    fb = (COMPOSITE_FWD_KERNEL.launches, COMPOSITE_BWD_KERNEL.launches)
    leaf = VoxelParams(p.density_raw.clone().requires_grad_(True),
                       p.albedo_raw.clone().requires_grad_(True))
    bgl = bg.clone().requires_grad_(True)
    out = composite(segs, leaf, sky_rgb=bgl)
    ref = composite_plain(segs.slot, segs.t0, segs.t1, p.density_raw, p.albedo_raw, bg)
    for k, r in zip(("rgb", "depth", "opacity", "weights"), ref):
        torch.testing.assert_close(out[k], r, rtol=1e-5, atol=1e-6, msg=k)
    torch.autograd.backward([out["rgb"], out["depth"], out["opacity"], out["weights"]], g)
    assert (COMPOSITE_FWD_KERNEL.launches, COMPOSITE_BWD_KERNEL.launches) == (fb[0] + 1,
                                                                           fb[1] + 1)
    want = composite_backward_plain(segs.slot, segs.t0, segs.t1, p.density_raw,
                                    p.albedo_raw, bg, 8192.0, *g)
    _k6_close((leaf.density_raw.grad, leaf.albedo_raw.grad, bgl.grad), want)
    # the fit path: rgb's gradient alone (K6 stages three arrays, not four)
    leaf = VoxelParams(p.density_raw.clone().requires_grad_(True),
                       p.albedo_raw.clone().requires_grad_(True))
    composite(segs, leaf, sky_rgb=bg)["rgb"].backward(g[0])
    assert COMPOSITE_BWD_KERNEL.launches == fb[1] + 2
    want = composite_backward_plain(segs.slot, segs.t0, segs.t1, p.density_raw,
                                    p.albedo_raw, bg, 8192.0, g[0], None, None, None)
    _k6_close((leaf.density_raw.grad, leaf.albedo_raw.grad), want[:2])


POOLS = ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree", "chunk_twig", "chunkcoordmin")


def _assert_worlds_equal(a: TorchWorld, b: TorchWorld):
    for k in POOLS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape, k
        assert torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32)), k


def _patch_both(ranges):
    """K7 on a CUDA world and patch_plain on a CPU one, the same batch of
    ``ranges`` [(target, dst, words)] laid out as plan lays out its own;
    returns both worlds and K7's launches."""
    w = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                       amplitude=16.0)
    ga, gw = w.to_device(device="cuda")
    _, cw = w.to_device(device="cpu")
    desc, words = layout([(t, d, np.asarray(seg).astype(np.int32)) for t, d, seg in ranges])
    batch = PatchBatch(desc=desc, words=words, chunks=0)
    check_batch(gw, batch.desc, batch.words.size)
    before = PATCH_KERNEL.launches
    patch(gw, batch.desc, ga.stage(batch, gw.device))
    torch.cuda.synchronize()
    launched = PATCH_KERNEL.launches - before
    patch_plain(cw, torch.from_numpy(batch.desc), torch.from_numpy(batch.words))
    return gw, cw, launched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_kernel_matches_plain(gpu_scene, seed):
    """K7 against patch_plain on random ranges, laid out by layout as
    plan's are: twig rows at several 64-word offsets (one ending at the
    pool's end), tree rows (one ending at the pool's end), long rows of many
    blocks' worth, and chunk-table rows."""
    rng = np.random.default_rng(seed)
    _, pools = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                              amplitude=16.0).to_device(device="cpu")
    n_twig, n_tree = pools.twig.numel() // 64, pools.tree.numel()
    twig_starts = sorted(rng.choice(np.arange(40, n_twig - 80, 40), size=5, replace=False))
    ranges = []
    for t0 in [0] + [int(t) for t in twig_starts]:
        k = int(rng.integers(1, 40))
        words = (rng.uniform(size=64 * k) < 0.5) * rng.integers(1, 7, 64 * k)
        ranges.append((TWIG, 64 * t0, words))
    ranges += [(TWIG, 64 * (n_twig - 3), rng.integers(0, 7, 64 * 3)),   # ends at the pool's end
               (TREE, n_tree - 9, rng.integers(0, 1 << 31, 9)),
               (TREE, 17, rng.integers(0, 1 << 31, min(n_tree - 40, 5000))),
               (CHUNK_BMIN, 3, np.float32([96.0, -32.0, 64.0]).view(np.int32)),
               (CHUNK_TREE, 2, np.int32([12345])),
               (CHUNK_TWIG, 3, np.int32([678]))]
    gw, cw, launched = _patch_both(ranges)
    assert launched == 1
    _assert_worlds_equal(gw, cw)


def test_patch_kernel_heads_tails_and_pieces(gpu_scene):
    """Tree rows at every destination mod 4 with lengths 1-9 (the scalar
    head and tail around the int4 words), and twig rows that cross piece
    boundaries, from a twig's start at several offsets."""
    rng = np.random.default_rng(4)
    ranges = [(TREE, 40 * (4 * n + k) + 8 + k, rng.integers(-(1 << 31), 1 << 31, n))
              for k in range(4) for n in range(1, 10)]
    t0 = 0
    for k, twigs in enumerate((PIECE_WORDS // 64 + 1, 2 * PIECE_WORDS // 64 + 5,
                               3 * PIECE_WORDS // 64 - 1)):
        t0 += 7 + k
        words = (rng.uniform(size=64 * twigs) < 0.3) * rng.integers(1, 1 << 20, 64 * twigs)
        words[64 * 2:64 * 3] = 0                  # an empty twig: occupancy 0
        ranges.append((TWIG, 64 * t0, words))
        t0 += twigs
    gw, cw, launched = _patch_both(ranges)
    assert launched == 1
    _assert_worlds_equal(gw, cw)


@pytest.mark.parametrize("extra", [0, 1])
def test_patch_kernel_row_cap(gpu_scene, extra):
    """A batch of exactly the largest row capacity goes in one launch, one
    more row in two; the pools equal patch_plain's either way."""
    n = ROW_CAPS[-1] + extra
    rng = np.random.default_rng(9 + extra)
    ranges = [(TREE, i, rng.integers(0, 1 << 30, 1)) for i in range(n)]
    gw, cw, launched = _patch_both(ranges)
    assert launched == len(launch_groups(n)) == 1 + extra
    _assert_worlds_equal(gw, cw)


def test_patch_kernel_growth_then_patch():
    """An edit that outgrows the pools (slack 1.0): the CUDA world grows,
    then K7 patches it; the pools equal the CPU path's (patch_plain), and
    a second batch on the grown pools does too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    w = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                       amplitude=16.0)
    wc = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
                        amplitude=16.0)
    ga, gw = w.to_device(slack=1.0, device="cuda")
    ca, cw = wc.to_device(slack=1.0, device="cpu")
    cap = ga.tree.capacity
    before = PATCH_KERNEL.launches
    box = ((0.3, 14.3, 0.7), (63.6, 30.2, 62.4))     # all four chunks, in open air
    gw = w.apply(ga, gw, w.build(*box, 2))
    cw = wc.apply(ca, cw, wc.build(*box, 2))
    assert ga.tree.capacity > cap and gw.tree.numel() == ga.tree.capacity
    assert gw.twig_occ.numel() == 2 * ga.twig.capacity
    _assert_worlds_equal(gw, cw)
    box = ((20.5, 2.5, 20.5), (44.5, 12.5, 44.5))
    gw = w.apply(ga, gw, w.destroy(*box))
    cw = wc.apply(ca, cw, wc.destroy(*box))
    torch.cuda.synchronize()
    assert PATCH_KERNEL.launches == before + 2
    _assert_worlds_equal(gw, cw)


# ---- the ray-sharded paths on a one-rank NCCL group -----------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group on cuda:0 (one card: the collectives run, no
    exchange between cards does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL runs only on the card)")
    created = not dist.is_initialized()
    init_distributed(local_address(), 1, 0, device="cuda")
    yield make_mesh("cuda")
    if created:
        dist.destroy_process_group()


def _launches():
    return (MARCH_KERNEL.launches, SHADE_KERNEL.launches, SEGMENTS_KERNEL.launches,
            COMPOSITE_FWD_KERNEL.launches, COMPOSITE_BWD_KERNEL.launches)


def test_sharded_render_and_march_equal_one_process(gpu_scene, nccl_mesh):
    """The same kernels on the same rays: bit for bit, with K1 and K2 once a
    call (K1 twice with ray shadows) and once a group of the tiled frame."""
    world, o, d, eye, _ = gpu_scene
    n = o.shape[0]
    for cfg, k1 in ((RenderConfig(), 1), (RenderConfig(shadow="ray"), 2)):
        before = _launches()
        got = render_sharded(nccl_mesh, world, o, d, eye, cfg=cfg)
        torch.cuda.synchronize()
        assert _launches()[:2] == (before[0] + k1, before[1] + 1)
        assert torch.equal(got, render(world, o, d, eye, cfg=cfg)["rgb"]), cfg.shadow
    tile = 1000
    before = _launches()
    frame = render_frame_sharded(nccl_mesh, world, o, d, eye, tile=tile)
    torch.cuda.synchronize()
    groups = -(-n // tile)
    assert _launches()[:2] == (before[0] + groups, before[1] + groups)
    assert torch.equal(frame, render(world, o, d, eye)["rgb"])
    hit, t, mat = march_sharded(nccl_mesh, world, o, d)
    ref = march(world, o, d, 512)
    assert torch.equal(hit, ref.hit) and torch.equal(mat, ref.material)
    assert torch.equal(t.view(torch.int32), ref.t.view(torch.int32))


class _RecordingAdam(torch.optim.Adam):
    """Adam that keeps a copy of the gradients its last step was given."""

    def step(self, closure=None):
        self.seen = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def test_sharded_step_modes_agree(gpu_scene, nccl_mesh, monkeypatch):
    """Blocking, overlapped and ZeRO steps on the card: grad_tiles launches
    of K4, K5 and K6 a step and nothing else, the overlapped step's
    all-reduces asynchronous, falling losses, and step 1's gradients within
    K6's tolerance of the blocking step's (|g - gb| <= 1e-3|gb| + 1e-5
    max|gb|, as chip_smoke.py holds K6), its params within that tolerance
    carried through Adam's first update lr*g/(|g| + eps)."""
    world, o, d, eye, _ = gpu_scene
    target = render(world, o, d, eye)["rgb"]
    params0 = init_params_from_world(world)
    lr, K, tiles = 0.05, 16, 4
    opt = functools.partial(_RecordingAdam, lr=lr)
    calls = []
    inner = dist.all_reduce

    def counted(tensor, *args, async_op=False, **kwargs):
        calls.append(bool(async_op))
        return inner(tensor, *args, async_op=async_op, **kwargs)

    monkeypatch.setattr(dist, "all_reduce", counted)
    init_zero, zero_step = make_zero_train_step(nccl_mesh, world, opt, K, tiles)
    modes = (("blocking", make_sharded_train_step(nccl_mesh, world, opt, K, False, tiles), None),
             ("overlap", make_sharded_train_step(nccl_mesh, world, opt, K, True, tiles), None),
             ("zero", zero_step, init_zero(params0)))
    runs = {}
    for name, step, state in modes:
        calls.clear()
        before = _launches()
        p1, state, loss1 = step(params0, state, world, o, d, target)
        seen = state.seen
        _, state, loss2 = step(p1, state, world, o, d, target)
        torch.cuda.synchronize()
        grew = tuple(a - b for a, b in zip(_launches(), before))
        assert grew == (0, 0, 2 * tiles, 2 * tiles, 2 * tiles), name
        n_async = 2 * tiles if name == "overlap" else 0
        n_block = {"blocking": 3, "overlap": 1, "zero": 1}[name]
        assert sorted(calls) == sorted([True] * 2 * n_async + [False] * 2 * n_block), name
        assert np.isfinite([float(loss1), float(loss2)]).all() and float(loss2) < float(loss1)
        runs[name] = (float(loss1), p1, seen)
    lb, pb, gb = runs["blocking"]
    for name in ("overlap", "zero"):
        loss, p, g = runs[name]
        assert abs(loss - lb) <= 1e-5 * abs(lb), name
        for a, b, pa, pbl in zip(g, gb, (p.density_raw, p.albedo_raw),
                                 (pb.density_raw, pb.albedo_raw)):
            scale = float(b.abs().max())
            assert bool(((a - b).abs() <= 1e-3 * b.abs() + 1e-5 * scale).all()), name
            lim = lr * (1e-3 + 1e-5 * scale / (b.abs() + 1e-8))
            assert bool(((pa - pbl).abs() <= lim).all()), name


def test_entry_and_dryrun_on_the_card(nccl_mesh):
    """entry()'s frame on the card within K2's tolerance of the plain one
    (1e-5 + 1e-4|plain|, as test_shade_kernel_matches_plain), and
    dryrun_multichip(1) on the one-rank group."""
    fn, args = entry.entry()
    got = fn(*args)
    assert got.is_cuda and tuple(got.shape) == (64 * 64, 3)
    cfn, cargs = entry.entry(device="cpu")
    want = cfn(*cargs)
    assert bool(((got.cpu() - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())
    out = entry.dryrun_multichip(1)
    assert out["rgb"].is_cuda and np.isfinite(list(out["losses"].values())).all()


def test_guards_on_the_card(gpu_scene):
    """march_checked equals march; a NaN direction raises before K1
    launches; composite_checked passes K4's segments and flags bad slots."""
    world, o, d, _, _ = gpu_scene
    got = march_checked(world, o, d)
    ref = march(world, o, d)
    for k in ("hit", "t", "material", "texel", "cell_bmin", "cell_size"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    bad = d.clone()
    bad[3, 1] = float("nan")
    before = MARCH_KERNEL.launches
    with pytest.raises(GuardError, match="march: non-finite ray direction"):
        march_checked(world, o, bad)
    assert MARCH_KERNEL.launches == before
    segs = sample_segments(world, o, d, 8)
    params = init_params_from_world(world)
    assert torch.isfinite(composite_checked(segs, params)["rgb"]).all()
    wrong = SegmentBatch(torch.where(segs.slot >= 0, segs.slot + params.num_slots, segs.slot),
                         segs.t0, segs.t1, segs.count)
    with pytest.raises(GuardError, match="composite: segment slot out of range"):
        composite_checked(wrong, params)
