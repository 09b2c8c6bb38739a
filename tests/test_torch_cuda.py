"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided in
the fixture, not at import).  The file imports neither JAX nor the JAX
package, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Both kernels are built with -fmad=false, so the march agrees bit for bit and
the shading to within libm ulps (tolerance as in chip_smoke.py)."""

import numpy as np
import pytest
import torch

from octree_raymarcher_tpu_torch.ops.march import MARCH_KERNEL, march, march_plain
from octree_raymarcher_tpu_torch.shade import (
    LightRig,
    MaterialTable,
    PerspectiveCamera,
    RenderConfig,
    default_atlas,
    default_envmap,
    shade_hits,
    shade_hits_plain,
)
from octree_raymarcher_tpu_torch.shade.render import SHADE_KERNEL
from octree_raymarcher_tpu_torch.world.world import World

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
    before = SHADE_KERNEL.launches
    got = shade_hits(res, o, d, eye, lights, mats, cfg, **kw)
    ref = shade_hits_plain(res, o, d, eye, lights, mats, cfg, **kw)
    assert SHADE_KERNEL.launches == before + 1
    for k in ("rgb", "depth", "point", "normal"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)
