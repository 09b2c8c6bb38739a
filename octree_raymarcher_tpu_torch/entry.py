"""Entry points of the port, the counterparts of the repository's
``__graft_entry__.py``.

entry(device)             -> (fn, example_args): the forward pass of the
                             flagship VoxelScene (hard render: K1 march + K2
                             shade) on the 64x64 demo frame.
dryrun_multichip(n, dev)  -> on the initialised process group of ``n``
                             ranks: the sharded render, the blocking,
                             overlapped and ZeRO train steps, the
                             ``cfg.tile=8`` frame and the stage-compacted
                             sharded march, one call each on tiny shapes
                             (steps 1-6 of the reference's dryrun).

    python -m octree_raymarcher_tpu_torch.entry [--device cpu]

runs ``entry()``'s fn, then ``dryrun_multichip`` on a one-rank group it
creates (NCCL on ``cuda``, gloo on ``cpu``) when none exists.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch
import torch.distributed as dist

from .models.scene import VoxelScene
from .parallel.mesh import init_distributed, local_address, make_mesh
from .parallel.render_sharded import (
    make_sharded_train_step,
    make_zero_train_step,
    march_sharded_compact,
    pad_rays,
    render_sharded,
)
from .shade.camera import OrthoCamera, PerspectiveCamera
from .shade.render import RenderConfig, render
from .world.device import resolve_device, to_device


def _demo_scene(size=16.0, depth=4, seed=3, device="cuda"):
    return VoxelScene.demo(chunk_size=size, depth=depth, seed=seed, device=device)


def entry(device="cuda"):
    dev = resolve_device(device)
    scene = _demo_scene(device=dev)
    cam = PerspectiveCamera(
        position=(8.0, 12.0, -4.0), pitch_deg=-35.0, fov_deg=70.0, width=64, height=64
    )
    origins, dirs = cam.rays()
    eye = torch.tensor(cam.position, dtype=torch.float32, device=dev)

    def fn(world, origins, dirs):
        return render(world, origins, dirs, eye, scene.lights, scene.materials, scene.cfg,
                      device=world.device)["rgb"]

    return fn, (scene.world, to_device(origins, dev), to_device(dirs, dev))


def _check_loss(name: str, loss: torch.Tensor) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise RuntimeError(f"dryrun_multichip: {name} loss is not finite ({value})")
    return value


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Steps 1-6 of the reference's dryrun on the initialised group, which
    must have ``n_devices`` ranks.  Returns the rgb of steps 1 and 5, the
    three steps' losses and step 6's per-rank executed lanes; raises if a
    loss is not finite or an output has another shape."""
    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip needs an initialised process group "
                           "(parallel.mesh.init_distributed)")
    mesh = make_mesh(device)
    if mesh.size != n_devices:
        raise ValueError(f"need a group of {n_devices} ranks, have {mesh.size}")

    scene = _demo_scene(size=16.0, depth=4, device=mesh.device)
    cam = OrthoCamera(
        position=(8.0, 24.0, 8.0), direction=(0, -1, 0), up=(0, 0, 1),
        width=15.0, height=15.0, xres=16, yres=n_devices * 2,
    )
    origins, dirs = cam.rays()
    origins, dirs, _ = pad_rays(origins, dirs, n_devices)
    n = origins.shape[0]
    eye = (8.0, 24.0, 8.0)

    # 1) sharded forward render
    rgb = render_sharded(mesh, scene.world, origins, dirs, eye)

    # 2) full sharded train step: per-rank segment sampling + compositing
    #    grads, all-reduced over the ranks, replicated Adam update.
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    targets = np.zeros((n, 3), dtype=np.float32)
    train_step = make_sharded_train_step(mesh, scene.world, opt, max_segments=4)
    _, _, loss = train_step(scene.params, None, scene.world, origins, dirs, targets)
    losses = {"blocking": _check_loss("blocking", loss)}

    # 3) overlapped gradient reduction: one async all_reduce per tile.
    step_olap = make_sharded_train_step(mesh, scene.world, opt, max_segments=4, overlap=True,
                                        grad_tiles=2)
    _, _, loss = step_olap(scene.params, None, scene.world, origins, dirs, targets)
    losses["overlap"] = _check_loss("overlap", loss)

    # 4) ZeRO: per-tile reduce_scatter + sharded optimizer + all_gather.
    init_zero, step_zero = make_zero_train_step(mesh, scene.world, opt, max_segments=4,
                                                grad_tiles=2)
    _, _, loss = step_zero(scene.params, init_zero(scene.params), scene.world, origins, dirs,
                           targets)
    losses["zero"] = _check_loss("zero", loss)

    # 5) the frame with cfg.tile below the shard width (accepted, ignored).
    cfgf = RenderConfig(shadow="none", max_steps=64, tile=8)
    rgb_tile = render_sharded(mesh, scene.world, origins, dirs, eye, cfg=cfgf)
    for name, out in (("render_sharded", rgb), ("tile=8 frame", rgb_tile)):
        if tuple(out.shape) != (n, 3):
            raise RuntimeError(f"dryrun_multichip: {name} gave {tuple(out.shape)}, "
                               f"want ({n}, 3)")

    # 6) the stage-compacted march on the mesh: each rank compacts its own
    #    rays, and reports its executed lanes.
    hit, t, _, executed = march_sharded_compact(mesh, scene.world, origins, dirs, max_steps=64,
                                                tile=16)
    if tuple(executed.shape) != (n_devices,) or tuple(t.shape) != (n,):
        raise RuntimeError(f"dryrun_multichip: march_sharded_compact gave t "
                           f"{tuple(t.shape)} and executed {tuple(executed.shape)}, want "
                           f"({n},) and ({n_devices},)")
    return {"rgb": rgb, "rgb_tile": rgb_tile, "losses": losses, "executed": executed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print("entry ok:", tuple(fn(*example).shape))
    created = not dist.is_initialized()
    if created:
        init_distributed(local_address(), 1, 0, device=args.device)
    try:
        n = dist.get_world_size()
        out = dryrun_multichip(n, args.device)
        print(f"dryrun_multichip({n}) ok: losses {out['losses']}")
    finally:
        if created:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
