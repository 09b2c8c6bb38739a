"""Command-line entry of the port: the app-layer surface of the engine.

The counterpart of ``python -m octree_raymarcher_tpu``, with the same
subcommands, world flags and JSON lines:

  python -m octree_raymarcher_tpu_torch render  --out frame.png [world/camera flags]
  python -m octree_raymarcher_tpu_torch demo    [--frames N --out DIR]   (scripted session)
  python -m octree_raymarcher_tpu_torch fit     [--out DIR --steps N]    (inverse rendering)
  python -m octree_raymarcher_tpu_torch info                              (world/memory report)

Common world flags: --dims AxBxC --chunksize S --depth D --seed N --water L
--amplitude A --device cuda|cpu.  ``--device`` takes the place of the
reference's ``--platform``: ``cuda`` (the default) runs the CUDA kernels and
fails without a card, ``cpu`` runs the plain PyTorch versions.  ``render
--compact`` renders with the stage-compacted march (``render_frame(compact=
True)``) and adds its ``lane_iters`` to the JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def _add_world_args(ap):
    ap.add_argument("--dims", default="2x2x2")
    ap.add_argument("--chunksize", type=float, default=64.0)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--water", type=float, default=6.0)
    ap.add_argument("--amplitude", type=float, default=32.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))


def _setup(args):
    """(host World, its allocator, its tensors on the device)."""
    from .world.device import resolve_device
    from .world.world import World

    dev = resolve_device(args.device)
    dims = tuple(int(v) for v in args.dims.split("x"))
    w = World.generate(dims=dims, chunksize=args.chunksize, depth=args.depth, seed=args.seed,
                       water_level=args.water, amplitude=args.amplitude)
    wa, world = w.to_device(device=dev)
    return w, wa, world


def _device_name(world) -> str:
    import torch

    dev = world.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def cmd_render(args):
    import numpy as np

    from .shade.camera import PerspectiveCamera
    from .shade.render import RenderConfig, render_frame
    from .utils.png import save_png

    t0 = time.time()
    w, _, world = _setup(args)
    width, height = (int(v) for v in args.res.split("x"))
    ext = [d * args.chunksize for d in w.dims]
    pos = ((ext[0] * 0.5, ext[1] * 0.9, -0.6 * ext[2]) if args.camera is None
           else tuple(float(v) for v in args.camera.split(",")))
    cam = PerspectiveCamera(position=pos, yaw_deg=args.yaw, pitch_deg=args.pitch,
                            fov_deg=args.fov, width=width, height=height)
    o, d = cam.rays()
    cfg = RenderConfig(shadow=args.shadow, max_steps=args.max_steps)
    out = render_frame(world, o, d, np.asarray(cam.position, dtype=np.float32), cfg=cfg,
                       compact=args.compact, device=world.device)
    rgb = np.clip(out["rgb"].cpu().numpy().reshape(height, width, 3), 0, 1)
    save_png(args.out, (rgb * 255).astype(np.uint8))
    hit = float(out["hit"].float().mean())
    line = {"out": args.out, "res": args.res, "shadow": args.shadow,
            "hit_frac": round(hit, 3), "seconds": round(time.time() - t0, 1),
            "device": _device_name(world)}
    if args.compact:
        line["lane_iters"] = int(out["lane_iters"])
    print(json.dumps(line))


def cmd_info(args):
    w, wa, _ = _setup(args)
    rep = w.memory_report()
    rep["allocator"] = wa.occupancy()
    print(json.dumps(rep, indent=1, default=str))


def cmd_demo(args):
    from . import demo

    demo.main(["--frames", str(args.frames), "--out", args.out, "--res", args.res,
               "--dims", args.dims, "--depth", str(args.depth), "--device", args.device])


def cmd_fit(args):
    from . import bench_fit

    bench_fit.main(["--steps", str(args.steps), "--res", str(args.res_fit),
                    "--device", args.device, "--dir", args.out])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="octree_raymarcher_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render one frame to PNG")
    _add_world_args(r)
    r.add_argument("--out", default="frame.png")
    r.add_argument("--res", default="640x360")
    r.add_argument("--camera", default=None,
                   help="x,y,z eye position (default: above world center)")
    r.add_argument("--yaw", type=float, default=0.0)
    r.add_argument("--pitch", type=float, default=-25.0)
    r.add_argument("--fov", type=float, default=70.0)
    r.add_argument("--shadow", default="map", choices=("none", "ray", "map"))
    r.add_argument("--max-steps", type=int, default=512)
    r.add_argument("--compact", action="store_true",
                   help="stage-compacted march schedule (ops/march_compact)")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="world + allocator memory report")
    _add_world_args(i)
    i.set_defaults(fn=cmd_info)

    dm = sub.add_parser("demo", help="scripted engine session (demo.py)")
    _add_world_args(dm)
    dm.add_argument("--frames", type=int, default=12)
    dm.add_argument("--out", default="demo_out")
    dm.add_argument("--res", default="320x180")
    dm.set_defaults(fn=cmd_demo)

    f = sub.add_parser("fit", help="inverse-rendering convergence run (bench_fit.py)")
    _add_world_args(f)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--res-fit", type=int, default=128)
    f.add_argument("--out", default="fit_out", help="directory of the record and PNGs")
    f.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
