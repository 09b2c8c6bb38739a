"""Scripted engine session on the port — the app-layer analog of the
reference's interactive loop (src/Main.cpp:68-262: fly camera, x/z/c edits
at the picked cursor, g LOD swap, 1-6 world shifts, HUD), driven as a
deterministic script: orbit the camera over a generated world, render each
frame with ray shadows, the atlas and the sky map, pick the surface under
the view ray and carve/build/replace there, swap a chunk for its LOD, stream
the world, and write every frame as PNG plus per-frame metrics to JSONL.
The counterpart of the repository's demo.py for the JAX package.

Usage:  python -m octree_raymarcher_tpu_torch.demo [--frames N] [--out DIR]
            [--res WxH] [--dims WxHxD] [--depth D] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .core.chunk import Dirty
from .shade import PerspectiveCamera, RenderConfig, default_atlas, default_envmap, render_frame
from .utils.metrics import MetricsLogger
from .utils.png import save_png
from .world.alloc import WorldAllocator
from .world.device import TorchWorld, resolve_device
from .world.lod import lod
from .world.pick import cursor_box, pick
from .world.world import World

MATERIALS = (2, 3, 4, 5)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def orbit_camera(w: World, i: int, frames: int, width: int, height: int) -> PerspectiveCamera:
    """Frame ``i`` of the orbit around the world's centre, looking in."""
    cs = w.chunksize
    dims = w.dims
    cx, cz = dims[0] * cs / 2, dims[2] * cs / 2
    radius = max(dims[0], dims[2]) * cs * 0.9
    ang = 2 * math.pi * i / max(frames, 1)
    eye = (cx + radius * math.cos(ang), dims[1] * cs * 0.55, cz + radius * math.sin(ang))
    # camera convention: forward = (sin yaw, 0, cos yaw) at pitch 0
    yaw = math.degrees(math.atan2(cx - eye[0], cz - eye[2]))
    return PerspectiveCamera(position=eye, yaw_deg=yaw, pitch_deg=-25.0, fov_deg=70.0,
                             width=width, height=height)


def run_session(w: World, wa: WorldAllocator, world: TorchWorld, frames: int = 12,
                res: tuple = (320, 180), out: str | None = None, device="cuda",
                on_batch=None) -> dict:
    """Run the scripted session on ``world`` (packed from ``w`` by ``wa``).

    Every frame renders ``render_frame(shadow="ray", atlas, envmap)``; every
    3rd frame (i % 3 == 1) picks mid-screen with ``cursor_scale=6`` and
    applies destroy, build or replace there; frame ``frames // 2`` swaps the
    chunk under the world's centre for its LOD; frame ``frames - 3`` shifts
    the world one chunk along +x; the end saves the world (with ``out``,
    which also receives a PNG per frame and ``metrics.jsonl``).  Each pool
    patch is one batch; ``on_batch(kind, batch, world)`` is called after
    each, the device synchronised.  Returns the final world and the host
    times (s): ``frame_s`` (render + synchronize), ``pick_s``, ``batches``
    [(kind, PatchBatch, apply_s)], ``lod_s``, ``shift_s`` and ``save_s``."""
    dev = resolve_device(device)
    width, height = res
    if out:
        os.makedirs(out, exist_ok=True)
    log = MetricsLogger(os.path.join(out, "metrics.jsonl") if out else None)
    cfg = RenderConfig(shadow="ray")
    atlas = torch.from_numpy(default_atlas(resolution=32)).to(dev)
    envmap = torch.from_numpy(default_envmap(64, 128)).to(dev)
    cs = w.chunksize
    centre = (w.dims[0] * cs / 2, 10.0, w.dims[2] * cs / 2)
    stats = {"frame_s": [], "pick_s": [], "batches": [], "lod_s": None, "shift_s": None,
             "save_s": None}

    def patched(kind, fn, **fields):
        nonlocal world
        t0 = time.perf_counter()
        world = fn()
        _sync(dev)
        dt = time.perf_counter() - t0
        batch = wa.last_batch
        if batch is None:
            return
        stats["batches"].append((kind, batch, dt))
        log.log(kind, apply_s=dt, chunks=batch.chunks, descriptors=int(batch.desc.shape[0]),
                words=batch.words_written, **fields)
        if on_batch is not None:
            on_batch(kind, batch, world)

    for i in range(frames):
        cam = orbit_camera(w, i, frames, width, height)
        o, d = cam.rays()
        eye = np.asarray(cam.position, dtype=np.float32)
        t0 = time.perf_counter()
        rgb = render_frame(world, o, d, eye, cfg=cfg, atlas=atlas, envmap=envmap,
                           device=dev)["rgb"]
        _sync(dev)
        dt = time.perf_counter() - t0
        stats["frame_s"].append(dt)
        log.counter("frame_s").add(dt)
        log.log("frame", i=i, seconds=dt, rays=width * height,
                rays_per_s=width * height / dt)
        if out:
            save_png(os.path.join(out, f"frame_{i:03d}.png"),
                     rgb.cpu().numpy().reshape(height, width, 3))

        # Every 3rd frame: pick the surface mid-screen and edit there
        # (reference keys x/z/c at the ImaginaryCube cursor).
        if i % 3 == 1:
            t0 = time.perf_counter()
            p = pick(w, eye, d.reshape(height, width, 3)[height // 2, width // 2],
                     cursor_scale=6.0)
            stats["pick_s"].append(time.perf_counter() - t0)
            if p is not None:
                bmin, bmax = cursor_box(p)
                op = ("destroy", "build", "replace")[(i // 3) % 3]
                mat = MATERIALS[(i // 3) % len(MATERIALS)]
                if op == "destroy":
                    edits = w.destroy(bmin, bmax)
                elif op == "build":
                    edits = w.build(bmin, bmax + 8.0, mat)
                else:
                    edits = w.replace(bmin, bmax, mat)
                patched("edit", lambda: w.apply(wa, world, edits), op=op,
                        box=[bmin.tolist(), np.asarray(bmax).tolist()])

        # Mid-way: LOD-swap the chunk under the centre (reference key g).
        if i == frames // 2:
            ci = w.index(*w.index_float(centre))
            t0 = time.perf_counter()
            w.chunks[ci] = lod(w.chunks[ci])
            stats["lod_s"] = time.perf_counter() - t0
            patched("lod", lambda: wa.modify(world, ci, w.chunks[ci], Dirty(realloc=True),
                                             Dirty(realloc=True)),
                    chunk=ci, lod_s=stats["lod_s"])

        # Late: stream the world one chunk +x (reference keys 1-6).
        if i == frames - 3:
            t0 = time.perf_counter()
            touched = w.shift(0, +1)
            stats["shift_s"] = time.perf_counter() - t0
            patched("shift", lambda: w.apply_shift(wa, world, touched), axis=0,
                    shift_s=stats["shift_s"])

    if out:
        t0 = time.perf_counter()
        w.save(os.path.join(out, "world.npz"))
        stats["save_s"] = time.perf_counter() - t0
    log.log("done", occupancy=wa.occupancy(), frames=frames,
            frame=log.counter("frame_s").stats())
    log.close()
    stats["world"] = world
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--res", default="320x180")
    ap.add_argument("--dims", default="2x2x2")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--platform", default="default", choices=("default", "cpu"),
                    help="accepted for callers of the JAX demo: cpu is --device cpu")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    width, height = (int(v) for v in args.res.split("x"))
    dims = tuple(int(v) for v in args.dims.split("x"))
    device = "cpu" if args.platform == "cpu" else args.device
    resolve_device(device)

    w = World.generate(dims=dims, chunksize=64.0, depth=args.depth, seed=0,
                       water_level=6.0, amplitude=32.0)
    wa, world = w.to_device(device=device)
    stats = run_session(w, wa, world, args.frames, (width, height), out=args.out,
                        device=device)
    print(json.dumps({"frames": args.frames,
                      "avg_frame_s": round(float(np.mean(stats["frame_s"])), 4),
                      "batches": len(stats["batches"]), "out": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
