"""Inverse-rendering convergence run on the port: the twin of the
repository's bench_fit.py (the JAX package's fit record).

Protocol, as there: optimize per-voxel density and albedo (the soft
renderer's parameters, diff/) from ``FIT_VIEWS`` target views of 8 cameras
orbiting the golden-test world scaled up one depth (2x1x2 chunks of 32,
depth 6, seed 7), with Adam (lr 0.05, K = 32 segments a ray), and record
the loss and PSNR path.

* Targets are soft-rendered under the ground-truth parameters
  (``FIT_TARGETS=soft``), or rendered by the hard march (first hit's
  material diffuse, the sky on a miss; ``FIT_TARGETS=hard``).
* The start perturbs the ground truth (albedo re-drawn, solids half
  transparent; ``FIT_INIT=perturb``) or carries none of it
  (``FIT_INIT=scratch``).  Its random numbers are the reference's:
  ``jax.random.split(PRNGKey(FIT_SEED))`` and ``jax.random.normal``, drawn
  by the numpy copy of that generator in utils/threefry.py, so both
  packages start from the same parameters.
* The fit's wall time includes the read back of the loss history.

Knobs, each an environment variable and a flag of :func:`main`:
``FIT_STEPS`` / ``--steps`` (200), ``FIT_RES`` / ``--res`` (256),
``FIT_VIEWS`` / ``--views`` (8), ``FIT_SEED`` / ``--seed`` (0),
``FIT_INIT`` / ``--init``, ``FIT_TARGETS`` / ``--targets``, ``FIT_OUT`` /
``--out`` (the JSON's bare file name, bench_fit_result.json), ``FIT_DEVICE`` /
``--device`` (cuda, or cpu for a small run: ``FIT_RES`` <= 64 advised) and
``--dir``, the directory the JSON and the view-0 PNGs go to (fit_out; never
the repository root, which holds the JAX package's records).  The record
names the card and its power limit (nvidia-smi).

Usage:  python -m octree_raymarcher_tpu_torch.bench_fit [--steps N] [--dir DIR] ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .diff import fit, init_params_from_world, render_soft
from .diff.composite import VoxelParams
from .ops.march import march
from .shade.camera import PerspectiveCamera
from .shade.materials import MaterialTable
from .utils import threefry
from .utils.png import save_png
from .world.device import resolve_device
from .world.world import World

K = 32
SKY = (0.45, 0.65, 0.95)
REPO_ROOT = Path(__file__).resolve().parent.parent


def note(msg: str) -> None:
    print(f"# bench_fit: {msg}", file=sys.stderr, flush=True)


def fit_world(device):
    """The fit's world packed as the reference packs it (an allocator with
    slack 1.5, so the parameter slots are the same), on ``device``."""
    w = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=6, seed=7, water_level=4.0,
                       amplitude=16.0)
    return w.to_device(device=device)[1]


def cameras(res: int, n_views: int) -> list:
    """``n_views`` cameras orbiting the world's centre, looking in and down."""
    cx, cy_, cz = 32.0, 10.0, 32.0
    radius = 55.0
    cams = []
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        px, pz = cx + radius * np.sin(th), cz + radius * np.cos(th)
        py = 38.0
        yaw = np.degrees(np.arctan2(cx - px, cz - pz))
        horiz = np.hypot(cx - px, cz - pz)
        pitch = np.degrees(np.arctan2(cy_ - py, horiz))
        cams.append(PerspectiveCamera(position=(px, py, pz), yaw_deg=float(yaw),
                                      pitch_deg=float(pitch), fov_deg=60.0, width=res,
                                      height=res))
    return cams


def target_views(world, gt: VoxelParams, cams: list, target_mode: str, device) -> list:
    """[(origins, dirs, target rgb)] on ``device``: soft renders under the
    ground truth, or the hard march's first-hit diffuse with the sky."""
    dev = torch.device(device)
    diffuse = MaterialTable.default().diffuse.to(dev)
    sky = torch.tensor(SKY, dtype=torch.float32, device=dev)
    views = []
    for cam in cams:
        o, d = (torch.from_numpy(a).to(dev) for a in cam.rays())
        with torch.no_grad():
            if target_mode == "hard":
                r = march(world, o, d, 512, device=dev)
                col = diffuse[r.material.clamp(0, diffuse.shape[0] - 1).long()]
                target = torch.where(r.hit[:, None], col, sky)
            else:
                target = render_soft(world, gt, o, d, max_segments=K, device=dev)["rgb"]
        views.append((o, d, target))
    return views


def start_params(gt: VoxelParams, seed: int, init_mode: str) -> VoxelParams:
    """The reference's starting parameters from ``seed``: albedo re-drawn
    as 1.5 N(0, 1); density the ground truth less 3 plus 0.1 N(0, 1)
    (``perturb``) or -3 plus that noise (``scratch``)."""
    k0, k1 = threefry.split(threefry.prng_key(seed))
    dev = gt.density_raw.device
    n_alb = torch.from_numpy(threefry.normal(k0, tuple(gt.albedo_raw.shape))).to(dev)
    n_den = torch.from_numpy(threefry.normal(k1, tuple(gt.density_raw.shape))).to(dev)
    albedo = 1.5 * n_alb
    if init_mode == "scratch":
        density = torch.full_like(gt.density_raw, -3.0) + 0.1 * n_den
    else:
        density = gt.density_raw - 3.0 + 0.1 * n_den
    return VoxelParams(density_raw=density, albedo_raw=albedo)


def card_record(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's "cpu"."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": limit}


def _args(argv):
    env = os.environ.get
    ap = argparse.ArgumentParser(prog="octree_raymarcher_tpu_torch.bench_fit")
    ap.add_argument("--steps", type=int, default=int(env("FIT_STEPS", "200")))
    ap.add_argument("--res", type=int, default=int(env("FIT_RES", "256")))
    ap.add_argument("--views", type=int, default=int(env("FIT_VIEWS", "8")))
    ap.add_argument("--seed", type=int, default=int(env("FIT_SEED", "0")))
    ap.add_argument("--init", default=env("FIT_INIT", "perturb"), choices=("perturb", "scratch"))
    ap.add_argument("--targets", default=env("FIT_TARGETS", "soft"), choices=("soft", "hard"))
    ap.add_argument("--out", default=env("FIT_OUT", "bench_fit_result.json"))
    ap.add_argument("--device", default=env("FIT_DEVICE", "cuda"))
    ap.add_argument("--dir", default="fit_out")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the fit; write the JSON record and the view-0 PNGs into
    ``--dir``; print the summary line; return the record."""
    args = _args(argv)
    out_dir = Path(args.dir).resolve()
    if out_dir == REPO_ROOT:
        raise ValueError("the repository root holds the JAX package's fit records; "
                         "give the port's run another --dir")
    if Path(args.out).name != args.out:
        raise ValueError(f"--out/FIT_OUT is a file name inside --dir, not a path: {args.out!r}")
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = resolve_device(args.device)

    t_all = time.time()
    note("building world")
    world = fit_world(dev)
    cams = cameras(args.res, args.views)
    gt = init_params_from_world(world, solid_density=40.0)
    note(f"rendering {args.views} {args.targets} target views at {args.res}x{args.res}")
    views = target_views(world, gt, cams, args.targets, dev)
    start = start_params(gt, args.seed, args.init)

    note(f"fitting: {args.steps} Adam steps over {args.views} views "
         f"({args.res * args.res * args.views} rays, {gt.num_slots} slots)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    fitted, history = fit(world, views, start, steps=args.steps, lr=0.05, max_segments=K,
                          device=dev)
    t_fit = time.time() - t0        # includes the read back of the loss history
    note(f"fit done: {t_fit:.1f}s ({args.steps / t_fit:.2f} steps/s) "
         f"loss {history[0]:.5f} -> {history[-1]:.6f}")

    stem = args.out[:-5] if args.out.endswith(".json") else args.out
    stem = stem.replace("_result", "")
    psnrs = []
    with torch.no_grad():
        for i, (o, d, target) in enumerate(views):
            out = render_soft(world, fitted, o, d, max_segments=K, device=dev)["rgb"]
            mse = float(torch.mean((out - target) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            if i == 0:
                for name, img in (("view0", out), ("target0", target)):
                    rgb = np.clip(img.cpu().numpy().reshape(args.res, args.res, 3), 0, 1)
                    save_png(str(out_dir / f"{stem}_{name}.png"), (rgb * 255).astype(np.uint8))
        out0 = render_soft(world, start, views[0][0], views[0][1], max_segments=K,
                           device=dev)["rgb"]
        mse0 = float(torch.mean((out0 - views[0][2]) ** 2))
    psnr_start = -10.0 * np.log10(max(mse0, 1e-12))

    result = {
        "metric": "inverse_render_psnr_db",
        "value": round(float(np.mean(psnrs)), 2),
        "unit": "dB",
        "psnr_per_view_db": [round(p, 2) for p in psnrs],
        "psnr_start_db": round(psnr_start, 2),
        "steps": args.steps,
        "views": args.views,
        "resolution": args.res,
        "param_slots": gt.num_slots,
        "fit_wall_s": round(t_fit, 1),
        "steps_per_s": round(args.steps / t_fit, 3),
        "loss_first": history[0],
        "loss_last": history[-1],
        "loss_curve": [round(v, 6) for v in history[:: max(1, args.steps // 50)]],
        "losses": history,
        "init": args.init,
        "targets": args.targets,
        **card_record(dev),
        "torch_version": torch.__version__,
        "target": ">=25 dB (BASELINE config 3)",
    }
    path = out_dir / args.out
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(result, indent=1))
    os.replace(tmp, path)
    print(json.dumps({k: result[k] for k in
                      ("metric", "value", "unit", "psnr_start_db", "steps", "fit_wall_s")}),
          flush=True)
    note(f"total wall {time.time() - t_all:.1f}s; wrote {path} + fitted/target view-0 PNGs")
    return result


if __name__ == "__main__":
    main()
