"""Count a cell's fixed work for its rooflines, once, on the card.

    python -m benchmark.work --workload <cell>

prints the JSON object that ``cells/<cell>.json`` keeps beside its limits:
the counts and the bounds per frame or step.  A viewer cell: the
reference's exact march steps and twig hits of every orbit pose at phase 0,
and of the light bundle (benchmark/reference).  A fit cell: the segments of
every view at phase 0 from the port's sampler (valid, on coarse LEAF slots,
slots touched), and the reference's plain sampler's exact steps on the first
view, taken for every view (the sampler's bound is set by its bytes).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import harness, roofline
from .traffic import orbit


def pools_bytes(packed) -> dict:
    return {k: int(getattr(packed, k).nbytes)
            for k in ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree")}


def viewer_work(cfg: dict, traffic: dict, dev) -> dict:
    from .reference import world as ref_world
    from .reference.lights import LightRig, host_leaf
    from .reference.march import march_plain
    from .reference.shadow import shadow_bundle

    w, cam, r = cfg["world"], cfg["camera"], cfg["render"]
    packed = ref_world.generate(w["dims"], w["chunksize"], w["depth"], w["seed"],
                                w["water_level"], w["amplitude"])
    world = ref_world.world_on(packed, dev)
    pools = pools_bytes(packed)
    order = orbit.block_order(int(cam["height"]), int(cam["width"]), int(cam["block"]), dev)
    steps, twig_hits = [], []
    for p, yaw in orbit.poses(cam, int(traffic["poses"]), 0.0):
        o, d = orbit.rays(cam, p, yaw, order, dev)
        res = march_plain(world, o, d, int(r["max_steps"]), True, None, None,
                          bool(r["assume_resident"]))
        steps.append(int(res.steps.to(torch.int64).sum()))
        twig_hits.append(int((res.texel >= 0).sum()))
    n = int(cam["width"]) * int(cam["height"])
    cam_bounds = [roofline.march_bound_ms(n, s, t, pools) for s, t in zip(steps, twig_hits)]
    out = {"rays_per_frame": n, "march_steps_per_frame": float(np.mean(steps)),
           "twig_hits_per_frame": float(np.mean(twig_hits)),
           "camera_march_bound_ms": float(np.mean([b[0] for b in cam_bounds])),
           "camera_march_bound_by": cam_bounds[0][1], "pools_bytes": pools}
    if r["shadow"] == "map":
        lights = LightRig.default()
        ldir = host_leaf(lights.directional.direction).astype(np.float64)
        ldir = ldir / np.linalg.norm(ldir)
        o_rel, dirs, pv_rel, half = shadow_bundle(ldir, 512, 512, world.dims, world.chunksize, 1.1)
        center = world.chunkcoordmin.cpu().numpy().astype(np.float32) * np.float32(
            world.chunksize) + half
        lo = torch.from_numpy(o_rel + center[None, :]).to(dev)
        ld = torch.from_numpy(np.ascontiguousarray(dirs)).to(dev)
        lres = march_plain(world, lo, ld, int(r["max_steps"]), True, None, None,
                           bool(r["assume_resident"]))
        light_steps = int(lres.steps.to(torch.int64).sum())
        lb = roofline.light_bound_ms(lo.shape[0], light_steps, pools)
        out.update(light_rays=int(lo.shape[0]), light_steps=light_steps,
                   light_bound_ms=lb[0], light_bound_by=lb[1])
    out["march_bound_ms"] = out["camera_march_bound_ms"] + out.get("light_bound_ms", 0.0)
    return out


def fit_work(cfg: dict, traffic: dict, dev) -> dict:
    from octree_raymarcher_tpu_torch.diff.segments import sample_segments
    from octree_raymarcher_tpu_torch.world.world import World

    from .reference import world as ref_world
    from .reference.segments import _sample_segments_plain

    w, cam, f = cfg["world"], cfg["camera"], cfg["fit"]
    K, max_steps = int(f["K"]), int(f["max_steps"])
    packed = ref_world.generate(w["dims"], w["chunksize"], w["depth"], w["seed"],
                                w["water_level"], w["amplitude"])
    ref = ref_world.world_on(packed, dev)
    pools = pools_bytes(packed)
    world = World.generate(dims=tuple(w["dims"]), chunksize=float(w["chunksize"]),
                           depth=int(w["depth"]), seed=int(w["seed"]),
                           water_level=float(w["water_level"]),
                           amplitude=float(w["amplitude"])).to_torch(device=dev)
    leaf0 = int(world.twig.shape[0])
    order = orbit.block_order(int(cam["height"]), int(cam["width"]), int(cam["block"]), dev)
    rows = []
    steps0 = None
    for p, yaw in orbit.poses(cam, int(traffic["views"]), 0.0):
        o, d = orbit.rays(cam, p, yaw, order, dev)
        segs = sample_segments(world, o, d, K, max_steps, device=dev)
        valid = segs.slot >= 0
        if steps0 is None:      # the plain sampler's exact steps, on the first view
            steps0 = int(_sample_segments_plain(ref, o, d, K, max_steps)[1].sum())
        rows.append((int(valid.sum()), int((segs.slot >= leaf0).sum()),
                     int(torch.unique(segs.slot[valid]).numel()), steps0))
    n = int(cam["width"]) * int(cam["height"])
    per_step = int(traffic["views_per_step"])
    seg_b = [roofline.segments_bound_ms(n, K, s, v, lf, pools)[0] for v, lf, _, s in rows]
    comp_b = [sum(b[0] for b in roofline.composite_bound_ms(n, K, t, v)) for v, _, t, _ in rows]
    out = {"rays_per_view": n, "K": K, "views_per_step": per_step,
           "valid_segments_per_view": float(np.mean([r[0] for r in rows])),
           "leaf_segments_per_view": float(np.mean([r[1] for r in rows])),
           "touched_slots_per_view": float(np.mean([r[2] for r in rows])),
           "sampler_steps_view0": steps0,
           "pools_bytes": pools,
           "composite_bound_ms": float(np.mean(comp_b)) * per_step}
    if not traffic.get("cached"):
        out["segments_bound_ms"] = float(np.mean(seg_b)) * per_step
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m benchmark.work")
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    wl = harness.workload(args.workload)
    cfg, traffic = harness.config(wl["config"]), harness.traffic(wl["traffic"])
    dev = torch.device("cuda", 0)
    fn = viewer_work if traffic["loop"] == "viewer" else fit_work
    print(json.dumps({"workload": args.workload, **fn(cfg, traffic, dev)}), flush=True)


if __name__ == "__main__":
    main()
