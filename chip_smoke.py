"""Chip smoke test of the PyTorch port: drive the hard 1080p frame on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ with nvcc, generates the bench
scene of bench.py (4x4x4 chunks x 128^3, depth 8, seed 0) on the host,
uploads its pools, builds the 1920x1080 camera rays in 128x128 screen-block
order, and then:

  4. holds the march kernel K1 against march_plain on all 2,073,600 rays;
  5. holds the shading kernel K2 against shade_hits_plain, plain and with the
     default atlas and sky map;
  6. renders the frame with render_frame(shadow="none") through both kernels,
     plain and textured, and times it with CUDA events; the launch counters
     are zeroed just before this phase and read just after; then times each
     kernel and plain version alone, and K1 under two other ray orders;
  7. renders the golden scene of tests/test_golden.py on the card and checks
     it against the committed golden thumbnails.

Every phase prints one line; any failure raises and the script exits
nonzero without printing a result.  The line before the last is a JSON
object with one entry per kernel (times, launches, bounds); the last line is
{"ok": true, "device": {...}}.  With no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
# Float operations the march does per executed step, counted from
# csrc/march.cu with one descent level: clamp 1, point 6, in-world 6,
# chunk index 9, descent level 11, texel probe 14, escape 26.
MARCH_OPS_PER_STEP = 73
# Float operations of K2 per ray (no atlas), counted from csrc/shade.cu:
# hit point 7, cube normal 44, three lights 3 x ~95, sky or depth ~20.
SHADE_OPS_PER_RAY = 360

REF_STEPS = 50_006_052          # roofline_march.json true_ray_steps_per_frame
REF_HIT_FRAC = 0.642            # docs/PERF_NOTES.md, plain frame
TIMED_ITERS = 20


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of fn over ``iters`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def simt_efficiency(steps: torch.Tensor) -> float:
    """Sum of steps over sum over warps (32 consecutive rays in launch
    order) of 32 * the warp's most steps."""
    s = steps.to(torch.int64)
    pad = (-s.numel()) % 32
    warps = torch.nn.functional.pad(s, (0, pad)).view(-1, 32)
    lanes = float((warps.max(dim=1).values * 32).sum())
    return float(s.sum()) / lanes if lanes else 1.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    from octree_raymarcher_tpu_torch import kernels
    from octree_raymarcher_tpu_torch.ops.march import MARCH_KERNEL, march, march_plain
    from octree_raymarcher_tpu_torch.shade import (
        LightRig,
        MaterialTable,
        PerspectiveCamera,
        RenderConfig,
        block_permutation,
        default_atlas,
        default_envmap,
        render_frame,
        shade_hits,
        shade_hits_plain,
    )
    from octree_raymarcher_tpu_torch.shade.render import SHADE_KERNEL
    from octree_raymarcher_tpu_torch.world.world import World

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    kernels.build()
    kernels.library()
    regs = [ln.strip() for ln in kernels.build_log().splitlines() if "registers" in ln]
    print(f"phase 1 build: {time.time() - t0:.2f} s, {kind}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}; ptxas: {regs}", flush=True)

    # ---- 2. bench world: generate, pack, upload -----------------------------
    t0 = time.time()
    w = World.generate(dims=(4, 4, 4), chunksize=128.0, depth=8, seed=0,
                       water_level=6.0, amplitude=64.0)
    t_gen = time.time() - t0
    packed = w.pack()
    world = w.to_torch(dev)
    torch.cuda.synchronize()
    pool_bytes = world.pool_bytes
    print(f"phase 2 world: generate {t_gen:.2f} s, pack+upload {time.time() - t0 - t_gen:.2f} s; "
          f"tree {packed.tree.size} u32, twig {packed.twig.size} u32, twig_occ "
          f"{packed.twig_occ.size} u32, {pool_bytes} pool bytes", flush=True)

    # ---- 3. 1080p camera rays in 128x128 screen-block order ----------------
    cam = PerspectiveCamera(position=(256.0, 90.0, -80.0), yaw_deg=0.0, pitch_deg=-12.0,
                            fov_deg=80.0, width=1920, height=1080)
    o_np, d_np = cam.rays()
    perm, _ = block_permutation(cam.height, cam.width, 128)
    O = torch.from_numpy(o_np[perm]).to(dev)
    D = torch.from_numpy(d_np[perm]).to(dev)
    eye = torch.tensor(cam.position, dtype=torch.float32, device=dev)
    n = O.shape[0]
    print(f"phase 3 camera: {n} rays, block order 128", flush=True)

    # ---- 4. K1 vs march_plain -----------------------------------------------
    mk = dict(max_steps=512, steps_aov=True, assume_resident=True, device=dev)
    rk = march(world, O, D, **mk)
    rp = march_plain(world, O, D, 512, True, None, None, True)
    torch.cuda.synchronize()
    mism = {}
    for k in ("hit", "material", "texel", "cell_bmin", "cell_size", "steps"):
        eq = getattr(rk, k) == getattr(rp, k)
        mism[k] = int((~eq.reshape(n, -1).all(dim=1)).sum())
    fin = torch.isfinite(rk.t) & torch.isfinite(rp.t)
    ulps = (rk.t[fin].view(torch.int32).long() - rp.t[fin].view(torch.int32).long()).abs()
    t_bad = int((ulps > 1).sum()) + int((torch.isfinite(rk.t) != torch.isfinite(rp.t)).sum())
    worst = max(mism.values())
    print(f"phase 4 march K1 vs plain: mismatching rays {mism}, t beyond 1 ulp {t_bad}",
          flush=True)
    if worst > n * 1e-4 or t_bad > 0:
        fail(f"K1 disagrees with march_plain: {mism}, t {t_bad}")
    both = rk.hit & rp.hit
    march_err = float((rk.t[both] - rp.t[both]).abs().max()) if bool(both.any()) else 0.0
    steps_sum = int(rk.steps.to(torch.int64).sum())
    hit_frac = float(rk.hit.float().mean())
    simt = simt_efficiency(rk.steps)
    twig_hits = int((rk.texel >= 0).sum())
    print(f"phase 4 march stats: sum steps {steps_sum} (reference count {REF_STEPS}), "
          f"hit fraction {hit_frac:.4f} (reference {REF_HIT_FRAC}), SIMT efficiency "
          f"{simt:.4f}, max steps {int(rk.steps.max())}, twig hits {twig_hits}", flush=True)

    # ---- 5. K2 vs shade_hits_plain ---------------------------------------------
    # Tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain| per value.  Both run
    # the same float32 formulas with no contraction; only libm (powf, atan2f,
    # acosf) may differ by an ulp, and powf with grass shininess 1000 turns an
    # ulp of its base into ~1e-4 relative.
    lights, mats = LightRig.default(), MaterialTable.default(device=dev)
    atlas = torch.from_numpy(default_atlas(resolution=32)).to(dev)
    env = torch.from_numpy(default_envmap(64, 128)).to(dev)
    cfg = RenderConfig(shadow="none", max_steps=512, assume_resident=True)
    shade_err = {}
    for name, kw in (("plain", {}), ("textured", dict(atlas=atlas, envmap=env))):
        a = shade_hits(rk, O, D, eye, lights, mats, cfg, **kw)
        b = shade_hits_plain(rk, O, D, eye, lights, mats, cfg, **kw)
        torch.cuda.synchronize()
        errs, bad = {}, 0
        for k in ("rgb", "depth", "point", "normal"):
            diff = (a[k] - b[k]).abs()
            errs[k] = float(diff.max())
            bad += int((diff > 1e-5 + 1e-4 * b[k].abs()).sum())
            if not bool(torch.isfinite(a[k]).all()):
                fail(f"K2 {name}: non-finite {k}")
        exact = float((a["rgb"] == b["rgb"]).all(dim=1).float().mean())
        shade_err[name] = max(errs.values())
        print(f"phase 5 shade K2 vs plain ({name}): max abs err {errs}, values beyond "
              f"tolerance {bad}, rgb exact fraction {exact:.6f}", flush=True)
        if bad:
            fail(f"K2 {name} disagrees with shade_hits_plain")

    # ---- 6. the frame through both kernels (main path) --------------------------
    def frame_plain():
        return render_frame(world, O, D, eye, cfg=cfg, device=dev)

    def frame_textured():
        return render_frame(world, O, D, eye, cfg=cfg, atlas=atlas, envmap=env, device=dev)

    MARCH_KERNEL.launches = 0
    SHADE_KERNEL.launches = 0
    frame_ms = {"plain": cuda_ms(frame_plain, TIMED_ITERS),
                "textured": cuda_ms(frame_textured, TIMED_ITERS)}
    out = frame_plain()
    out_tex = frame_textured()
    torch.cuda.synchronize()
    launches = {"march": MARCH_KERNEL.launches, "shade": SHADE_KERNEL.launches}
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was not launched by the frame")
    for res in (out, out_tex):
        if tuple(res["rgb"].shape) != (n, 3) or not bool(torch.isfinite(res["rgb"]).all()):
            fail("frame rgb is not finite f32[N,3]")
        if not torch.equal(res["hit"], rk.hit):
            fail("frame hit mask differs from the march's")
    print(f"phase 6 frame: ms/frame {frame_ms}, rays/s "
          f"{ {k: round(n / (v / 1e3)) for k, v in frame_ms.items()} }, launches {launches}",
          flush=True)

    # kernels and plain versions alone, at the frame's shapes
    fk = dict(max_steps=512, assume_resident=True, device=dev)
    k1_ms = cuda_ms(lambda: march(world, O, D, **fk), TIMED_ITERS)
    p1_ms = cuda_ms(lambda: march_plain(world, O, D, 512, False, None, None, True), 2)
    rf = march(world, O, D, **fk)
    k2_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye, lights, mats, cfg), TIMED_ITERS)
    p2_ms = cuda_ms(lambda: shade_hits_plain(rf, O, D, eye, lights, mats, cfg), 5)
    k2t_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye, lights, mats, cfg,
                                        atlas=atlas, envmap=env), TIMED_ITERS)
    print(f"phase 6 kernels alone: K1 {k1_ms:.4f} ms (plain {p1_ms:.2f} ms), K2 "
          f"{k2_ms:.4f} ms (plain {p2_ms:.2f} ms), K2 textured {k2t_ms:.4f} ms", flush=True)

    # K1 under other ray orders: warps of 32 consecutive rays in each order.
    orders = {"scanline": np.arange(n),
              "block8": block_permutation(cam.height, cam.width, 8)[0]}
    for name, p in orders.items():
        Op = torch.from_numpy(o_np[p]).to(dev)
        Dp = torch.from_numpy(d_np[p]).to(dev)
        ms = cuda_ms(lambda: march(world, Op, Dp, **fk), TIMED_ITERS)
        eff = simt_efficiency(march(world, Op, Dp, steps_aov=True, **fk).steps)
        print(f"phase 6 ray order {name}: K1 {ms:.4f} ms, SIMT efficiency {eff:.4f} "
              f"(block128: {k1_ms:.4f} ms, {simt:.4f})", flush=True)

    # ---- 7. the golden scene on the card -----------------------------------------
    gw = World.generate(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7,
                        water_level=4.0, amplitude=16.0).to_torch(dev)
    gcam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                             fov_deg=70.0, width=96, height=54)
    go, gd = gcam.rays()
    geye = np.asarray(gcam.position, dtype=np.float32)
    for golden, kw in (("plain_2x1x2_d5", {}),
                       ("textured_env_2x1x2_d5",
                        dict(atlas=default_atlas(resolution=16, seed=0),
                             envmap=default_envmap(32, 64)))):
        rgb = render_frame(gw, go, gd, geye, device=dev, **kw)["rgb"].cpu().numpy()
        thumb = rgb.astype(np.float64).reshape(54, 96, 3)[:48, :96].reshape(
            8, 6, 8, 12, 3).mean(axis=(1, 3))
        ref = np.load(os.path.join(HERE, "tests", "golden", golden + ".npy"))
        err = float(np.abs(thumb - ref).max())
        print(f"phase 7 golden {golden}: max thumbnail error {err:.3g} (limit 2e-2)",
              flush=True)
        if err > 2e-2:
            fail(f"golden {golden} mismatch")

    # ---- result ---------------------------------------------------------------
    ray_io = 24 + 33                     # o, d in; hit t material cell size steps texel out
    k1_bytes = (n * ray_io + packed.tree.nbytes + packed.twig_occ.nbytes
                + packed.chunk_bmin.nbytes + 2 * packed.chunk_tree.nbytes + 4 * twig_hits)
    k2_bytes = n * (49 + 40) + mats.to_matrix().nbytes + 50 * 4
    b1, by1 = bound_ms(k1_bytes, MARCH_OPS_PER_STEP * steps_sum)
    b2, by2 = bound_ms(k2_bytes, SHADE_OPS_PER_RAY * n)
    report = {"kernels": [
        {"name": "march", "route": "cuda",
         "source": "octree_raymarcher_tpu_torch/csrc/march.cu",
         "replaces": "octree_raymarcher_tpu/ops/march_jnp.py:474",
         "launches": launches["march"], "max_abs_err": march_err, "ms": k1_ms,
         "plain_ms": p1_ms, "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "shade", "route": "cuda",
         "source": "octree_raymarcher_tpu_torch/csrc/shade.cu",
         "replaces": "octree_raymarcher_tpu/shade/render.py:62",
         "launches": launches["shade"], "max_abs_err": max(shade_err.values()),
         "ms": k2_ms, "plain_ms": p2_ms, "bound_ms": b2, "bound_by": by2,
         "library_ms": None},
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
