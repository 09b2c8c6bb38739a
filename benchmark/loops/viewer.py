"""The viewer loop: an orbit of full frames, at most ``in_flight`` of them
on the device at once.

Set-up builds the world with the port (``World.generate``, ``to_torch``),
the rays of the orbit's phase-0 poses on the device, started at a pose
drawn from the seed (the same frames for every seed, in another order),
the port's default atlas and sky map, and renders two whole cycles of the
orbit as warm-up (the first builds every kernel and fills the caching
allocator, the second is timed to size the window's events).  The window
then renders whole cycles: the host submits frame n once frame
n - ``in_flight``'s completion event has fired, and never waits on the
frame it has just submitted.  It ends at the first cycle boundary after ``--seconds``.  The
outputs of ``keep_frames`` poses drawn from the seed are held from each
cycle (the last cycle's are compared), the only outputs held past their
frame.

``frame_ms`` is the window's host-clock time from its start to the last
frame's completion over the frames completed; ``frame_p95_ms`` the 95th
percentile of the intervals between successive frames' completion events
(device timestamps).  With ``--trace 1`` a profiled window of
``trace_cycles`` cycles follows the measured one.

The comparison, after the window, with the program's state freed: the
reference (benchmark/reference) generates and packs the world again,
compares its pools with the program's, marches the light bundle and the
kept poses' rays, shades them, and compares hit, material, the hit point
(the march's t), depth and rgb with the program's outputs.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import trace as tr
from ..traffic import orbit


class _Clock:
    """Completion events with timestamps: CUDA events on the card, the
    host clock at record time elsewhere (the CPU tests)."""

    def __init__(self, device, n: int):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
            for e in self.events:       # create each CUDA event now, outside the window
                e.record()
            torch.cuda.synchronize(device)
        else:
            self.events = [0.0] * n

    def __len__(self):
        return len(self.events)

    def record(self, i: int) -> None:
        if i >= len(self.events):      # past the estimate: one more event, made here
            self.events.append(torch.cuda.Event(enable_timing=True) if self.cuda else 0.0)
        if self.cuda:
            self.events[i].record()
        else:
            self.events[i] = time.perf_counter()

    def wait(self, i: int) -> None:
        if self.cuda:
            self.events[i].synchronize()

    def intervals_ms(self, n: int) -> list:
        """Ms between successive events 0..n-1."""
        if self.cuda:
            return [self.events[i].elapsed_time(self.events[i + 1]) for i in range(n - 1)]
        return [(self.events[i + 1] - self.events[i]) * 1e3 for i in range(n - 1)]


def setup(run):
    """The program's world, the rays, the frame's tables, and the frame
    call; returns a dict of the cell's state."""
    cfg, traffic, dev = run.config, run.traffic, run.device
    with run.part("import"):
        from octree_raymarcher_tpu_torch.shade import (
            LightRig,
            MaterialTable,
            RenderConfig,
            default_atlas,
            default_envmap,
            render_frame,
        )
        from octree_raymarcher_tpu_torch.world.world import World
    wcfg = cfg["world"]
    t0 = time.perf_counter()
    with run.part("worldgen"):
        world_host = World.generate(dims=tuple(wcfg["dims"]), chunksize=float(wcfg["chunksize"]),
                                    depth=int(wcfg["depth"]), seed=int(wcfg["seed"]),
                                    water_level=float(wcfg["water_level"]),
                                    amplitude=float(wcfg["amplitude"]))
    with run.part("upload"):
        world = world_host.to_torch(device=dev)
        del world_host
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    run.record["worldgen_s"] = time.perf_counter() - t0
    cam = cfg["camera"]
    n = int(traffic["poses"])
    with run.part("rays"):
        # one fixed set of poses (phase 0), started at a pose drawn from the
        # seed: every seed's whole cycles render the same frames
        pose_list = orbit.rotated(orbit.poses(cam, n, 0.0), run.args.seed)
        order = orbit.block_order(int(cam["height"]), int(cam["width"]), int(cam["block"]), dev)
        rays = [orbit.rays(cam, p, yaw, order, dev) for p, yaw in pose_list]
        eyes = [np.asarray(p, dtype=np.float32) for p, _ in pose_list]
        r = cfg["render"]
        rcfg = RenderConfig(shadow=r["shadow"], max_steps=int(r["max_steps"]),
                            assume_resident=bool(r["assume_resident"]))
        lights, mats = LightRig.default(), MaterialTable.default()
        atlas = torch.from_numpy(default_atlas()).to(dev) if r.get("atlas") else None
        env = torch.from_numpy(default_envmap()).to(dev) if r.get("envmap") else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rng = np.random.default_rng((run.args.seed & (2**63 - 1)) ^ 0x5EED)
    keep = sorted(int(k) for k in rng.choice(n, size=int(traffic["keep_frames"]), replace=False))

    def frame(k):
        o, d = rays[k]
        return render_frame(world, o, d, eyes[k], lights, mats, rcfg, atlas, envmap=env,
                            device=dev)

    return dict(world=world, rays=rays, eyes=eyes, keep=keep, frame=frame, n=n, rcfg=rcfg,
                pose_list=pose_list)


def cycles(state, clock, start: int, frames_in_flight: int, kept: dict, deadline=None,
           count: int = 1, host_ms=None):
    """Render whole cycles of the orbit from frame number ``start`` until
    ``count`` cycles are done, or, given a ``deadline`` (host clock), until
    the first cycle boundary after it.  Returns the next frame number."""
    n, frame, keep = state["n"], state["frame"], state["keep"]
    f = start
    done = 0
    while True:
        for k in range(n):
            if f - frames_in_flight >= start:
                clock.wait(f - frames_in_flight)
            if host_ms is not None:
                h0 = time.perf_counter()
                out = frame(k)
                host_ms.append((time.perf_counter() - h0) * 1e3)
            else:
                out = frame(k)
            clock.record(f)
            if k in keep:
                kept[k] = out
            f += 1
        done += 1
        if deadline is None:
            if done >= count:
                return f
        elif time.perf_counter() >= deadline:
            return f


def run(run):
    traffic, dev = run.traffic, run.device
    state = setup(run)
    n = state["n"]
    depth = int(traffic["in_flight"])
    kept: dict = {}
    with run.part("warmup"):
        warm = _Clock(dev, n)
        cycles(state, warm, 0, depth, kept)      # builds the kernels, fills the allocator
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cycles(state, warm, 0, depth, kept)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        cycle_s = time.perf_counter() - t0
        clock = _Clock(dev, (int(2 * run.args.seconds / max(cycle_s, 1e-3)) + 4) * n)
    host_ms: list = []
    gc.collect()
    gc.disable()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.start_window()
    t_start = time.perf_counter()
    frames = cycles(state, clock, 0, depth, kept, deadline=t_start + run.args.seconds,
                    host_ms=host_ms)
    if clock.cuda:
        clock.wait(frames - 1)
    t_end = time.perf_counter()
    gc.enable()
    intervals = clock.intervals_ms(frames)
    run.record["frames"] = frames
    run.record["frame_host_ms"] = host_ms
    e2e = {"frame_ms": (t_end - t_start) * 1e3 / frames,
           "frame_p95_ms": float(np.percentile(intervals, 95)) if intervals else float("nan")}
    if run.args.trace:
        from ..run import smi

        run.record["smi_after"] = smi() if dev.type == "cuda" else ""
        tcycles = int(traffic["trace_cycles"])
        tclock = _Clock(dev, tcycles * n)
        with tr.traced(run.record):
            cycles(state, tclock, 0, depth, kept)     # the profiler's own start, untimed
            with tr.window():
                cycles(state, tclock, 0, depth, kept, count=tcycles)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        run.record["trace_frames"] = tcycles * n
    if dev.type == "cuda":
        run.record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    t0 = time.perf_counter()
    judge(run, state, kept)
    run.record["judge_s"] = time.perf_counter() - t0
    return {"e2e": e2e, "attempted": frames, "failed": 0}


def judge(run, state, kept: dict, control: bool = False) -> dict:
    """Compare the kept frames with the reference; record each number
    beside its limit.  ``control`` puts the reference computed from
    bfloat16 rays, with bfloat16 outputs, in the program's place.  Returns
    the numbers."""
    from ..reference import frame as ref_frame
    from ..reference import world as ref_world
    from ..reference.atlas import default_atlas as ref_atlas
    from ..reference.envmap import default_envmap as ref_envmap
    from ..reference.lights import LightRig as RefRig
    from ..reference.materials import MaterialTable as RefTable
    from ..reference.render import RenderConfig as RefConfig

    dev = run.device
    keep = state["keep"]
    ours = {k: {f: kept[k][f].detach().clone() for f in ("hit", "material", "point", "depth",
                                                          "rgb")} for k in keep}
    rays = {k: state["rays"][k] for k in keep}
    eyes = {k: state["eyes"][k] for k in keep}
    prog_pools = {name: getattr(state["world"], name).cpu().numpy().view(np.uint32)
                  for name in ("tree", "twig", "twig_occ")}
    state.clear()
    kept.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cfg = run.config
    w = cfg["world"]
    packed = ref_world.generate(w["dims"], w["chunksize"], w["depth"], w["seed"],
                                w["water_level"], w["amplitude"])
    pool_diff = 0
    for name, a in prog_pools.items():
        b = getattr(packed, name)
        pool_diff += int(np.count_nonzero(a != b)) if a.shape == b.shape else max(a.size, b.size)
    world = ref_world.world_on(packed, dev)
    r = cfg["render"]
    rcfg = RefConfig(shadow=r["shadow"], max_steps=int(r["max_steps"]),
                     assume_resident=bool(r["assume_resident"]))
    lights, mats = RefRig.default(), RefTable.default()
    atlas = torch.from_numpy(ref_atlas()).to(dev) if r.get("atlas") else None
    env = torch.from_numpy(ref_envmap()).to(dev) if r.get("envmap") else None
    smap = None
    if r["shadow"] == "map":
        smap = ref_frame.shadow_map(world, lights, rcfg.max_steps, rcfg.assume_resident)
    hit_bad = mat_bad = total = both = 0
    point_gap = depth_gap = rgb_gap = 0.0
    for k in keep:
        o, d = rays[k]
        if control:
            o, d = o.bfloat16().float(), d.bfloat16().float()
        want = ref_frame.frame(world, rays[k][0], rays[k][1], eyes[k], lights, mats, rcfg, atlas,
                               env, smap)
        got = ours[k]
        if control:
            got = ref_frame.frame(world, o, d, eyes[k], lights, mats, rcfg, atlas, env, smap)
            got = {f: (v.bfloat16().float() if v.is_floating_point() else v)
                   for f, v in got.items()}
        hit = got["hit"] & want["hit"]
        total += hit.numel()
        both += int(hit.sum())
        hit_bad += int((got["hit"] != want["hit"]).sum())
        mat_bad += int((hit & (got["material"] != want["material"])).sum())
        same = (got["hit"] == want["hit"]) & (~hit | (got["material"] == want["material"]))
        if bool(hit.any()):
            point_gap = max(point_gap, float((got["point"] - want["point"])[hit].abs().max()))
        if bool(same.any()):
            depth_gap = max(depth_gap, float((got["depth"] - want["depth"])[same].abs().max()))
            rgb_gap = max(rgb_gap, float((got["rgb"] - want["rgb"])[same].abs().max()))
    numbers = {"pool_words_differing": float(pool_diff),
               "hit_mismatch_share": hit_bad / max(total, 1),
               "material_mismatch_share": mat_bad / max(both, 1),
               "point_gap": point_gap, "depth_gap": depth_gap, "rgb_gap": rgb_gap}
    for name, value in numbers.items():
        run.check(name, value)
    return numbers


def control(run) -> dict:
    """The control's numbers: set-up, one cycle to fill the kept frames,
    then the comparison with the bfloat16 reference in the program's place."""
    state = setup(run)
    kept: dict = {}
    cycles(state, _Clock(run.device, state["n"]), 0, int(run.traffic["in_flight"]), kept)
    return judge(run, state, kept, control=True)
