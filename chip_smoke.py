"""Chip smoke test of the PyTorch port: drive its main paths on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ with nvcc, generates the bench
scene of bench.py (4x4x4 chunks x 128^3, depth 8, seed 0) on the host,
uploads its pools, builds the 1920x1080 camera rays in 128x128 screen-block
order, and then:

  4. holds the march kernel K1 against march_plain on all 2,073,600 rays, bit
     for bit (t included), and counts the dependent pool loads a step makes
     with and without the path cache of csrc/march_step.cuh (path_loads);
  5. holds the shading kernel K2 against shade_hits_plain, plain and with the
     default atlas and sky map;
  6. renders the frame with render_frame(shadow="none") through both kernels,
     plain and textured, and times it with CUDA events; the launch counters
     are zeroed just before this phase and read just after, and each of K2's
     untextured and textured instantiations must have run once a frame (and
     no wide instantiation, each of which has a counter of its own); then
     times each kernel and plain version alone (K2's loops of calls with its
     tables on the card and on the host; K2 also replayed from a CUDA graph
     with its inputs rotated past the L2, its device time), counts the
     frame's all-hit, all-miss and mixed warps, and times K1 under two other
     ray orders;
  7. renders the golden scene of tests/test_golden.py on the card and checks
     it against the committed golden thumbnails;
  8. shadows: holds K3's three entries (ray_prep, shadow_resolve,
     map_project) and K1 on the shadow rays and on the 512x512 light bundle
     against their plain versions on all rays (K1 bit for bit, with its
     steps, load counts and bound for both), and the two fused kernels of
     the map-shadowed frame against their plain compositions: K1's
     light-depth instantiation (march_depth) against shadow_resolve of the
     march, and the map-shadowed K2 against K2 fed map_project's factor, bit
     for bit; then renders and times the frames shadow="ray", shadow="map"
     and the full reference frame (map + atlas + sky map), each with the
     launch counters zeroed just before and read just after and held to
     their kernels a frame (map and full: K1 twice, K2 once, no K3, no wide
     K2), drives
     the standalone K3 passes, times every K3 kernel and both fused kernels
     as device time in a CUDA graph (inputs rotated past the L2) beside the
     loops of calls, and checks the ray- and map-shadow goldens on the card;
  9. geometry: holds the segment sampler K4 at K=32 against its plain
     version on every 16th ray, with and without a step budget, then on all
     2,073,600 rays without one, and times both there; K4's SIMT efficiency
     comes from the plain version's per-ray steps;
 10. training: holds K5 (composite forward) and K6 (backward) against their
     plain versions at 1080p and K=32, on the bench segments and on a
     contention batch made on the card from a seed (every valid segment on
     the 8 coarse-LEAF slots, invalid slots interleaved), times both with
     their achieved GB/s and share of the bound; holds K6's column counter
     to the count from the slots (the share of columns past each tile's
     last valid one); runs fit() for 5 Adam steps toward the shadowless frame (counters zeroed just before,
     read just after), times the geometry pass, one step and the full step,
     and checks the soft golden on the card.
 11. the edited-world session: packs the bench world again with room for
     edits (World.to_device, slack 1.5) and runs the scripted session of
     octree_raymarcher_tpu_torch/demo.py (run_session) at 1920x1080 for 12
     frames with ray shadows, the atlas and the sky map: 4 edits at the
     picked cursor, one LOD swap and one streaming shift, each one batch
     patched by the pool-patch kernel K7 (counters zeroed just before, read
     just after; K7 launched once per launch group of each batch's rows).
     After every batch a CPU mirror of the pools takes the same batch
     through patch_plain and must equal the card's pools word for word, and
     apply's host time is printed split (plan, grow, check, staging buffer,
     fill, copy and launch enqueue); the final frame must match one rendered
     from a fresh pack of the same chunks, and the saved world is loaded
     back.  Then K7 is timed on each batch as device time in a CUDA graph,
     with the staged words rotated past the L2 and reused, beside a graph of
     as many one-element add_ launches (the launch floor) and its bound; and
     a launch with its rows in the smallest and in the largest parameter
     block.
 12. the ray-sharded paths of octree_raymarcher_tpu_torch/parallel/ on a
     one-rank NCCL process group (cuda:0; no exchange between cards is
     exercised on one card): render_frame_sharded (in one group, and in the
     reference's 65,536-ray tiles) and march_sharded must equal phase 6's
     render_frame and march bit for bit, with K1 and K2 launched once a
     group; the blocking, overlapped and ZeRO train steps (K=32, 4 gradient
     tiles) run 3 steps each from init_params_from_world toward the
     shadowless frame, with falling losses, 4 launches of K4, K5 and K6 a
     step and nothing else, the overlapped step's all-reduces asynchronous,
     and step 1's gradients and params held against the blocking step's
     within K6's tolerance; then entry(), dryrun_multichip(1) and the march
     guards (march_checked equal to march; a NaN direction raises before
     any launch).  The frames, the marches and one step of each mode are
     timed by CUDA events.
 13. the differentiable frame: render with the light rig, the material
     table, the eye, the rays (and the atlas and sky map) requiring grad,
     the loss mean(rgb^2) + mean(depth), backward: one K1, one K2 (its wide
     instantiation, the rig by pointer) and one K8 (csrc/shade_bwd.cu, K2's
     VJP) a step, counters zeroed just before and read just after; the wide
     K2's frame within phase 5's tolerance of shade_hits_plain and K8's
     gradients against torch.autograd.grad of shade_hits_plain within
     1e-3 |plain| + 1e-5 max|plain| (K6's tolerance: both sum in their own
     order), on the shadowless frame plain and textured and on the map
     frame plain and textured (the full frame) with its depth map given:
     each of K8's four instantiations; K8 and the wide K2 as device time in
     a cold CUDA graph beside K8's bound and its plain version; K8's
     registers, spills and blocks an SM (none spilled and at least two
     blocks, or the phase fails); a contention batch at 1080p (every hit on
     one atlas texel, every miss on one set of four sky taps) against the
     plain VJP and timed; K2 with
     material tables of 40, 300, 2,048, 8,192 and 65,536 rows (each hit's
     row read from the columns) within phase 5's tolerance of
     shade_hits_plain and timed; then
     the port's command line in subprocesses: render at 640x360 (its
     hit_frac held against the frame's) and a 3-step fit of 2 views at
     64x64 (finite, falling losses).
 14. the stage-compacted march and sampler (ops/march_compact.py,
     diff/segments_compact.py: K9's entry and stage instantiations and the
     partition K10, csrc/compact.cu; a call is one replay of a CUDA graph
     captured on the first call of its shape): K9's registers and spills;
     the compacted march of the 2,073,600 camera rays, the 2,073,600
     shadow rays (live_start) and the 262,144 light rays, each bit for bit
     against K1 on every ray, its coarse steps within their bounds, every
     field and lane_iters equal to its plain version on all rays, one
     entry, 20 stages and 20 partitions a call (counters, which a replay
     adds as its graph's kernels), timed by CUDA events beside K1, the
     host's enqueue of a call apart, its SIMT efficiency against K1's, the
     live count after each stage and its kernels' device time
     (torch.profiler); a second camera batch through the same graph (the
     first result unchanged); the camera rays' march under other schedules
     (one stage of 512 iterations, 4 of 128, 16 of 32); K9's entry and K10
     alone on the first pack against their plain versions beside
     torch.nonzero of the same flags; render_frame(compact=True) for the
     shadowless, ray, map and full frames against compact=False on every
     pixel, both timed; the four compacted frames and the sampler under
     torch.cuda.set_sync_debug_mode("error"); render_shadowmap(compact=True)
     against the light-depth K1; sample_segments_compact at K=32 against
     K4 and its plain version on every ray (lanes per phase too), one
     entry, 6 stages and 6 partitions a call, timed beside K4 with its
     host enqueue and device time, and under other stage schedules;
     fit(compact=True) against fit (same losses) and a step of each timed;
     and the launch counters of the compacted paths, zeroed just before and
     read just after.

Last, one K2 call with its eye and tables on the host is traced by
torch.profiler: no host-to-device copy may appear.

Phases 6 and 8 also print K2's bounds: its bytes (a hit reads its t and
material, a miss does not) and the operations of each ray's outcome, and
for the textured instantiations the distinct atlas texels and sky-map taps
the frame reads and the sky's and the atlas decode's operations.

Phase 1 prints the card's name and power limit (nvidia-smi) and ptxas's
registers, shared memory and spills for every instantiation of K1, K2, K4,
K7, K8, K9 and K10.  Every phase prints its
lines; any failure raises and the script exits nonzero without printing a
result.  The line before the last is a JSON object with one entry per
kernel and per instantiation of K2 and K8 (times, launches and the path
that made them, bounds); the last
line is {"ok": true, "device": {...}}.  With no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import re
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
# Float operations of K2, counted from csrc/shade.cu (a transcendental
# counts one).  Every ray: hit point 7, cube normal and cmax 46.  A hit: the
# view vector 13, the point light 84, the directional 69, the spot 114, lit
# 1, depth 13.  A miss of an untextured frame: none (the sky constant).
SHADE_OPS_PER_RAY = 53
SHADE_OPS_PER_HIT = 294
# The textured instantiations beside those: a hit adds cube_uv and the
# texel address 32 and the material colours times the texel 6; a miss
# samples the sky map: normalize 10, atan2f and u 3, acosf and v 4, the
# texel coordinates 8, the weights 2, four bilinear taps 33.  The atlas is
# gamma-decoded once per channel (fmaxf, powf) in the launch, not per hit.
SHADE_TEX_OPS_PER_HIT = 38
SHADE_TEX_OPS_PER_MISS = 60
ATLAS_DECODE_OPS_PER_CHANNEL = 2
# K3 per ray, counted from csrc/shadow.cu: ray_prep = hit point 7 + cube
# normal 44 + start 6; shadow_resolve = point 7 + row 6; map_project = hit
# point 7 + four rows 24 + divide and sign 9 + uv and texel 8 + compare 3.
RAY_PREP_OPS = 57
RESOLVE_OPS = 13
PROJECT_OPS = 51
# K4: the march's ops per executed step, plus the extraction per segment
# (point 6, escape 19, t1 and cursor 3).
SEGMENT_OPS = 28
# K5 per valid segment (transcendentals count one each): softplus 5, dl 2,
# tau 1, alpha 2, prefix 1, T 3, w 1, three sigmoids 9, rgb 6, mid and depth
# 4, tau sum 1.  K6 per valid segment: the recompute pass 9 and the reverse
# pass ~60 (forward terms again, G 8, cotangents 8, d sigma 4, albedo 12).
COMPOSITE_FWD_OPS = 35
COMPOSITE_BWD_OPS = 69

# K8 (csrc/shade_bwd.cu), hand counts rounded, of what the function needs:
# a hit's point and normal again (53), its forward again (294) and the
# reverse pass: the three lights' terms (~135), Blinn terms with two
# normalize VJPs each (~225), attenuations and distances (~42), the spot
# cone (~55), depth and view vector (~45), the row sums (~5); and its 53
# values added into the rig and eye sums (53).  A miss of an untextured
# frame adds to no gradient.  Textured: a hit's texel address and decode
# and their VJP (~60), a miss's sky weights and four tap scatters (~40).
SHADE_BWD_OPS_PER_HIT = 907
SHADE_BWD_TEX_OPS_PER_HIT = 60
SHADE_BWD_TEX_OPS_PER_MISS = 40

PATH_LEVELS = 8                 # csrc/march_step.cuh kPathLevels
REF_STEPS = 50_006_052          # roofline_march.json true_ray_steps_per_frame
REF_HIT_FRAC = 0.642            # docs/PERF_NOTES.md, plain frame
TIMED_ITERS = 20
L2_BYTES = 50 * 2**20           # the H100's L2 cache


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


def cuda_ms_once(fn):
    """(ms of one call of fn (no warm-up) by CUDA events, its result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call of fn, replayed from one CUDA graph of
    ``iters`` calls: the kernels run back to back, clear of the host's
    launch path (which bounds a loop of microsecond kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 5) / iters


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


def cold_graph_ms(fn, args: tuple, iters: int) -> float:
    """graph_ms of fn(*args) with each launch on the next of several copies
    of the tensors in ``args``, which together span at least twice the L2:
    a launch reads its inputs from memory, where the HBM bound applies, and
    not from the L2 lines the launch before it left."""
    size = sum(t.nbytes for t in _tensors(args))
    copies = [args] + [_clone(args) for _ in range(-(-2 * L2_BYTES // size) - 1)]
    turn = itertools.cycle(copies)
    return graph_ms(lambda: fn(*next(turn)), len(copies) * -(-iters // len(copies)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def simt_efficiency(steps: torch.Tensor) -> float:
    """Sum of steps over sum over warps (32 consecutive rays in launch
    order) of 32 * the warp's most steps."""
    s = steps.to(torch.int64)
    pad = (-s.numel()) % 32
    warps = torch.nn.functional.pad(s, (0, pad)).view(-1, 32)
    lanes = float((warps.max(dim=1).values * 32).sum())
    return float(s.sum()) / lanes if lanes else 1.0


def ptxas_report(log: str) -> dict:
    """{kernel (template arguments spelled out): "registers, shared memory,
    stack and spills"} from nvcc -Xptxas -v output."""
    out, name, frame = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            for tag in ("compact_entry_kernel", "compact_stage_kernel", "march_kernel",
                        "segments_kernel", "shade_bwd_kernel", "shade_kernel", "patch_kernel"):
                if tag in name:
                    args = re.findall(r"L[bi](\d+)E", name.split(tag, 1)[1])
                    name = f"{tag}<{','.join(args)}>"
            frame = ""
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out[name] = ln.split(":", 1)[1].strip() + "; " + frame
    return out


def texture_bytes(res, O, D, atlas, env) -> int:
    """Bytes of atlas and sky map that textured shading must read for these
    rays, each distinct texel once (12 bytes): the atlas texel each hit
    samples (nearest, by face UV, as shade_hits_plain) and the four sky-map
    taps of each miss (bilinear, as sample_env)."""
    return sum(texture_parts(res, O, D, atlas, env))


def texture_parts(res, O, D, atlas, env) -> tuple:
    """texture_bytes split: (the atlas texels' bytes, the sky-map taps')."""
    import math

    from octree_raymarcher_tpu_torch.core.constants import EPS
    from octree_raymarcher_tpu_torch.core.geometry import const, cube_uv, normalize

    hit = res.hit
    p = O[hit] + D[hit] * (res.t[hit] - EPS)[:, None]
    cmin = res.cell_bmin[hit]
    uv = cube_uv(p, cmin, cmin + res.cell_size[hit][:, None])
    r = atlas.shape[1]
    ui = torch.clamp(uv[:, 0] * r, 0, r - 1).to(torch.int64)
    vi = torch.clamp(uv[:, 1] * r, 0, r - 1).to(torch.int64)
    mi = res.material[hit].clamp(0, atlas.shape[0] - 1).to(torch.int64)
    texels = torch.unique((mi * r + vi) * r + ui).numel()
    h, w = env.shape[0], env.shape[1]
    nd = normalize(D[~hit])
    u = torch.atan2(nd[:, 2], nd[:, 0]) / const(nd, 2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(nd[:, 1], -1.0, 1.0)) / const(nd, math.pi)
    x0 = torch.floor(u * w - 0.5).to(torch.int64)
    y0 = torch.floor(v * h - 0.5).to(torch.int64)
    taps = torch.cat([torch.remainder(x0 + dx, w) + (y0 + dy).clamp(0, h - 1) * w
                      for dx in (0, 1) for dy in (0, 1)])
    return 12 * texels, 12 * torch.unique(taps).numel()


def march_mismatches(a, b) -> dict:
    """Rays on which two MarchResults differ, per field; t and cell_bmin
    compared bit for bit."""
    out = {}
    for k in ("hit", "t", "material", "texel", "cell_bmin", "cell_size", "steps"):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[k] = int((~(x == y).reshape(x.shape[0], -1).all(dim=1)).sum())
    return out


def path_loads(world, o, d, max_steps: int, assume_resident: bool, live_start=None) -> dict:
    """A count, not a time: per step of the march on these rays, the pool
    loads on a ray's dependent chain without the path cache (chunk table,
    root word, one word per level descended, the twig's occupancy word) and
    with it (chunk table and root only when the chunk changes, only the
    levels below the first new child choice or past the PATH_LEVELS the
    path keeps, occupancy only for a new twig), as csrc/march_step.cuh
    run_march does.  A warp waits for its
    longest chain, so each iteration also counts the longest chain among
    the 32 rays of a warp (launch order) still marching.  Same formulas as
    march_plain; the hit step counts, the loop stops at hits and exits."""
    from octree_raymarcher_tpu_torch.core.constants import BIGEPS, EPS, TWIG_SIZE
    from octree_raymarcher_tpu_torch.core.geometry import const, inv_dir
    from octree_raymarcher_tpu_torch.ops.march import T_CLAMP, _entry, _world_box, loop_bound

    n, dev = o.shape[0], o.device
    g = inv_dir(d)
    lo, hi = _world_box(world, o)
    t, live0 = _entry(world, o, d, g, None, live_start)
    act = torch.nonzero(live0).flatten()
    ta = t[act]
    wdim, hdim, ddim = world.dims
    cs = world.chunksize
    depth = world.depth
    prev_q = torch.full((n, 3), float("inf"), device=dev)
    prev_choice = torch.full((n, max(depth, 1)), -1, dtype=torch.int8, device=dev)
    occ_len = world.twig_occ.shape[0]
    tot = {"steps": 0, "before": 0, "after": 0, "warp_before": 0, "warp_after": 0,
           "zero_load_steps": 0}
    nwarps = (n + 31) // 32
    for _ in range(loop_bound(max_steps)):
        if act.numel() == 0:
            break
        a, b, ga = o[act], d[act], g[act]
        tg = torch.clamp_max(ta, T_CLAMP)
        p = a + b * tg[:, None]
        in_world = ((p >= lo) & (p <= hi)).all(dim=1)
        q = torch.floor(p / const(p, cs))
        qi = q.to(torch.int32)
        ci = (torch.remainder(qi[:, 0], wdim) + torch.remainder(qi[:, 2], ddim) * wdim
              + torch.remainder(qi[:, 1], hdim) * (wdim * ddim)).clamp(0, world.num_chunks - 1)
        bm = q * cs
        ci = ci.long()
        resident = in_world if assume_resident else in_world & (world.chunk_bmin[ci] == bm).all(1)
        same = (q == prev_q[act]).all(dim=1)
        tree_off = world.chunk_tree[ci].long()
        word = world.tree[tree_off]
        size = torch.full((act.numel(),), cs, dtype=torch.float32, device=dev)
        levels = torch.zeros(act.numel(), dtype=torch.int32, device=dev)
        loaded = torch.zeros(act.numel(), dtype=torch.int32, device=dev)
        choices = prev_choice[act]
        for lv in range(depth):
            mb = ((word >> 30) & 3) == 2
            half = size * 0.5
            ge = p >= bm + half[:, None]
            child = ge[:, 0].int() + 2 * ge[:, 1].int() + 4 * ge[:, 2].int()
            bm = torch.where(mb[:, None], bm + torch.where(ge, half[:, None], 0.0), bm)
            size = torch.where(mb, size - half, size)
            kept = lv < PATH_LEVELS
            same = same & (~mb | (kept & (child == choices[:, lv].int())))
            levels += mb.int()
            loaded += (mb & ~same).int()
            choices[:, lv] = torch.where(mb, child.to(torch.int8), choices[:, lv])
            nxt = world.tree[(tree_off + (word & ((1 << 30) - 1)).long() + child.long())
                             .clamp(0, world.tree.shape[0] - 1)]
            word = torch.where(mb, nxt, word)
        ty = (word >> 30) & 3
        m_twig = ty == 3
        new_chunk = ~((q == prev_q[act]).all(dim=1))
        before = 2 + levels + m_twig.int()
        after = 2 * new_chunk.int() + loaded + (m_twig & ~same).int()
        before = torch.where(resident, before, 0)
        after = torch.where(resident, after, 0)
        tot["steps"] += int(resident.sum())
        tot["before"] += int(before.sum())
        tot["after"] += int(after.sum())
        tot["zero_load_steps"] += int((resident & (after == 0)).sum())
        warp = act // 32
        for key, v in (("warp_before", before), ("warp_after", after)):
            m = torch.zeros(nwarps, dtype=torch.int32, device=dev)
            m.scatter_reduce_(0, warp, v.int(), reduce="amax")
            tot[key] += int(m.sum())
        prev_q[act] = torch.where(resident[:, None], q, prev_q[act])
        prev_choice[act] = torch.where(resident[:, None], choices, prev_choice[act])

        # probe and escape, as march_plain
        payload = word & ((1 << 30) - 1)
        twig_off = world.chunk_twig[ci]
        leafsize = size * (1.0 / TWIG_SIZE)
        to = torch.clamp((p - bm) * (1.0 / leafsize)[:, None], 0.0, TWIG_SIZE - 1).to(torch.int32)
        tword = to[:, 2] * 16 + to[:, 1] * 4 + to[:, 0]
        oi = ((twig_off + payload).long() * 2 + (tword >> 5).long()).clamp(0, occ_len - 1)
        tex_solid = ((world.twig_occ[oi] >> (tword & 31)) & 1) == 1
        solid = resident & ((ty == 1) | (m_twig & tex_solid))
        offs = to.to(torch.float32) * leafsize[:, None]
        e = bm + torch.where(m_twig[:, None], offs, 0.0)
        esize = torch.where(m_twig, size + (leafsize - size), size)
        dd = torch.maximum((e - p) * ga, (e + esize[:, None] - p) * ga)
        esc = torch.minimum(dd[:, 0], torch.minimum(dd[:, 1], dd[:, 2]))
        esc = torch.where(esc < EPS, esc + (BIGEPS - esc), esc) + EPS
        adv = resident & ~solid
        act = act[adv]
        ta = (tg + esc)[adv]
    s = max(tot["steps"], 1)
    return {"steps": tot["steps"], "chain_before": tot["before"] / s,
            "chain_after": tot["after"] / s, "zero_load_share": tot["zero_load_steps"] / s,
            "warp_chain_ratio": tot["warp_after"] / max(tot["warp_before"], 1)}


def phase_session(w, dev, atlas, env, zero_counts, read_counts, res=(1920, 1080),
                  frames: int = 12) -> dict:
    """Phase 11: the edited-world session on ``w`` (module docstring).
    Returns K7's numbers for the kernels line."""
    from octree_raymarcher_tpu_torch.demo import run_session
    from octree_raymarcher_tpu_torch.shade import PerspectiveCamera, RenderConfig, render_frame
    from octree_raymarcher_tpu_torch.world.alloc import (
        PATCH_KERNEL,
        PIECE_WORDS,
        ROW_CAPS,
        TWIG,
        WorldAllocator,
        kernel_pointers,
        launch_groups,
        pack_rows,
        patch,
        patch_plain,
    )
    from octree_raymarcher_tpu_torch.world.device import TorchWorld
    from octree_raymarcher_tpu_torch.world.world import World

    t0 = time.time()
    wa, ew = w.to_device(slack=1.5, device=dev)
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    mirror = TorchWorld.from_numpy(ew.to_numpy(), device="cpu")
    pool_names = ("tree", "twig", "twig_occ", "chunk_bmin", "chunk_tree", "chunk_twig")
    batch_log = []
    seen = [0]

    def mirror_batch(kind, batch, ew_now):
        """The CPU mirror takes the same batch through patch_plain; every
        pool word and chunk-table entry must equal the card's, and K7 must
        have launched once per launch group of the batch's rows."""
        launched = read_counts()["patch"] - seen[0]
        seen[0] += launched
        if launched != len(launch_groups(batch.desc.shape[0])):
            fail(f"K7 launched {launched} times for a {kind} batch of {batch.desc.shape[0]} "
                 f"rows, not once per launch group")
        for k in ("tree", "twig", "twig_occ"):
            t, ref = getattr(mirror, k), getattr(ew_now, k)
            if t.numel() < ref.numel():
                grown = torch.zeros(ref.numel(), dtype=t.dtype)
                grown[:t.numel()] = t
                setattr(mirror, k, grown)
        patch_plain(mirror, torch.from_numpy(batch.desc), torch.from_numpy(batch.words))
        bad, err = {}, 0
        for k in pool_names:
            a = getattr(ew_now, k).cpu().view(torch.int32)
            b = getattr(mirror, k).view(torch.int32)
            bad[k] = int((a != b).sum())
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
        coordmin = torch.as_tensor(w.chunkcoordmin, dtype=torch.float32)
        bad["chunkcoordmin"] = int((ew_now.chunkcoordmin.cpu() != coordmin).sum())
        batch_log.append((kind, batch, err, launched))
        if any(bad.values()):
            fail(f"K7 disagrees with patch_plain after the {kind} batch: {bad}")

    session_dir = os.path.join(HERE, "build", "chip_smoke_session")
    zero_counts()
    session = run_session(w, wa, ew, frames=frames, res=res, out=session_dir, device=dev,
                          on_batch=mirror_batch)
    torch.cuda.synchronize()
    session_launches = {k: v for k, v in read_counts().items() if v}
    ew = session["world"]
    kinds = [k for k, _, _ in session["batches"]]
    if len(batch_log) != len(kinds) or read_counts()["patch"] != sum(b[3] for b in batch_log):
        fail(f"K7 launches {read_counts()['patch']} do not add up over the batches {kinds}")
    if kinds.count("lod") != 1 or kinds.count("shift") != 1 or kinds.count("edit") < 1:
        fail(f"the session's batches are {kinds}: want edits, one lod and one shift")
    for k in ("march", "ray_prep", "shade textured"):
        if read_counts()[k] == 0:
            fail(f"kernel {k} was not launched by the session's frames")
    for (kind, batch, apply_s), (_, _, err, launched) in zip(session["batches"], batch_log):
        split = {"plan": batch.plan_s, "grow": batch.grow_s, "check": batch.check_s,
                 "pinned wait + growth": batch.alloc_s, "fill": batch.fill_s,
                 "copy enqueue": batch.copy_s, "launch enqueue": batch.launch_s}
        split["rest (synchronize)"] = apply_s - sum(split.values())
        print(f"phase 11 batch {kind}: {batch.chunks} chunks, {batch.desc.shape[0]} rows "
              f"(by target {np.bincount(batch.desc[:, 0], minlength=5).tolist()}, longest "
              f"{int(batch.desc[:, 3].max())} of {PIECE_WORDS}), {batch.words.size} stream "
              f"words, {batch.words_written} words written, {launched} K7 launch(es); apply "
              f"{apply_s * 1e3:.4f} ms by host clock, split (ms) "
              f"{ {k: round(v * 1e3, 4) for k, v in split.items()} }; K7 vs patch_plain: "
              f"every word equal (max abs err {err})", flush=True)
    print(f"phase 11 session: pack {t_pack:.2f} s; {len(kinds)} batches {kinds}; ms per frame "
          f"(render + synchronize) {[round(x * 1e3, 3) for x in session['frame_s']]}; pick "
          f"{[round(x * 1e3, 1) for x in session['pick_s']]} ms; lod {session['lod_s']:.3f} s; "
          f"shift {session['shift_s']:.3f} s + apply_shift "
          f"{session['batches'][kinds.index('shift')][2]:.3f} s; save {session['save_s']:.3f} s; "
          f"launches {session_launches}", flush=True)

    # the patched world against a fresh pack of the same host chunks
    _, fresh = WorldAllocator.pack(w.chunks, w.dims, w.chunkcoordmin, device=dev)
    fcam = PerspectiveCamera(position=(256.0, 90.0, -80.0), yaw_deg=0.0, pitch_deg=-12.0,
                             fov_deg=80.0, width=res[0], height=res[1])
    fo, fd = fcam.rays()
    feye = np.asarray(fcam.position, dtype=np.float32)
    cfg_s = RenderConfig(shadow="ray")
    ra = render_frame(ew, fo, fd, feye, cfg=cfg_s, atlas=atlas, envmap=env, device=dev)
    rf = render_frame(fresh, fo, fd, feye, cfg=cfg_s, atlas=atlas, envmap=env, device=dev)
    torch.cuda.synchronize()
    edited_err = max_abs(ra["rgb"], rf["rgb"])
    rgb_bad = int(((ra["rgb"] - rf["rgb"]).abs() > 1e-5 + 1e-4 * rf["rgb"].abs()).sum())
    if not (torch.equal(ra["hit"], rf["hit"]) and torch.equal(ra["material"], rf["material"])
            and rgb_bad == 0):
        fail(f"the patched world's frame differs from a fresh pack's: rgb err {edited_err}")
    print(f"phase 11 patched vs fresh pack (1080p, ray shadows, atlas, sky map): hit and "
          f"material exact, rgb max abs err {edited_err}, hit fraction "
          f"{float(ra['hit'].float().mean()):.4f}; pools {ew.pool_bytes} bytes patched, "
          f"{fresh.pool_bytes} fresh", flush=True)
    del ra, rf, fresh

    t0 = time.time()
    loaded = World.load(os.path.join(session_dir, "world.npz"))
    load_s = time.time() - t0
    for a, b in zip(loaded.chunks, w.chunks, strict=True):
        if not (np.array_equal(a.tree[:a.ntrees], b.tree[:b.ntrees])
                and np.array_equal(a.twig[:a.ntwigs], b.twig[:b.ntwigs])):
            fail("the saved world does not load back equal")
    print(f"phase 11 load: {load_s:.3f} s, {len(loaded.chunks)} chunks equal", flush=True)

    # K7 and its plain version alone on each batch of the session, replayed
    # onto a copy of the final pools: K7's device time in a CUDA graph with
    # the staged words rotated past the L2 (cold) and reused (warm), beside
    # a graph of as many launches of a one-element add_ (the launch floor);
    # the bound counts the words read and written and the occupancy words
    scratch = dataclasses.replace(ew, **{k: getattr(ew, k).clone() for k in pool_names})
    one = torch.zeros(1, device=dev)
    patch_rows = []
    for kind, batch, _ in session["batches"]:
        desc = batch.desc
        staged = wa.stage(batch, dev)
        desc_t = torch.from_numpy(desc)
        n_launch = len(launch_groups(desc.shape[0]))
        loop = cuda_ms(lambda: patch(scratch, desc, staged), TIMED_ITERS)
        plain = cuda_ms(lambda: patch_plain(scratch, desc_t, staged), 3)
        h2d = cuda_ms(lambda: wa.stage(batch, dev), 5)
        warm = graph_ms(lambda: patch(scratch, desc, staged), TIMED_ITERS)
        cold = cold_graph_ms(lambda s: patch(scratch, desc, s), (staged,), TIMED_ITERS)
        floor = graph_ms(lambda: [one.add_(1) for _ in range(n_launch)], TIMED_ITERS)
        lengths = desc[:, 3]
        nbytes = 8 * int(lengths.sum()) + 4 * (int(lengths[desc[:, 0] == TWIG].sum()) // 32)
        bound = bound_ms(nbytes, 0.0)[0]
        patch_rows.append((cold, plain, bound))
        print(f"phase 11 K7 on the {kind} batch: {cold:.5f} ms a batch in a cold CUDA graph, "
              f"{warm:.5f} warm, launch floor {floor:.5f} ({n_launch} add_ launch(es)); bound "
              f"{bound:.5f} ms ({nbytes} bytes), {bound / cold:.3f} of it; loop of "
              f"{TIMED_ITERS} calls {loop:.4f} ms a call; staging + H2D {h2d:.4f} ms a call; "
              f"plain {plain:.3f} ms", flush=True)
    torch.cuda.synchronize()

    # what the parameter block costs a launch: the smallest batch carried in
    # the smallest and in the largest capacity
    kind, batch, _ = min(session["batches"], key=lambda b: b[1].desc.shape[0])
    staged = wa.stage(batch, dev)
    rows = pack_rows(batch.desc)
    ptrs = kernel_pointers(scratch, staged)
    cost = {}
    for cap in (ROW_CAPS[0], ROW_CAPS[-1]):
        def launch(cap=cap):
            PATCH_KERNEL(*ptrs, rows.ctypes.data, rows.shape[0], cap)
        cost[cap] = (graph_ms(launch, TIMED_ITERS), cuda_ms(launch, TIMED_ITERS))
    torch.cuda.synchronize()
    print(f"phase 11 K7 parameter block ({kind} batch, {rows.shape[0]} rows): "
          + "; ".join(f"{cap} rows ({16 * cap} bytes) {g:.5f} ms a launch in a warm graph, "
                      f"{lp:.4f} ms a call in a loop" for cap, (g, lp) in cost.items()),
          flush=True)
    del scratch
    k7_ms, k7_plain, k7_bound = (float(np.mean(c)) for c in zip(*patch_rows))
    return {"launches": session_launches["patch"], "err": float(max(b[2] for b in batch_log)),
            "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": k7_bound,
            "shade_launches": session_launches["shade textured"]}


class RecordingAdam(torch.optim.Adam):
    """Adam that keeps a copy of the gradients its last step was given."""

    def step(self, closure=None):
        self.seen = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def count_all_reduce(fn):
    """(fn(), {"async": a, "blocking": b}): fn run with
    torch.distributed.all_reduce counting its calls by ``async_op``."""
    import torch.distributed as dist

    calls = {"async": 0, "blocking": 0}
    inner = dist.all_reduce

    def counted(tensor, *args, async_op=False, **kwargs):
        calls["async" if async_op else "blocking"] += 1
        return inner(tensor, *args, async_op=async_op, **kwargs)

    dist.all_reduce = counted
    try:
        return fn(), calls
    finally:
        dist.all_reduce = inner


def device_breakdown(fn, top: int = 6):
    """(device ms, [(kernel, device ms), ...]) of one call of fn traced by
    torch.profiler: the sum of the kernels' and copies' device time (user
    annotations, which span kernels, left out), and the ``top`` of them by
    device time; (None, []) when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device events only; a user annotation spans kernels listed apart
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key[:60], round(us / 1e3, 4)))
    rows.sort(key=lambda r: -r[1])
    if not rows:
        return None, []
    return sum(ms for _, ms in rows), rows[:top]


def phase_sharded(world, O, D, eye, cfg, frame_rgb, dev, zero_counts, read_counts, smi: str,
                  K: int = 32, grad_tiles: int = 4, steps: int = 3, lr: float = 0.05) -> None:
    """Phase 12: the ray-sharded paths of parallel/ on a one-rank process
    group (NCCL on the card) over the bench scene and camera: the sharded
    frame and march against render_frame and march bit for bit, the
    blocking, overlapped and ZeRO train steps against each other, entry(),
    dryrun_multichip(1) and the march guards; each timed by CUDA events."""
    import torch.distributed as dist

    from octree_raymarcher_tpu_torch import entry
    from octree_raymarcher_tpu_torch.diff import init_params_from_world
    from octree_raymarcher_tpu_torch.ops.guards import GuardError, march_checked
    from octree_raymarcher_tpu_torch.ops.march import march
    from octree_raymarcher_tpu_torch.parallel import (
        init_distributed,
        local_address,
        make_mesh,
        make_sharded_train_step,
        make_zero_train_step,
        march_sharded,
        render_frame_sharded,
    )
    from octree_raymarcher_tpu_torch.shade import render_frame

    init_distributed(local_address(), 1, 0, device=dev)
    try:
        mesh = make_mesh(dev)
        nccl = "none"
        if dev.type == "cuda":
            v = torch.cuda.nccl.version()
            nccl = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
        print(f"phase 12 process group: {dist.get_backend()}, {mesh.size} rank on "
              f"{mesh.device}, NCCL {nccl}; card: {smi}", flush=True)
        n = O.shape[0]

        # the sharded frame: one group, and the reference's default tile
        tiles = {"one group": n, "tile 65536": 65536}
        for name, tile in tiles.items():
            zero_counts()
            rgb = render_frame_sharded(mesh, world, O, D, eye, tile=tile, cfg=cfg)
            torch.cuda.synchronize()
            counts = read_counts()
            groups = -(-n // tile)
            want = {k: groups if k in ("march", "shade") else 0 for k in counts}
            if counts != want:
                fail(f"render_frame_sharded ({name}) launched {counts}, want {groups} K1 "
                     f"and K2")
            if not torch.equal(rgb, frame_rgb):
                fail(f"render_frame_sharded ({name}) differs from render_frame on "
                     f"{int((rgb != frame_rgb).any(dim=1).sum())} rays")
        zero_counts()
        hit, t, mat = march_sharded(mesh, world, O, D, 512)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {k: int(k == "march") for k in counts}:
            fail(f"march_sharded launched {counts}, want one K1")
        ref = march(world, O, D, 512, device=dev)
        torch.cuda.synchronize()
        if not (torch.equal(hit, ref.hit) and torch.equal(mat, ref.material)
                and torch.equal(t.view(torch.int32), ref.t.view(torch.int32))):
            fail("march_sharded differs from march")
        print(f"phase 12 sharded frame (one group, and tile 65536: {-(-n // 65536)} groups) "
              f"equal to render_frame's rgb on all {n} rays, march_sharded to march's "
              f"(hit, t bit for bit, material); launches a call: K1 and K2 once a group",
              flush=True)
        frame_ms = {
            "render_frame": cuda_ms(lambda: render_frame(world, O, D, eye, cfg=cfg, device=dev),
                                    TIMED_ITERS),
            **{f"render_frame_sharded, {name}": cuda_ms(
                lambda tile=tile: render_frame_sharded(mesh, world, O, D, eye, tile=tile,
                                                       cfg=cfg), TIMED_ITERS)
               for name, tile in tiles.items()},
            "march": cuda_ms(lambda: march(world, O, D, 512, device=dev), TIMED_ITERS),
            "march_sharded": cuda_ms(lambda: march_sharded(mesh, world, O, D, 512),
                                     TIMED_ITERS),
        }
        print(f"phase 12 ms a call (CUDA events, mean of {TIMED_ITERS}; {smi}): {frame_ms}",
              flush=True)
        for name, tile in tiles.items():
            busy, top = device_breakdown(lambda tile=tile: render_frame_sharded(
                mesh, world, O, D, eye, tile=tile, cfg=cfg))
            ms = frame_ms[f"render_frame_sharded, {name}"]
            idle = "not measured" if busy is None else f"{1 - busy / ms:.3f}"
            print(f"phase 12 sharded frame, {name}: device time by torch.profiler "
                  f"{'not measured' if busy is None else f'{busy:.4f} ms'} (idle share {idle} "
                  f"of {ms:.4f} ms), most: {top}", flush=True)

        # the train steps, from init_params_from_world toward the shadowless frame
        params0 = init_params_from_world(world)

        def build(name, opt):
            """(step, a fresh optimizer state) of one mode."""
            if name == "zero":
                init, zstep = make_zero_train_step(mesh, world, opt, K, grad_tiles)
                return zstep, init(params0)
            return make_sharded_train_step(mesh, world, opt, K, name == "overlap",
                                           grad_tiles), None

        runs, step_ms = {}, {}
        for name in ("blocking", "overlap", "zero"):
            step, state0 = build(name, functools.partial(RecordingAdam, lr=lr))

            def run():
                params, state, out = params0, state0, []
                for i in range(steps):
                    params, state, loss = step(params, state, world, O, D, frame_rgb)
                    if i == 0:
                        first = (params, state.seen)
                    out.append(float(loss))
                return out, first

            zero_counts()
            (losses, first), calls = count_all_reduce(run)
            torch.cuda.synchronize()
            counts = read_counts()
            per = {"segments", "composite_fwd", "composite_bwd"}
            want = {k: steps * grad_tiles if k in per else 0 for k in counts}
            if counts != want:
                fail(f"the {name} step launched {counts} in {steps} steps, want {grad_tiles} "
                     f"K4, K5 and K6 a step")
            want_calls = {"blocking": {"async": 0, "blocking": 3 * steps},
                          "overlap": {"async": 2 * grad_tiles * steps, "blocking": steps},
                          "zero": {"async": 0, "blocking": steps}}[name]
            if calls != want_calls:
                fail(f"the {name} step made all_reduce calls {calls}, want {want_calls}")
            if not (np.isfinite(losses).all() and all(b < a for a, b in
                                                        zip(losses, losses[1:]))):
                fail(f"the {name} step's losses are not finite and falling: {losses}")
            runs[name] = (losses, first)
            # timed with plain Adam, from a state one step in
            step, state = build(name, functools.partial(torch.optim.Adam, lr=lr))
            _, state, _ = step(params0, state, world, O, D, frame_rgb)
            step_ms[name] = cuda_ms(lambda: step(params0, state, world, O, D, frame_rgb), 5)
            busy, top = device_breakdown(lambda: step(params0, state, world, O, D, frame_rgb))
            idle = "not measured" if busy is None else f"{1 - busy / step_ms[name]:.3f}"
            print(f"phase 12 {name} step (K={K}, grad_tiles={grad_tiles}, lr {lr}): losses "
                  f"{losses}, launches {({k: v for k, v in counts.items() if v})}, all_reduce "
                  f"calls {calls}; {step_ms[name]:.4f} ms a step (CUDA events, mean of 5), one "
                  f"step's device time by torch.profiler "
                  f"{'not measured' if busy is None else f'{busy:.4f} ms'} (idle share {idle}), "
                  f"most: {top}", flush=True)
        # Step 1 of the three modes: the gradients Adam was given within K6's
        # tolerance of the blocking step's (|g - gb| <= 1e-3|gb| + 1e-5 max|gb|,
        # as phase 10 holds K6), and the params within that tolerance carried
        # through Adam's first update lr*g/(|g| + eps): |p - pb| <=
        # lr*(1e-3 + 1e-5 max|gb| / (|gb| + eps)).
        (pb, gb), lb = runs["blocking"][1], runs["blocking"][0][0]
        agree = {}
        for name in ("overlap", "zero"):
            (p, g), loss = runs[name][1], runs[name][0][0]
            if abs(loss - lb) > 1e-5 * abs(lb):
                fail(f"the {name} step's first loss {loss} differs from the blocking {lb}")
            errs = []
            for a, b, pa, pbl in zip(g, gb, (p.density_raw, p.albedo_raw),
                                     (pb.density_raw, pb.albedo_raw)):
                scale = float(b.abs().max())
                if bool(((a - b).abs() > 1e-3 * b.abs() + 1e-5 * scale).any()):
                    fail(f"the {name} step's gradients differ from the blocking step's "
                         f"beyond K6's tolerance: max abs err {max_abs(a, b)}")
                lim = lr * (1e-3 + 1e-5 * scale / (b.abs() + 1e-8))
                if bool(((pa - pbl).abs() > lim).any()):
                    fail(f"the {name} step's params differ from the blocking step's: max abs "
                         f"err {max_abs(pa, pbl)}")
                errs.append((max_abs(a, b), max_abs(pa, pbl)))
            agree[name] = errs
        print(f"phase 12 step 1 against the blocking step (gradients, params; density, "
              f"albedo): {agree}; ms a step (CUDA events, mean of 5; {smi}): {step_ms}",
              flush=True)

        # the entry twin, the dryrun on this one-rank group, the guards
        fn, args = entry.entry(device=dev)
        rgb = fn(*args)
        if tuple(rgb.shape) != (64 * 64, 3) or not bool(torch.isfinite(rgb).all()):
            fail("entry()'s frame is not finite f32[4096, 3]")
        dry = entry.dryrun_multichip(1, device=dev)
        checked = march_checked(world, O, D, max_steps=512, device=dev)
        torch.cuda.synchronize()
        for k in ("hit", "material", "texel", "cell_size", "steps"):
            if not torch.equal(getattr(checked, k), getattr(ref, k)):
                fail(f"march_checked's {k} differs from march's")
        if not torch.equal(checked.t.view(torch.int32), ref.t.view(torch.int32)):
            fail("march_checked's t differs from march's")
        bad = D.clone()
        bad[7, 1] = float("nan")
        zero_counts()
        try:
            march_checked(world, O, bad, max_steps=512, device=dev)
        except GuardError as e:
            if str(e) != "march: non-finite ray direction":
                fail(f"march_checked raised {e!r} on a NaN direction")
        else:
            fail("march_checked did not raise on a NaN direction")
        if read_counts()["march"]:
            fail("march_checked launched K1 before its input checks")
        print(f"phase 12 entry(): {tuple(rgb.shape)} finite; dryrun_multichip(1): losses "
              f"{dry['losses']}; march_checked equal to march on all {n} rays, and raises "
              f"GuardError('march: non-finite ray direction') before any launch", flush=True)
    finally:
        dist.destroy_process_group()


def _rig_grad(rig) -> torch.Tensor:
    """The gradient of a rig of tensor leaves as its 50 floats (zeros for a
    leaf the shading does not read)."""
    return torch.cat([(torch.zeros_like(v) if v.grad is None else v.grad).reshape(-1)
                      for v in rig.leaves()])


def _grad_close(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(values beyond 1e-3 |b| + 1e-5 max|b| (K6's tolerance), max abs err,
    max|b|)."""
    scale = float(b.abs().max()) if b.numel() else 0.0
    bad = int(((a - b).abs() > 1e-3 * b.abs() + 1e-5 * scale).sum())
    return bad, max_abs(a, b), scale


def phase_grad(world, rf, O, D, eye, atlas, env, smap, zero_counts, read_counts, k2_fwd_ms,
               texel_bytes: int, smi: str) -> dict:
    """Phase 13: the differentiable hard frame (render with every
    differentiable input requiring grad: one K1, one wide K2 and one K8 a
    step) against the plain versions of K2 (shade_hits_plain) and K8
    (torch.autograd.grad of shade_hits_plain) on the bench frame,
    shadowless plain and textured and map-shadowed plain and textured with
    the light's depth map given; K8's device time in a cold CUDA graph
    beside its bound and K2's, its ptxas and occupancy, and the contention
    batch; K2 with tables of 40 to 65,536 rows against
    shade_hits_plain; then the port's command line: render at 640x360 and a
    3-step fit, each in a subprocess.  Returns, per case, the launches, the
    errors, the times and K8's bound."""
    import tempfile

    from octree_raymarcher_tpu_torch import kernels
    from octree_raymarcher_tpu_torch.ops.march import MarchResult
    from octree_raymarcher_tpu_torch.shade import LightRig, MaterialTable, RenderConfig
    from octree_raymarcher_tpu_torch.shade.render import (
        ShadeTables,
        _shade_bwd_launch,
        _shade_launch,
        render,
        render_frame,
        shade_hits,
        shade_hits_plain,
        shade_hits_vjp_plain,
        shade_tables,
    )

    dev = O.device
    n = O.shape[0]
    hits = int(rf.hit.sum())
    lights, mats = LightRig.default(), MaterialTable.default()
    cfg = RenderConfig(shadow="none", max_steps=512, assume_resident=True)
    cfg_map = RenderConfig(shadow="map", max_steps=512, assume_resident=True)
    tex = dict(atlas=atlas, envmap=env)
    # each case: its config, textures, depth map and the counters of its
    # wide K2 and its K8 instantiation
    cases = {"none": (cfg, {}, None, "shade_wide", "shade_bwd"),
             "none textured": (cfg, tex, None, "shade_wide textured", "shade_bwd textured"),
             "map": (cfg_map, {}, smap, "shade_map_wide", "shade_bwd_map"),
             "full": (cfg_map, tex, smap, "shade_map_wide textured", "shade_bwd_map textured")}
    keys = ("rig", "diffuse", "specular", "shininess", "eye", "atlas", "envmap", "origins",
            "dirs")
    result, upstream_of = {}, {}
    for name, (c, kw, sm, k2_name, k8_name) in cases.items():
        rig = LightRig.from_numpy(lights, device=dev, requires_grad=True)
        table = MaterialTable.from_numpy(mats, device=dev, requires_grad=True)
        eye_l, o_l, d_l = (t.clone().requires_grad_(True) for t in (eye, O, D))
        tex_l = {k: v.clone().requires_grad_(True) for k, v in kw.items()}
        upstream = {}
        zero_counts()
        out = render(world, o_l, d_l, eye_l, rig, table, c, shadowmap=sm, device=dev, **tex_l)
        out["rgb"].register_hook(lambda g: upstream.__setitem__("rgb", g))
        out["depth"].register_hook(lambda g: upstream.__setitem__("depth", g))
        loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["depth"])
        loss.backward()
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
        want_launches = {"march": 1, k2_name: 1, k8_name: 1}
        if launches != want_launches:
            fail(f"the differentiable {name} frame launched {launches}, want {want_launches}")
        # the wide K2's frame against shade_hits_plain (phase 5's tolerance)
        with torch.no_grad():
            plain = shade_hits_plain(rf, O, D, eye, lights, mats, c, shadowmap=sm, **kw)
        fwd_bad = sum(int(((out[k].detach() - plain[k]).abs() > 1e-5 + 1e-4 * plain[k].abs())
                          .sum()) for k in ("rgb", "depth", "point", "normal"))
        fwd_err = max(max_abs(out[k].detach(), plain[k]) for k in ("rgb", "depth", "point",
                                                                     "normal"))
        if fwd_bad:
            fail(f"the wide K2 ({name}) disagrees with shade_hits_plain on {fwd_bad} values")
        got = {"rig": _rig_grad(rig),
               "diffuse": table.diffuse.grad, "specular": table.specular.grad,
               "shininess": table.shininess.grad, "eye": eye_l.grad, "origins": o_l.grad,
               "dirs": d_l.grad, **{k: v.grad for k, v in tex_l.items()}}
        want = shade_hits_vjp_plain(rf, O, D, eye, lights, mats, c, upstream["rgb"],
                                    upstream["depth"], shadowmap=sm, **kw)
        torch.cuda.synchronize()
        report, bad_total, err_max = {}, 0, 0.0
        for k in keys:
            if got.get(k) is None:
                continue
            bad, err, scale = _grad_close(got[k], want[k])
            if not bool(torch.isfinite(got[k]).all()):
                fail(f"K8 {name}: non-finite gradient of {k}")
            bad_total += bad
            report[k] = (err, scale)
            err_max = max(err_max, err)
        print(f"phase 13 K8 vs plain ({name}, loss mean(rgb^2) + mean(depth), 1080p): max abs "
              f"err, largest |grad| per gradient {report}; values beyond 1e-3|plain| + "
              f"1e-5 max|plain| {bad_total}; the wide K2's frame vs shade_hits_plain: max abs "
              f"err {fwd_err}; launches a step {launches}", flush=True)
        if bad_total:
            fail(f"K8 disagrees with its plain version ({name}) on {bad_total} values")
        result[name] = {"k2": k2_name, "k8": k8_name, "k2_launches": launches[k2_name],
                        "k8_launches": launches[k8_name], "k2_err": fwd_err, "k8_err": err_max}
        upstream_of[name] = (upstream["rgb"].detach(), upstream["depth"].detach())
        del out, loss, got, want, plain, rig, table, eye_l, o_l, d_l, tex_l

    # K8 alone: device time in a cold CUDA graph (the rig, the table and the
    # eye on the card, the rays' gradients not asked for, as a fit of the
    # lights and materials asks), the wide K2 forward of the same step, and
    # the plain version (torch.autograd.grad of shade_hits_plain)
    rig_v = lights.to_tensor(dev)
    cols = tuple(c.to(dev).contiguous() for c in (mats.diffuse, mats.specular, mats.shininess))
    block = np.zeros(56, np.float32)
    block[3:6] = np.asarray(cfg.sky, np.float32)
    wide = ShadeTables(block, eye, cols, mats.num_materials, rig_v)
    for name, (c, kw, sm, _, _) in cases.items():
        g_rgb, g_depth = upstream_of[name]
        smk = {} if sm is None else {"shadowmap": sm}
        result[name].update({
            "K8": cold_graph_ms(
                lambda r, o, d, gr, gd: _shade_bwd_launch(r, o, d, eye, rig_v, cols, c, gr, gd,
                                                          **kw, **smk),
                (rf, O, D, g_rgb, g_depth), TIMED_ITERS),
            "K2 wide": cold_graph_ms(
                lambda r, o, d: _shade_launch(r, o, d, wide, c, **kw, **smk), (rf, O, D),
                TIMED_ITERS),
            "plain": cuda_ms(lambda: shade_hits_vjp_plain(rf, O, D, eye, lights, mats, c, g_rgb,
                                                          g_depth, **kw, **smk), 1)})
    # K8's bound, the bytes and operations the timed function needs (no ray
    # gradients asked): every ray's hit byte; a hit's o, d, cell, t,
    # material and upstream rgb and depth (64 bytes); the rig, the eye and
    # the table read and their gradients written once.  A miss of an
    # untextured frame adds to no gradient.  Textured: a miss reads d and
    # its upstream rgb (the sky sample is linear in the taps, so their
    # gradients need no tap values), a hit its atlas texel, and the atlas's
    # and sky map's gradients are written once.  Map-shadowed: the depth
    # map is read.
    table_bytes = sum(x.nbytes for x in cols)
    for name, (c, kw, sm, _, _) in cases.items():
        nbytes = n + hits * 64 + 2 * (53 * 4 + table_bytes)
        ops = SHADE_BWD_OPS_PER_HIT * hits
        if kw:
            nbytes += (n - hits) * 24 + texel_bytes + atlas.nbytes + env.nbytes
            ops += SHADE_BWD_TEX_OPS_PER_HIT * hits + SHADE_BWD_TEX_OPS_PER_MISS * (n - hits)
        if sm is not None:
            nbytes += sm[0].numel() * 4
            ops += (PROJECT_OPS - 7) * hits
        result[name]["bound"] = bound_ms(nbytes, ops)
        result[name]["bytes"] = nbytes
    print(f"phase 13 device ms per launch in a cold CUDA graph (inputs rotated past the L2; "
          f"{smi}): " + "; ".join(
              f"{name}: K8 {t['K8']:.4f} ms, bound {t['bound'][0]:.5f} ms by {t['bound'][1]} "
              f"({t['bytes']} bytes, {t['bound'][0] / t['K8']:.4f} of it), K2 with the rig by "
              f"pointer {t['K2 wide']:.4f} ms (by value {k2_fwd_ms[name]:.4f}), plain K8 "
              f"(autograd of shade_hits_plain) {t['plain']:.2f} ms"
              for name, t in result.items()), flush=True)
    # K8's registers and spills (ptxas) and the blocks of 256 threads an SM
    # they and its shared memory allow: the rig and eye columns (53 x 256
    # floats), the staged rows (7 floats a row) and 208 static bytes; 64 K
    # registers (allocated 8 a thread at a time) and 228 KB an SM, 1 KB of it
    # reserved a block
    report = ptxas_report(kernels.build_log())
    for name, (c, kw, sm, _, _) in cases.items():
        info = report[f"shade_bwd_kernel<{int(sm is not None)},{int(bool(kw))}>"]
        regs = int(re.search(r"Used (\d+) registers", info).group(1))
        spills = re.search(r"(\d+) bytes spill stores", info).group(1)
        smem = 53 * 256 * 4 + mats.num_materials * 7 * 4 + 208
        blocks = min(65536 // (-(-regs // 8) * 8 * 256), 233472 // (smem + 1024))
        result[name].update(regs=regs, spills=int(spills), blocks_per_sm=blocks)
    print("phase 13 K8 ptxas and occupancy: " + "; ".join(
        f"{name}: {t['regs']} registers, {t['spills']} bytes spilled, {t['blocks_per_sm']} "
        f"blocks of 256 an SM" for name, t in result.items()), flush=True)
    for name, t in result.items():
        if t["spills"] or t["blocks_per_sm"] < 2:
            fail(f"K8 ({name}) spills {t['spills']} bytes or fits {t['blocks_per_sm']} blocks")

    # the contention batch: the textured K8 at 1080p on warps that alternate
    # all hit and all miss, every hit on one atlas texel (the top face of
    # the unit cell at the origin, material 3) and every miss on one
    # bilinear cell of the sky map (the same four taps), jittered inside
    # them; held to the plain VJP and timed
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    hit_c = (torch.arange(n, device=dev) // 32) % 2 == 0
    res_r = atlas.shape[1]
    jit = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * 0.6
    pc = torch.stack([1.0 - (5.5 + jit[:, 0]) / res_r, torch.ones(n, device=dev),
                      1.0 - (7.5 + jit[:, 1]) / res_r], 1)
    down = torch.cat([(torch.rand((n, 1), generator=gen, device=dev) - 0.5) * 0.6,
                      -torch.ones((n, 1), device=dev),
                      (torch.rand((n, 1), generator=gen, device=dev) - 0.5) * 0.6], 1)
    h_e, w_e = env.shape[0], env.shape[1]
    xs = 40.25 + (torch.rand(n, generator=gen, device=dev) - 0.5) * 0.2
    ys = 20.25 + (torch.rand(n, generator=gen, device=dev) - 0.5) * 0.2
    phi = ((xs + 0.5) / w_e - 0.5) * 2.0 * np.pi
    theta = (ys + 0.5) / h_e * np.pi
    sky_d = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                         torch.sin(theta) * torch.sin(phi)], 1)
    dc = torch.where(hit_c[:, None], down, sky_d)
    dc = (dc / dc.norm(dim=1, keepdim=True)).contiguous()
    tc = 2.0 + 18.0 * torch.rand(n, generator=gen, device=dev)
    oc = torch.where(hit_c[:, None], pc - dc * (tc - 1.0 / 4096.0)[:, None],
                     torch.rand((n, 3), generator=gen, device=dev)).contiguous()
    rc = MarchResult(hit=hit_c, t=torch.where(hit_c, tc, torch.inf).contiguous(),
                     material=torch.where(hit_c, 3, 0).to(torch.int32),
                     cell_bmin=torch.zeros((n, 3), device=dev),
                     cell_size=torch.ones(n, device=dev),
                     steps=torch.zeros(n, dtype=torch.int32, device=dev),
                     texel=torch.full((n,), -1, dtype=torch.int32, device=dev))
    g_rgb = torch.randn((n, 3), generator=gen, device=dev)
    g_depth = torch.randn(n, generator=gen, device=dev)
    want = shade_hits_vjp_plain(rc, oc, dc, eye, lights, mats, cfg, g_rgb, g_depth, **tex)
    got = _shade_bwd_launch(rc, oc, dc, eye, rig_v, cols, cfg, g_rgb, g_depth, **tex,
                            want_o=True, want_d=True)
    torch.cuda.synchronize()
    bad, cerr = 0, 0.0
    for k in keys:
        b, err, _ = _grad_close(got[k], want[k])
        bad, cerr = bad + b, max(cerr, err)
    texels_c = int((got["atlas"].abs().sum(-1) > 0).sum())
    taps_c = int((got["envmap"].abs().sum(-1) > 0).sum())
    if bad or (texels_c, taps_c) != (1, 4):
        fail(f"K8 on the contention batch: {bad} values beyond the tolerance, {texels_c} "
             f"texels and {taps_c} taps with a gradient (want 1 and 4)")
    contention_ms = cold_graph_ms(
        lambda r, o, d, gr, gd: _shade_bwd_launch(r, o, d, eye, rig_v, cols, cfg, gr, gd, **tex),
        (rc, oc, dc, g_rgb, g_depth), TIMED_ITERS)
    print(f"phase 13 K8 contention batch (1080p, every hit on one atlas texel, every miss on "
          f"one set of four sky taps): max abs err vs plain {cerr}, values "
          f"beyond 1e-3|plain| + 1e-5 max|plain| 0; device ms a launch in a cold CUDA graph "
          f"{contention_ms:.4f} (the textured frame's {result['none textured']['K8']:.4f})",
          flush=True)
    del rc, oc, dc, g_rgb, g_depth, want, got

    # K2 with tables past the parameter block: by pointer, each hit's row
    # read from the columns through __ldg, ids spread over the table and
    # past its ends on every hit
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    wide_ms, wide_err = {}, 0.0
    for rows in (40, 300, 2048, 8192, 65536):
        table = MaterialTable(*(torch.rand(sh, generator=gen, device=dev)
                                for sh in ((rows, 3), (rows, 3), (rows, 3))),
                              1.0 + 99.0 * torch.rand(rows, generator=gen, device=dev))
        ids = torch.randint(-3, rows + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
        r2 = dataclasses.replace(rf, material=torch.where(rf.hit, ids, rf.material))
        a = shade_hits(r2, O, D, eye, lights, table, cfg)
        b = shade_hits_plain(r2, O, D, eye, lights, table, cfg)
        torch.cuda.synchronize()
        bad = sum(int(((a[k] - b[k]).abs() > 1e-5 + 1e-4 * b[k].abs()).sum())
                  for k in ("rgb", "depth", "point", "normal"))
        err = max(max_abs(a[k], b[k]) for k in ("rgb", "depth", "point", "normal"))
        wide_err = max(wide_err, err)
        if bad:
            fail(f"K2 with a {rows}-row table disagrees with shade_hits_plain on {bad} values")
        tables = shade_tables(eye, lights, table, cfg, dev)
        wide_ms[rows] = cold_graph_ms(lambda r, o, d: _shade_launch(r, o, d, tables, cfg),
                                      (r2, O, D), TIMED_ITERS)
        del a, b, r2, table, ids
    print(f"phase 13 K2 with wide tables vs shade_hits_plain (1e-5 + 1e-4|plain|): max abs "
          f"err {wide_err}; device ms per launch in a cold CUDA graph { {k: round(v, 5) for k, v in wide_ms.items()} } "
          f"(8 rows by value: {k2_fwd_ms['none']:.4f})", flush=True)
    result = {"cases": result, "wide_ms": wide_ms, "wide_err": wide_err}

    # the command line: render at 640x360 against the frame rendered here
    # from the same world and camera, and a 3-step fit of 2 views at 64x64
    from octree_raymarcher_tpu_torch.shade import PerspectiveCamera
    from octree_raymarcher_tpu_torch.world.world import World

    with tempfile.TemporaryDirectory() as tmp:
        # both subprocesses start together; the frame is rendered here meanwhile
        cmd = [sys.executable, "-m", "octree_raymarcher_tpu_torch"]
        t0 = time.time()
        procs = {
            "render": subprocess.Popen(
                cmd + ["render", "--device", "cuda", "--res", "640x360", "--out",
                       os.path.join(tmp, "frame.png")], cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
            "fit": subprocess.Popen(
                cmd + ["fit", "--device", "cuda", "--steps", "3", "--res-fit", "64", "--out",
                       os.path.join(tmp, "fit")], cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env={**os.environ, "FIT_VIEWS": "2"})}
        try:
            cw = World.generate(dims=(2, 2, 2), chunksize=64.0, depth=6, seed=0,
                                water_level=6.0, amplitude=32.0).to_device(device=dev)[1]
            cam = PerspectiveCamera(position=(64.0, 128.0 * 0.9, -0.6 * 128.0), yaw_deg=0.0,
                                    pitch_deg=-25.0, fov_deg=70.0, width=640, height=360)
            co, cd = cam.rays()
            hit = float(render_frame(cw, co, cd, np.asarray(cam.position, np.float32),
                                     cfg=RenderConfig(shadow="map", max_steps=512),
                                     device=dev)["hit"].float().mean())
            outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        cli_s = time.time() - t0
        for k, p in procs.items():
            if p.returncode != 0:
                fail(f"the CLI {k} failed: {outs[k][1][-2000:]}")
        line = json.loads(outs["render"][0].strip().splitlines()[-1])
        if line["hit_frac"] != round(hit, 3) or line["device"] != torch.cuda.get_device_name(0):
            fail(f"the CLI render gave {line}, the frame's hit fraction is {hit}")
        rec = json.loads(open(os.path.join(tmp, "fit", "bench_fit_result.json")).read())
        losses = rec["losses"]
        if len(losses) != 3 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"the CLI fit's losses are not finite and falling: {losses}")
    print(f"phase 13 CLI render (640x360, map shadows): {line} (the frame's hit fraction "
          f"{hit:.4f}); CLI fit (3 steps, 2 views at 64x64): losses {losses}, {rec['device']}, "
          f"{rec['power_limit']}; both subprocesses {cli_s:.1f} s with their interpreters' "
          f"start", flush=True)
    return result


def kernel_device_ms(fn, tags: dict, calls: int = 3) -> dict:
    """{name: device ms a call of fn, summed over the kernels whose name
    holds the tag} from torch.profiler over ``calls`` calls, and under
    "records" the kernel records a call found for each tag (a trace can
    miss a graph's first kernels; the records show it); {} when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, records = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        for name, tag in tags.items():
            if tag in e.key and us > 0:
                ms[name] = ms.get(name, 0.0) + us / 1e3 / calls
                records[name] = records.get(name, 0) + e.count / calls
    if not ms:
        return {}
    return {**{k: round(v, 4) for k, v in ms.items()}, "records": records}


def replay_ms(kind: str, iters: int = TIMED_ITERS) -> float:
    """Device ms of the newest captured call of ``kind`` (ops/march_compact
    :class:`CapturedCall`): CUDA events around its replays alone, on the
    inputs of its last call (whose outputs it rewrites)."""
    from octree_raymarcher_tpu_torch.ops import march_compact as MC

    call = next(reversed(MC._GRAPHS[kind].values()))
    return cuda_ms(call.graph.replay, iters)


def phase_compact(ctx, zero_counts, read_counts, smi: str) -> dict:
    """Phase 14: the stage-compacted march (K9, K10) on the bench frame's
    three ray sets, the compacted frames, the compacted sampler and fit, the
    compacted light pass, and the frames under the sync debug mode."""
    from octree_raymarcher_tpu_torch import kernels
    from octree_raymarcher_tpu_torch.diff import fit
    from octree_raymarcher_tpu_torch.diff.segments import sample_segments
    from octree_raymarcher_tpu_torch.diff.segments_compact import (
        sample_segments_compact,
        sample_segments_compact_plain,
        sampler_schedule,
    )
    from octree_raymarcher_tpu_torch.ops import march_compact as MC
    from octree_raymarcher_tpu_torch.ops.march import march
    from octree_raymarcher_tpu_torch.shade import render_frame
    from octree_raymarcher_tpu_torch.shade.shadow import render_shadowmap

    c = ctx
    world, dev, K = c["world"], c["dev"], c["K"]
    sched = MC.default_schedule(512, 16)
    n_stages = len(sched)
    out = {}
    regs = {name: info for name, info in ptxas_report(kernels.build_log()).items()
            if name.startswith("compact_stage_kernel")}
    out["k9_ptxas"] = regs
    print(f"phase 14 K9 stage ptxas (frame march <0>, sampler <1>): {regs}", flush=True)

    def host_ms(fn, iters: int = TIMED_ITERS) -> float:
        """Mean host ms to enqueue one call (no synchronisation inside)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t_host = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return t_host

    # ---- the compacted march on the camera, shadow and light rays -------------------
    sets = {"camera": (c["O"], c["D"], None, True, c["rk"]),
            "shadow": (c["start"], c["sdirs"], c["live"], False, c["sk"]),
            "light": (c["lorig"], c["ldirs"], None, True, c["lk"])}
    march_rows = {}
    tags = {"entry": "compact_entry_kernel", "stage": "compact_stage_kernel",
            "count": "partition_count", "scatter": "partition_scatter"}
    for name, (o, d, live, resident, ref) in sets.items():
        kw = dict(live_start=live, assume_resident=resident, device=dev)
        zero_counts()
        res, lanes = MC.march_frame_compact(world, o, d, 512, **kw)
        torch.cuda.synchronize()
        per_call = {k: v for k, v in read_counts().items() if v}
        want = {"compact_entry": 1, "compact_stage": n_stages, "partition": n_stages}
        if per_call != want:
            fail(f"the compacted {name} march launched {per_call}, want {want}")
        mism = march_mismatches(res, ref)
        mism.pop("steps")
        if max(mism.values()) > 0:
            fail(f"the compacted {name} march differs from K1: {mism}")
        exact = ref.steps
        if not (bool((res.steps >= exact).all())
                and bool((res.steps <= exact + max(sched)).all())):
            fail(f"the compacted {name} march's coarse steps leave their bounds")
        plain_ms, (resp, lanes_p) = cuda_ms_once(
            lambda: MC.march_frame_compact_plain(world, o, d, 512, live_start=live,
                                                 assume_resident=resident))
        pm = march_mismatches(res, resp)
        err = max_abs(res.t[res.hit], resp.t[res.hit])
        if max(pm.values()) > 0 or int(lanes) != int(lanes_p):
            fail(f"the compacted {name} march differs from its plain version: {pm}, "
                 f"lane_iters {int(lanes)} against {int(lanes_p)}")
        del resp
        ms = cuda_ms(lambda: MC.march_frame_compact(world, o, d, 512, **kw), TIMED_ITERS)
        enqueue = host_ms(lambda: MC.march_frame_compact(world, o, d, 512, **kw))
        span = replay_ms("march")
        k1_ms = cuda_ms(lambda: march(world, o, d, 512, live_start=live,
                                      assume_resident=resident, device=dev), TIMED_ITERS)
        prof = kernel_device_ms(lambda: MC.march_frame_compact(world, o, d, 512, **kw), tags)
        st, _ = MC.compact_begin(world, o, d, live_start=live, device=dev)
        MC.compact_stages(world, st, sched, assume_resident=resident, last=True)
        MC.compact_finish(world, st)
        history = [int(v) for v in torch.cat(st.history).tolist()]
        steps = int(exact.to(torch.int64).sum())
        eff_c = steps / int(lanes) if int(lanes) else 1.0
        eff_k1 = simt_efficiency(exact)
        march_rows[name] = {"ms": ms, "k1_ms": k1_ms, "plain_ms": plain_ms,
                            "lane_iters": int(lanes), "steps": steps, "eff": eff_c,
                            "k1_eff": eff_k1, "profile": prof, "history": history,
                            "n": o.shape[0], "err": err, "host_ms": enqueue,
                            "replay_ms": span,
                            "launches": sum(per_call.values())}
        print(f"phase 14 compacted march, {name} rays ({o.shape[0]}): equal to K1 on every "
              f"ray (hit, t, material, texel, cell bit for bit), steps within [exact, exact + "
              f"{max(sched)}], equal to its plain version (lane_iters {int(lanes)}); ms a call "
              f"(CUDA events, mean of {TIMED_ITERS}; {smi}): {ms:.4f}, K1 {k1_ms:.4f} (plain "
              f"{plain_ms:.1f}); the host's enqueue of a call (one graph replay) "
              f"{enqueue:.4f} ms; the replay alone {span:.4f} ms (CUDA events); "
              f"launches a call {sum(per_call.values())} {per_call}; SIMT efficiency "
              f"compacted {eff_c:.4f} (sum of steps {steps} / lane_iters), K1 {eff_k1:.4f}; "
              f"device ms of one call by torch.profiler {prof or 'no device events traced'}; "
              f"live count after the entry and each stage {history}", flush=True)
    out["march"] = march_rows
    O, D = c["O"], c["D"]

    # a second camera batch of the same shape replays the same graph with
    # fresh outputs: its result is K1's on those rays, the first unchanged
    res_a, _ = MC.march_frame_compact(world, O, D, 512, assume_resident=True, device=dev)
    keep = res_a.t.clone()
    O2, D2 = O.flip(0).contiguous(), D.flip(0).contiguous()
    res_b, _ = MC.march_frame_compact(world, O2, D2, 512, assume_resident=True, device=dev)
    k1_b = march(world, O2, D2, 512, assume_resident=True, device=dev)
    mism = march_mismatches(res_b, k1_b)
    mism.pop("steps")
    if max(mism.values()) > 0 or not torch.equal(res_a.t, keep):
        fail(f"a second camera batch through the captured march: {mism}, first result kept "
             f"{torch.equal(res_a.t, keep)}")
    print("phase 14 a second camera batch (the rays reversed) through the same captured "
          "march: equal to K1 on those rays; the first call's result unchanged", flush=True)
    del res_a, res_b, k1_b, O2, D2, keep

    # other schedules on the camera rays: one stage of 512 iterations is one
    # K1 launch's work in K9, then coarser and finer stages
    sweep = {}
    for label, sc in (("1x512", (512,)), ("4x128", (128,) * 4), ("16x32", (32,) * 16),
                      ("default", sched)):
        kw = dict(assume_resident=True, schedule=sc, device=dev)
        res_s, lanes_s = MC.march_frame_compact(world, O, D, 512, **kw)
        mism = march_mismatches(res_s, c["rk"])
        mism.pop("steps")
        if max(mism.values()) > 0:
            fail(f"the compacted camera march with the schedule {label} differs from K1: {mism}")
        sweep[label] = {
            "ms": cuda_ms(lambda: MC.march_frame_compact(world, O, D, 512, **kw), TIMED_ITERS),
            "lane_iters": int(lanes_s),
            "profile": kernel_device_ms(lambda: MC.march_frame_compact(world, O, D, 512, **kw),
                                        tags)}
    out["sweep"] = sweep
    print(f"phase 14 compacted camera march by schedule (equal to K1 on every ray; ms a call "
          f"by CUDA events, lane_iters, device ms by torch.profiler): {sweep}", flush=True)

    # K9's entry and K10 alone on the camera rays' first pack (repeatable calls)
    n = O.shape[0]
    res0 = MC._miss_result(n, dev, False)
    t0 = torch.empty(n, dtype=torch.float32, device=dev)
    flag0 = torch.empty(n, dtype=torch.uint8, device=dev)
    rows = MC.Rows.empty(n, dev, True)
    scratch = MC.partition_scratch(n, dev, False)
    everyone = torch.full((1,), n, dtype=torch.int64, device=dev)
    table0 = MC.out_table(dev, res0, lanes=torch.zeros(1, dtype=torch.int64, device=dev))
    entry_ms = cuda_ms(lambda: MC._entry_launch(world, O, D, None, t0, flag0, table0),
                       TIMED_ITERS)
    src = MC.Rows(O, D, t0, None, None)
    part_ms = cuda_ms(lambda: MC.partition(flag0, src, everyone, rows, block_counts=scratch),
                      TIMED_ITERS)
    live_k, _ = MC.partition(flag0, src, everyone, rows, block_counts=scratch)
    rows_p = MC.Rows.empty(n, dev, True)
    part_plain_ms, (live_p, _) = cuda_ms_once(
        lambda: MC.partition_plain(flag0, src, everyone, rows_p))
    L = int(live_k)
    if L != int(live_p) or not all(torch.equal(getattr(rows, f)[:L], getattr(rows_p, f)[:L])
                                   for f in ("o", "d", "t", "orig", "charge")):
        fail("K10 differs from partition_plain on the camera rays' first pack")
    t_p, flag_p = MC.entry_plain(world, O, D, None)
    entry_plain_ms = cuda_ms(lambda: MC.entry_plain(world, O, D, None), 3)
    if not (torch.equal(t_p[flag_p == 1], t0[flag0 == 1]) and torch.equal(flag_p, flag0)):
        fail("K9's entry differs from entry_plain on the camera rays")
    nz_ms = cuda_ms(lambda: torch.nonzero(flag0 == 1), TIMED_ITERS)
    out["entry"] = {"ms": entry_ms, "plain_ms": entry_plain_ms, "err": max_abs(t_p, t0),
                    "bound": bound_ms(n * (24 + 4 + 1), 0)}
    # K10 must read every flag and the rows of the rays it moves (o, d, t),
    # and write their rows (o, d, t, orig, charge)
    out["partition"] = {"ms": part_ms, "plain_ms": part_plain_ms, "library_ms": nz_ms,
                        "err": max_abs(rows.t[:L], rows_p.t[:L]),
                        "bound": bound_ms(n + L * (28 + 40), 0), "live": L}
    print(f"phase 14 K9 entry alone (camera rays): {entry_ms:.4f} ms (plain "
          f"{entry_plain_ms:.3f}); K10 alone on the first pack ({n} flags, {L} live): "
          f"{part_ms:.4f} ms (plain {part_plain_ms:.3f}), bound "
          f"{out['partition']['bound'][0]:.5f} ms by bytes; torch.nonzero of the same "
          f"flags {nz_ms:.4f} ms (its size goes to the host: a synchronisation a call)",
          flush=True)

    # ---- the compacted frames against the plain ones -------------------------------------
    frames = {"none": (c["cfg"], {}), "ray": (c["cfg_ray"], {}), "map": (c["cfg_map"], {}),
              "full": (c["cfg_map"], dict(atlas=c["atlas"], envmap=c["env"]))}
    eye = c["eye"]
    frame_rows = {}
    for name, (cfg, kw) in frames.items():
        want = render_frame(world, O, D, eye, cfg=cfg, device=dev, **kw)
        got = render_frame(world, O, D, eye, cfg=cfg, compact=True, device=dev, **kw)
        torch.cuda.synchronize()
        bad = {k: int((~(got[k] == want[k]).reshape(n, -1).all(dim=1)).sum())
               for k in ("rgb", "depth", "hit", "material", "point", "normal")}
        if any(bad.values()):
            fail(f"the compacted {name} frame differs from the plain one: {bad}")
        ms_c = cuda_ms(lambda: render_frame(world, O, D, eye, cfg=cfg, compact=True,
                                            device=dev, **kw), TIMED_ITERS)
        ms_p = cuda_ms(lambda: render_frame(world, O, D, eye, cfg=cfg, device=dev, **kw),
                       TIMED_ITERS)
        frame_rows[name] = {"ms": ms_c, "plain_ms": ms_p, "lane_iters": int(got["lane_iters"])}
        print(f"phase 14 compacted {name} frame: equal to compact=False on every pixel (rgb, "
              f"depth, hit, material, point, normal bit for bit); ms/frame {ms_c:.4f} against "
              f"{ms_p:.4f}; lane_iters {int(got['lane_iters'])}", flush=True)
    out["frames"] = frame_rows
    eye_host = c["eye_host"]
    for name, (cfg, kw) in frames.items():        # the light-bundle cache, filled
        render_frame(world, O, D, eye_host, cfg=cfg, compact=True, device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, (cfg, kw) in frames.items():
            render_frame(world, O, D, eye_host, cfg=cfg, compact=True, device=dev, **kw)
        sample_segments_compact(world, O[:65536], D[:65536], 4, 512, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("phase 14 the four compacted frames and the compacted sampler under "
          "torch.cuda.set_sync_debug_mode('error'): no synchronisation", flush=True)

    # ---- the compacted light pass ---------------------------------------------------------
    lights = c["lights"]
    depth_c, vp_c, lanes_l = render_shadowmap(world, lights, max_steps=512, compact=True,
                                              assume_resident=True)
    depth_p, vp_p = render_shadowmap(world, lights, max_steps=512, assume_resident=True)
    torch.cuda.synchronize()
    if not (torch.equal(depth_c, depth_p) and torch.equal(vp_c, vp_p)):
        fail("render_shadowmap(compact=True) differs from the plain light pass")
    print(f"phase 14 render_shadowmap(compact=True): the 512x512 depth map equal to the light-"
          f"depth K1's bit for bit; lane_iters {int(lanes_l)}", flush=True)

    # ---- the compacted sampler and fit ------------------------------------------------------
    segs = c["segs"]
    s_stages = len(sampler_schedule(512, K)[0])
    sample_segments_compact(world, O, D, K, 512, device=dev)     # captured here
    zero_counts()
    got, ex = sample_segments_compact(world, O, D, K, 512, device=dev)
    torch.cuda.synchronize()
    sampler_calls = {k: v for k, v in read_counts().items() if v}
    want = {"sampler_entry": 1, "sampler_stage": s_stages, "partition": s_stages}
    if sampler_calls != want:
        fail(f"the compacted sampler launched {sampler_calls}, want {want}")
    bad = {k: int((getattr(got, k) != getattr(segs, k)).sum())
           for k in ("slot", "t0", "t1", "count")}
    if any(bad.values()):
        fail(f"the compacted sampler differs from K4 at K={K}: {bad}")
    executed = [int(v) for v in ex]
    s_plain_ms, (gp, ex_p) = cuda_ms_once(
        lambda: sample_segments_compact_plain(world, O, D, K, 512))
    bad = {k: int((getattr(got, k) != getattr(gp, k)).sum())
           for k in ("slot", "t0", "t1", "count")}
    if any(bad.values()) or executed != [int(v) for v in ex_p]:
        fail(f"the compacted sampler differs from its plain version: {bad}")
    s_err = max(max_abs(got.t0, gp.t0), max_abs(got.t1, gp.t1))
    del gp, got
    sprof = kernel_device_ms(lambda: sample_segments_compact(world, O, D, K, 512, device=dev),
                             tags)
    sink = MC.SegmentSink(torch.empty_like(segs.slot), torch.empty_like(segs.t0),
                          torch.empty_like(segs.t1), torch.empty_like(segs.count),
                          int(world.twig.shape[0]), 8)
    t1 = torch.empty(n, dtype=torch.float32, device=dev)
    flag1 = torch.empty(n, dtype=torch.uint8, device=dev)
    table1 = MC.out_table(dev, sink=sink, lanes=torch.zeros(K, dtype=torch.int64, device=dev))
    s_entry_ms = cuda_ms(lambda: MC._entry_launch(world, O, D, None, t1, flag1, table1, K),
                         TIMED_ITERS)
    if not (torch.equal(flag1, flag0) and torch.equal(t1, t0)):
        fail("the sampler's K9 entry differs from the frame march's")
    del sink
    s_ms = cuda_ms(lambda: sample_segments_compact(world, O, D, K, 512, device=dev), 5)
    s_host = host_ms(lambda: sample_segments_compact(world, O, D, K, 512, device=dev), 5)
    s_span = replay_ms("sampler", 5)
    s_live = [int(v) for v in next(reversed(MC._GRAPHS["sampler"].values())).bufs["counts"]]
    k4_ms = cuda_ms(lambda: sample_segments(world, O, D, K, 512, device=dev), 5)
    # other stage schedules: a given per-phase schedule's stages, then doubling
    s_sweep = {}
    for label, sc in (("stride 16", MC.default_schedule(512, 16)),
                      ("stride 64", MC.default_schedule(512, 64))):
        g_s, _ = sample_segments_compact(world, O, D, K, 512, schedule=sc, device=dev)
        if not all(torch.equal(getattr(g_s, k), getattr(segs, k))
                   for k in ("slot", "t0", "t1", "count")):
            fail(f"the compacted sampler with the per-phase schedule {label} differs from K4")
        del g_s
        s_sweep[label] = {
            "stages": len(sampler_schedule(512, K, 16, sc)[0]),
            "ms": cuda_ms(lambda: sample_segments_compact(world, O, D, K, 512, schedule=sc,
                                                          device=dev), 5),
            "profile": kernel_device_ms(lambda: sample_segments_compact(
                world, O, D, K, 512, schedule=sc, device=dev), tags)}
    print(f"phase 14 compacted sampler by stage schedule (K={K}; equal to K4; ms a call by "
          f"CUDA events, device ms by torch.profiler): {s_sweep}", flush=True)
    views, params0 = c["views"], c["params0"]
    fit_c = cuda_ms(lambda: fit(world, views, params0, steps=1, lr=0.05, max_segments=K,
                                compact=True, device=dev), 3)
    fit_p = cuda_ms(lambda: fit(world, views, params0, steps=1, lr=0.05, max_segments=K,
                                device=dev), 3)
    _, h_c = fit(world, views, params0, steps=2, lr=0.05, max_segments=K, compact=True,
                 device=dev)
    _, h_p = fit(world, views, params0, steps=2, lr=0.05, max_segments=K, device=dev)
    if h_c != h_p:
        fail(f"fit(compact=True) gave {h_c}, fit {h_p}")
    out["sampler"] = {"ms": s_ms, "k4_ms": k4_ms, "plain_ms": s_plain_ms,
                      "executed": executed, "launches": sum(sampler_calls.values()),
                      "fit_ms": fit_c, "fit_plain_ms": fit_p, "entry_ms": s_entry_ms,
                      "profile": sprof, "err": s_err, "host_ms": s_host, "stages": s_stages,
                      "sweep": s_sweep, "replay_ms": s_span, "live": s_live}
    print(f"phase 14 compacted sampler (K={K}, {n} rays, {s_stages} stages): segments equal "
          f"to K4's and to its plain version on every ray; {s_ms:.4f} ms a call (K4 "
          f"{k4_ms:.4f}, plain {s_plain_ms:.1f}); the host's enqueue of a call {s_host:.4f} "
          f"ms, the replay alone {s_span:.4f} ms; rays in each stage's prefix {s_live}; "
          f"device ms of one call by torch.profiler "
          f"{sprof or 'no device events traced'}; its K9 entry alone {s_entry_ms:.4f} ms; "
          f"launches a call {sampler_calls}; lanes executed per phase "
          f"{executed} (sum {sum(executed)}); one fit step with the geometry pass: compact "
          f"{fit_c:.4f} ms, K4 {fit_p:.4f} ms; fit(compact=True) losses equal to fit's: {h_c}",
          flush=True)

    # ---- the launch counters on the compacted paths ---------------------------------------
    zero_counts()
    for name, (cfg, kw) in frames.items():
        render_frame(world, O, D, eye, cfg=cfg, compact=True, device=dev, **kw)
    fit(world, views, params0, steps=1, lr=0.05, max_segments=K, compact=True, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    for k in ("compact_entry", "compact_stage", "sampler_entry", "sampler_stage", "partition"):
        if counts[k] == 0:
            fail(f"kernel {k} was not launched by the compacted paths")
    out["launches"] = counts
    print(f"phase 14 launches of the four compacted frames and one fit(compact=True) step: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    from octree_raymarcher_tpu_torch import kernels
    from octree_raymarcher_tpu_torch.ops.march import (
        MARCH_DEPTH_KERNEL,
        MARCH_KERNEL,
        march,
        march_depth,
        march_depth_plain,
        march_plain,
    )
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
    from octree_raymarcher_tpu_torch.diff.composite import (
        COMPOSITE_BWD_KERNEL,
        COMPOSITE_FWD_KERNEL,
        SKY,
        VoxelParams,
        _composite_bwd_cuda,
        _composite_fwd_cuda,
        composite,
        composite_backward_plain,
        composite_plain,
        composite_plan,
    )
    from octree_raymarcher_tpu_torch.diff import fit, init_params_from_world, render_soft
    from octree_raymarcher_tpu_torch.diff.optim import photometric_loss, sample_views
    from octree_raymarcher_tpu_torch.diff.segments import (
        SEGMENTS_KERNEL,
        SegmentBatch,
        _sample_segments_plain,
        sample_segments,
        sample_segments_plain,
    )
    from octree_raymarcher_tpu_torch.shade import shadow as S
    from octree_raymarcher_tpu_torch.shade.render import (
        SHADE_BWD_KERNELS,
        SHADE_KERNEL,
        SHADE_MAP_KERNEL,
        SHADE_MAP_TEX_KERNEL,
        SHADE_TEX_KERNEL,
        SHADE_WIDE_KERNELS,
        _ray_shadow_hits,
        _shade_launch,
        shade_tables,
    )
    from octree_raymarcher_tpu_torch.ops import march_compact as MC
    from octree_raymarcher_tpu_torch.world.alloc import PATCH_KERNEL
    from octree_raymarcher_tpu_torch.world.world import World

    counters = {"march": MARCH_KERNEL, "march_depth": MARCH_DEPTH_KERNEL,
                "shade": SHADE_KERNEL, "shade textured": SHADE_TEX_KERNEL,
                "shade_map": SHADE_MAP_KERNEL, "shade_map textured": SHADE_MAP_TEX_KERNEL,
                "ray_prep": S.RAY_PREP_KERNEL, "shadow_resolve": S.SHADOW_RESOLVE_KERNEL,
                "map_project": S.MAP_PROJECT_KERNEL, "segments": SEGMENTS_KERNEL,
                "composite_fwd": COMPOSITE_FWD_KERNEL,
                "composite_bwd": COMPOSITE_BWD_KERNEL, "patch": PATCH_KERNEL,
                "shade_wide": SHADE_WIDE_KERNELS[(False, False)],
                "shade_wide textured": SHADE_WIDE_KERNELS[(False, True)],
                "shade_map_wide": SHADE_WIDE_KERNELS[(True, False)],
                "shade_map_wide textured": SHADE_WIDE_KERNELS[(True, True)],
                "shade_bwd": SHADE_BWD_KERNELS[(False, False)],
                "shade_bwd textured": SHADE_BWD_KERNELS[(False, True)],
                "shade_bwd_map": SHADE_BWD_KERNELS[(True, False)],
                "shade_bwd_map textured": SHADE_BWD_KERNELS[(True, True)],
                "compact_entry": MC.COMPACT_ENTRY_KERNEL, "compact_stage": MC.COMPACT_STAGE_KERNEL,
                "sampler_entry": MC.SAMPLER_ENTRY_KERNEL, "sampler_stage": MC.SAMPLER_STAGE_KERNEL,
                "partition": MC.PARTITION_KERNEL}

    def zero_counts():
        for k in counters.values():
            k.launches = 0

    def read_counts() -> dict:
        return {name: k.launches for name, k in counters.items()}

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
    for name, info in ptxas_report(kernels.build_log()).items():
        if any(k in name for k in ("march_kernel", "segments_kernel", "shade_kernel",
                                   "shade_bwd_kernel", "patch_kernel", "compact_", "partition_")):
            print(f"phase 1 ptxas {name}: {info}", flush=True)

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
    mism = march_mismatches(rk, rp)
    print(f"phase 4 march K1 vs plain: mismatching rays {mism} (t compared bit for bit)",
          flush=True)
    if max(mism.values()) > 0:
        fail(f"K1 disagrees with march_plain: {mism}")
    both = rk.hit & rp.hit
    march_err = float((rk.t[both] - rp.t[both]).abs().max()) if bool(both.any()) else 0.0
    steps_sum = int(rk.steps.to(torch.int64).sum())
    hit_frac = float(rk.hit.float().mean())
    simt = simt_efficiency(rk.steps)
    twig_hits = int((rk.texel >= 0).sum())
    print(f"phase 4 march stats: sum steps {steps_sum} (reference count {REF_STEPS}), "
          f"hit fraction {hit_frac:.4f} (reference {REF_HIT_FRAC}), SIMT efficiency "
          f"{simt:.4f}, max steps {int(rk.steps.max())}, twig hits {twig_hits}", flush=True)
    loads = {"camera": path_loads(world, O, D, 512, True)}
    if loads["camera"]["steps"] != steps_sum:
        fail(f"path_loads counted {loads['camera']['steps']} steps, K1 {steps_sum}")
    print(f"phase 4 dependent pool loads per step (camera rays): {loads['camera']}",
          flush=True)

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

    zero_counts()
    frame_ms = {"plain": cuda_ms(frame_plain, TIMED_ITERS),
                "textured": cuda_ms(frame_textured, TIMED_ITERS)}
    out = frame_plain()
    out_tex = frame_textured()
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    # cuda_ms's warm-up, its TIMED_ITERS frames and the one above, of each
    want = {"march": 2 * (TIMED_ITERS + 2), "shade": TIMED_ITERS + 2,
            "shade textured": TIMED_ITERS + 2}
    if launches != want:
        fail(f"the hard frames launched {launches}, want {want}")
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
    # K1's step_budget option (B3b) on the same rays: every ray charged
    # 16-step strides against a budget of 512, held exact against the plain
    # version and timed alone
    budget = torch.full((n,), 512, dtype=torch.int32, device=dev)
    k1b_ms = cuda_ms(lambda: march(world, O, D, step_budget=budget, steps_stride=16, **fk),
                     TIMED_ITERS)
    rb = march(world, O, D, step_budget=budget, steps_stride=16, **fk)
    p1b_ms, rbp = cuda_ms_once(
        lambda: march_plain(world, O, D, 512, False, None, None, True, budget, 16, False))
    torch.cuda.synchronize()
    bmism = {k: int((~(getattr(rb, k) == getattr(rbp, k)).reshape(n, -1).all(dim=1)).sum())
             for k in ("hit", "t", "material", "texel", "cell_bmin", "cell_size", "steps")}
    if max(bmism.values()) > 0:
        fail(f"K1 with step_budget disagrees with march_plain: {bmism}")
    del rb, rbp
    rf = march(world, O, D, **fk)
    hits = int(rf.hit.sum())
    tex = dict(atlas=atlas, envmap=env)
    # K2's loops of calls (the host's launch path): tables on the card (the
    # eye and the material table), and on the host (both by value)
    eye_host, mats_host = cam.position, MaterialTable.default()
    k2_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye, lights, mats, cfg), TIMED_ITERS)
    k2h_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye_host, lights, mats_host, cfg),
                     TIMED_ITERS)
    p2_ms = cuda_ms(lambda: shade_hits_plain(rf, O, D, eye, lights, mats, cfg), 5)
    k2t_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye, lights, mats, cfg, **tex), TIMED_ITERS)
    k2th_ms = cuda_ms(lambda: shade_hits(rf, O, D, eye_host, lights, mats_host, cfg, **tex),
                      TIMED_ITERS)
    p2t_ms = cuda_ms(lambda: shade_hits_plain(rf, O, D, eye, lights, mats, cfg, **tex), 5)
    tables = shade_tables(eye, lights, mats, cfg, dev)
    k2g_ms = cold_graph_ms(lambda r, o, d: _shade_launch(r, o, d, tables, cfg), (rf, O, D),
                           TIMED_ITERS)
    k2tg_ms = cold_graph_ms(lambda r, o, d: _shade_launch(r, o, d, tables, cfg, **tex),
                            (rf, O, D), TIMED_ITERS)
    print(f"phase 6 kernels alone: K1 {k1_ms:.4f} ms (plain {p1_ms:.2f} ms), K1 with "
          f"step_budget=512, steps_stride=16 {k1b_ms:.4f} ms (plain {p1b_ms:.2f} ms; exact vs "
          f"plain: mismatching rays {bmism}); K2 by CUDA events over a loop of calls with the "
          f"tables on the card {k2_ms:.4f} ms, on the host {k2h_ms:.4f} ms (plain "
          f"{p2_ms:.2f} ms), K2 textured {k2t_ms:.4f} ms, on the host {k2th_ms:.4f} ms (plain "
          f"{p2t_ms:.2f} ms); K2 device time per launch in a CUDA graph (inputs from memory): "
          f"{k2g_ms:.4f} ms, textured {k2tg_ms:.4f} ms", flush=True)
    # K2's bounds: per ray 41 bytes in (hit, o, d, cell) and 40 out, per hit
    # 8 more (t, material), the material table; the operations of the rays'
    # outcomes.  Textured: the distinct atlas texels and sky-map taps the
    # frame reads, and their operations.
    k2_bytes = (n * (41 + 40) + hits * 8
                + sum(c.nbytes for c in (mats.diffuse, mats.specular, mats.shininess)))
    k2_ops = SHADE_OPS_PER_RAY * n + SHADE_OPS_PER_HIT * hits
    tex_bytes = texture_bytes(rf, O, D, atlas, env)
    tex_ops = (SHADE_TEX_OPS_PER_HIT * hits + SHADE_TEX_OPS_PER_MISS * (n - hits)
               + ATLAS_DECODE_OPS_PER_CHANNEL * atlas.numel())
    b2 = bound_ms(k2_bytes, k2_ops)
    b2t = bound_ms(k2_bytes + tex_bytes, k2_ops + tex_ops)
    print(f"phase 6 K2 bound {b2[0]:.5f} ms by {b2[1]} ({k2_bytes} bytes, {k2_ops} operations; "
          f"{hits} hits), {b2[0] / k2g_ms:.4f} of it; textured {b2t[0]:.5f} ms by {b2t[1]} "
          f"(+ {tex_bytes} bytes of atlas texels and sky-map taps, + {tex_ops} operations), "
          f"device time {k2tg_ms:.4f} ms, {b2t[0] / k2tg_ms:.4f} of its bound", flush=True)
    # warps of 32 consecutive rays in launch order: all hit, all miss, mixed
    wh = rf.hit.view(-1, 32)
    warp_share = {"all_hit": float(wh.all(dim=1).float().mean()),
                  "all_miss": float((~wh.any(dim=1)).float().mean())}
    warp_share["mixed"] = 1.0 - warp_share["all_hit"] - warp_share["all_miss"]
    print(f"phase 6 K2 warps (32 consecutive rays, {wh.shape[0]} warps): {warp_share}",
          flush=True)

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

    # ---- 8. shadows: K3 and the shadow-ray march vs plain, shadowed frames ------
    ldir = S.light_dir(lights)
    prep_k = S.ray_prep(rk, O, D, ldir)
    prep_p = S.ray_prep_plain(rk, O, D, ldir)
    torch.cuda.synchronize()
    prep_err = max(max_abs(a, b) for a, b in zip(prep_k, prep_p))
    if not all(torch.equal(a, b) for a, b in zip(prep_k, prep_p)):
        fail(f"K3 ray_prep disagrees with ray_prep_plain: max abs err {prep_err}")
    start, sdirs, live = prep_k
    sk = march(world, start, sdirs, 512, steps_aov=True, live_start=live, device=dev)
    psr_ms, sp = cuda_ms_once(lambda: march_plain(world, start, sdirs, 512, True, None, live,
                                                  False))
    torch.cuda.synchronize()
    smism = march_mismatches(sk, sp)
    if max(smism.values()) > 0:
        fail(f"shadow-ray K1 disagrees with march_plain(live_start): {smism}")
    lorig, ldirs, vp = S._bundle(world, lights, 512, 512, 1.1)
    lres = march(world, lorig, ldirs, 512, assume_resident=True, device=dev)
    lk = march(world, lorig, ldirs, 512, steps_aov=True, assume_resident=True, device=dev)
    lp = march_plain(world, lorig, ldirs, 512, True, None, None, True)
    torch.cuda.synchronize()
    lmism = march_mismatches(lk, lp)
    if max(lmism.values()) > 0:
        fail(f"light-bundle K1 disagrees with march_plain: {lmism}")
    if not all(torch.equal(getattr(lres, k), getattr(lk, k)) for k in ("hit", "t", "texel")):
        fail("light-bundle K1 differs with and without the steps AOV")
    sray_steps = int(sk.steps.to(torch.int64).sum())
    light_steps = int(lk.steps.to(torch.int64).sum())
    loads["shadow"] = path_loads(world, start, sdirs, 512, False, live)
    loads["light"] = path_loads(world, lorig, ldirs, 512, True)
    if (loads["shadow"]["steps"], loads["light"]["steps"]) != (sray_steps, light_steps):
        fail(f"path_loads step counts {loads['shadow']['steps']}, {loads['light']['steps']} "
             f"differ from K1's {sray_steps}, {light_steps}")
    print(f"phase 8 dependent pool loads per step: shadow rays {loads['shadow']}, light "
          f"bundle {loads['light']}", flush=True)
    depth_k = S.shadow_resolve(lorig, ldirs, lres.hit, lres.t, vp)
    depth_p = S.shadow_resolve_plain(lorig, ldirs, lres.hit, lres.t, vp)
    depth_map = depth_k.reshape(512, 512)
    fac_k = S.map_project(rk, O, D, depth_map, vp, cfg.shadow_bias)
    fac_p = S.map_project_plain(rk, O, D, depth_map, vp, cfg.shadow_bias)
    torch.cuda.synchronize()
    resolve_err, project_err = max_abs(depth_k, depth_p), max_abs(fac_k, fac_p)
    if not (torch.equal(depth_k, depth_p) and torch.equal(fac_k, fac_p)):
        fail(f"K3 resolve/project disagree with plain: {resolve_err}, {project_err}")
    print(f"phase 8 K3 vs plain (exact): ray_prep max abs err {prep_err}, shadow_resolve "
          f"{resolve_err} ({lorig.shape[0]} light rays, hit fraction "
          f"{float(lres.hit.float().mean()):.4f}), map_project {project_err}; K1 vs "
          f"march_plain mismatching rays (t bit for bit): shadow rays {smism}, light bundle "
          f"{lmism}; steps: shadow rays {sray_steps}, light bundle {light_steps}", flush=True)

    # The fused kernels against their plain compositions, bit for bit: K1's
    # light-depth instantiation against shadow_resolve_plain of march_plain's
    # hits (and K3 shadow_resolve of K1's hit record); the map-shadowed K2
    # against K2 fed K3 map_project's factor (and shade_hits_plain with the
    # map within K2's tolerance of phase 5: powf and the sky's libm calls).
    cfg_map = RenderConfig(shadow="map", max_steps=512, assume_resident=True)
    smap = (depth_map, vp)
    depth_f = march_depth(world, lorig, ldirs, vp[2], 512, assume_resident=True, device=dev)
    depth_fp = S.shadow_resolve_plain(lorig, ldirs, lp.hit, lp.t, vp)
    torch.cuda.synchronize()
    md_err = max_abs(depth_f, depth_fp)
    if not (torch.equal(depth_f, depth_fp) and torch.equal(depth_f, depth_k)):
        fail(f"light-depth K1 disagrees with shadow_resolve of the march: {md_err}")
    sm_err = {}
    for name, kw in (("plain", {}), ("textured", dict(atlas=atlas, envmap=env))):
        a = shade_hits(rk, O, D, eye, lights, mats, cfg_map, shadowmap=smap, **kw)
        b = shade_hits(rk, O, D, eye, lights, mats, cfg_map, shadow_factor=fac_k, **kw)
        c = shade_hits_plain(rk, O, D, eye, lights, mats, cfg_map, shadowmap=smap, **kw)
        torch.cuda.synchronize()
        split_bad = {k: int((~(a[k] == b[k]).reshape(n, -1).all(dim=1)).sum())
                     for k in ("rgb", "depth", "point", "normal")}
        if any(split_bad.values()):
            fail(f"map-shadowed K2 ({name}) differs from K2 fed map_project: {split_bad}")
        errs, bad = {}, 0
        for k in ("rgb", "depth", "point", "normal"):
            diff = (a[k] - c[k]).abs()
            errs[k] = float(diff.max())
            bad += int((diff > 1e-5 + 1e-4 * c[k].abs()).sum())
        if bad:
            fail(f"map-shadowed K2 ({name}) disagrees with shade_hits_plain: {errs}")
        sm_err[name] = max(errs.values())
        print(f"phase 8 map-shadowed K2 ({name}): equal to K2 fed map_project's factor on "
              f"every ray (rgb, depth, point, normal bit for bit); vs shade_hits_plain with the "
              f"map: max abs err {errs}", flush=True)
    del a, b, c
    print(f"phase 8 light-depth K1 vs shadow_resolve_plain of march_plain and vs K3 of K1's "
          f"record: equal on all {lorig.shape[0]} light rays (max abs err {md_err})",
          flush=True)

    cfg_ray = RenderConfig(shadow="ray", max_steps=512, assume_resident=True)
    shadow_frames = {
        "ray": (lambda: render_frame(world, O, D, eye, cfg=cfg_ray, device=dev),
                {"march": 2, "ray_prep": 1, "shade": 1}),
        "map": (lambda: render_frame(world, O, D, eye, cfg=cfg_map, device=dev),
                {"march_depth": 1, "march": 1, "shade_map": 1}),
        "full": (lambda: render_frame(world, O, D, eye, cfg=cfg_map, atlas=atlas, envmap=env,
                                      device=dev),
                 {"march_depth": 1, "march": 1, "shade_map textured": 1}),
    }
    shadow_ms, shadow_launches = {}, {}
    for name, (fn, per_frame) in shadow_frames.items():
        zero_counts()
        shadow_ms[name] = cuda_ms(fn, TIMED_ITERS)
        out_s = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        shadow_launches[name] = {k: v for k, v in counts.items() if v}
        # cuda_ms's warm-up, its TIMED_ITERS frames and the one above
        want = {k: per_frame.get(k, 0) * (TIMED_ITERS + 2) for k in counts}
        if counts != want:
            fail(f"the {name} frame launched {shadow_launches[name]}, want {per_frame} a frame")
        if (tuple(out_s["rgb"].shape) != (n, 3)
                or not bool(torch.isfinite(out_s["rgb"]).all())):
            fail(f"{name} frame rgb is not finite f32[N,3]")
        if not torch.equal(out_s["hit"], rk.hit):
            fail(f"{name} frame hit mask differs from the march's")
        if name != "full" and not bool((out_s["rgb"] <= out["rgb"] + 1e-6).all()):
            fail(f"{name} frame is brighter than the shadowless frame somewhere")
    shadowed = {"ray": _ray_shadow_hits(world, rk, O, D, lights, cfg_ray),
                "map": S.map_project(rk, O, D, depth_map, vp, cfg.shadow_bias)}
    shadowed_frac = {k: float(v.mean()) for k, v in shadowed.items()}
    hit_n = float(rk.hit.float().sum())
    print(f"phase 8 shadowed frames: ms/frame {shadow_ms}, rays/s "
          f"{ {k: round(n / (v / 1e3)) for k, v in shadow_ms.items()} }; shadowed pixel "
          f"fraction {shadowed_frac} (of hit pixels: "
          f"{ {k: float(v.sum()) / hit_n for k, v in shadowed.items()} }); launches over "
          f"{TIMED_ITERS + 2} frames each {shadow_launches} (map and full: no K3 "
          f"shadow_resolve or map_project)", flush=True)

    # The standalone shadow passes: public entry points of shade/shadow.py
    # that no frame runs any more (a light depth resolved from a march the
    # caller made, the map shadow of hit records and of given points).
    zero_counts()
    k3_out = (S.shadow_resolve(lorig, ldirs, lres.hit, lres.t, vp),
              S.map_project(rk, O, D, depth_map, vp, cfg.shadow_bias),
              S.map_shadow(out["point"], depth_map, vp, cfg.shadow_bias, device=dev))
    torch.cuda.synchronize()
    k3_launches = read_counts()
    pts_plain = S.map_shadow_plain(out["point"], depth_map, vp, cfg.shadow_bias)
    if not (torch.equal(k3_out[0], depth_k) and torch.equal(k3_out[1], fac_k)
            and torch.equal(k3_out[2], pts_plain)):
        fail("the standalone K3 passes disagree with their plain versions")
    if min(k3_launches[k] for k in ("shadow_resolve", "map_project")) == 0:
        fail(f"the standalone K3 passes launched {k3_launches}")
    print(f"phase 8 standalone K3 passes (shadow_resolve, map_project, map_shadow of the "
          f"frame's points): launches { {k: v for k, v in k3_launches.items() if v} }, exact "
          f"vs plain", flush=True)
    del k3_out, pts_plain

    rp_ms = cuda_ms(lambda: S.ray_prep(rk, O, D, ldir), TIMED_ITERS)
    rp_plain_ms = cuda_ms(lambda: S.ray_prep_plain(rk, O, D, ldir), 5)
    rs_ms = cuda_ms(lambda: S.shadow_resolve(lorig, ldirs, lres.hit, lres.t, vp), TIMED_ITERS)
    rs_plain_ms = cuda_ms(lambda: S.shadow_resolve_plain(lorig, ldirs, lres.hit, lres.t, vp), 5)
    mp_ms = cuda_ms(lambda: S.map_project(rk, O, D, depth_map, vp, cfg.shadow_bias),
                    TIMED_ITERS)
    mp_plain_ms = cuda_ms(lambda: S.map_project_plain(rk, O, D, depth_map, vp,
                                                      cfg.shadow_bias), 5)
    md_ms = cuda_ms(lambda: march_depth(world, lorig, ldirs, vp[2], 512, assume_resident=True,
                                        device=dev), TIMED_ITERS)
    md_plain_ms = cuda_ms(lambda: march_depth_plain(world, lorig, ldirs, vp[2], 512,
                                                    assume_resident=True), 2)
    sm_ms = cuda_ms(lambda: shade_hits(rk, O, D, eye, lights, mats, cfg_map, shadowmap=smap),
                    TIMED_ITERS)
    sm_plain_ms = cuda_ms(lambda: shade_hits_plain(rk, O, D, eye, lights, mats, cfg_map,
                                                   shadowmap=smap), 5)
    smt_plain_ms = cuda_ms(lambda: shade_hits_plain(rk, O, D, eye, lights, mats, cfg_map,
                                                    shadowmap=smap, **tex), 5)
    sray_ms = cuda_ms(lambda: march(world, start, sdirs, 512, live_start=live, device=dev),
                      TIMED_ITERS)
    light_ms = cuda_ms(lambda: march(world, lorig, ldirs, 512, assume_resident=True,
                                     device=dev), TIMED_ITERS)
    # device time per launch, replayed from a CUDA graph with the inputs
    # rotated past the L2 (cold_graph_ms; the loops above time the host's
    # launch path for the microsecond kernels).  The marches share the
    # world's pools, as every march of a frame does.
    shade_in = (rk, O, D, smap)
    dev_ms = {
        "ray_prep": cold_graph_ms(lambda r, o, d: S.ray_prep(r, o, d, ldir), (rk, O, D),
                                  TIMED_ITERS),
        "shadow_resolve": cold_graph_ms(S.shadow_resolve, (lorig, ldirs, lres.hit, lres.t, vp),
                                        TIMED_ITERS),
        "map_project": cold_graph_ms(
            lambda r, o, d, dm, m: S.map_project(r, o, d, dm, m, cfg.shadow_bias),
            (rk, O, D, depth_map, vp), TIMED_ITERS),
        "march light bundle": cold_graph_ms(
            lambda o, d: march(world, o, d, 512, assume_resident=True, device=dev),
            (lorig, ldirs), TIMED_ITERS),
        "march_depth": cold_graph_ms(
            lambda o, d, row: march_depth(world, o, d, row, 512, assume_resident=True,
                                          device=dev), (lorig, ldirs, vp[2]), TIMED_ITERS),
        "shade_map": cold_graph_ms(
            lambda r, o, d, m: _shade_launch(r, o, d, tables, cfg_map, shadowmap=m),
            shade_in, TIMED_ITERS),
        "shade_map textured": cold_graph_ms(
            lambda r, o, d, m: _shade_launch(r, o, d, tables, cfg_map, shadowmap=m, **tex),
            shade_in, TIMED_ITERS),
    }
    print(f"phase 8 device ms per launch in a CUDA graph, inputs from memory: {dev_ms} (K2 "
          f"without the map: {k2g_ms:.4f}, textured {k2tg_ms:.4f})", flush=True)
    # the textured map-shadowed K2's bound: the map-shadowed K2's bytes and
    # operations (below) and the texture bytes of phase 6 (the same hits)
    b_smt = bound_ms(k2_bytes + depth_map.numel() * 4 + tex_bytes,
                     k2_ops + tex_ops + (PROJECT_OPS - 7) * hits)
    print(f"phase 8 map-shadowed K2 textured bound {b_smt[0]:.5f} ms by {b_smt[1]}; device "
          f"time {dev_ms['shade_map textured']:.4f} ms, "
          f"{b_smt[0] / dev_ms['shade_map textured']:.4f} of its bound", flush=True)

    pools_k1 = (packed.tree.nbytes + packed.twig_occ.nbytes + packed.chunk_bmin.nbytes
                + 2 * packed.chunk_tree.nbytes)
    n_light = lorig.shape[0]
    # shadow rays read o, d and live_start; light rays o, d; both write the
    # 33 bytes of a MarchResult per ray and read one twig word per texel hit
    b_sray = bound_ms(n * (24 + 4 + 33) + pools_k1 + 4 * int((sk.texel >= 0).sum()),
                      MARCH_OPS_PER_STEP * sray_steps)
    b_light = bound_ms(n_light * (24 + 33) + pools_k1 + 4 * int((lk.texel >= 0).sum()),
                       MARCH_OPS_PER_STEP * light_steps)
    print(f"phase 8 kernels alone (CUDA events over a loop of calls): ray_prep {rp_ms:.4f} ms "
          f"(plain {rp_plain_ms:.3f}), shadow_resolve {rs_ms:.4f} ms (plain {rs_plain_ms:.3f}), "
          f"map_project {mp_ms:.4f} ms (plain {mp_plain_ms:.3f}), light-depth K1 {md_ms:.4f} ms "
          f"(plain {md_plain_ms:.3f}), map-shadowed K2 {sm_ms:.4f} ms (plain "
          f"{sm_plain_ms:.3f}); K1 on the shadow rays {sray_ms:.4f} ms (plain {psr_ms:.2f} ms, "
          f"with the steps AOV) "
          f"(bound {b_sray[0]:.4f} ms by {b_sray[1]}, {sray_steps} steps, SIMT efficiency "
          f"{simt_efficiency(sk.steps):.4f}), K1 on the 512x512 light bundle {light_ms:.4f} ms "
          f"(bound {b_light[0]:.4f} ms by {b_light[1]}, {light_steps} steps, SIMT efficiency "
          f"{simt_efficiency(lk.steps):.4f})", flush=True)
    del sp, lp

    for golden, shadow in (("rayshadow_2x1x2_d5", "ray"), ("mapshadow_2x1x2_d5", "map")):
        rgb = render_frame(gw, go, gd, geye, cfg=RenderConfig(shadow=shadow),
                           device=dev)["rgb"].cpu().numpy()
        thumb = rgb.astype(np.float64).reshape(54, 96, 3)[:48, :96].reshape(
            8, 6, 8, 12, 3).mean(axis=(1, 3))
        ref = np.load(os.path.join(HERE, "tests", "golden", golden + ".npy"))
        err = float(np.abs(thumb - ref).max())
        print(f"phase 8 golden {golden}: max thumbnail error {err:.3g} (limit 2e-2)",
              flush=True)
        if err > 2e-2:
            fail(f"golden {golden} mismatch")

    # ---- 9. geometry: K4 vs plain, K4 over the frame ----------------------------------
    K = 32
    Os, Ds = O[::16].contiguous(), D[::16].contiguous()
    seg_err = 0.0
    for budget in (None, 96):
        gk = sample_segments(world, Os, Ds, K, 512, step_budget=budget, device=dev)
        gp = sample_segments_plain(world, Os, Ds, K, 512, 8, budget, 16)
        torch.cuda.synchronize()
        bad = {k: int((getattr(gk, k) != getattr(gp, k)).sum())
               for k in ("slot", "t0", "t1", "count")}
        seg_err = max(seg_err, max_abs(gk.t0, gp.t0), max_abs(gk.t1, gp.t1))
        print(f"phase 9 K4 vs plain (K={K}, step_budget={budget}, {Os.shape[0]} rays): "
              f"mismatching values {bad}, mean count {float(gk.count.float().mean()):.3f}",
              flush=True)
        if any(bad.values()):
            fail(f"K4 disagrees with sample_segments_plain (budget {budget}): {bad}")
    seg_ms = cuda_ms(lambda: sample_segments(world, O, D, K, 512, device=dev), 5)
    segs = sample_segments(world, O, D, K, 512, device=dev)
    # the plain version over all rays: its time, K4's executed march steps
    # (for the bound), and K4 held against it on every ray
    seg_plain_ms, (gp, plain_steps) = cuda_ms_once(
        lambda: _sample_segments_plain(world, O, D, K, 512))
    seg_steps = int(plain_steps.sum())
    seg_simt = simt_efficiency(plain_steps)
    bad = {k: int((getattr(segs, k) != getattr(gp, k)).sum())
           for k in ("slot", "t0", "t1", "count")}
    if any(bad.values()):
        fail(f"K4 disagrees with sample_segments_plain on all {n} rays: {bad}")
    del gp, plain_steps
    valid = segs.slot >= 0
    n_valid = int(valid.sum())
    leaf_slot0 = int(world.twig.shape[0])          # slots >= this are the 8 LEAF slots
    n_leaf = int((segs.slot >= leaf_slot0).sum())
    full_frac = float((segs.count == K).float().mean())
    print(f"phase 9 K4 over the frame: {seg_ms:.4f} ms (plain {seg_plain_ms:.1f} ms), "
          f"{n_valid} segments (mean {n_valid / n:.3f} per ray; {n_leaf} on the 8 coarse-LEAF "
          f"slots), fraction of rays at count = K {full_frac:.4f}, executed march steps "
          f"{seg_steps}, SIMT efficiency {seg_simt:.4f} (from the plain version's per-ray "
          f"steps); K4 vs plain on all {n} rays: exact", flush=True)

    # ---- 10. training step: K5/K6 vs plain, fit ---------------------------------------
    params0 = init_params_from_world(world)
    P = params0.num_slots
    sky = torch.tensor(SKY, dtype=torch.float32, device=dev)
    with torch.no_grad():
        fk = composite(segs, params0)
    fp = composite_plain(segs.slot, segs.t0, segs.t1, params0.density_raw,
                           params0.albedo_raw, sky)
    torch.cuda.synchronize()

    def check_k5(fk, fp, batch):
        """K5 within 1e-6 + 1e-5|plain| of composite_plain; its max abs err."""
        err, bad = 0.0, 0
        for name, b in zip(("rgb", "depth", "opacity", "weights"), fp):
            a = fk[name]
            err = max(err, max_abs(a, b))
            bad += int(((a - b).abs() > 1e-6 + 1e-5 * b.abs()).sum())
            if not bool(torch.isfinite(a).all()):
                fail(f"K5 {name} not finite ({batch})")
        print(f"phase 10 K5 vs composite_plain ({batch}): max abs err {err}, values beyond "
              f"1e-6 + 1e-5|plain| {bad}", flush=True)
        if bad:
            fail(f"K5 disagrees with composite_plain ({batch})")
        return err

    fwd_err = check_k5(fk, fp, "bench segments")
    del fk, fp

    rng = np.random.default_rng(0)
    ups = [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dev)
           for sh in ((n, 3), (n,), (n,), (n, K))]
    def trainable(p):
        return VoxelParams(p.density_raw.detach().clone().requires_grad_(True),
                           p.albedo_raw.detach().clone().requires_grad_(True))

    def check_k6(batch_segs, batch):
        """K6 through autograd with all four upstream gradients, against
        composite_backward_plain; its max abs err."""
        leaf = trainable(params0)
        outs = composite(batch_segs, leaf)
        torch.autograd.backward([outs["rgb"], outs["depth"], outs["opacity"],
                                 outs["weights"]], ups)
        want = composite_backward_plain(batch_segs.slot, batch_segs.t0, batch_segs.t1,
                                        params0.density_raw, params0.albedo_raw, sky, 8192.0,
                                        *ups)
        torch.cuda.synchronize()
        # Tolerance: |K6 - plain| <= 1e-3 |plain| + 1e-5 max|plain| per value.
        # Both sum the same per-segment terms, but K6 in its own order (runs,
        # warp groups, block tables, atomics in run-to-run order) and the
        # plain version with index_add_ in another; the 8 coarse-LEAF slots
        # each take millions of terms, so their float32 sums carry
        # order-dependent rounding near 1e-4 of their magnitude.
        err, bad = 0.0, 0
        for name, a, b in (("density_raw", leaf.density_raw.grad, want[0]),
                           ("albedo_raw", leaf.albedo_raw.grad, want[1])):
            scale_b = float(b.abs().max())
            err = max(err, max_abs(a, b))
            bad += int(((a - b).abs() > 1e-3 * b.abs() + 1e-5 * scale_b).sum())
            print(f"phase 10 K6 vs composite_backward_plain ({name}, {batch}): max abs err "
                  f"{max_abs(a, b)}, largest |grad| {scale_b}", flush=True)
        if bad:
            fail(f"K6 disagrees with composite_backward_plain on {bad} values ({batch})")
        return err

    bwd_err = check_k6(segs, "bench segments")

    def check_columns(b, batch):
        """K6's column counter against the count from the slots: each tile
        of composite_plan's rays, rows x K walked, rows x (K - cut) past its
        last valid column; returns the skipped share."""
        cols = torch.zeros(2, dtype=torch.int64, device=dev)
        _composite_bwd_cuda(b.slot, b.t0, b.t1, params0.density_raw, params0.albedo_raw, sky,
                            8192.0, ups[0], None, None, None, bg_grad=False, columns=cols)
        rays = composite_plan(K, True).rays
        valid = b.slot >= 0
        last = torch.where(valid, torch.arange(1, K + 1, device=dev), 0).amax(dim=1)
        pad = -n % rays
        tiles = torch.nn.functional.pad(last, (0, pad)).view(-1, rays).amax(dim=1)
        rows = torch.full_like(tiles, rays)
        rows[-1] = rays - pad
        want = [n * K, int((rows * (K - tiles)).sum())]
        got = cols.tolist()
        print(f"phase 10 K6 columns ({batch}): walked {got[0]}, past each tile's last valid "
              f"column {got[1]} ({got[1] / max(got[0], 1):.4f}); from the slots {want}",
              flush=True)
        if got != want:
            fail(f"K6's column counter {got} disagrees with the slots' count {want} ({batch})")
        return got[1] / max(got[0], 1)

    skipped_share = check_columns(segs, "bench segments")

    def kernel_times(b):
        """(K5, K6 with all four upstream gradients, K6 with rgb's alone) ms."""
        args = (b.slot, b.t0, b.t1, params0.density_raw, params0.albedo_raw, sky, 8192.0)
        return (cuda_ms(lambda: _composite_fwd_cuda(*args), TIMED_ITERS),
                cuda_ms(lambda: _composite_bwd_cuda(*args, *ups), TIMED_ITERS),
                cuda_ms(lambda: _composite_bwd_cuda(*args, ups[0], None, None, None),
                        TIMED_ITERS))

    fwd_ms, bwd_ms, fit_bwd_ms = kernel_times(segs)
    fwd_plain_ms = cuda_ms(lambda: composite_plain(
        segs.slot, segs.t0, segs.t1, params0.density_raw, params0.albedo_raw, sky), 3)
    bwd_plain_ms = cuda_ms(lambda: composite_backward_plain(
        segs.slot, segs.t0, segs.t1, params0.density_raw, params0.albedo_raw, sky, 8192.0,
        *ups), 2)
    # the bounds' bytes: each segment once, each touched slot once (K6: read
    # and written), the per-ray inputs and outputs (and K5's weights)
    touched = int(torch.unique(segs.slot[valid]).numel())
    fwd_bytes = n * K * 12 + touched * 16 + n * (20 + 4 * K)
    bwd_bytes = n * K * 12 + 2 * touched * 16 + n * (20 + 4 * K) + n * 12
    # K6 with rgb's gradient alone reads no dL/dw, dL/ddepth or dL/dopacity
    fit_bwd_bytes = bwd_bytes - n * (8 + 4 * K)
    b_fwd = bound_ms(fwd_bytes, COMPOSITE_FWD_OPS * n_valid)
    b_bwd = bound_ms(bwd_bytes, COMPOSITE_BWD_OPS * n_valid)
    b_fit_bwd = bound_ms(fit_bwd_bytes, COMPOSITE_BWD_OPS * n_valid)
    rates = {name: f"{nb / (t * 1e6):.1f} GB/s, {bnd[0] / t:.4f} of its bound"
             for name, nb, t, bnd in (("K5", fwd_bytes, fwd_ms, b_fwd),
                                      ("K6", bwd_bytes, bwd_ms, b_bwd),
                                      ("K6 rgb only", fit_bwd_bytes, fit_bwd_ms, b_fit_bwd))}
    print(f"phase 10 kernels alone: K5 {fwd_ms:.4f} ms (plain {fwd_plain_ms:.2f}), K6 "
          f"{bwd_ms:.4f} ms with all four upstream gradients, {fit_bwd_ms:.4f} ms with rgb "
          f"only (plain {bwd_plain_ms:.2f}); bound K5 {b_fwd[0]:.4f} ms ({fwd_bytes} bytes), "
          f"K6 {b_bwd[0]:.4f} ms ({bwd_bytes} bytes; rgb only {b_fit_bwd[0]:.4f} ms, "
          f"{fit_bwd_bytes} bytes); achieved {rates}; K6 skipped {skipped_share:.4f} of the "
          f"columns (past each tile's last valid one)", flush=True)

    # contention: every valid segment on one of the 8 coarse-LEAF slots, runs
    # of one slot within rays, invalid slots interleaved; made on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    c_slot = (P - 8) + torch.randint(0, 8, (n, K), generator=gen, device=dev,
                                     dtype=torch.int32)
    rep = torch.rand((n, K), generator=gen, device=dev) < 0.5
    for k in range(1, K):
        c_slot[:, k] = torch.where(rep[:, k], c_slot[:, k - 1], c_slot[:, k])
    c_slot = torch.where(torch.rand((n, K), generator=gen, device=dev) < 0.3, -1, c_slot)
    c_t0 = torch.cumsum(torch.rand((n, K), generator=gen, device=dev) * 0.05, dim=1)
    c_t1 = c_t0 + torch.rand((n, K), generator=gen, device=dev) * 0.05
    contention = SegmentBatch(c_slot.contiguous(), c_t0.contiguous(), c_t1.contiguous(),
                              (c_slot >= 0).sum(dim=1, dtype=torch.int32))
    del rep, c_slot, c_t0, c_t1
    with torch.no_grad():
        fk = composite(contention, params0)
    fp = composite_plain(contention.slot, contention.t0, contention.t1, params0.density_raw,
                         params0.albedo_raw, sky)
    fwd_err = max(fwd_err, check_k5(fk, fp, "contention"))
    del fk, fp
    bwd_err = max(bwd_err, check_k6(contention, "contention"))
    c_ms = kernel_times(contention)
    print(f"phase 10 contention batch ({int((contention.slot >= 0).sum())} valid segments, "
          f"all on the 8 coarse-LEAF slots): K5 {c_ms[0]:.4f} ms, K6 {c_ms[1]:.4f} ms with all "
          f"four upstream gradients, {c_ms[2]:.4f} ms with rgb only", flush=True)
    del ups, contention

    target = out["rgb"]                  # the shadowless hard frame (phase 6)
    views = [(O, D, target)]
    zero_counts()
    _, history = fit(world, views, params0, steps=5, lr=0.05, max_segments=K, device=dev)
    torch.cuda.synchronize()
    fit_launches = {k: v for k, v in read_counts().items() if v}
    for k in ("segments", "composite_fwd", "composite_bwd"):
        if read_counts()[k] == 0:
            fail(f"kernel {k} was not launched by fit()")
    if not all(np.isfinite(history)) or not history[-1] < history[0]:
        fail(f"fit losses not finite or not falling: {history}")
    print(f"phase 10 fit (5 Adam steps, lr 0.05, K={K}): losses {history}, launches "
          f"{fit_launches}", flush=True)

    cached = sample_views(world, views, K, device=dev)
    p_t = trainable(params0)
    opt = torch.optim.Adam([p_t.density_raw, p_t.albedo_raw], lr=0.05)

    def fit_step(cached_views):
        """One step of fit()'s loop."""
        opt.zero_grad(set_to_none=True)
        photometric_loss(p_t, cached_views).backward()
        opt.step()

    step_ms = cuda_ms(lambda: fit_step(cached), 10)
    full_step_ms = cuda_ms(lambda: fit_step(sample_views(world, views, K, device=dev)), 5)
    print(f"phase 10 step times: geometry (K4) {seg_ms:.4f} ms, one step on cached "
          f"segments (K5 + loss + K6 + Adam) {step_ms:.4f} ms, full step (geometry + step) "
          f"{full_step_ms:.4f} ms; {P} param slots", flush=True)
    del cached, p_t, opt

    gcam_s = PerspectiveCamera(position=(32.0, 30.0, -20.0), pitch_deg=-20.0, fov_deg=70.0,
                               width=48, height=27)
    so, sd = gcam_s.rays()
    soft = render_soft(gw, init_params_from_world(gw), so, sd, device=dev)["rgb"]
    thumb = soft.detach().cpu().numpy().astype(np.float64).reshape(27, 48, 3)[:27, :48]
    thumb = thumb.reshape(3, 9, 3, 16, 3).mean(axis=(1, 3))
    ref = np.load(os.path.join(HERE, "tests", "golden", "soft_2x1x2_d5.npy"))
    err = float(np.abs(thumb - ref).max())
    print(f"phase 10 golden soft_2x1x2_d5: max thumbnail error {err:.3g} (limit 3e-2)",
          flush=True)
    if err > 3e-2:
        fail("golden soft_2x1x2_d5 mismatch")

    # ---- 11. the edited-world session ----------------------------------------------
    k7 = phase_session(w, dev, atlas, env, zero_counts, read_counts)

    # ---- 12. the ray-sharded paths on a one-rank NCCL group ----------------------------
    phase_sharded(world, O, D, eye, cfg, out["rgb"], dev, zero_counts, read_counts, smi)

    # ---- 13. the differentiable frame (K8), wide tables, the command line ------------
    grad = phase_grad(world, rf, O, D, eye, atlas, env, smap, zero_counts, read_counts,
                      {"none": k2g_ms, "none textured": k2tg_ms, "map": dev_ms["shade_map"],
                       "full": dev_ms["shade_map textured"]},
                      texture_parts(rf, O, D, atlas, env)[0], smi)

    # ---- 14. the stage-compacted march and sampler (K9, K10) --------------------------
    comp = phase_compact(dict(world=world, dev=dev, K=K, O=O, D=D, eye=eye, eye_host=eye_host,
                              rk=rk, sk=sk, lk=lk, start=start, sdirs=sdirs, live=live,
                              lorig=lorig, ldirs=ldirs, cfg=cfg, cfg_ray=cfg_ray,
                              cfg_map=cfg_map, atlas=atlas, env=env, lights=lights,
                              segs=segs, views=views, params0=params0),
                         zero_counts, read_counts, smi)

    # ---- K2 with its tables on the host uploads nothing ------------------------
    # one call traced by torch.profiler (last: a trace taken before phase 12's
    # dropped device events there): no host-to-device copy may appear (the
    # atlas and the sky map are on the card already)
    k2_trace = device_breakdown(
        lambda: shade_hits(rf, O, D, eye_host, lights, mats_host, cfg, **tex), top=20)[1]
    if any("HtoD" in name for name, _ in k2_trace):
        fail(f"shade_hits with host tables copied to the card: {k2_trace}")
    print(f"K2 with host tables, one call by torch.profiler: "
          f"{k2_trace or 'no device events traced'} (no host-to-device copy)", flush=True)

    # ---- result ---------------------------------------------------------------
    ray_io = 24 + 33                     # o, d in; hit t material cell size steps texel out
    k1_bytes = (n * ray_io + packed.tree.nbytes + packed.twig_occ.nbytes
                + packed.chunk_bmin.nbytes + 2 * packed.chunk_tree.nbytes + 4 * twig_hits)
    b1, by1 = bound_ms(k1_bytes, MARCH_OPS_PER_STEP * steps_sum)
    b_rp = bound_ms(n * (45 + 28), RAY_PREP_OPS * n)
    b_rs = bound_ms(n_light * (29 + 4), RESOLVE_OPS * n_light)
    b_mp = bound_ms(n * (29 + 4) + depth_map.numel() * 4, PROJECT_OPS * n)
    # the light-depth K1: o, d in, the depth out, the pools K1 reads (no hit
    # record, no twig words); the map-shadowed K2: K2's bytes and the depth
    # map, and the projection (less the hit point K2 has) on every hit
    b_md = bound_ms(n_light * (24 + 4) + pools_k1,
                    MARCH_OPS_PER_STEP * light_steps + RESOLVE_OPS * n_light)
    b_sm = bound_ms(k2_bytes + depth_map.numel() * 4, k2_ops + (PROJECT_OPS - 7) * hits)
    pools = (packed.tree.nbytes + packed.twig_occ.nbytes + packed.chunk_bmin.nbytes
             + 2 * packed.chunk_tree.nbytes)
    b_seg = bound_ms(n * (24 + 4 + 12 * K) + pools + 4 * (n_valid - n_leaf),
                     MARCH_OPS_PER_STEP * seg_steps + SEGMENT_OPS * n_valid)

    # path: the run whose counters give launches (the hard frames of phase
    # 6, the shadowed frames or the standalone K3 passes of phase 8, fit,
    # the session)
    def entry(name, source, replaces, path, launches_n, err_v, ms, plain, bound,
              library=None):
        return {"name": name, "route": "cuda",
                "source": f"octree_raymarcher_tpu_torch/csrc/{source}",
                "replaces": replaces, "path": path, "launches": launches_n,
                "max_abs_err": err_v, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library}

    sl = {k: sum(v.get(k, 0) for v in shadow_launches.values())
          for k in ("ray_prep", "march_depth", "shade_map", "shade_map textured")}
    report = {"kernels": [
        entry("march", "march.cu", "octree_raymarcher_tpu/ops/march_jnp.py:474",
              "hard frames", launches["march"], march_err, k1_ms, p1_ms, (b1, by1)),
        # K2, K3 and the fused kernels: device ms per launch in a CUDA graph,
        # inputs from memory (their loops of calls are host-bound; phases 6
        # and 8 print both)
        entry("shade", "shade.cu", "octree_raymarcher_tpu/shade/render.py:62",
              "hard frames", launches["shade"], shade_err["plain"], k2g_ms, p2_ms, b2),
        # the textured instantiation: the textured hard frames and the session
        entry("shade textured", "shade.cu", "octree_raymarcher_tpu/shade/render.py:62",
              "textured hard frames + session",
              launches["shade textured"] + k7["shade_launches"], shade_err["textured"],
              k2tg_ms, p2t_ms, b2t),
        entry("ray_prep", "shadow.cu", "octree_raymarcher_tpu/shade/render.py:139",
              "shadowed frames", sl["ray_prep"], prep_err, dev_ms["ray_prep"], rp_plain_ms,
              b_rp),
        # no frame launches these two any more
        entry("shadow_resolve", "shadow.cu", "octree_raymarcher_tpu/shade/render.py:252",
              "standalone K3 passes", k3_launches["shadow_resolve"], resolve_err,
              dev_ms["shadow_resolve"], rs_plain_ms, b_rs),
        entry("map_project", "shadow.cu", "octree_raymarcher_tpu/shade/render.py:364",
              "standalone K3 passes", k3_launches["map_project"], project_err,
              dev_ms["map_project"], mp_plain_ms, b_mp),
        # the map and full frames' light pass and shading
        entry("march_depth", "march.cu", "octree_raymarcher_tpu/shade/render.py:210",
              "shadowed frames", sl["march_depth"], md_err, dev_ms["march_depth"],
              md_plain_ms, b_md),
        entry("shade_map", "shade.cu", "octree_raymarcher_tpu/shade/render.py:427",
              "map frames", sl["shade_map"], sm_err["plain"], dev_ms["shade_map"],
              sm_plain_ms, b_sm),
        # the full frame users look at (map + atlas + sky map)
        entry("shade_map textured", "shade.cu", "octree_raymarcher_tpu/shade/render.py:427",
              "full frames", sl["shade_map textured"], sm_err["textured"],
              dev_ms["shade_map textured"], smt_plain_ms, b_smt),
        entry("segments", "segments.cu", "octree_raymarcher_tpu/diff/segments.py:96",
              "fit", fit_launches["segments"], seg_err, seg_ms, seg_plain_ms, b_seg),
        entry("composite_fwd", "composite.cu", "octree_raymarcher_tpu/diff/composite.py:89",
              "fit", fit_launches["composite_fwd"], fwd_err, fwd_ms, fwd_plain_ms, b_fwd),
        entry("composite_bwd", "composite.cu", "octree_raymarcher_tpu/diff/composite.py:89",
              "fit", fit_launches["composite_bwd"], bwd_err, bwd_ms, bwd_plain_ms, b_bwd),
        # device ms a batch in a cold CUDA graph, the mean over the session's
        # batches; no single PyTorch call writes the five arrays and derives
        # the occupancy words, so no library time
        entry("patch", "patch.cu", "octree_raymarcher_tpu/world/alloc.py:167",
              "session", k7["launches"], k7["err"], k7["ms"], k7["plain_ms"],
              (k7["bound_ms"], "bytes")),
    ]}
    # phase 13's differentiable frames, one a case: K2's wide instantiation
    # (the rig by pointer; the bounds and plain versions of the narrow one,
    # the same function) and K2's VJP K8 (the reverse mode XLA derives for
    # shade_hits), each as device ms a launch in a cold CUDA graph; no
    # single PyTorch call computes K8, so no library time
    fwd_of = {"none": (p2_ms, b2, "62"), "none textured": (p2t_ms, b2t, "62"),
              "map": (sm_plain_ms, b_sm, "427"), "full": (smt_plain_ms, b_smt, "427")}
    for case, g in grad["cases"].items():
        plain_ms, bound, line = fwd_of[case]
        report["kernels"].append(entry(
            g["k2"], "shade.cu", f"octree_raymarcher_tpu/shade/render.py:{line}",
            f"differentiable frames ({case})", g["k2_launches"], g["k2_err"], g["K2 wide"],
            plain_ms, bound))
        report["kernels"].append(entry(
            g["k8"], "shade_bwd.cu", "octree_raymarcher_tpu/shade/render.py:62",
            f"differentiable frames ({case})", g["k8_launches"], g["k8_err"], g["K8"],
            g["plain"], g["bound"]))
    # phase 14: K9's instantiations and K10, launches from the compacted
    # frames and one fit(compact=True) step; the stages' ms is their device
    # time summed over one camera-ray march (or one sampler call) by
    # torch.profiler, else that call's time by CUDA events; K10's and the entries' a
    # launch on the camera rays' first pack; torch.nonzero of the same flags
    # is K10's library time (the permutation half, with a synchronisation)
    cl, cam, sam = comp["launches"], comp["march"]["camera"], comp["sampler"]
    report["kernels"] += [
        entry("compact_entry", "compact.cu", "octree_raymarcher_tpu/ops/march_compact.py:133",
              "compacted frames", cl["compact_entry"], comp["entry"]["err"],
              comp["entry"]["ms"], comp["entry"]["plain_ms"], comp["entry"]["bound"]),
        entry("compact_stage", "compact.cu", "octree_raymarcher_tpu/ops/march_compact.py:152",
              "compacted frames", cl["compact_stage"], cam["err"],
              cam["profile"].get("stage", cam["ms"]), cam["plain_ms"], (b1, by1)),
        entry("sampler_entry", "compact.cu",
              "octree_raymarcher_tpu/diff/segments_compact.py:83", "fit(compact=True)",
              cl["sampler_entry"], comp["entry"]["err"], sam["entry_ms"],
              comp["entry"]["plain_ms"], comp["entry"]["bound"]),
        entry("sampler_stage", "compact.cu",
              "octree_raymarcher_tpu/diff/segments_compact.py:55", "fit(compact=True)",
              cl["sampler_stage"], sam["err"], sam["profile"].get("stage", sam["ms"]),
              sam["plain_ms"], b_seg),
        entry("partition", "compact.cu", "octree_raymarcher_tpu/ops/march_compact.py:109",
              "compacted frames + fit(compact=True)", cl["partition"],
              comp["partition"]["err"], comp["partition"]["ms"],
              comp["partition"]["plain_ms"], comp["partition"]["bound"],
              comp["partition"]["library_ms"]),
    ]
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
