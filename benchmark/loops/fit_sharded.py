"""The sharded fit loop: the voxel fit of the ``fit`` loop, ray-sharded over
a process group through the port's multi-card entry (``parallel/mesh.py``
``init_distributed`` and ``make_mesh``; ``parallel/render_sharded.py``
``make_sharded_train_step``), one rank a card.

Rank 0 runs in the harness's process; it builds the port's kernels, then
starts ranks 1 to n-1 as fresh processes (this module's :func:`worker`),
with the rendezvous at ``local_address()``.  Every rank runs under a deadline: a rank that fails,
or a deadline that passes, ends the run (rank 0 kills the other ranks and
exits without a result), so a run never hangs.

Set-up, on every rank: the world; the rays of the ``views`` orbit views (as
the ``fit`` loop's, turned by the seed's phase) on the rank's device as one
contiguous tensor a quantity, views in order; the ground truth; the
targets, each rank rendering its contiguous quarter (``render_soft``) and
the quarters gathered once; the start, the ground truth perturbed by noise
drawn on the device from the seed (the ``fit`` loop's ``start_from``).

A step ``i`` is one call of the entry's step on the global batch of views
``size*i .. size*i + size - 1`` (mod ``views``), a contiguous slice of those
tensors; rank ``r`` takes the ``r``-th view as its block.  The entry samples
segments (K4) tile by tile, composites (K5, K6), all-reduces each tile's
gradients asynchronously and steps Adam, replicated on each rank; each
step's loss goes into a buffer on the device.  The first three steps are
driven before the warm-up (the reference follows them); the warm-up's time
on rank 0 fixes the window's step count, broadcast once, so that no step
exchanges a flag.  The end-to-end metric (``step_metric``) is rank 0's host
clock over the window's steps, ended by a synchronise.  With ``--trace 1``
rank 0 profiles ``trace_steps`` further steps while the other ranks run
them untraced.

The comparison, after the window, with the program's state freed, on the
program's first three steps: each rank re-samples its view of each of them
with the port's ``sample_segments`` (the sampler the entry calls) before
the state goes, and checks its pools, rows drawn from the seed against the
plain sampler, and its targets, as the ``fit`` loop does; the reference
(``reference/sharded.py``) then computes each global step's loss and
gradient, each rank its own view's float64 sums, gathered to rank 0 and
added there in view order, and steps its own Adam.  Rank 0 compares the
losses, the first gradient's norm by leaf (from its optimizer's first
moment) and the change's norm by leaf after three steps; the numbers and
limits are the ``fit`` loop's.

``mode`` is ``program``, ``control`` (the reference computed in bfloat16 in
the program's place) or ``fault:<name>`` (``benchmark/faults_sharded.py``,
planted on every rank).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import harness
from .. import trace as tr
from ..traffic import orbit

fit = harness.loop("fit")

WORKER = ("import sys; from benchmark import harness; "
          "sys.exit(harness.loop(sys.argv[1]).worker(sys.argv[2:]))")
POLL_S = 0.5


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- the ranks


def _watch(deadline: float, procs: list, stop: threading.Event) -> None:
    """End the run when a rank fails or the deadline passes: kill every
    process in ``procs`` and exit at once (a collective cannot be
    interrupted)."""
    while not stop.wait(POLL_S):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        late = time.time() > deadline
        if failed or late:
            why = (f"rank process {failed[0].args[-1]} exited {failed[0].returncode}"
                   if failed else "the deadline passed")
            print(f"# bench: {why}; ending every rank", file=sys.stderr, flush=True)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            os._exit(1)


def _orphan_watch(deadline: float, parent: int) -> None:
    """A worker's watch: exit when the deadline passes or rank 0 is gone."""
    while True:
        time.sleep(POLL_S)
        if time.time() > deadline or os.getppid() != parent:
            os._exit(1)


def _spawn(run, addr: str, ranks: int, deadline: float, mode: str) -> list:
    a = run.args
    procs = []
    for rank in range(1, ranks):
        argv = [sys.executable, "-c", WORKER, run.traffic["loop"],
                "--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds),
                "--trace", str(a.trace), "--mode", mode, "--device", run.device.type,
                "--addr", addr, "--ranks", str(ranks), "--deadline", repr(deadline),
                "--rank", str(rank)]
        env = dict(os.environ, LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(argv, cwd=harness.ROOT, env=env, stdout=sys.stderr,
                                      stdin=subprocess.DEVNULL))
    return procs


def run(run, mode: str = "program") -> dict:
    """Rank 0's part: start the other ranks, run the cell on every rank,
    gather their reports; returns the harness's result."""
    from octree_raymarcher_tpu_torch.parallel import init_distributed, local_address, make_mesh

    ranks = int(run.config["sharded"]["ranks"])
    deadline = time.time() + float(run.traffic["deadline_s"]) + float(run.args.seconds)
    if run.device.type == "cuda":
        from octree_raymarcher_tpu_torch import kernels

        with run.part("kernels"):       # built once, before the other ranks start and load it
            kernels.build()
    addr = local_address()
    procs = _spawn(run, addr, ranks, deadline, mode)
    stop = threading.Event()
    watch = threading.Thread(target=_watch, args=(deadline, procs, stop), daemon=True)
    watch.start()
    try:
        with run.part("process_group"):
            init_distributed(addr, ranks, 0, device=run.device.type)
            mesh = make_mesh(run.device.type)
        out, reports = _rank(run, mesh, mode)
        dist.destroy_process_group()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    finally:
        stop.set()
    found = sorted({m for r in reports for m in r["forbidden"]})
    if found:
        print(f"# bench: a rank loaded modules of JAX or of the JAX package: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
    if run.device.type == "cuda":
        run.record["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in reports)
    return out


def worker(argv) -> int:
    """Rank ``--rank`` of a run that rank 0 started."""
    from octree_raymarcher_tpu_torch.parallel import init_distributed, make_mesh

    ap = argparse.ArgumentParser(prog="fit_sharded worker")
    for name in ("workload", "mode", "device", "addr"):
        ap.add_argument(f"--{name}", required=True)
    for name in ("seed", "trace", "ranks", "rank"):
        ap.add_argument(f"--{name}", type=int, required=True)
    for name in ("seconds", "deadline"):
        ap.add_argument(f"--{name}", type=float, required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_orphan_watch, args=(args.deadline, os.getppid()),
                     daemon=True).start()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    init_distributed(args.addr, args.ranks, args.rank, device=args.device)
    mesh = make_mesh(args.device)
    run = harness.Run(args, harness.spec(), time.perf_counter(), mesh.device)
    _rank(run, mesh, args.mode)
    dist.destroy_process_group()
    return 0


def _rank(run, mesh, mode: str):
    """One rank's run: set-up, first steps, warm-up, window, trace, the
    comparison and the reports.  Returns (the harness's result on rank 0,
    every rank's report)."""
    from .. import faults_sharded
    from ..run import forbidden_modules

    if mode.startswith("fault:"):
        planted = faults_sharded.planted(mode.split(":", 1)[1], mesh.rank)
    else:
        planted = contextlib.nullcontext()
    dev = mesh.device
    with planted:
        state = setup(run, mesh)
        out = window(run, mesh, state)
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        first = {**state.pop("first"), "losses": state.pop("program_losses")}
        t0 = time.perf_counter()
        parts = judge(run, mesh, state, control=mode == "control")
    report = {"rank": mesh.rank, "forbidden": forbidden_modules(), **parts,
              "memory_peak_bytes": peak}
    reports = [None] * mesh.size
    dist.all_gather_object(reports, report, group=mesh.group)
    if mesh.rank == 0:
        compare(run, reports, first, mode == "control")
        run.record["judge_s"] = time.perf_counter() - t0
    return out, reports


# ------------------------------------------------------------------ set-up


def setup(run, mesh) -> dict:
    cfg, traffic, dev = run.config, run.traffic, mesh.device
    with run.part("import"):
        from octree_raymarcher_tpu_torch.diff.composite import (
            SKY,
            VoxelParams,
            init_params_from_world,
            render_soft,
        )
        from octree_raymarcher_tpu_torch.parallel import make_sharded_train_step
        from octree_raymarcher_tpu_torch.world.world import World
    w, cam, f, sh = cfg["world"], cfg["camera"], cfg["fit"], cfg["sharded"]
    K, V, size = int(f["K"]), int(traffic["views"]), mesh.size
    if size != int(sh["ranks"]) or V % size:
        raise ValueError(f"{V} views over {size} ranks: the configuration asks {sh['ranks']} "
                         "ranks, and the views must split evenly over them")
    if int(f["max_steps"]) != 512 or tuple(f["sky"]) != tuple(SKY):
        raise ValueError("the sharded step samples with max_steps 512 over the sky "
                         f"{SKY}; the configuration asks otherwise")
    t0 = time.perf_counter()
    with run.part("worldgen"):
        host = World.generate(dims=tuple(w["dims"]), chunksize=float(w["chunksize"]),
                              depth=int(w["depth"]), seed=int(w["seed"]),
                              water_level=float(w["water_level"]),
                              amplitude=float(w["amplitude"]))
    with run.part("upload"):
        world = host.to_torch(device=dev)
        del host
        _sync(dev)
    run.record["worldgen_s"] = time.perf_counter() - t0
    with run.part("rays_targets"):
        order = orbit.block_order(int(cam["height"]), int(cam["width"]), int(cam["block"]), dev)
        N = int(cam["width"]) * int(cam["height"])
        origins = torch.empty((V * N, 3), dtype=torch.float32, device=dev)
        dirs = torch.empty_like(origins)
        for v, (p, yaw) in enumerate(orbit.poses(cam, V, orbit.phase(run.args.seed))):
            origins[v * N:(v + 1) * N], dirs[v * N:(v + 1) * N] = orbit.rays(cam, p, yaw, order,
                                                                              dev)
        gt = init_params_from_world(world, solid_density=float(f["solid_density"]))
        share = V // size
        mine = torch.empty((share * N, 3), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for j in range(share):
                rows = slice((mesh.rank * share + j) * N, (mesh.rank * share + j + 1) * N)
                mine[j * N:(j + 1) * N] = render_soft(
                    world, gt, origins[rows], dirs[rows], max_segments=K,
                    max_steps=int(f["max_steps"]), device=dev)["rgb"]
        targets = torch.empty_like(origins)
        dist.all_gather_into_tensor(targets, mine, group=mesh.group)
        del mine
        density, albedo = fit.start_from(gt.density_raw, gt.albedo_raw, f, run.args.seed)
        del gt
        _sync(dev)
    train_step = make_sharded_train_step(
        mesh, world, functools.partial(torch.optim.Adam, lr=float(f["lr"])), max_segments=K,
        overlap=bool(sh["overlap"]), grad_tiles=int(sh["grad_tiles"]))
    losses = torch.zeros(fit.LOSS_SLOTS, dtype=torch.float32, device=dev)
    st = {"params": VoxelParams(density, albedo), "opt": None}

    def step(i: int) -> None:
        first = (size * i) % V
        rows = slice(first * N, (first + size) * N)
        st["params"], st["opt"], loss = train_step(st["params"], st["opt"], world,
                                                   origins[rows], dirs[rows], targets[rows])
        losses[i % fit.LOSS_SLOTS].copy_(loss)

    return dict(world=world, origins=origins, dirs=dirs, targets=targets, st=st, step=step,
                losses=losses, V=V, N=N, K=K)


def first_steps(state) -> dict:
    """The first steps; keeps the first gradient's norm by leaf (this
    rank's optimizer's first moment after one step) and the change's norm
    by leaf after the steps."""
    st = state["st"]

    def leaves():
        return (st["params"].density_raw, st["params"].albedo_raw)

    start = [p.detach().clone() for p in leaves()]
    g1 = None
    for i in range(fit.FIRST_STEPS):
        state["step"](i)
        if i == 0:
            opt = st["opt"]
            held = [p for group in opt.param_groups for p in group["params"]]
            g1 = [float((opt.state[p]["exp_avg"] / (1 - fit.BETA1)).norm())
                  if "exp_avg" in opt.state.get(p, {}) else 0.0 for p in held]
    change = [float((p.detach() - s).norm()) for p, s in zip(leaves(), start)]
    return {"g1": g1, "change": change}


# ------------------------------------------------------------------ window


def window(run, mesh, state) -> dict:
    traffic, dev, step = run.traffic, mesh.device, state["step"]
    with run.part("warmup"):
        state["first"] = first_steps(state)
        i = fit.FIRST_STEPS
        _sync(dev)
        t0 = time.perf_counter()
        warm = int(traffic.get("warmup_steps", 4))
        for _ in range(warm):
            step(i)
            i += 1
        _sync(dev)
        per_step = (time.perf_counter() - t0) / warm
        count = torch.tensor([max(1, math.ceil(run.args.seconds / per_step))],
                             dtype=torch.int64, device=dev)
        dist.broadcast(count, 0, group=mesh.group)
        steps = int(count.item())
        dist.barrier(group=mesh.group)
        _sync(dev)
    host_ms = []
    gc.collect()
    gc.disable()
    run.start_window()
    t_start = time.perf_counter()
    w0 = i
    for _ in range(steps):
        h0 = time.perf_counter()
        step(i)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        i += 1
    _sync(dev)
    t_end = time.perf_counter()
    gc.enable()
    run.record["steps"] = steps
    run.record["step_host_ms"] = host_ms
    run.record["ranks"] = mesh.size
    e2e = {traffic["step_metric"]: (t_end - t_start) * 1e3 / steps}
    if run.args.trace:
        n = int(traffic["trace_steps"])
        if mesh.rank == 0:
            from ..run import smi

            run.record["smi_after"] = smi() if dev.type == "cuda" else ""
            with tr.traced(run.record):
                for _ in range(2):
                    step(i)
                    i += 1
                with tr.window():
                    for _ in range(n):
                        step(i)
                        i += 1
                    _sync(dev)
            run.record["trace_steps"] = n
        else:
            for _ in range(2 + n):
                step(i)
                i += 1
    _sync(dev)
    losses = state["losses"]
    state["program_losses"] = losses[:fit.FIRST_STEPS].tolist()
    slots = torch.arange(w0, w0 + steps, device=dev) % fit.LOSS_SLOTS
    bad = int((~torch.isfinite(losses[slots])).sum())
    return {"e2e": e2e, "attempted": steps, "failed": bad}


# -------------------------------------------------------------- comparison


def judge(run, mesh, state, control: bool = False) -> dict:
    """This rank's part of the comparison: its pools, its drawn rows and
    targets, and the reference's sums of its views of the first steps.
    Returns this rank's numbers (on rank 0 also the reference's first
    steps and, for the control, the bfloat16 reference's)."""
    from octree_raymarcher_tpu_torch.diff.segments import sample_segments

    from ..reference import fit as ref_fit
    from ..reference import sharded as ref_sharded
    from ..reference import world as ref_world
    from ..reference.segments import sample_segments_plain

    dev, cfg, traffic = mesh.device, run.config, run.traffic
    f, w = cfg["fit"], cfg["world"]
    K, sky, max_steps = state["K"], tuple(f["sky"]), int(f["max_steps"])
    V, N, size = state["V"], state["N"], mesh.size
    # this rank's view of each first step: rays, the port's segments, the program's target
    mine = []
    for i in range(fit.FIRST_STEPS):
        v = (size * i + mesh.rank) % V
        rows = slice(v * N, (v + 1) * N)
        o, d = state["origins"][rows].clone(), state["dirs"][rows].clone()
        segs = sample_segments(state["world"], o, d, K, max_steps, device=dev)
        mine.append((v, o, d, (segs.slot, segs.t0, segs.t1), state["targets"][rows].clone()))
    prog_pools = {name: getattr(state["world"], name).cpu().numpy().view(np.uint32)
                  for name in ("tree", "twig", "twig_occ")}
    state.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    packed = ref_world.generate(w["dims"], w["chunksize"], w["depth"], w["seed"],
                                w["water_level"], w["amplitude"])
    pool_diff = 0
    for name, a in prog_pools.items():
        b = getattr(packed, name)
        pool_diff += int(np.count_nonzero(a != b)) if a.shape == b.shape else max(a.size, b.size)
    world = ref_world.world_on(packed, dev)
    den_gt, alb_gt = ref_fit.init_params(world, solid_density=float(f["solid_density"]))

    rows_each = int(traffic.get("check_rows", 8192))
    picks = []
    for v, o, _, _, _ in mine:     # the same rows of a view whichever rank holds it
        g = torch.Generator(device="cpu")
        g.manual_seed((fit._seed(run.args.seed) ^ 0xC0FFEE) + v)
        picks.append(torch.randperm(o.shape[0], generator=g)[:rows_each].to(dev))
    o_rows = torch.cat([o[r] for (_, o, _, _, _), r in zip(mine, picks)])
    d_rows = torch.cat([d[r] for (_, _, d, _, _), r in zip(mine, picks)])
    want = sample_segments_plain(world, o_rows, d_rows, K, max_steps)
    if control:     # the control samples the drawn rows from bfloat16 rays
        rounded = sample_segments_plain(world, o_rows.bfloat16().float(),
                                        d_rows.bfloat16().float(), K, max_steps)
        got = [rounded.slot, rounded.t0, rounded.t1]
    else:
        got = [torch.cat([segs[c][r] for (_, _, _, segs, _), r in zip(mine, picks)])
               for c in range(3)]
    same = ((got[0] == want.slot) & (got[1] == want.t0) & (got[2] == want.t1)).all(dim=1)
    seg_bad, seg_rows = int((~same).sum()), int(same.numel())

    target_gap, views = 0.0, []
    for _, _, _, segs, target in mine:
        with torch.no_grad():
            t_ref = ref_fit.render(segs, den_gt.double(), alb_gt.double(), sky).float()
            if control:
                target = ref_fit.render(segs, den_gt.bfloat16(), alb_gt.bfloat16(), sky).float()
        target_gap = max(target_gap, float((target - t_ref).abs().max()))
        views.append((segs, t_ref))
    den0, alb0 = fit.start_from(den_gt, alb_gt, f, run.args.seed)
    lr, n_global = float(f["lr"]), size * N
    parts = {"pool_words_differing": pool_diff, "seg_bad": seg_bad, "seg_rows": seg_rows,
             "target_gap": target_gap}
    ref = ref_sharded.first_steps(views, den0, alb0, lr, sky, n_global, mesh.group)
    if control:
        ctl = ref_sharded.first_steps(views, den0, alb0, lr, sky, n_global, mesh.group,
                                      dtype=torch.bfloat16)
    if mesh.rank == 0:
        parts["reference"] = ref
        parts["moving"] = fit.moving(ref[1], (den_gt.numel(), alb_gt.numel()))
        if control:
            parts["control"] = ctl
    return parts


def compare(run, reports: list, first: dict, control: bool = False) -> dict:
    """Rank 0: the ranks' numbers beside their limits."""
    r0 = reports[0]
    ref_losses, g1_ref, change_ref = r0["reference"]
    if control:
        losses, g1, change = r0["control"]
    else:
        losses, g1, change = first["losses"], first["g1"], first["change"]
    counted = r0["moving"]
    numbers = {
        "pool_words_differing": float(sum(r["pool_words_differing"] for r in reports)),
        "segment_rows_differing": sum(r["seg_bad"] for r in reports)
        / max(sum(r["seg_rows"] for r in reports), 1),
        "target_gap": max(r["target_gap"] for r in reports),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_norm_gap": fit._gap([g1[k] for k in counted], [g1_ref[k] for k in counted]),
        "change_norm_gap": fit._gap([change[k] for k in counted],
                                    [change_ref[k] for k in counted]),
    }
    run.record["fit_readings"] = {"losses": losses, "ref_losses": ref_losses, "g1": g1,
                                  "g1_ref": g1_ref, "change": change, "change_ref": change_ref,
                                  "counted": counted,
                                  "judge_rows": sum(r["seg_rows"] for r in reports)}
    for name, value in numbers.items():
        run.check(name, value)
    return numbers


def control(cell) -> dict:
    """The control's run (``python -m benchmark.control --mode control``)."""
    return run(cell, "control")
