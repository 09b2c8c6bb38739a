"""The fit loop: Adam on per-voxel density and albedo, as the port's ``fit``
runs its loop, over streamed or cached orbit views.

Set-up builds the world with the port, the ground truth
(``init_params_from_world``), the views' rays on the device, their targets
(the ground truth's soft renders, ``render_soft``), and the start: the ground
truth perturbed by noise drawn on the device from the seed (albedo
``albedo_noise`` N(0, 1), density the truth plus ``density_offset`` plus
``density_noise`` N(0, 1)).  One trainer (the parameters and
``torch.optim.Adam``) is built, driven through its first three steps by the
window's own step function (the reference follows them), warmed up, and
handed to the window.

A step: ``zero_grad``; with ``cached`` false, ``sample_views`` of the next
``views_per_step`` views (K4), else the views' segments sampled once in
set-up; ``photometric_loss``; ``backward`` (K5's VJP, K6); ``Adam.step``.
No step waits on the host: each loss goes into a buffer on the device, read
after the window.  The end-to-end metric the mix names (``step_metric``) is
the window's host-clock time over the steps completed; the window ends at
the first step after ``--seconds``.

The comparison, after the window, with the program's state freed: the
reference generates the world again and checks the program's pools, the
ground truth and the targets, re-samples rows drawn from the seed of the
first steps' segments with its plain sampler, then runs the first three
steps itself (its composite under autograd, its own Adam) on the program's
segments, and compares each step's loss, the first gradient's norm by leaf
(from Adam's first moment after one step) and the parameters' change after
three steps by leaf, each leaf against its own reference norm.  A leaf that
the reference's gradient moves by round-off alone is left out (``moving``);
density and albedo both move.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import trace as tr
from ..traffic import orbit

FIRST_STEPS = 3
BETA1 = 0.9
LOSS_SLOTS = 1 << 16
ROUNDOFF = 1e-6


def _seed(seed: int) -> int:
    return seed & (2**63 - 1)


def noise(num_slots: int, seed: int, dev):
    """(N(0, 1)[P, 3] for the albedo, N(0, 1)[P] for the density) drawn on
    ``dev`` from the seed."""
    g = torch.Generator(device=dev)
    g.manual_seed(_seed(seed))
    n_alb = torch.randn((num_slots, 3), generator=g, device=dev, dtype=torch.float32)
    n_den = torch.randn((num_slots,), generator=g, device=dev, dtype=torch.float32)
    return n_alb, n_den


def start_from(density_gt, albedo_gt, fcfg: dict, seed: int):
    n_alb, n_den = noise(density_gt.shape[0], seed, density_gt.device)
    albedo = float(fcfg["albedo_noise"]) * n_alb
    density = density_gt + float(fcfg["density_offset"]) + float(fcfg["density_noise"]) * n_den
    return density, albedo


def setup(run):
    cfg, traffic, dev = run.config, run.traffic, run.device
    with run.part("import"):
        from octree_raymarcher_tpu_torch.diff import optim
        from octree_raymarcher_tpu_torch.diff.composite import (
            VoxelParams,
            init_params_from_world,
            render_soft,
        )
        from octree_raymarcher_tpu_torch.world.world import World
    w, cam, f = cfg["world"], cfg["camera"], cfg["fit"]
    K = int(f["K"])
    t0 = time.perf_counter()
    with run.part("worldgen"):
        host = World.generate(dims=tuple(w["dims"]), chunksize=float(w["chunksize"]),
                              depth=int(w["depth"]), seed=int(w["seed"]),
                              water_level=float(w["water_level"]),
                              amplitude=float(w["amplitude"]))
    with run.part("upload"):
        world = host.to_torch(device=dev)
        del host
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    run.record["worldgen_s"] = time.perf_counter() - t0
    V = int(traffic["views"])
    with run.part("rays_targets"):
        order = orbit.block_order(int(cam["height"]), int(cam["width"]), int(cam["block"]), dev)
        pose_list = orbit.poses(cam, V, orbit.phase(run.args.seed))
        rays = [orbit.rays(cam, p, yaw, order, dev) for p, yaw in pose_list]
        gt = init_params_from_world(world, solid_density=float(f["solid_density"]))
        with torch.no_grad():
            targets = [render_soft(world, gt, o, d, max_segments=K,
                                   max_steps=int(f["max_steps"]), device=dev)["rgb"]
                       for o, d in rays]
        density, albedo = start_from(gt.density_raw, gt.albedo_raw, f, run.args.seed)
        del gt
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    views = [(o, d, t) for (o, d), t in zip(rays, targets)]
    cached = None
    if traffic.get("cached"):
        with run.part("segments"):
            cached = optim.sample_views(world, views, K, int(f["max_steps"]), device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    leaves = [density.requires_grad_(True), albedo.requires_grad_(True)]
    params = VoxelParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=float(f["lr"]))
    losses = torch.zeros(LOSS_SLOTS, dtype=torch.float32, device=dev)
    per_step = int(traffic["views_per_step"])

    def step(i: int):
        """The window's step i; returns the (segments, target) it used."""
        opt.zero_grad(set_to_none=True)
        if cached is not None:
            c = cached
        else:
            c = optim.sample_views(world, [views[(i * per_step + j) % V] for j in range(per_step)],
                                   K, int(f["max_steps"]), device=dev)
        loss = optim.photometric_loss(params, c)
        loss.backward()
        opt.step()
        losses[i % LOSS_SLOTS].copy_(loss.detach())
        return c

    return dict(world=world, views=views, cached=cached, leaves=leaves, opt=opt, step=step,
                losses=losses, V=V, per_step=per_step)


def first_steps(state) -> dict:
    """Drive the trainer through its first steps; keep what the reference
    follows: the steps' segments and targets (on the host), the first
    gradient's norm by leaf, the change's norm by leaf after the steps."""
    leaves, opt = state["leaves"], state["opt"]
    start = [p.detach().clone() for p in leaves]
    used = []
    g1 = None
    for i in range(FIRST_STEPS):
        c = state["step"](i)
        if state["cached"] is None:
            used.append([((s.slot.cpu(), s.t0.cpu(), s.t1.cpu()), t.cpu()) for s, t in c])
        if i == 0:      # Adam's first moment after one step is (1 - beta1) g
            g1 = [float((opt.state[p]["exp_avg"] / (1 - BETA1)).norm())
                  if "exp_avg" in opt.state.get(p, {}) else 0.0 for p in leaves]
    change = [float((p.detach() - s).norm()) for p, s in zip(leaves, start)]
    return {"segments": used, "g1": g1, "change": change}


def run(run):
    traffic, dev = run.traffic, run.device
    state = setup(run)
    with run.part("warmup"):
        first = first_steps(state)
        step = state["step"]
        i = FIRST_STEPS
        for _ in range(int(traffic.get("warmup_steps", 4))):
            step(i)
            i += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    host_ms = []
    gc.collect()
    gc.disable()
    run.start_window()
    t_start = time.perf_counter()
    deadline = t_start + run.args.seconds
    w0, steps = i, 0
    while True:
        h0 = time.perf_counter()
        step(i)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        i += 1
        steps += 1
        if h0 >= deadline:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    gc.enable()
    run.record["steps"] = steps
    run.record["step_host_ms"] = host_ms
    e2e = {traffic["step_metric"]: (t_end - t_start) * 1e3 / steps}
    if run.args.trace:
        from ..run import smi

        run.record["smi_after"] = smi() if dev.type == "cuda" else ""
        n = int(traffic["trace_steps"])
        with tr.traced(run.record):
            for _ in range(2):
                step(i)
                i += 1
            with tr.window():
                for _ in range(n):
                    step(i)
                    i += 1
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        run.record["trace_steps"] = n
    if dev.type == "cuda":
        run.record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    losses = state["losses"][:FIRST_STEPS].tolist()
    window = torch.arange(w0, w0 + steps, device=dev) % LOSS_SLOTS
    bad = int((~torch.isfinite(state["losses"][window])).sum())     # the window's steps
    t0 = time.perf_counter()
    judge(run, state, first, losses)
    run.record["judge_s"] = time.perf_counter() - t0
    return {"e2e": e2e, "attempted": steps, "failed": bad}


def _gap(ours, ref) -> float:
    """Largest gap between the program's and the reference's norm over the
    leaves given, each against that leaf's own reference norm; NaN (which
    fails) where no leaf is given."""
    return max((abs(a - b) / b for a, b in zip(ours, ref)), default=float("nan"))


def moving(g1_ref, sizes) -> list:
    """The leaves that the reference's first gradient moves beyond
    round-off: those whose gradient's root mean square per element is at
    least ``ROUNDOFF`` of Adam's eps (a leaf below it moves less than
    ``ROUNDOFF`` × lr a step, by rounding alone)."""
    from ..reference.fit import ADAM_EPS

    return [k for k, (g, n) in enumerate(zip(g1_ref, sizes))
            if g / n ** 0.5 >= ROUNDOFF * ADAM_EPS]


def chain(views_of, den0, alb0, lr: float, sky, dtype=torch.float64):
    """The reference's first steps from (den0, alb0): (losses, first
    gradient's norm by leaf, change's norm by leaf)."""
    from ..reference import fit as ref_fit

    params = [den0.clone(), alb0.clone()]
    adam = ref_fit.Adam(params, lr)
    losses, g1 = [], None
    for views in views_of:
        loss, gd, ga = ref_fit.loss_and_grads(views, params[0], params[1], sky, dtype=dtype)
        losses.append(loss)
        if g1 is None:
            g1 = [float(gd.norm()), float(ga.norm())]
        adam.step([gd, ga])
    return losses, g1, [float((p - p0).norm()) for p, p0 in zip(params, (den0, alb0))]


def judge(run, state, first: dict, losses: list, control: bool = False) -> dict:
    """Compare the first steps with the reference's; record each number
    beside its limit.  ``control`` puts the reference computed in bfloat16
    in the program's place: the drawn rows sampled from bfloat16 rays, the
    targets and the first steps composited from bfloat16 parameters and
    segment distances.  Returns the numbers."""
    from ..reference import fit as ref_fit
    from ..reference import world as ref_world
    from ..reference.segments import sample_segments_plain

    dev, cfg, traffic = run.device, run.config, run.traffic
    f, w = cfg["fit"], cfg["world"]
    K, sky = int(f["K"]), tuple(f["sky"])
    V, per_step = state["V"], state["per_step"]
    prog_pools = {name: getattr(state["world"], name).cpu().numpy().view(np.uint32)
                  for name in ("tree", "twig", "twig_occ")}
    # the distinct views of the first steps: (rays, program segments, program target)
    if state["cached"] is not None:
        distinct = [(state["views"][v][:2], (s.slot, s.t0, s.t1), t)
                    for v, (s, t) in enumerate(state["cached"])]
        step_of = [list(range(len(distinct)))] * FIRST_STEPS
    else:
        distinct, step_of = [], []
        for i, used in enumerate(first["segments"]):
            step_of.append([])
            for j, (segs, target) in enumerate(used):
                v = (i * per_step + j) % V
                step_of[-1].append(len(distinct))
                distinct.append((state["views"][v][:2], tuple(x.to(dev) for x in segs),
                                 target.to(dev)))
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

    # the program's segments against the plain sampler on rows drawn from
    # the seed; its targets against the reference's composite of the truth
    g = torch.Generator(device="cpu")
    g.manual_seed(_seed(run.args.seed) ^ 0xC0FFEE)
    rows_each = int(traffic.get("check_rows", 8192))
    picks = [torch.randperm(o.shape[0], generator=g)[:rows_each].to(dev)
             for (o, _), _, _ in distinct]
    # one plain sampler call over the drawn rows of every view
    want = sample_segments_plain(world, torch.cat([o[r] for ((o, _), _, _), r in zip(distinct, picks)]),
                                 torch.cat([d[r] for ((_, d), _, _), r in zip(distinct, picks)]),
                                 K, int(f["max_steps"]))
    if control:     # the control samples the drawn rows from bfloat16 rays
        ctl = sample_segments_plain(
            world, torch.cat([o[r] for ((o, _), _, _), r in zip(distinct, picks)]).bfloat16().float(),
            torch.cat([d[r] for ((_, d), _, _), r in zip(distinct, picks)]).bfloat16().float(),
            K, int(f["max_steps"]))
        got = [ctl.slot, ctl.t0, ctl.t1]
    else:
        got = [torch.cat([segs[c][r] for (_, segs, _), r in zip(distinct, picks)])
               for c in range(3)]
    same = ((got[0] == want.slot) & (got[1] == want.t0) & (got[2] == want.t1)).all(dim=1)
    seg_bad, seg_rows = int((~same).sum()), int(same.numel())
    target_gap = 0.0
    ref_views = []
    for _, segs, target in distinct:
        with torch.no_grad():
            t_ref = ref_fit.render(segs, den_gt.double(), alb_gt.double(), sky).float()
            if control:
                target = ref_fit.render(segs, den_gt.bfloat16(), alb_gt.bfloat16(), sky).float()
        target_gap = max(target_gap, float((target - t_ref).abs().max()))
        ref_views.append((segs, t_ref))
    views_of = [[ref_views[k] for k in ks] for ks in step_of]

    den0, alb0 = start_from(den_gt, alb_gt, f, run.args.seed)
    lr = float(f["lr"])
    ref_losses, g1_ref, change_ref = chain(views_of, den0, alb0, lr, sky)
    if control:
        losses, g1, change = chain(views_of, den0, alb0, lr, sky, dtype=torch.bfloat16)
    else:
        g1, change = first["g1"], first["change"]
    counted = moving(g1_ref, (den_gt.numel(), alb_gt.numel()))
    numbers = {
        "pool_words_differing": float(pool_diff),
        "segment_rows_differing": seg_bad / max(seg_rows, 1),
        "target_gap": target_gap,
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_norm_gap": _gap([g1[k] for k in counted], [g1_ref[k] for k in counted]),
        "change_norm_gap": _gap([change[k] for k in counted], [change_ref[k] for k in counted]),
    }
    run.record["fit_readings"] = {"losses": losses, "ref_losses": ref_losses, "g1": g1,
                                  "g1_ref": g1_ref, "change": change, "change_ref": change_ref,
                                  "counted": counted, "judge_rows": seg_rows}
    for name, value in numbers.items():
        run.check(name, value)
    return numbers


def control(run) -> dict:
    """The control's numbers: set-up and the first steps (for their
    segments), then the comparison with the bfloat16 reference's first
    steps in the program's place."""
    state = setup(run)
    first = first_steps(state)
    return judge(run, state, first, None, control=True)
