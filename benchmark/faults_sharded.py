"""Faults planted under the sharded fit's timed path, for the checks that
its comparison fails them, and the command that reads them.

    python -m benchmark.faults_sharded --workload <cell> --seed <n> [<n> ...] --mode <mode>

``--mode`` is ``program``, ``control`` (the reference in bfloat16 in the
program's place) or ``fault:<name>``; the loop (``loops/fit_sharded.py``)
plants the fault on every rank, each rank patching the port in its own
process.  One JSON line a seed, as ``benchmark.control`` prints.

* ``dropped``: rank 1's gradients left out of the sum (each of its tiles
  hands the all-reduce zeros; its loss still counts);
* ``local_count``: the gradient divided by the rank's own ray count instead
  of the global one (the rank count times too large);
* ``stale``: the step leaves the parameters as they were (Adam's step does
  nothing);
* ``altered``: each tile's loss scaled by 1.01 where it is produced.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

FAULTS = ("dropped", "local_count", "stale", "altered")


@contextlib.contextmanager
def planted(fault: str, rank: int):
    """Patch the port with ``fault`` in this rank's process while the block
    runs."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} of the sharded fit; one of {FAULTS}")
    patches = _patches(fault, rank)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


def _patches(fault: str, rank: int) -> list:
    import importlib

    import torch
    import torch.distributed as dist

    # the module (the package's ``render_sharded`` is the function of that name)
    rs = importlib.import_module("octree_raymarcher_tpu_torch.parallel.render_sharded")

    if fault == "stale":
        def step(self, closure=None):
            return None
        return [(torch.optim.Adam, "step", step)]
    if fault == "local_count":
        real_step = rs.optimizer_step

        def optimizer_step(optimizer, opt_state, values, grads):
            size = dist.get_world_size()
            return real_step(optimizer, opt_state, values, [g * size for g in grads])
        return [(rs, "optimizer_step", optimizer_step)]
    real = rs._tile_loss_grad

    def tile_loss_grad(*args, **kwargs):
        loss, grads = real(*args, **kwargs)
        if fault == "altered":
            return loss * 1.01, grads
        return loss, [torch.zeros_like(g) for g in grads] if rank == 1 else grads
    return [(rs, "_tile_loss_grad", tile_loss_grad)]


def read(args, dev) -> dict:
    """One seed's readings."""
    from . import harness
    from .run import STARTED

    run = harness.Run(args, harness.spec(), STARTED, dev)
    harness.loop(run.traffic["loop"]).run(run, args.mode)
    readings = {n: {"value": v, "limit": lim, "passes": ok} for n, v, lim, ok in run.checks}
    return {"workload": args.workload, "seed": args.seed, "mode": args.mode,
            "correct": bool(run.checks) and all(c[3] for c in run.checks),
            "checks": readings, "judge_s": run.record.get("judge_s"),
            "extra": run.record.get("fit_readings")}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python -m benchmark.faults_sharded")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.trace = 0
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    for seed in list(args.seed):
        args.seed = seed
        print(json.dumps(read(args, dev)), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
