"""Readings for the limits: the program, the control and the planted faults,
on a cell at its own size.  Not part of a benchmark run.

    python -m benchmark.control --workload <cell> --seed <n> [<n> ...] --mode program
    python -m benchmark.control --workload <cell> --seed <n> [<n> ...] --mode control
    python -m benchmark.control --workload <cell> --seed <n> [<n> ...] --mode fault:<name>

``program`` runs the cell as it is for ``--seconds`` and prints the numbers
that the comparison reads; ``control`` puts the reference computed in the
precision below the configuration's (bfloat16 for float32) in the program's
place; ``fault:<name>`` runs the cell with the fault planted
(benchmark/faults.py).  Each seed is read in turn in this one process, so
that the import and the CUDA start are paid once.  One JSON line a seed:
the mode, each number beside its limit, and the fit's readings by leaf.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import faults, harness
from .run import STARTED


def read(args, dev) -> dict:
    """One seed's readings."""
    run = harness.Run(args, harness.spec(), STARTED, dev)
    loop_name = run.traffic["loop"]
    mod = harness.loop(loop_name)
    if args.mode == "control":
        mod.control(run)
    elif args.mode == "program":
        mod.run(run)
    elif args.mode.startswith("fault:"):
        with faults.planted(loop_name, args.mode.split(":", 1)[1]):
            mod.run(run)
    else:
        raise SystemExit(f"unknown mode {args.mode!r}")
    readings = {n: {"value": v, "limit": lim, "passes": ok} for n, v, lim, ok in run.checks}
    return {"workload": args.workload, "seed": args.seed, "mode": args.mode,
            "correct": all(c[3] for c in run.checks), "checks": readings,
            "judge_s": run.record.get("judge_s"), "extra": run.record.get("fit_readings")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
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
