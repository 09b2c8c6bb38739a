"""Run one cell of BENCHMARK.json once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``checks`` last, and with ``--trace 1`` ``breakdown``); the numbers compared
are also the last lines of standard error, each beside its limit.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a profiled window after the
measured one.  The run exits with 2, printing no result, when the cell asks
for more CUDA devices than there are, and with 3 when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "octree_raymarcher_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def note(msg: str) -> None:
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def smi() -> str:
    """The card's name, clocks, power, power limit and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def result_line(run, out: dict, trace: int) -> dict:
    """The result object of a finished run."""
    import torch

    from . import harness
    from . import trace as tr

    bench = run.bench
    name = run.args.workload
    metrics = {}
    if trace == 0:
        e2e = dict(out["e2e"])
        e2e["setup_s"] = run.window_started - run.started
        for m in bench["end_to_end"]:
            if harness.applies(m, name, set(e2e)) and m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        reported = {m["name"] for m in bench["end_to_end"]
                    if harness.applies(m, name, set(out["e2e"]) | {"setup_s"})}
        for m in bench["per_layer"]:
            if not harness.applies(m, name, reported):
                continue
            value = harness.metric(m["name"]).read(run.record, run.work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": run.workload["chips"],
              "memory_peak_bytes": run.record.get("memory_peak_bytes", 0)}
    line = {"correct": bool(run.checks) and all(c[3] for c in run.checks),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace == 1:
        t = run.record.get("trace", {})
        device["busy_s"] = t.get("busy_s", 0.0)
        device["window_s"] = t.get("window_s", 0.0)
        line["breakdown"] = {"device_ops": tr.device_ops(t),
                             "idle_gaps": [[n, s] for n, s in t.get("gaps", [])]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in run.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness

    bench = harness.spec()
    cell = harness.workload(args.workload, bench)
    import torch

    import_s = time.perf_counter() - STARTED
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        note(f"the cell needs {cell['chips']} CUDA device(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
             f"device_count() = {torch.cuda.device_count()}")
        return 2
    return execute(args, bench, torch.device("cuda", 0), import_s)


def execute(args, bench: dict, device, import_s: float = 0.0) -> int:
    """Run the cell on ``device`` (the tests call this on the CPU) and print
    its line; returns the exit code."""
    import gc

    import torch

    from . import harness

    torch.set_num_threads(min(4, torch.get_num_threads()))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    run = harness.Run(args, bench, STARTED, device)
    run.setup["import"] = import_s
    with run.part("cuda_init"):
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
    before = smi() if args.trace and device.type == "cuda" else None
    try:
        out = harness.loop(run.traffic["loop"]).run(run)
    finally:
        gc.enable()
    note(f"run ended {time.perf_counter() - STARTED:.1f} s after start; the comparison took "
         f"{run.record.get('judge_s', float('nan')):.1f} s")
    found = forbidden_modules()
    if found:
        note(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}")
        return 3
    if before is not None:
        note(f"nvidia-smi before the window: {before}")
        note(f"nvidia-smi after the window: {run.record.get('smi_after', smi())}")
    if run.window_started is not None:
        split = ", ".join(f"{k} {v:.3f}" for k, v in run.setup.items())
        note(f"setup_s {run.window_started - run.started:.3f}: {split}")
    line = result_line(run, out, args.trace)
    for n, v, lim, ok in run.checks:
        print(f"check {n}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
