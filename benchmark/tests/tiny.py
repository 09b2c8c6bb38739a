"""A copy of the benchmark, at a size a test run holds, in a temporary
directory: the cells' configurations cut to a 2 x 1 x 2 world of 32-unit
chunks at depth 5 and a 64 x 36 camera, their mixes to a few poses or views,
each added as new files beside the originals (no file of the copy edited),
with the real cells' limits.  ``run`` drives a cell of the copy on the CPU
in a fresh process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
WORLD = {"dims": [2, 1, 2], "chunksize": 32, "depth": 5, "seed": 7, "water_level": 4,
         "amplitude": 16}
CAMERA = {"width": 64, "height": 36, "position0": [32, 20, -20], "centre_xz": [32, 32],
          "block": 16}
# the real cell each tiny cell stands for, its configuration, and its mix's cuts
CELLS = {
    "viewer.tiny": ("viewer.orbit_full", {"poses": 3, "trace_cycles": 1}),
    "fit.tiny_streamed": ("fit.streamed_views", {"views": 5, "trace_steps": 2,
                                                 "check_rows": 256}),
    "fit.tiny_cached": ("fit.cached_views", {"views": 3, "views_per_step": 3,
                                             "trace_steps": 2, "check_rows": 256}),
}


def make(dst: Path) -> Path:
    """Copy BENCHMARK.json and the benchmark into ``dst`` and add the tiny
    cells as new files; returns ``dst``."""
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    for tiny, (real, cuts) in CELLS.items():
        w = by_name[real]
        cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
        cfg["name"] = f"{w['config']}-tiny"
        cfg["world"], cfg["camera"] = dict(WORLD), {**cfg["camera"], **CAMERA}
        (dst / "benchmark/configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        mix.update(cuts)
        (dst / "benchmark/traffic" / f"{w['traffic']}-tiny.json").write_text(json.dumps(mix))
        cell = json.loads((BENCH / "cells" / f"{real}.json").read_text())
        (dst / "benchmark/cells" / f"{tiny}.json").write_text(json.dumps(cell))
        bench["workloads"].append({**w, "name": tiny, "config": cfg["name"],
                                   "traffic": f"{w['traffic']}-tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run(dst: Path, cell: str, seed: int = 12345678901, fault: str | None = None,
        control: bool = False, device: str = "cpu", trace: int = 0,
        timeout: float = 600) -> dict:
    """Drive ``cell`` of the copy at ``dst`` on ``device`` in a fresh
    process (a fault planted, or the control in the program's place);
    returns the last line's JSON."""
    if control or fault:
        mode = "control" if control else f"fault:{fault}"
        code = ["-m", "benchmark.control", "--workload", cell, "--seed", str(seed),
                "--mode", mode, "--seconds", "0.5", "--device", device]
    else:
        code = ["-c", "import sys, torch; from benchmark import harness, run; "
                f"sys.exit(run.execute(run.parse(['--workload', '{cell}', '--seed', "
                f"'{seed}', '--seconds', '0.5', '--trace', '{trace}']), harness.spec(), "
                f"torch.device('{device}')))"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, *code], cwd=dst, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{cell} exited {out.returncode}:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])
