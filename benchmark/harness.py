"""Find the benchmark's parts by name, and carry one run's state.

Each part is a file of its own, so that a later change adds a part by adding
a file and edits none:

* ``configs/<config>.json``: the deployment (world, camera rig, render or fit
  settings), its ``source``, ``reduced`` and ``assumed``;
* ``traffic/<mix>.json``: a traffic mix, the parameters that the loop named by
  its ``"loop"`` key reads;
* ``loops/<loop>.py``: a loop's set-up, measured window and comparison, as
  ``run(run: Run) -> dict``;
* ``metrics/<metric>.py``: a per-layer metric's reader,
  ``read(record: dict, work: dict) -> float | None``; one reader serves a
  quantity in every cell (``metrics/idle_share.py`` reads
  ``idle_share.viewer`` and ``idle_share.cached``);
* ``layers/<layer>/*.txt``: the kernel-name patterns (one regular expression a
  line, ``#`` starts a comment) whose device time is the layer's;
* ``cells/<cell>.json``: a cell's fixed work for the rooflines and the limits
  of the numbers its comparison reports.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spec() -> dict:
    """BENCHMARK.json, beside this folder."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell(name: str) -> dict:
    """The cell's fixed work and limits; {} when it has no file."""
    path = HERE / "cells" / f"{name}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    mod_name = f"benchmark.{kind}.{name.replace('.', '__')}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        loader_spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(loader_spec)
        sys.modules[mod_name] = mod
        loader_spec.loader.exec_module(mod)
    return mod


def loop(name: str):
    """The loop module (``run(run) -> dict``)."""
    return _module("loops", name)


def metric(name: str):
    """The per-layer metric's reader module (``read(record, work)``):
    ``metrics/<metric>.py``, or else the reader of the quantity that the
    name's last dot splits off (``composite_ms.cached`` is read by
    ``metrics/composite_ms.py`` where it has no file of its own)."""
    if not (HERE / "metrics" / f"{name}.py").is_file() and "." in name:
        return _module("metrics", name.rsplit(".", 1)[0])
    return _module("metrics", name)


def layer_patterns(layer: str) -> list:
    """Compiled kernel-name patterns of ``layers/<layer>/*.txt``."""
    folder = HERE / "layers" / layer
    if not folder.is_dir():
        raise LookupError(f"no layer named {layer!r} (benchmark/layers/{layer}/)")
    pats = []
    for path in sorted(folder.glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                pats.append(re.compile(line))
    return pats


def workload(name: str, bench: dict | None = None) -> dict:
    bench = spec() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric_entry: dict, cell_name: str, reported: set) -> bool:
    """Whether a metric of BENCHMARK.json belongs in the cell's line: listed
    for it, or listing no cells and moving a metric the cell reports."""
    if "workloads" in metric_entry:
        return cell_name in metric_entry["workloads"]
    moves = metric_entry.get("moves")
    return moves is None or moves in reported


class Run:
    """One run of one cell: its arguments and parts, the set-up's split, the
    record that the metric readers read, and the numbers compared."""

    def __init__(self, args, bench: dict, started: float, device):
        self.args = args
        self.bench = bench
        self.started = started
        self.device = device
        self.workload = workload(args.workload, bench)
        self.config = config(self.workload["config"])
        self.traffic = traffic(self.workload["traffic"])
        self.work = cell(args.workload)
        self.setup: dict = {}
        self.record: dict = {}
        self.checks: list = []          # (name, value, limit, passes)
        self.window_started: float | None = None

    @contextlib.contextmanager
    def part(self, name: str):
        """Time a part of set-up by the host clock (summed over repeats)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t0

    def start_window(self) -> None:
        """Mark the end of set-up: the first timed frame or step follows."""
        self.window_started = time.perf_counter()

    def check(self, name: str, value: float, limit_key: str | None = None,
              at_most: bool = True) -> None:
        """Record a number compared beside its limit from the cell's file
        (``limits``); a number with no limit there fails."""
        limit = self.work.get("limits", {}).get(limit_key or name)
        ok = limit is not None and value == value and (
            value <= limit if at_most else value >= limit)
        self.checks.append((name, float(value), limit, bool(ok)))
