"""Observability: rolling frame timers and structured metrics logging.

Capability parity with the reference's instrumentation — the 32-sample ring
`Counter` with avg/std/min/max (src/Util.h:8-23, src/Util.cpp:17-70), the
labeled SW_START/SW_STOP stopwatches (src/Debug.h:6-12) and the HUD/console
reports of frame time, pool occupancy and octree memory (src/Main.cpp:264-311,
src/Debug.cpp:131-176) — re-expressed as host-side utilities: timers (around
device work that ends in a synchronize, for honest walls) and a JSONL
metrics logger instead of an on-screen HUD.  A copy of
octree_raymarcher_tpu/utils/metrics.py.
"""

from __future__ import annotations

import contextlib
import json
import math
import time


class Counter:
    """Rolling ring of the last ``window`` samples with summary stats."""

    def __init__(self, window: int = 32):
        self.window = window
        self.samples: list[float] = []
        self._i = 0

    def add(self, value: float) -> None:
        if len(self.samples) < self.window:
            self.samples.append(float(value))
        else:
            self.samples[self._i] = float(value)
        self._i = (self._i + 1) % self.window

    def stats(self) -> dict:
        s = self.samples
        if not s:
            return {"n": 0, "avg": 0.0, "std": 0.0, "min": 0.0, "max": 0.0}
        avg = sum(s) / len(s)
        var = sum((x - avg) ** 2 for x in s) / len(s)
        return {
            "n": len(s),
            "avg": avg,
            "std": math.sqrt(var),
            "min": min(s),
            "max": max(s),
        }

    @contextlib.contextmanager
    def time(self):
        """Stopwatch context (the SW_START/SW_STOP analog)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)


class MetricsLogger:
    """Structured per-step metrics to JSONL (rays/s, steps/ray, pool
    occupancy, losses, scaling efficiency — SURVEY.md section 5)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.counters: dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter()
        return self.counters[name]

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def frame_report(self) -> dict:
        return {name: c.stats() for name, c in self.counters.items()}

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12)


__all__ = ["Counter", "MetricsLogger", "rays_per_second"]
