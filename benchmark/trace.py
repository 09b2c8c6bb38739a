"""The traced window: torch.profiler over a few frames or steps, reduced to
device intervals by kernel name, the window's busy time, and the idle gaps
named by what the host was doing.

The trace is exported as a Chrome trace into a temporary directory (under
``TMPDIR``), read, and deleted.  Device events are the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the window is the span of the
``bench_window`` annotation that the loop opens around its traced frames or
steps and the synchronise that ends them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")


@contextlib.contextmanager
def traced(record: dict):
    """Profile the block on CPU and CUDA; put the reduced trace in
    ``record["trace"]``.  The block opens ``window()`` around its work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    record["trace"] = reduce(events)


def window():
    """The annotation that bounds the traced window."""
    import torch

    return torch.profiler.record_function(WINDOW)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    """{"window_s", "busy_s", "kernels": [(name, start_s, end_s)],
    "gaps": [(host name, seconds)] longest first} of a Chrome trace's
    events, clipped to the ``bench_window`` annotation's span."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        return {}
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in spans)
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                kernels.append((e.get("name", "?"), s, t))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((ts, ts + dur, e.get("name", "?")))
    busy = _merge([(s, t) for _, s, t in kernels])
    busy_us = sum(t - s for s, t in busy)
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 - g0 <= 0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "host"
        j = bisect.bisect_right(starts, mid)
        for k in range(j - 1, max(-1, j - 400), -1):
            if host[k][1] >= mid:        # the innermost host event over the gap's middle
                name = host[k][2]
                break
        gaps.append((name, (g1 - g0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": [(n, s * 1e-6, t * 1e-6) for n, s, t in kernels], "gaps": gaps[:10]}


def layer_seconds(tr: dict, patterns) -> float:
    """Device seconds of the kernels whose names match any pattern."""
    return sum(t - s for n, s, t in tr.get("kernels", ())
               if any(p.search(n) for p in patterns))


def device_ops(tr: dict, top: int = 10) -> list:
    """[[kernel name, seconds]] of the ``top`` kernels by device time."""
    by = {}
    for n, s, t in tr.get("kernels", ()):
        by[n] = by.get(n, 0.0) + (t - s)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
