"""Helpers the metric readers share: a layer's device time per frame or
step in the traced window, and the window's idle share."""

from __future__ import annotations

from .. import harness
from .. import trace as tr


def per_unit_ms(record: dict, layer: str, unit: str):
    """Device ms of the layer's kernels per traced frame or step
    (``unit``: "trace_frames" or "trace_steps"); None without a trace, or
    where no kernel of the layer ran."""
    t, count = record.get("trace"), record.get(unit)
    if not t or not count:
        return None
    s = tr.layer_seconds(t, harness.layer_patterns(layer))
    return s * 1e3 / count if s > 0 else None


def idle_share(record: dict):
    """Per cent of the traced window in which no kernel, copy or memset ran."""
    t = record.get("trace")
    if not t or not t.get("window_s") or not (record.get("trace_frames")
                                                or record.get("trace_steps")):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mean(values):
    return sum(values) / len(values) if values else None
