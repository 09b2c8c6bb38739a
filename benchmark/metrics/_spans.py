"""Helpers the span readers share: the port's span log cut into the traced
window's frames or steps.

The port records its spans (``octree_raymarcher_tpu_torch/utils/metrics.py``
``span``) only while a profiler runs, so the log holds the traced window
and the profiler's untimed lead-in before it; the units are counted from
the log's end.  A frame is one ``render.frame`` span and the spans opened
inside it.  A step is one ``fit.loss`` span, the ``fit.sample`` before it,
and what opens after it (its composites, and ``fit.composite_bwd`` on
autograd's thread) up to the next step's first span."""

from __future__ import annotations

MARKERS = {"trace_frames": ("render.frame", ()),
           "trace_steps": ("fit.loss", ("fit.sample",))}


def log() -> list:
    """The port's span records; [] where the port records none (a port
    without spans)."""
    try:
        from octree_raymarcher_tpu_torch.utils.metrics import span_records
    except ImportError:
        return []
    return span_records()


def units(record: dict):
    """The records of each of the last ``record[unit]`` frames or steps, a
    list a unit, in order of entry; None where the log holds fewer units or
    a record of them was made without CUDA (a run off the card)."""
    unit = "trace_frames" if record.get("trace_frames") else "trace_steps"
    count = record.get(unit)
    if not count:
        return None
    marker, leading = MARKERS[unit]
    groups, pending = [], []
    for rec in sorted(log(), key=lambda r: r["id"]):
        if rec["name"] in leading:
            pending.append(rec)
        elif rec["name"] == marker:
            groups.append(pending + [rec])
            pending = []
        elif groups:
            groups[-1].append(rec)
    groups = groups[-count:]
    if len(groups) < count or not all(r["cuda"] for g in groups for r in g):
        return None
    return groups


def per_unit(record: dict, value):
    """The sum of ``value(rec)`` over the last units' records, per unit;
    ``value`` returns None for a record that does not count.  None where
    :func:`units` is None or no record counts."""
    groups = units(record)
    if groups is None:
        return None
    values = [v for g in groups for v in map(value, g) if v is not None]
    return sum(values) / len(groups) if values else None
