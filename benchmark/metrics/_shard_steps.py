"""Helpers the readers of the sharded fit share: the port's span log cut
into the traced window's steps, a step being one ``fit.shard_step`` span
(``parallel/render_sharded.py``) and every span that opens after it (its
collectives, composites and waits, and ``fit.composite_bwd`` on autograd's
thread) up to the next step's; and the trace's NCCL time not covered by
any other device work."""

from __future__ import annotations

from benchmark.metrics import _spans

MARKER = "fit.shard_step"


def units(record: dict):
    """The records of each of the last ``record["trace_steps"]`` steps, a
    list a step, in order of entry; None where the log holds fewer steps
    (a port without the span) or a record of them was made without CUDA."""
    count = record.get("trace_steps")
    if not count:
        return None
    groups = []
    for rec in sorted(_spans.log(), key=lambda r: r["id"]):
        if rec["name"] == MARKER:
            groups.append([rec])
        elif groups:
            groups[-1].append(rec)
    groups = groups[-count:]
    if len(groups) < count or not all(r["cuda"] for g in groups for r in g):
        return None
    return groups


def per_step(record: dict, value):
    """The sum of ``value(rec)`` over the last steps' records, per step;
    ``value`` returns None for a record that does not count.  None where
    :func:`units` is None or no record counts."""
    groups = units(record)
    if groups is None:
        return None
    values = [v for g in groups for v in map(value, g) if v is not None]
    return sum(values) / len(groups) if values else None


def step_bytes(record: dict):
    """Bytes handed to collectives a step (the ``fit.shard_step`` spans'
    ``collective_bytes``); None without them."""
    return per_step(record, lambda r: r.get("collective_bytes") if r["name"] == MARKER
                    else None)


def _measure(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, t in sorted(intervals):
        if t > end:
            total += t - max(s, end)
            end = t
    return total


def exposed_seconds(trace: dict, patterns):
    """Device seconds in which a kernel matching ``patterns`` ran and no
    other device operation (kernel, copy or memset) did; None where none
    matched."""
    mine, other = [], []
    for name, s, t in trace.get("kernels", ()):
        (mine if any(p.search(name) for p in patterns) else other).append((s, t))
    if not mine:
        return None
    return _measure(mine + other) - _measure(other)
