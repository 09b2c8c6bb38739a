"""Observability: rolling frame timers, structured metrics logging, and
spans on the profiler's clock.

Capability parity with the reference's instrumentation — the 32-sample ring
`Counter` with avg/std/min/max (src/Util.h:8-23, src/Util.cpp:17-70), the
labeled SW_START/SW_STOP stopwatches (src/Debug.h:6-12) and the HUD/console
reports of frame time, pool occupancy and octree memory (src/Main.cpp:264-311,
src/Debug.cpp:131-176) — re-expressed as host-side utilities: a JSONL
metrics logger instead of an on-screen HUD, and, for the stopwatches,
:func:`span`, which names a layer's interval inside a ``torch.profiler``
trace (so it sits on one timeline with the kernels it launches) and keeps
a record of it in memory (:func:`span_records`).  Spans cost one read of
the profiler's flag when no profiler is active.  :class:`Collectives`
counts the bytes that ``parallel/`` hands to collectives, which each span
records beside its kernel launches.  ``Counter`` and
``MetricsLogger`` are copies of octree_raymarcher_tpu/utils/metrics.py's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from ..kernels import Kernel

SPAN_LOG_SIZE = 4096    # records kept; the oldest are dropped past it


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


class Collectives:
    """Bytes handed to collectives by the port's ``parallel/`` layer (each
    ``all_reduce``'s tensor, each ``reduce_scatter_tensor``'s and
    ``all_gather_into_tensor``'s input), summed over the process's life,
    whether or not a profiler runs."""

    total_bytes = 0

    @classmethod
    def add(cls, tensor: torch.Tensor) -> None:
        cls.total_bytes += tensor.numel() * tensor.element_size()


class _SpanLog:
    """The spans recorded while a profiler is active: a bounded ring of
    records (the oldest dropped past ``size``), and each thread's stack of
    open spans and its current CUDA streams (autograd runs a CUDA backward
    on a thread of its own)."""

    def __init__(self, size: int):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def stream(self):
        """The current CUDA stream, its Python object made once a thread
        (``torch.cuda.current_stream()`` builds one at every call)."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        streams = getattr(self.local, "streams", None)
        if streams is None:
            streams = self.local.streams = {}
        stream = streams.get(key)
        if stream is None:
            stream = streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def add(self, rec: dict) -> None:
        with self.lock:
            self.records.append(rec)

    def clear(self) -> None:
        with self.lock:
            self.records.clear()


_LOG = _SpanLog(SPAN_LOG_SIZE)
_OFF = contextlib.nullcontext()


class _Span:
    """An open span: a ``record_function`` range and the record that its
    exit completes and appends to the log."""

    __slots__ = ("name", "scope", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        cuda = torch.cuda.is_initialized()
        drains = int(_LOG.stream().query()) if cuda else 0
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        stack = _LOG.stack()
        rec = {"name": self.name, "id": next(_LOG.ids),
               "parent": stack[-1]["id"] if stack else None,
               "thread": threading.get_ident(), "launches": Kernel.total_launches,
               "collective_bytes": Collectives.total_bytes, "drains": drains, "cuda": cuda}
        stack.append(rec)
        self.rec = rec
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        rec["launches"] = Kernel.total_launches - rec["launches"]
        rec["collective_bytes"] = Collectives.total_bytes - rec["collective_bytes"]
        if rec["cuda"]:
            rec["drains"] += int(_LOG.stream().query())
        _LOG.stack().pop()
        _LOG.add(rec)
        self.scope.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that spans a layer's work under ``name``.

    With no profiler active in the process it is one shared object that
    does nothing.  Under ``torch.profiler`` it opens
    ``torch.profiler.record_function(name)`` and, at its exit, appends a
    record to the span log (:func:`span_records`): ``name``; ``id`` (in
    order of entry); ``parent``, the id of the span open around it on the
    same thread, or None; ``thread``; ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``); ``launches``, the kernel launches of the
    port inside it (``Kernel.total_launches``); ``collective_bytes``, the
    bytes handed to collectives inside it (:class:`Collectives`); ``cuda``,
    whether CUDA was initialised at its entry; and ``drains``, how many of
    its entry and exit found the current CUDA stream with nothing left to
    run (0 without CUDA).  A span enqueues nothing on the stream, so an
    idle stream drains at every boundary."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_records() -> list:
    """The span log's records, oldest first by exit (at most
    ``SPAN_LOG_SIZE``); nothing writes them anywhere."""
    with _LOG.lock:
        return list(_LOG.records)


def clear_spans() -> None:
    """Empty the span log."""
    _LOG.clear()


__all__ = ["Collectives", "Counter", "MetricsLogger", "SPAN_LOG_SIZE", "clear_spans", "span",
           "span_records"]
