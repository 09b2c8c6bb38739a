"""The readers of the port's span log (drains, composite_host_ms,
launches) on synthetic logs: units counted from the log's end, a step's
spans grouped around its ``fit.loss``, and no number without a log or
without CUDA; light_pass_ms on a synthetic trace.  On the card: a profiled
64 x 64 map frame puts the light bundle's K1 launch inside
``render.light_pass`` in the exported trace, ``light_pass_ms`` reads that
kernel, and ``launches`` reads the frame's three kernels."""

from __future__ import annotations

import itertools
import json

import pytest

from benchmark import harness
from benchmark import trace as tr
from benchmark.metrics import _spans
from benchmark.tests import tiny


def _log(spec, cuda: bool = True):
    """Records in order of entry from (name, parent index or None, ms,
    launches, drains); each span's host interval is ``ms``."""
    ids = itertools.count(100)
    recs = []
    for name, parent, ms, launches, drains in spec:
        rid = next(ids)
        recs.append({"name": name, "id": rid,
                     "parent": None if parent is None else recs[parent]["id"],
                     "thread": 1, "launches": launches, "drains": drains,
                     "cuda": cuda,
                     "start_ns": 0, "end_ns": int(ms * 1e6)})
    return recs[::-1]          # the log is in order of exit


def _frames(lights, drains=0, launches=3):
    spec = []
    for ms in lights:
        at = len(spec)
        spec += [("render.frame", None, 1.0, launches, drains),
                 ("render.light_pass", at, ms, 1, 0),
                 ("render.march", at, 0.7, 1, 0),
                 ("render.shade", at, 0.1, 1, drains)]
    return spec


def _steps(views, n, composite_ms=2.0, sample=True, drains=1):
    spec = []
    for _ in range(n):
        if sample:
            spec.append(("fit.sample", None, 4.0, 1, 0))
        at = len(spec)
        spec.append(("fit.loss", None, 3.0, views, 0))      # its composites' K5s
        for _ in range(views):
            c = len(spec)
            spec += [("fit.composite", at, composite_ms, 1, 0),
                     ("fit.background", c, 0.5, 0, drains)]
        spec += [("fit.composite_bwd", None, 2.0, 1, 0)] * views
    return spec


def _read(metric: str, record: dict, log, monkeypatch):
    monkeypatch.setattr(_spans, "log", lambda: log)
    return harness.metric(metric).read(record, {})


def test_frames_are_counted_from_the_end(monkeypatch):
    log = _log(_frames([9.0, 9.0, 0.2, 0.4], launches=5)[:8] + _frames([0.2, 0.4]))
    rec = {"trace_frames": 2}
    assert _read("launches.viewer", rec, log, monkeypatch) == 3
    assert _read("drains.viewer", rec, log, monkeypatch) == 0
    log = _log(_frames([0.2, 0.2], drains=1))
    assert _read("drains.viewer", rec, log, monkeypatch) == 2      # every span's boundaries


def test_light_pass_reads_the_light_kernel_from_the_trace():
    light = "void ort::(anonymous namespace)::march_kernel<false, true>(MarchArgs)"
    camera = "void ort::(anonymous namespace)::march_kernel<false, false>(MarchArgs)"
    trace = {"kernels": [(light, 0.0, 0.2e-3), (camera, 0.2e-3, 1.0e-3),
                         (light, 1.1e-3, 1.5e-3), (camera, 1.5e-3, 2.3e-3)]}
    read = harness.metric("light_pass_ms.viewer").read
    assert read({"trace": trace, "trace_frames": 2}, {}) == pytest.approx(0.3)
    assert read({"trace": trace}, {}) is None
    assert read({"trace_frames": 2}, {}) is None
    assert read({"trace": {"kernels": trace["kernels"][1::2]}, "trace_frames": 2}, {}) is None


def test_a_step_takes_its_sample_before_and_its_backward_after(monkeypatch):
    lead = _steps(1, 2, composite_ms=50.0, drains=5)
    log = _log(lead + _steps(1, 3))
    rec = {"trace_steps": 3}
    assert _read("launches.streamed", rec, log, monkeypatch) == 3      # K4, K5, K6
    assert _read("drains.streamed", rec, log, monkeypatch) == 1
    assert _read("composite_host_ms.streamed", rec, log, monkeypatch) == pytest.approx(2.0)
    log = _log(_steps(8, 10, sample=False))
    rec = {"trace_steps": 8}
    assert _read("launches.cached", rec, log, monkeypatch) == 16
    assert _read("drains.cached", rec, log, monkeypatch) == 8
    assert _read("composite_host_ms.cached", rec, log, monkeypatch) == pytest.approx(16.0)


def test_grouping_by_entry_order(monkeypatch):
    monkeypatch.setattr(_spans, "log", lambda: _log(_steps(2, 2)))
    assert [[r["name"] for r in g] for g in _spans.units({"trace_steps": 2})] == [
        ["fit.sample", "fit.loss", "fit.composite", "fit.background", "fit.composite",
         "fit.background", "fit.composite_bwd", "fit.composite_bwd"]] * 2


@pytest.mark.parametrize("metric", ["composite_host_ms.streamed", "drains.viewer", "launches.viewer",
                                    "drains.cached", "composite_host_ms.cached",
                                    "launches.cached"])
def test_no_number_without_a_log_or_cuda(monkeypatch, metric):
    viewer = metric.endswith("viewer")
    rec = {"trace_frames": 2} if viewer else {"trace_steps": 2}
    spec = _frames([0.2, 0.2]) if viewer else _steps(8, 2, sample=False)
    assert _read(metric, rec, [], monkeypatch) is None
    assert _read(metric, rec, _log(spec, cuda=False), monkeypatch) is None    # off the card
    assert _read(metric, rec, _log(spec[:len(spec) // 2]), monkeypatch) is None  # too few units
    assert _read(metric, {}, _log(spec), monkeypatch) is None             # no traced window
    assert _read(metric, rec, _log(spec), monkeypatch) is not None


def test_a_port_without_spans_gives_no_log(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_spans(name, *args, **kw):
        if name == "octree_raymarcher_tpu_torch.utils.metrics":
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert _spans.log() == []
    assert harness.metric("launches.viewer").read({"trace_frames": 1}, {}) is None


@pytest.mark.cuda
def test_light_pass_launch_lies_inside_its_span_on_the_card(tmp_path):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    from octree_raymarcher_tpu_torch.shade import (
        LightRig,
        MaterialTable,
        RenderConfig,
        render_frame,
    )
    from octree_raymarcher_tpu_torch.shade.camera import PerspectiveCamera
    from octree_raymarcher_tpu_torch.utils.metrics import clear_spans
    from octree_raymarcher_tpu_torch.world.world import World

    w = tiny.WORLD
    world = World.generate(dims=tuple(w["dims"]), chunksize=float(w["chunksize"]),
                           depth=w["depth"], seed=w["seed"], water_level=float(w["water_level"]),
                           amplitude=float(w["amplitude"])).to_torch(device="cuda")
    cam = PerspectiveCamera(position=(32.0, 20.0, -20.0), pitch_deg=-20.0, fov_deg=70.0,
                            width=64, height=64)
    o, d = (torch.from_numpy(a).cuda() for a in cam.rays())
    eye = np.asarray(cam.position, dtype=np.float32)
    cfg = RenderConfig(shadow="map", max_steps=512)

    def frame():
        return render_frame(world, o, d, eye, LightRig.default(), MaterialTable.default(), cfg,
                            device="cuda")

    frame()                      # builds the kernels
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            frame()
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    rec = {"trace_frames": 1, "trace": tr.reduce(events)}
    assert harness.metric("launches.viewer").read(rec, {}) == 3
    assert harness.metric("drains.viewer").read(rec, {}) is not None
    (light,) = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "render.light_pass"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "march_kernel<false, true>" in e.get("name", "")]
    assert len(kernels) == 1
    # the reader takes the kernel's interval as the difference of two absolute
    # timestamps (µs since the epoch's order of 1e12), so to about a nanosecond
    assert harness.metric("light_pass_ms.viewer").read(rec, {}) == pytest.approx(
        float(kernels[0]["dur"]) * 1e-3, abs=1e-5)
    corr = kernels[0]["args"]["correlation"]
    (launch,) = [e for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("args", {}).get("correlation") == corr]
    t0, t1 = float(light["ts"]), float(light["ts"]) + float(light["dur"])
    assert t0 <= float(launch["ts"]) and float(launch["ts"]) + float(launch["dur"]) <= t1
    clear_spans()
