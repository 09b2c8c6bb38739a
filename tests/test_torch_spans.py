"""The port's spans (utils/metrics.py ``span``) on the CPU: off, one shared
object that does nothing; under ``torch.profiler``, ``record_function``
ranges in the trace and records in the span log with their parents by
thread, the log bounded; and the frame's, the fit step's and the sharded
fit step's spans where they belong, the last with the bytes it hands to
collectives."""

import functools
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from octree_raymarcher_tpu_torch.diff.composite import VoxelParams, init_params_from_world
from octree_raymarcher_tpu_torch.diff.optim import photometric_loss, sample_views
from octree_raymarcher_tpu_torch.parallel import (
    init_distributed,
    local_address,
    make_mesh,
    make_sharded_train_step,
)
from octree_raymarcher_tpu_torch.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu_torch.shade.render import RenderConfig, render_frame
from octree_raymarcher_tpu_torch.utils import metrics
from octree_raymarcher_tpu_torch.utils.metrics import clear_spans, span, span_records
from octree_raymarcher_tpu_torch.world.world import World

SCENE = dict(dims=(2, 1, 2), chunksize=32.0, depth=5, seed=7, water_level=4.0,
             amplitude=16.0)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_log():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture(scope="module")
def scene():
    world = World.generate(**SCENE).to_torch("cpu")
    cam = PerspectiveCamera(position=(32.0, 30.0, -20.0), yaw_deg=0.0, pitch_deg=-20.0,
                            fov_deg=70.0, width=16, height=12)
    o, d = cam.rays()
    return world, o, d, np.asarray(cam.position, dtype=np.float32)


def _names_by_id(records):
    return {r["id"]: r["name"] for r in records}


def test_off_span_is_one_shared_object_that_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = span("a"), span("b")
    assert first is second
    with span("a"):
        with span("b"):
            pass
    assert span_records() == []
    with _profiled():            # the same patch, on: the span reaches record_function
        with pytest.raises(AssertionError, match="record_function"):
            with span("a"):
                pass


def test_on_spans_nest_and_land_in_the_trace(tmp_path):
    with _profiled() as prof:
        with span("outer"):
            with span("inner"):
                with span("leaf"):
                    pass
            with span("inner"):
                pass
    recs = span_records()
    assert [r["name"] for r in recs] == ["leaf", "inner", "inner", "outer"]   # by exit
    names = _names_by_id(recs)
    assert [names.get(r["parent"]) for r in recs] == ["inner", "outer", "outer", None]
    assert len({r["id"] for r in recs}) == 4
    for r in recs:
        assert r["end_ns"] >= r["start_ns"] and r["launches"] == 0 and r["drains"] == 0
        assert r["cuda"] is False and r["thread"] == threading.get_ident()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    cats = {(e["name"], e.get("cat")) for e in events if e.get("name") in names.values()}
    assert cats == {(n, "user_annotation") for n in ("outer", "inner", "leaf")}


def test_each_thread_keeps_its_own_stack():
    threads, rounds = 8, 40
    barrier = threading.Barrier(threads)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            def work():
                barrier.wait(timeout=30)
                for _ in range(rounds):
                    with span("outer"):
                        with span("inner"):
                            pass
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    recs = span_records()
    assert len(recs) == threads * rounds * 2
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "inner":
            parent = by_id[r["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == r["thread"]
        else:
            assert r["parent"] is None
    assert len({r["thread"] for r in recs}) == threads


def test_the_log_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(metrics, "_LOG", metrics._SpanLog(8))
    with _profiled():
        for i in range(20):
            with span(f"s{i}"):
                pass
    assert [r["name"] for r in span_records()] == [f"s{i}" for i in range(12, 20)]
    clear_spans()
    assert span_records() == []


@pytest.mark.parametrize("shadow,compact", [("map", False), ("map", True), ("ray", False),
                                            ("ray", True)])
def test_frame_spans(scene, shadow, compact):
    world, o, d, eye = scene
    with _profiled():
        render_frame(world, o, d, eye, cfg=RenderConfig(shadow=shadow, max_steps=64),
                     compact=compact, device="cpu")
    recs = span_records()
    (frame,) = [r for r in recs if r["name"] == "render.frame"]
    assert frame["parent"] is None
    children = sorted((r for r in recs if r["parent"] == frame["id"]), key=lambda r: r["id"])
    first = "render.light_pass" if shadow == "map" else "render.shadow_rays"
    want = ([first, "render.march", "render.shade"] if shadow == "map"
            else ["render.march", first, "render.shade"])
    assert [r["name"] for r in children] == want
    assert len(recs) == 4
    assert all(frame["start_ns"] <= r["start_ns"] <= r["end_ns"] <= frame["end_ns"]
               for r in children)


def test_fit_step_spans(scene):
    world, o, d, _ = scene
    gt = init_params_from_world(world)
    views = [(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(o.shape[0], 3))] * 2
    params = VoxelParams(gt.density_raw.clone().requires_grad_(True),
                         gt.albedo_raw.clone().requires_grad_(True))
    with _profiled():
        cached = sample_views(world, views, 8, 64, device="cpu")
        photometric_loss(params, cached).backward()
    recs = span_records()
    names = _names_by_id(recs)
    edges = sorted((r["name"], names.get(r["parent"])) for r in recs)
    assert edges == sorted([("fit.sample", None), ("fit.loss", None),
                            ("fit.composite", "fit.loss"), ("fit.composite", "fit.loss"),
                            ("fit.background", "fit.composite"),
                            ("fit.background", "fit.composite"),
                            ("fit.composite_bwd", None), ("fit.composite_bwd", None)])
    order = [r["name"] for r in sorted(recs, key=lambda r: r["id"]) if r["parent"] is None]
    assert order == ["fit.sample", "fit.loss", "fit.composite_bwd", "fit.composite_bwd"]
    assert params.density_raw.grad is not None


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test, taken down after it."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    init_distributed(local_address(), 1, 0, device="cpu")
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_step_spans(scene, one_rank):
    """One overlapped step of four tiles: its ``fit.shard_step``, each
    tile's two gradient ``fit.allreduce`` launches and the loss's, one
    ``fit.allreduce_wait``, and 4 x 4P floats of gradient (plus the loss's
    one) handed to collectives; off, the same step records nothing and
    still counts its bytes."""
    world, o, d, _ = scene
    gt = init_params_from_world(world)
    p = gt.num_slots
    grads = 4 * 4 * p * 4
    step = make_sharded_train_step(one_rank, world, functools.partial(torch.optim.Adam, lr=0.05),
                                   max_segments=2, overlap=True, grad_tiles=4)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    target = torch.zeros(o.shape[0], 3)
    before = metrics.Collectives.total_bytes
    params, state, _ = step(gt, None, world, o, d, target)
    assert span_records() == []
    assert metrics.Collectives.total_bytes - before == grads + 4
    with _profiled():
        step(params, state, world, o, d, target)
    recs = span_records()
    (unit,) = [r for r in recs if r["name"] == "fit.shard_step"]
    assert unit["parent"] is None and unit["collective_bytes"] == grads + 4
    reduces = sorted((r for r in recs if r["name"] == "fit.allreduce"), key=lambda r: r["id"])
    assert len(reduces) == 4 * 2 + 1 and all(r["parent"] == unit["id"] for r in reduces)
    assert [r["collective_bytes"] for r in reduces] == [4 * p, 12 * p] * 4 + [4]
    (wait,) = [r for r in recs if r["name"] == "fit.allreduce_wait"]
    assert wait["parent"] == unit["id"] and wait["collective_bytes"] == 0
    assert reduces[7]["id"] < wait["id"] < reduces[8]["id"]    # the tiles', the wait, the loss's
    composites = [r for r in recs if r["name"] == "fit.composite"]
    assert len(composites) == 4 and all(r["parent"] == unit["id"] for r in composites)


@pytest.mark.cuda
def test_an_idle_stream_drains_at_every_boundary():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the drain count queries a CUDA stream)")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with _profiled():
        for _ in range(50):
            with span("outer"):
                with span("inner"):
                    pass
        torch.cuda._sleep(100_000_000)          # tens of ms of work on the stream
        with span("busy"):
            pass
        torch.cuda.synchronize()
    recs = span_records()
    idle = [r for r in recs if r["name"] != "busy"]
    assert len(idle) == 100 and all(r["cuda"] for r in recs)
    assert sum(r["drains"] for r in idle) == 200
    (busy,) = [r for r in recs if r["name"] == "busy"]
    assert busy["drains"] == 0
