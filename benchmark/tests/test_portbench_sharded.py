"""The sharded fit's cell on the CPU at a size a test run holds: a tiny copy
of the benchmark (``tiny.make`` plus the tiny sharded cell, two gloo ranks,
added as new files) whose run is correct while the control and each
sharded fault fail; the port's sharded step against ``reference/sharded.py``
on seeded random parameters; and the new readers and the NCCL layer's
patterns on synthetic records.  Every process runs under a deadline.

Tolerances of the step against the reference (two gloo ranks, one 64 x 36
view each, K = 8): the loss at 1e-5 relative, float32 sums of 4,608 rays
against float64; each gradient element within 1e-5 of the leaf's largest
(the port's float32 autograd sums the hot slots' terms in another order).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.faults_sharded import FAULTS
from benchmark.metrics import _spans
from benchmark.tests import tiny

CELL = "fit.tiny_sharded"
REAL = "fit.sharded4_streamed"
RANKS = 2
DEADLINE_S = 240
SEED = 12345678901


def make_sharded(dst: Path) -> Path:
    """``tiny.make`` and the tiny sharded cell beside it: the world and
    camera of the tiny cells, four views over two gloo ranks, K = 8 (the
    rank count and K listed under ``reduced``)."""
    tiny.make(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == REAL)
    cfg = json.loads((tiny.BENCH / "configs" / f"{w['config']}.json").read_text())
    cfg["name"] = f"{w['config']}-tiny"
    cfg["world"], cfg["camera"] = dict(tiny.WORLD), {**cfg["camera"], **tiny.CAMERA}
    cfg["sharded"] = {**cfg["sharded"], "ranks": RANKS}
    cfg["fit"] = {**cfg["fit"], "K": 8}
    cfg["reduced"] = cfg["reduced"] + ["sharded.ranks", "fit.K"]
    (dst / "benchmark/configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    mix.update(views=4, warmup_steps=1, trace_steps=2, check_rows=256, deadline_s=DEADLINE_S)
    (dst / "benchmark/traffic" / f"{w['traffic']}-tiny.json").write_text(json.dumps(mix))
    cell = json.loads((tiny.BENCH / "cells" / f"{REAL}.json").read_text())
    (dst / "benchmark/cells" / f"{CELL}.json").write_text(json.dumps(cell))
    bench["workloads"].append({**w, "name": CELL, "config": cfg["name"],
                               "traffic": f"{w['traffic']}-tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(tiny.REPO), OMP_NUM_THREADS="2")


def read(dst: Path, mode: str) -> dict:
    """One seed of the tiny cell in ``mode`` (program, control or
    fault:<name>), in a fresh process."""
    out = subprocess.run([sys.executable, "-m", "benchmark.faults_sharded", "--workload", CELL,
                          "--seed", str(SEED), "--mode", mode, "--seconds", "0.5",
                          "--device", "cpu"], cwd=dst, env=_env(), capture_output=True,
                         text=True, timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_sharded(tmp_path_factory.mktemp("bench"))


def test_program_is_correct(copy):
    code = ("import sys, torch; from benchmark import harness, run; "
            f"sys.exit(run.execute(run.parse(['--workload', '{CELL}', '--seed', '{SEED}', "
            "'--seconds', '0.5', '--trace', '0']), harness.spec(), torch.device('cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=_env(), capture_output=True,
                         text=True, timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "streamed_step_ms"}
    assert line["device"]["count"] == 4        # the real cell's chips, copied


@pytest.mark.parametrize("mode", ["control"] + [f"fault:{f}" for f in FAULTS])
def test_control_and_faults_are_not_correct(copy, mode):
    line = read(copy, mode)
    assert line["checks"] and not line["correct"], line["checks"]


WATCH = ("import subprocess, sys, threading, time; from benchmark import harness; "
         "m = harness.loop('fit_sharded'); "
         "procs = [subprocess.Popen([sys.executable, '-c', c]) for c in sys.argv[2:]]; "
         "m._watch(time.time() + float(sys.argv[1]), procs, threading.Event())")


@pytest.mark.parametrize("deadline,ranks", [(60.0, ["import sys; sys.exit(7)", "import time; "
                                                    "time.sleep(60)"]),
                                            (1.0, ["import time; time.sleep(60)"])])
def test_a_failed_rank_or_the_deadline_ends_the_run(deadline, ranks):
    """Rank 0's watch: a rank that fails, or the deadline, kills every rank
    and exits at once."""
    out = subprocess.run([sys.executable, "-c", WATCH, str(deadline), *ranks], cwd=tiny.REPO,
                         env=_env(), capture_output=True, text=True, timeout=30)
    assert out.returncode == 1 and "ending every rank" in out.stderr, out.stderr[-2000:]


# ------------------------------------------- the sharded step and the reference


def _worker(rank: int, addr: str, out_dir: str) -> None:
    """One gloo rank: the port's sharded step on seeded random parameters
    and the reference's global step on the same views, to rank<r>.npz."""
    import torch
    import torch.distributed as dist

    from benchmark.reference import sharded as ref_sharded
    from benchmark.reference import world as ref_world
    from benchmark.reference.segments import sample_segments_plain
    from benchmark.traffic import orbit
    from octree_raymarcher_tpu_torch.diff.composite import SKY, VoxelParams
    from octree_raymarcher_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_sharded_train_step,
    )
    from octree_raymarcher_tpu_torch.world.world import World

    class Keep(torch.optim.Optimizer):
        """Keeps the gradients it is handed; moves nothing."""

        def __init__(self, params):
            super().__init__(params, {})

        def step(self, closure=None):
            self.grads = [p.grad.clone() for g in self.param_groups for p in g["params"]]

    torch.set_num_threads(1)
    init_distributed(addr, RANKS, rank, device="cpu")
    try:
        mesh = make_mesh("cpu")
        w, K = tiny.WORLD, 8
        world = World.generate(dims=tuple(w["dims"]), chunksize=float(w["chunksize"]),
                               depth=int(w["depth"]), seed=int(w["seed"]),
                               water_level=float(w["water_level"]),
                               amplitude=float(w["amplitude"])).to_torch("cpu")
        cam = {**json.loads((tiny.BENCH / "configs/fit-ref-default.json").read_text())["camera"],
               **tiny.CAMERA}
        order = orbit.block_order(cam["height"], cam["width"], cam["block"], "cpu")
        rays = [orbit.rays(cam, p, yaw, order, "cpu") for p, yaw in orbit.poses(cam, RANKS, 0.3)]
        o = torch.cat([r[0] for r in rays])
        d = torch.cat([r[1] for r in rays])
        g = torch.Generator().manual_seed(2024)
        target = torch.rand((o.shape[0], 3), generator=g)
        p = world.twig.numel() + 8
        density = torch.randn(p, generator=g) * 2.0
        albedo = torch.randn((p, 3), generator=g)
        step = make_sharded_train_step(mesh, world, Keep, max_segments=K, overlap=True,
                                       grad_tiles=3)
        _, opt, loss = step(VoxelParams(density, albedo), None, world, o, d, target)
        rows = mesh.ray_block(o.shape[0])
        ref = ref_world.world_on(ref_world.generate(w["dims"], w["chunksize"], w["depth"],
                                                    w["seed"], w["water_level"],
                                                    w["amplitude"]), "cpu")
        segs = sample_segments_plain(ref, o[rows], d[rows], K, 512)
        got = ref_sharded.first_steps([((segs.slot, segs.t0, segs.t1), target[rows])],
                                      density, albedo, 0.0, SKY, o.shape[0])
        sums = ref_sharded.view_sums((segs.slot, segs.t0, segs.t1), target[rows], density,
                                     albedo, SKY)
        flat = torch.cat([sums[0].reshape(1), sums[1].reshape(-1), sums[2].reshape(-1)])
        parts = [torch.empty_like(flat) for _ in range(RANKS)]
        dist.all_gather(parts, flat)
        want = ref_sharded.global_step(parts, p, o.shape[0])
        out = {"loss": float(loss), "d_density": opt.grads[0].numpy(),
               "d_albedo": opt.grads[1].numpy(), "ref_loss": want[0],
               "ref_d_density": want[1].numpy(), "ref_d_albedo": want[2].numpy()}
        if rank == 0:
            out["chain_loss"] = got[0][0]
            out["chain_g1"] = np.array(got[1])
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_sharded_step_equals_the_reference(tmp_path):
    from octree_raymarcher_tpu_torch.parallel import local_address

    addr = local_address()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--addr", addr,
                               "--out", str(tmp_path)], cwd=tiny.REPO, env=_env())
             for r in range(RANKS)]
    try:
        codes = [p.wait(timeout=DEADLINE_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * RANKS
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)]
    for r in res:
        assert abs(r["loss"] - r["ref_loss"]) <= 1e-5 * abs(r["ref_loss"])
        for leaf in ("d_density", "d_albedo"):
            ref = r[f"ref_{leaf}"]
            assert np.abs(r[leaf] - ref).max() <= 1e-5 * np.abs(ref).max(), leaf
            assert np.abs(ref).max() > 0
        np.testing.assert_array_equal(r["d_density"], res[0]["d_density"])   # replicated
    r0 = res[0]
    assert r0["chain_loss"] == r0["ref_loss"]
    np.testing.assert_allclose(r0["chain_g1"], [np.linalg.norm(r0["ref_d_density"]),
                                                np.linalg.norm(r0["ref_d_albedo"])], rtol=1e-6)


# ------------------------------------------------------------------- readers


def _log(spec, cuda: bool = True):
    """Records in order of entry from (name, parent index or None, drains,
    collective bytes)."""
    ids = itertools.count(100)
    recs = []
    for name, parent, drains, nbytes in spec:
        recs.append({"name": name, "id": next(ids),
                     "parent": None if parent is None else recs[parent]["id"], "thread": 1,
                     "launches": 1, "drains": drains, "collective_bytes": nbytes, "cuda": cuda,
                     "start_ns": 0, "end_ns": 1000})
    return recs[::-1]


def _shard_steps(n: int, tiles: int = 4, p: int = 10, drains: int = 0):
    spec = []
    for _ in range(n):
        at = len(spec)
        spec.append(("fit.shard_step", None, drains, tiles * 16 * p + 4))
        for _ in range(tiles):
            c = len(spec)
            spec += [("fit.composite", at, 0, 0), ("fit.background", c, drains, 0),
                     ("fit.allreduce", at, 0, 4 * p), ("fit.allreduce", at, 0, 12 * p)]
            spec.append(("fit.composite_bwd", None, 0, 0))
        spec += [("fit.allreduce_wait", at, 0, 0), ("fit.allreduce", at, 0, 4)]
    return spec


def _read(metric: str, record: dict, monkeypatch, log=None, work=None):
    if log is not None:
        monkeypatch.setattr(_spans, "log", lambda: log)
    return harness.metric(metric).read(record, work or {})


def test_step_spans_are_counted_from_the_end(monkeypatch):
    log = _log([("fit.allreduce", None, 1, 8)] + _shard_steps(3, drains=1))
    rec = {"trace_steps": 2}
    assert _read("allreduce_mb.sharded4", rec, monkeypatch, log) == pytest.approx(644e-6)
    # the step's own record (1) and each tile's background's (4)
    assert _read("drains.sharded4", rec, monkeypatch, log) == 5
    assert _read("drains.sharded4", {"trace_steps": 4}, monkeypatch, log) is None
    assert _read("allreduce_mb.sharded4", rec, monkeypatch, _log(_shard_steps(2), cuda=False)) \
        is None
    assert _read("allreduce_mb.sharded4", rec, monkeypatch, []) is None    # a port without spans
    # the one-card fit's reader finds no step of its own in the sharded log
    assert _read("drains.streamed", rec, monkeypatch, log) is None


def _trace(kernels, window_s=10e-3):
    return {"window_s": window_s, "busy_s": 0.0, "kernels": kernels}


NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
NCCL_OLD = "ncclKernel_AllReduce_RING_LL_Sum_float(ncclDevComm*, unsigned long, ncclWork*)"
K4 = "ort::(anonymous namespace)::segments_kernel(ort::(anonymous namespace)::SegArgs)"
K6 = "void ort::(anonymous namespace)::composite_bwd_kernel<true>(CompositeArgs)"


def test_nccl_patterns_match_nccl_kernels_alone():
    pats = harness.layer_patterns("allreduce")
    for name in (NCCL, NCCL_OLD):
        assert any(p.search(name) for p in pats), name
    for name in (K4, K6, "Memcpy DtoD (Device -> Device)",
                 "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"):
        assert not any(p.search(name) for p in pats), name


def test_exposed_counts_nccl_time_outside_other_kernels(monkeypatch):
    ms = 1e-3
    kernels = [(K4, 0.0, 2 * ms), (NCCL, 1 * ms, 4 * ms),          # 2 ms exposed (2..4)
               (K6, 3 * ms, 3.5 * ms),                              # hides 0.5 of them
               (NCCL_OLD, 6 * ms, 7 * ms), (K4, 5 * ms, 8 * ms),    # hidden whole
               (NCCL, 9 * ms, 9.25 * ms)]                           # 0.25 exposed
    rec = {"trace": _trace(kernels), "trace_steps": 2}
    assert _read("allreduce_exposed_ms.sharded4", rec, monkeypatch) == pytest.approx(1.75 / 2)
    assert _read("allreduce_ms.sharded4", rec, monkeypatch) == pytest.approx(4.25 / 2)
    rec = {"trace": _trace([(K4, 0.0, 1 * ms)]), "trace_steps": 2}
    assert _read("allreduce_exposed_ms.sharded4", rec, monkeypatch) is None
    assert _read("allreduce_exposed_ms.sharded4", {}, monkeypatch) is None


def test_roofline_stays_under_100_at_the_stated_peak(monkeypatch):
    work = json.loads((tiny.BENCH / "cells" / f"{REAL}.json").read_text())
    peak, size = work["link_bytes_per_s"], work["allreduce_bytes_per_step"]
    ring_ms = 1.5 * size / peak * 1e3
    p = (size - 4) // 64
    log = _log(_shard_steps(2, p=p))
    for factor in (1.0, 1.3, 4.0):     # the NCCL kernels at the bound, and slower
        rec = {"trace": _trace([(NCCL, 0.0, 2 * factor * ring_ms * 1e-3)], 1.0),
               "trace_steps": 2, "ranks": 4}
        share = _read("allreduce_roofline.sharded4", rec, monkeypatch, log, work)
        assert share == pytest.approx(100.0 / factor, rel=1e-9) and share <= 100.0
    rec = {"trace": _trace([(NCCL, 0.0, 1e-3)], 1.0), "trace_steps": 2, "ranks": 1}
    assert _read("allreduce_roofline.sharded4", rec, monkeypatch, log, work) is None
    assert _read("allreduce_roofline.sharded4", {**rec, "ranks": 4}, monkeypatch, [], work) is None


def test_the_cell_and_its_metrics_are_declared():
    bench = harness.spec()
    cell = harness.workload(REAL, bench)
    assert cell["chips"] == 4 and harness.traffic(cell["traffic"])["loop"] == "fit_sharded"
    cfg = harness.config(cell["config"])
    assert cfg["sharded"]["ranks"] == 4 and cfg["reduced"] == ["hosts"]
    mine = [m for m in bench["per_layer"] if REAL in m.get("workloads", ())]
    assert {m["name"] for m in mine} == {
        f"{q}.sharded4" for q in ("allreduce_ms", "allreduce_roofline", "allreduce_exposed_ms",
                                  "allreduce_mb", "drains", "segments_ms", "composite_ms",
                                  "step_host_ms", "idle_share")}
    assert all(m["moves"] == "streamed_step_ms" for m in mine)
    work = harness.cell(REAL)
    P = 6_693_512
    assert work["allreduce_bytes_per_step"] == 4 * 4 * P * 4 + 4


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _worker(a.rank, a.addr, a.out)
