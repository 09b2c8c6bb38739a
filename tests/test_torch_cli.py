"""The port's command line (``python -m octree_raymarcher_tpu_torch``) and its
fit run (bench_fit.py in the package), on the CPU, against the JAX package's.

* ``info``, ``render`` and ``demo`` with ``--device cpu`` on a 1x1x1 world of
  depth 3, by subprocess with a timeout, as tests/test_aux.py:106,122 drive
  the reference's; ``render``'s ``hit_frac`` equals the JAX CLI's on the
  same flags.  Without a card, ``--device cuda`` (the default) fails.
* ``fit`` with 2 steps at 16x16, 2 views: finite losses.  The reference's
  bench_fit.py at the same knobs takes over five minutes on a CPU (its
  jitted sampler and fit), so its first loss is not recomputed here;
  instead what fixes the first loss is held against the JAX package: the
  ground truth of the world packed as the reference packs it, the starting
  parameters from ``jax.random.split``/``normal`` of ``FIT_SEED``, and the
  target views' rays (the targets are the port's ``render_soft`` of them,
  which tests/test_torch_diff.py holds against the JAX ``render_soft``;
  recomputing them with JAX here would cost a minute of compiling).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.diff import init_params_from_world as jax_init_params
from octree_raymarcher_tpu.shade.camera import PerspectiveCamera as JaxCamera
from octree_raymarcher_tpu.world.world import World as JaxWorld
from octree_raymarcher_tpu_torch import bench_fit
from octree_raymarcher_tpu_torch.diff import init_params_from_world, render_soft

ROOT = Path(__file__).resolve().parent.parent
WORLD = ["--dims", "1x1x1", "--depth", "3"]


def _run(module, args, timeout=300, env=None):
    # one compute thread a subprocess: the suite runs beside it on every core
    threads = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
               "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, **threads, **(env or {})})


def _port(args, **kw):
    return _run("octree_raymarcher_tpu_torch", args, **kw)


def test_cli_info_runs():
    p = _port(["info", "--device", "cpu", *WORLD])
    assert p.returncode == 0, p.stderr[-800:]
    rep = json.loads(p.stdout)
    assert rep["chunks"] == 1 and "allocator" in rep


def test_cli_render_hit_frac_matches_jax(tmp_path):
    flags = [*WORLD, "--res", "64x36"]
    p = _port(["render", "--device", "cpu", "--out", str(tmp_path / "port.png"), *flags])
    assert p.returncode == 0, p.stderr[-800:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    q = _run("octree_raymarcher_tpu", ["render", "--platform", "cpu", "--out",
                                       str(tmp_path / "jax.png"), *flags])
    assert q.returncode == 0, q.stderr[-800:]
    ref = json.loads(q.stdout.strip().splitlines()[-1])
    assert got["hit_frac"] == ref["hit_frac"] > 0
    assert (got["res"], got["shadow"], got["device"]) == (ref["res"], ref["shadow"], "cpu")
    assert (tmp_path / "port.png").stat().st_size > 0


def test_cli_render_compact_is_accepted_and_cuda_is_required(tmp_path):
    p = _port(["render", "--device", "cpu", "--compact", "--res", "16x9", "--out",
               str(tmp_path / "c.png"), *WORLD])
    assert p.returncode == 0, p.stderr[-800:]
    if torch.cuda.is_available():
        return
    p = _port(["render", "--res", "16x9", "--out", str(tmp_path / "g.png"), *WORLD])
    assert p.returncode != 0 and "torch.cuda.is_available() is False" in p.stderr


def test_cli_demo_runs(tmp_path):
    out = tmp_path / "demo_out"
    p = _port(["demo", "--device", "cpu", *WORLD, "--frames", "1", "--res", "32x18", "--out",
               str(out)], timeout=600)
    assert p.returncode == 0, (p.stderr[-1500:], p.stdout[-500:])
    assert (out / "metrics.jsonl").exists()


def test_cli_fit_runs(tmp_path):
    out = tmp_path / "fit_out"
    p = _port(["fit", "--device", "cpu", "--steps", "2", "--res-fit", "16", "--out", str(out)],
              timeout=600, env={"FIT_VIEWS": "2"})
    assert p.returncode == 0, p.stderr[-1500:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    rec = json.loads((out / "bench_fit_result.json").read_text())
    assert line["steps"] == rec["steps"] == 2 and rec["views"] == 2
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert (out / "bench_fit_view0.png").exists() and (out / "bench_fit_target0.png").exists()


def test_fit_refuses_the_repository_root():
    with pytest.raises(ValueError, match="repository root"):
        bench_fit.main(["--device", "cpu", "--dir", str(ROOT)])


@pytest.mark.parametrize("out", ["../bench_fit_result.json", str(ROOT / "bench_fit_result.json")])
def test_fit_refuses_an_out_path(out, tmp_path):
    with pytest.raises(ValueError, match="not a path"):
        bench_fit.main(["--device", "cpu", "--dir", str(tmp_path / "fit_out"), "--out", out])


@pytest.mark.parametrize("init", ["perturb", "scratch"])
def test_fit_targets_and_start_match_jax(init):
    """The fit's ground truth, its start from FIT_SEED=0 and its 2 target
    views' rays at 16x16 against the JAX package's bench_fit.py protocol."""
    world = bench_fit.fit_world("cpu")
    gt = init_params_from_world(world, solid_density=40.0)
    _, jdev = JaxWorld.generate(dims=(2, 1, 2), chunksize=32.0, depth=6, seed=7,
                                water_level=4.0, amplitude=16.0).to_device()
    jdev = jax.tree_util.tree_map(jnp.asarray, jdev)
    jgt = jax_init_params(jdev, solid_density=40.0)
    np.testing.assert_array_equal(gt.density_raw.numpy(), np.asarray(jgt.density_raw))
    np.testing.assert_allclose(gt.albedo_raw.numpy(), np.asarray(jgt.albedo_raw),
                               rtol=1e-6, atol=1e-6)

    start = bench_fit.start_params(gt, 0, init)
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    n_alb = jax.random.normal(k0, jgt.albedo_raw.shape)
    n_den = jax.random.normal(k1, jgt.density_raw.shape)
    want_den = (jnp.float32(-3.0) + 0.1 * n_den if init == "scratch"
                else jgt.density_raw - 3.0 + 0.1 * n_den)
    # the normals agree to a few ulps (XLA's and numpy's log1p and sqrt)
    np.testing.assert_allclose(start.albedo_raw.numpy(), np.asarray(1.5 * n_alb),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(start.density_raw.numpy(), np.asarray(want_den),
                               rtol=1e-5, atol=1e-6)

    if init == "scratch":
        return
    cams = bench_fit.cameras(16, 2)
    views = bench_fit.target_views(world, gt, cams, "soft", "cpu")
    for cam, (o, d, target) in zip(cams, views):
        jcam = JaxCamera(position=cam.position, yaw_deg=cam.yaw_deg, pitch_deg=cam.pitch_deg,
                         fov_deg=cam.fov_deg, width=cam.width, height=cam.height)
        jo, jd = jcam.rays()
        np.testing.assert_array_equal(o.numpy(), jo)
        np.testing.assert_array_equal(d.numpy(), jd)
        want = render_soft(world, gt, o, d, max_segments=bench_fit.K, device="cpu")["rgb"]
        assert torch.equal(target, want)
