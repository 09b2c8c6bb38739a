"""The port's ray-sharded paths (parallel/) on two gloo ranks against the JAX
package's on a two-device mesh, and against the port in one process.

One spawn per module: the ``ranks`` fixture starts two processes that run
this file as a script (``_worker``), each a gloo rank on the CPU, and joins
them with a deadline; each writes its results to an npz that the tests read.
While they run, the fixture computes the JAX references under ``jax.jit``
(an eager ``shard_map`` of the march compiles op by op, ~60 s a call).

Shapes: ``VoxelScene.demo(16, depth 4, seed 3)``; the dryrun's 16x4 ortho
camera (64 rays) for the train steps and a 16x12 perspective camera (192
rays, sky included) for the renders and the march.  Tolerances:
* hit and material exact, t at rtol 1e-6 (tests/test_torch_march.py), rgb
  at rtol 1e-5 / atol 1e-5 (tests/test_torch_render.py);
* the blocking step against JAX's ``make_sharded_train_step(overlap=False)``
  on the two-device mesh: loss and params at rtol 1e-3, the fit tolerance
  (Adam's epsilon placement and the order of sums differ between optax and
  torch.optim).  The JAX step runs with ``grad_tiles=1`` (each tile is a
  separately compiled sampler, ~6 s apiece on the CPU); tiles regroup the
  same sum;
* the overlapped and ZeRO steps against the port's blocking step, and the
  two-rank blocking step against the same step on a one-rank group, over
  two steps: loss at rtol 1e-5, params at rtol 1e-5 / atol 1e-6 (the
  gradients are the same sums grouped per tile and per rank).
"""

import argparse
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from octree_raymarcher_tpu.models.scene import VoxelScene as JaxVoxelScene
from octree_raymarcher_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octree_raymarcher_tpu.parallel.render_sharded import make_sharded_train_step as jax_step
from octree_raymarcher_tpu.parallel.render_sharded import march_sharded as jax_march_sharded
from octree_raymarcher_tpu.parallel.render_sharded import pad_rays as jax_pad_rays
from octree_raymarcher_tpu.parallel.render_sharded import render_frame_sharded as jax_frame
from octree_raymarcher_tpu.parallel.render_sharded import render_sharded as jax_render_sharded
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu_torch import entry
from octree_raymarcher_tpu_torch.models import VoxelScene
from octree_raymarcher_tpu_torch.ops.march_compact import march_frame_compact
from octree_raymarcher_tpu_torch.parallel import (
    RayMesh,
    init_distributed,
    local_address,
    make_mesh,
    make_sharded_train_step,
    make_zero_train_step,
    march_sharded,
    march_sharded_compact,
    pad_rays,
    render_frame_sharded,
    render_sharded,
)
from octree_raymarcher_tpu_torch.shade import OrthoCamera, PerspectiveCamera, RenderConfig
from octree_raymarcher_tpu_torch.shade import render as port_render

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
EYE = (8.0, 12.0, -4.0)
TILE = 40          # groups of 80 rays: the 192-ray frame pads to 240, three groups
K = 4              # the dryrun's max_segments
LR = 1e-2
STEPS = 2
DEADLINE_S = 240


def _frame_rays():
    cam = PerspectiveCamera(position=EYE, pitch_deg=-35.0, fov_deg=70.0, width=16, height=12)
    return cam.rays()


def _train_rays():
    cam = OrthoCamera(position=(8.0, 24.0, 8.0), direction=(0, -1, 0), up=(0, 0, 1),
                      width=15.0, height=15.0, xres=16, yres=RANKS * 2)
    o, d = cam.rays()
    target = np.random.default_rng(0).uniform(size=(o.shape[0], 3)).astype(np.float32)
    return o, d, target


def _leaves(p):
    return {"density_raw": p.density_raw.detach().numpy(),
            "albedo_raw": p.albedo_raw.detach().numpy()}


def _run_steps(step, params, state, world, o, d, target, tag, out):
    for i in range(STEPS):
        params, state, loss = step(params, state, world, o, d, target)
        out[f"{tag}_loss{i}"] = np.float32(loss)
        for k, v in _leaves(params).items():
            out[f"{tag}_{k}{i}"] = v
    return state


def _worker(rank: int, addr: str, out_dir: str) -> None:
    """One gloo rank: every sharded path once, results to rank<r>.npz."""
    torch.set_num_threads(1)
    init_distributed(addr, RANKS, rank, device="cpu")
    try:
        mesh = make_mesh("cpu")
        scene = VoxelScene.demo(16.0, 4, 3, device="cpu")
        before = _leaves(scene.params)
        out = {}
        fo, fd = _frame_rays()
        out["render"] = render_sharded(mesh, scene.world, fo, fd, EYE).numpy()
        out["render_ray"] = render_sharded(mesh, scene.world, fo, fd, EYE,
                                           cfg=RenderConfig(shadow="ray")).numpy()
        out["frame"] = render_frame_sharded(mesh, scene.world, fo, fd, EYE, tile=TILE).numpy()
        hit, t, mat = march_sharded(mesh, scene.world, fo, fd)
        out.update(hit=hit.numpy(), t=t.numpy(), material=mat.numpy())
        chit, ct, cmat, executed = march_sharded_compact(mesh, scene.world, fo, fd)
        out.update(compact_hit=chit.numpy(), compact_t=ct.numpy(), compact_material=cmat.numpy(),
                   compact_executed=executed.numpy())
        # each rank's entry is the lane count of its own block's compacted march
        block = mesh.ray_block(fo.shape[0])
        _, own = march_frame_compact(scene.world, fo[block], fd[block], 512, device="cpu")
        out["compact_executed_is_own"] = np.bool_(int(executed[rank]) == int(own))

        o, d, target = _train_rays()
        opt = functools.partial(torch.optim.Adam, lr=LR)
        calls = []
        all_reduce = dist.all_reduce

        def recording_all_reduce(tensor, *args, async_op=False, **kwargs):
            calls.append(bool(async_op))
            return all_reduce(tensor, *args, async_op=async_op, **kwargs)

        for tag, overlap in (("blocking", False), ("overlap", True)):
            calls.clear()
            dist.all_reduce = recording_all_reduce
            try:
                step = make_sharded_train_step(mesh, scene.world, opt, max_segments=K,
                                               overlap=overlap, grad_tiles=2)
                _run_steps(step, scene.params, None, scene.world, o, d, target, tag, out)
            finally:
                dist.all_reduce = all_reduce
            out[f"{tag}_async_calls"] = np.int32(sum(calls))
            out[f"{tag}_sync_calls"] = np.int32(len(calls) - sum(calls))
        init_zero, zstep = make_zero_train_step(mesh, scene.world, opt, max_segments=K,
                                                grad_tiles=2)
        zstate = _run_steps(zstep, scene.params, init_zero(scene.params), scene.world, o, d,
                            target, "zero", out)
        out["zero_state_rows"] = np.int32(zstate.param_groups[0]["params"][0].shape[0])

        # the same blocking step on a one-rank group: the one-process result
        sub = dist.new_group([0])
        if rank == 0:
            step = make_sharded_train_step(make_mesh("cpu", group=sub), scene.world, opt,
                                           max_segments=K, grad_tiles=2)
            _run_steps(step, scene.params, None, scene.world, o, d, target, "single", out)

        dry = entry.dryrun_multichip(RANKS, device="cpu")
        out["dryrun_rgb"] = dry["rgb"].numpy()
        out["dryrun_losses"] = np.float32([dry["losses"][k]
                                           for k in ("blocking", "overlap", "zero")])
        out["dryrun_executed"] = dry["executed"].numpy()
        out["params_unchanged"] = np.bool_(all(
            np.array_equal(v, before[k]) for k, v in _leaves(scene.params).items()))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, compute the JAX references meanwhile, join the
    ranks with a deadline; returns ([rank0, rank1] results, references)."""
    out_dir = tmp_path_factory.mktemp("ranks")
    addr = local_address()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--addr", addr,
                               "--out", str(out_dir)], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(RANKS)]
    try:
        refs = _jax_references()
        deadline = time.monotonic() + DEADLINE_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = "\n".join((out_dir / f"rank{r}.log").read_text() for r in range(RANKS))
    assert all(p.returncode == 0 for p in procs), text[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(RANKS)], refs


def _jax_references() -> dict:
    mesh = jax_make_mesh(jax.devices()[:RANKS])
    scene = JaxVoxelScene.demo(chunk_size=16.0, depth=4, seed=3)
    fo, fd = (jnp.asarray(a) for a in _frame_rays())
    refs = {
        "render": jax.jit(lambda w, a, b: jax_render_sharded(mesh, w, a, b, EYE))(
            scene.world, fo, fd),
        "render_ray": jax.jit(lambda w, a, b: jax_render_sharded(
            mesh, w, a, b, EYE, cfg=JaxRenderConfig(shadow="ray")))(scene.world, fo, fd),
        "frame": jax.jit(lambda w, a, b: jax_frame(mesh, w, a, b, EYE, tile=TILE))(
            scene.world, fo, fd),
    }
    refs["hit"], refs["t"], refs["material"] = jax.jit(
        lambda w, a, b: jax_march_sharded(mesh, w, a, b))(scene.world, fo, fd)
    o, d, target = _train_rays()
    opt = optax.adam(LR)
    step = jax_step(mesh, scene.world, opt, max_segments=K, overlap=False, grad_tiles=1)
    p, _, loss = step(scene.params, opt.init(scene.params), scene.world, jnp.asarray(o),
                      jnp.asarray(d), jnp.asarray(target))
    refs.update(blocking_loss0=loss, blocking_density_raw0=p.density_raw,
                blocking_albedo_raw0=p.albedo_raw)
    return {k: np.asarray(v) for k, v in refs.items()}


# ---- pure helpers (no process group) ---------------------------------------------

@pytest.mark.parametrize("n", [63, 64, 1])
def test_pad_rays_matches_reference(n):
    o, d = _frame_rays()
    o, d = o[:n], d[:n]
    got = pad_rays(o, d, 4)
    ref = jax_pad_rays(o, d, 4)
    assert got[2] == ref[2] == n
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_ray_block_partitions_the_batch():
    blocks = [RayMesh(None, r, 4, torch.device("cpu")).ray_block(64) for r in range(4)]
    assert [(b.start, b.stop) for b in blocks] == [(0, 16), (16, 32), (32, 48), (48, 64)]
    with pytest.raises(ValueError, match="pad_rays"):
        RayMesh(None, 0, 4, torch.device("cpu")).ray_block(63)


def test_make_mesh_needs_a_group(monkeypatch):
    if dist.is_initialized():
        pytest.fail("a process group leaked into the test process")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed(local_address(), 1, 0)
    assert not dist.is_initialized()


# ---- the two ranks ------------------------------------------------------------------

def test_ranks_return_the_same_global_arrays(ranks):
    (r0, r1), _ = ranks
    assert {k for k in r0 if not k.startswith("single_")} == set(r1)
    for k, v in r1.items():
        np.testing.assert_array_equal(r0[k], v, err_msg=k)
    assert r0["render"].shape == (192, 3) and r0["hit"].shape == (192,)


@pytest.mark.parametrize("key", ["render", "render_ray", "frame"])
def test_render_sharded_matches_reference(ranks, key):
    (r0, _), refs = ranks
    assert r0[key].shape == refs[key].shape == (192, 3)
    np.testing.assert_allclose(r0[key], refs[key], rtol=1e-5, atol=1e-5)


def test_render_sharded_equals_one_process_render(ranks):
    """The same kernels on the same rays: the gathered blocks equal the
    port's render of the whole batch, bit for bit, and the host-tiled frame
    equals the sharded render."""
    (r0, _), _ = ranks
    scene = VoxelScene.demo(16.0, 4, 3, device="cpu")
    fo, fd = _frame_rays()
    for key, cfg in (("render", RenderConfig()), ("render_ray", RenderConfig(shadow="ray"))):
        want = port_render(scene.world, fo, fd, EYE, cfg=cfg, device="cpu")["rgb"].numpy()
        np.testing.assert_array_equal(r0[key], want, err_msg=key)
    np.testing.assert_array_equal(r0["frame"], r0["render"])
    assert (r0["render_ray"] <= r0["render"] + 1e-6).all()


def test_march_sharded_matches_reference(ranks):
    (r0, _), refs = ranks
    np.testing.assert_array_equal(r0["hit"], refs["hit"])
    np.testing.assert_array_equal(r0["material"], refs["material"])
    hit = r0["hit"]
    assert 0 < hit.sum() < hit.size
    np.testing.assert_allclose(r0["t"][hit], refs["t"][hit], rtol=1e-6)
    assert np.isinf(r0["t"][~hit]).all()


def test_march_sharded_compact_equals_march_sharded(ranks):
    """Each rank compacts its own block: the same rays as march_sharded, bit
    for bit, and one lane count a rank, gathered with the rows."""
    (r0, r1), _ = ranks
    for r in (r0, r1):
        for k in ("hit", "t", "material"):
            np.testing.assert_array_equal(r[f"compact_{k}"], r0[k], err_msg=k)
        assert r["compact_executed"].dtype == np.int64
        assert r["compact_executed"].shape == (RANKS,) and (r["compact_executed"] > 0).all()
        assert bool(r["compact_executed_is_own"])


def test_blocking_step_matches_reference(ranks):
    (r0, _), refs = ranks
    np.testing.assert_allclose(r0["blocking_loss0"], refs["blocking_loss0"], rtol=1e-3)
    scene = VoxelScene.demo(16.0, 4, 3, device="cpu")
    for k, p0 in _leaves(scene.params).items():
        have, want = r0[f"blocking_{k}0"], refs[f"blocking_{k}0"]
        np.testing.assert_allclose(have, want, rtol=1e-3, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(have - p0, want - p0, atol=1e-3 * LR, err_msg=k)
    # the step moved the albedo (the opaque voxels' density saturates)
    assert np.abs(r0["blocking_albedo_raw0"] - scene.params.albedo_raw.numpy()).max() > 0.5 * LR


@pytest.mark.parametrize("mode", ["overlap", "zero", "single"])
def test_step_modes_agree(ranks, mode):
    """Overlap and ZeRO against the blocking step on two ranks, and the
    two-rank blocking step against the one-rank one, over two steps."""
    (r0, _), _ = ranks
    for i in range(STEPS):
        np.testing.assert_allclose(r0[f"{mode}_loss{i}"], r0[f"blocking_loss{i}"], rtol=1e-5)
        for k in ("density_raw", "albedo_raw"):
            np.testing.assert_allclose(r0[f"{mode}_{k}{i}"], r0[f"blocking_{k}{i}"],
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k} step {i}")
    assert r0["blocking_loss1"] < r0["blocking_loss0"]


def test_overlap_all_reduces_each_tile_asynchronously(ranks):
    """Per step: overlap issues one async all_reduce per gradient per tile
    (2 tiles x 2 gradients) and one blocking one for the loss; the blocking
    mode one blocking all_reduce per gradient and one for the loss."""
    (r0, _), _ = ranks
    assert (int(r0["overlap_async_calls"]), int(r0["overlap_sync_calls"])) == (4 * STEPS, STEPS)
    assert (int(r0["blocking_async_calls"]), int(r0["blocking_sync_calls"])) == (0, 3 * STEPS)


def test_zero_state_holds_a_slice_and_params_stay_unchanged(ranks):
    (r0, _), _ = ranks
    p = VoxelScene.demo(16.0, 4, 3, device="cpu").params.num_slots
    assert int(r0["zero_state_rows"]) == (p + RANKS - 1) // RANKS
    assert bool(r0["params_unchanged"])


def test_dryrun_multichip_two_ranks(ranks):
    (r0, _), _ = ranks
    assert r0["dryrun_rgb"].shape == (RANKS * 2 * 16, 3)
    assert np.isfinite(r0["dryrun_rgb"]).all() and np.isfinite(r0["dryrun_losses"]).all()
    np.testing.assert_allclose(r0["dryrun_losses"], r0["dryrun_losses"][0], rtol=1e-5)
    assert r0["dryrun_executed"].shape == (RANKS,) and (r0["dryrun_executed"] > 0).all()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _worker(a.rank, a.addr, a.out)
