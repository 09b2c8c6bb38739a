"""The orbit's poses and its rays in 128-pixel screen-block order follow
bench.py:108-122's camera and order, rebuilt in torch."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import harness
from benchmark.traffic import orbit
from octree_raymarcher_tpu_torch.shade.camera import PerspectiveCamera
from octree_raymarcher_tpu_torch.shade.tiling import block_permutation

CAM = harness.config("viewer-ref-default")["camera"]


def test_phase_zero_pose_is_the_bench_pose():
    (pos, yaw), *_ = orbit.poses(CAM, 64, 0.0)
    assert np.allclose(pos, (256.0, 90.0, -80.0), atol=1e-9) and abs(yaw) < 1e-9


def test_poses_are_even_on_the_circle_and_face_the_centre():
    turn = orbit.phase(2**33 + 5)
    ps = orbit.poses(CAM, 64, turn)
    for i, ((x, y, z), yaw) in enumerate(ps):
        assert math.isclose(math.hypot(x - 256, z - 256), 336.0, rel_tol=1e-12) and y == 90
        a = math.atan2(x - 256, z - 256) - math.atan2(0.0, -336.0)
        assert math.isclose(math.remainder(a - turn - 2 * math.pi * i / 64, 2 * math.pi), 0.0,
                            abs_tol=1e-9)
        fx, fz = math.sin(math.radians(yaw)), math.cos(math.radians(yaw))
        assert math.isclose(fx * (256 - x) + fz * (256 - z), 336.0, rel_tol=1e-9)


def test_phase_depends_on_the_seed_and_repeats():
    assert orbit.phase(5) == orbit.phase(5) != orbit.phase(6)
    assert 0.0 <= orbit.phase(2**40 + 3) < 2 * math.pi


def test_rotated_keeps_the_poses_and_starts_by_the_seed():
    ps = orbit.poses(CAM, 64, 0.0)
    starts = set()
    for seed in (5, 6, 7, 2**33 + 5, 3100000101):
        r = orbit.rotated(ps, seed)
        assert r == orbit.rotated(ps, seed)
        start = ps.index(r[0])
        assert r == ps[start:] + ps[:start]
        starts.add(start)
    assert len(starts) > 1


def test_rays_and_block_order_equal_the_bench_pattern():
    order = orbit.block_order(1080, 1920, 128, "cpu")
    perm, _ = block_permutation(1080, 1920, 128)
    assert np.array_equal(order.numpy(), perm)
    for pos, yaw in orbit.poses(CAM, 64, 0.3)[::21]:
        o, d = orbit.rays(CAM, pos, yaw, order, "cpu")
        cam = PerspectiveCamera(position=pos, yaw_deg=yaw, pitch_deg=-12.0, fov_deg=80.0,
                                width=1920, height=1080)
        O, D = cam.rays()
        assert o.is_contiguous() and d.is_contiguous()
        assert np.array_equal(o.numpy(), O[perm])
        # one float32 rounding apart, from the order of the norm's sum
        assert np.abs(d.numpy() - D[perm]).max() <= 2.5e-7
        assert o.dtype == d.dtype == torch.float32
