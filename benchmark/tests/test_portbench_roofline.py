"""The benchmark's roofline arithmetic is chip_smoke.py's."""

from __future__ import annotations

import pytest

import chip_smoke
from benchmark import roofline


def test_peaks_and_counts_are_chip_smokes():
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "MARCH_OPS_PER_STEP", "RESOLVE_OPS",
                 "SEGMENT_OPS", "COMPOSITE_FWD_OPS", "COMPOSITE_BWD_OPS"):
        assert getattr(roofline, name) == getattr(chip_smoke, name), name


@pytest.mark.parametrize("nbytes, ops", [(29_055_568, 50_006_052 * 73), (854e6, 1e9),
                                         (1.0, 1.0), (0.0, 5e12)])
def test_bound_is_chip_smokes(nbytes, ops):
    assert roofline.bound_ms(nbytes, ops) == chip_smoke.bound_ms(nbytes, ops)


def test_bench_frame_bounds():
    # the bench frame's K1 bound from PERF.md's kernel table (0.0377 ms, by
    # operations) at its step count, and the light-depth K1's (0.0029, bytes)
    pools = {"tree": 361_216 * 4, "twig": 6_693_504 * 4, "twig_occ": 209_172 * 4,
             "chunk_bmin": 64 * 12, "chunk_tree": 64 * 4}
    b, by = roofline.march_bound_ms(2_073_600, 34_600_000, 1_100_000, pools)
    assert by == "operations" and b == pytest.approx(0.0377, abs=5e-5)
    lb, lby = roofline.light_bound_ms(262_144, 1_147_214, pools)
    assert lby == "bytes" and lb == pytest.approx(0.0029, abs=5e-5)
    # K5 and K6 on the bench segments (K=32): 0.3380 and 0.3542 - 0.0817 (the
    # rgb-only K6 reads no dL/dw, dL/ddepth, dL/dopacity)
    n, K = 2_073_600, 32
    fwd, bwd = roofline.composite_bound_ms(n, K, 6_000_000, 46_000_000)
    assert fwd[1] == bwd[1] == "bytes"
    assert fwd[0] == pytest.approx((n * K * 12 + 6_000_000 * 16 + n * (20 + 4 * K)) / 3.35e9)
