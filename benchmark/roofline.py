"""Peaks of the card and the work of each kernel, for the rooflines.

Copied from chip_smoke.py (its peaks, ``bound_ms`` and hand counts of float
operations, and the byte counts of K1, K4, K5 and K6), so that the yardstick
lives with the benchmark.  A bound is the larger of bytes over the HBM
bandwidth and float operations over the float32 rate, in milliseconds.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
# Float operations per executed march step (csrc/march.cu, one descent
# level): clamp 1, point 6, in-world 6, chunk index 9, descent level 11,
# texel probe 14, escape 26.
MARCH_OPS_PER_STEP = 73
# The light-depth resolve per light ray: point 7 and one row 6.
RESOLVE_OPS = 13
# K4's extraction per segment: point 6, escape 19, t1 and cursor 3.
SEGMENT_OPS = 28
# K5 and K6 per valid segment.
COMPOSITE_FWD_OPS = 35
COMPOSITE_BWD_OPS = 69
RAY_IO = 24 + 33                # K1: o, d in; hit, t, material, cell, size, steps, texel out


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pools_k1(pools: dict) -> int:
    """Bytes of the pools K1 reads: tree, twig occupancy, chunk corners and
    twice the chunk offsets (``pools``: byte sizes by name)."""
    return (pools["tree"] + pools["twig_occ"] + pools["chunk_bmin"]
            + 2 * pools["chunk_tree"])


def march_bound_ms(n: int, steps: int, twig_hits: int, pools: dict):
    """K1 on ``n`` camera rays taking ``steps`` steps in all, ``twig_hits``
    of them ending on a twig texel."""
    return bound_ms(n * RAY_IO + pools_k1(pools) + 4 * twig_hits, MARCH_OPS_PER_STEP * steps)


def light_bound_ms(n: int, steps: int, pools: dict):
    """K1's light-depth instantiation on ``n`` light rays: o, d in, depth out."""
    return bound_ms(n * (24 + 4) + pools_k1(pools),
                    MARCH_OPS_PER_STEP * steps + RESOLVE_OPS * n)


def segments_bound_ms(n: int, K: int, steps: int, n_valid: int, n_leaf: int, pools: dict):
    """K4 on ``n`` rays of ``K`` segments: ``n_valid`` segments, ``n_leaf``
    of them on coarse LEAF slots (no twig word read)."""
    return bound_ms(n * (24 + 4 + 12 * K) + pools_k1(pools) + 4 * (n_valid - n_leaf),
                    MARCH_OPS_PER_STEP * steps + SEGMENT_OPS * n_valid)


def composite_bound_ms(n: int, K: int, touched: int, n_valid: int):
    """K5 then K6 with rgb's gradient alone, as the fit's step runs them:
    each segment once, each touched slot once (K6: read and written), the
    per-ray inputs and outputs.  Returns (K5 bound, K6 bound)."""
    fwd = n * K * 12 + touched * 16 + n * (20 + 4 * K)
    bwd = n * K * 12 + 2 * touched * 16 + n * (20 + 4 * K) + n * 12 - n * (8 + 4 * K)
    return (bound_ms(fwd, COMPOSITE_FWD_OPS * n_valid),
            bound_ms(bwd, COMPOSITE_BWD_OPS * n_valid))
