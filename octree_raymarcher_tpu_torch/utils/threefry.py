"""The reference's random numbers, in numpy: threefry2x32 keys and normals.

The JAX package's fit run (bench_fit.py) draws its starting parameters
with ``jax.random.split(jax.random.PRNGKey(seed))`` and
``jax.random.normal``.  The port's twin (bench_fit.py in this package) draws
the same numbers from this copy of that generator, so both runs start from
the same parameters: the threefry2x32 block cipher (Salmon et al., SC'11)
keyed as ``PRNGKey`` keys it, counters laid out as JAX's partitionable
layout lays them (a 64-bit index split into two words), the 32-bit
mantissa trick of ``uniform`` and the single-precision inverse error
function of XLA (Giles' approximation), so a normal agrees to an ulp or
two.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, c1, c2):
    """The threefry2x32 block (20 rounds) of two uint32 counter arrays
    under ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(c1, np.uint32) + ks[0]
    x1 = np.asarray(c2, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return np.array([0, np.uint32(seed & 0xFFFFFFFF)], np.uint32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32[num, 2]."""
    b1, b2 = threefry2x32(key, *_counters(num))
    return np.stack([b1, b2], axis=1)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' approximation)."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    small = (
        np.float32(2.81022636e-08), np.float32(3.43273939e-07), np.float32(-3.5233877e-06),
        np.float32(-4.39150654e-06), np.float32(0.00021858087), np.float32(-0.00125372503),
        np.float32(-0.00417768164), np.float32(0.246640727), np.float32(1.50140941))
    large = (
        np.float32(-0.000200214257), np.float32(0.000100950558), np.float32(0.00134934322),
        np.float32(-0.00367342844), np.float32(0.00573950773), np.float32(-0.0076224613),
        np.float32(0.00943887047), np.float32(1.00167406), np.float32(2.83297682))
    ws = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, small[0], large[0]).astype(np.float32)
    for a, b in zip(small[1:], large[1:]):
        p = (np.where(lt, a, b) + p * ws).astype(np.float32)
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), p * x).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    n = int(np.prod(shape))
    b1, b2 = threefry2x32(key, *_counters(n))
    bits = b1 ^ b2
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    hi = np.float32(1.0)
    u = np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv(u)).reshape(shape)


__all__ = ["threefry2x32", "prng_key", "split", "normal"]
