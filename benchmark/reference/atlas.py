"""The procedural material atlas (frozen copy of the port's shade/atlas.py)."""

from __future__ import annotations

import numpy as np

from .materials import MaterialTable, NUM_MATERIALS

def _value_noise(r: int, seed: int, octaves: int = 3, base: int = 4) -> np.ndarray:
    """Deterministic tileable value noise in [0,1] of shape [r, r]."""
    rng = np.random.default_rng(seed)
    out = np.zeros((r, r), dtype=np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = base * (1 << o)
        coarse = rng.random((g, g))
        # Tileable bilinear upsample: sample with wraparound.
        ys = np.linspace(0, g, r, endpoint=False)
        y0 = np.floor(ys).astype(int)
        fy = ys - y0
        y1 = (y0 + 1) % g
        c00 = coarse[np.ix_(y0, y0)]
        c01 = coarse[np.ix_(y0, y1)]
        c10 = coarse[np.ix_(y1, y0)]
        c11 = coarse[np.ix_(y1, y1)]
        fx = fy[None, :]
        fyv = fy[:, None]
        layer = (
            c00 * (1 - fyv) * (1 - fx)
            + c01 * (1 - fyv) * fx
            + c10 * fyv * (1 - fx)
            + c11 * fyv * fx
        )
        out += amp * layer
        total += amp
        amp *= 0.5
    return (out / total).astype(np.float32)


def default_atlas(
    materials: MaterialTable | None = None,
    resolution: int = 32,
    seed: int = 0,
) -> np.ndarray:
    """Procedural per-material tile atlas f32[M, R, R, 3] (linear color,
    in [0,1]).  Each tile modulates around 1.0 so `diffuse * tex` keeps the
    material's base color while adding spatial variety — the role the
    reference's painted PNG sheet plays."""
    materials = MaterialTable.default() if materials is None else materials
    M = NUM_MATERIALS
    R = int(resolution)
    atlas = np.ones((M, R, R, 3), dtype=np.float32)
    for m in range(M):
        n = _value_noise(R, seed * 1000 + m)
        if m == 6:  # water: horizontal ripple bands
            yy = np.arange(R)[:, None] / R
            pat = 0.85 + 0.3 * (0.5 + 0.5 * np.sin(yy * 12.0 + 4.0 * n))
        elif m == 4:  # grass: fine high-frequency speckle
            fine = _value_noise(R, seed * 1000 + 100 + m, octaves=4, base=8)
            pat = 0.75 + 0.5 * fine
        elif m == 1:  # stone: banded strata
            xx = np.arange(R)[None, :] / R
            pat = 0.8 + 0.35 * (0.5 + 0.5 * np.sin(xx * 8.0 + 6.0 * n)) * n
        else:
            pat = 0.75 + 0.5 * n
        atlas[m] = np.clip(pat, 0.05, 1.6)[..., None]
    # Gamma-ENCODE: shade_hits decodes with pow(tex, gamma) like the
    # reference (World.Fragment.glsl:180-182), so stored texels are sRGB-ish.
    return np.clip(atlas, 0.0, 1.0) ** (1.0 / 2.2)
