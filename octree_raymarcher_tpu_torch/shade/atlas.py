"""Texture atlas: procedural default tiles and the sampling layout.

Capability parity with the reference's TextureAtlas (src/Atlas.cpp:29-33:
nearest-filtered PNG sheet, the same file doubling as diffuse and specular)
and its leafUV tile addressing (shaders/World.Fragment.glsl:5-15: tile
coordinates x = mat & 0xff, y = (mat >> 8) & 0xff into a 256x256-tile sheet,
gamma-2.2 decoded at sample time, World.Fragment.glsl:180-182).

Layout: the atlas is a dense f32[M, R, R, 3] array — one RxR tile per
material id — nearest-sampled per hit in shade_hits (shade/render.py and the
shading kernel csrc/shade.cu).
The reference ships a hand-painted sheet; default_atlas() generates a deterministic
procedural equivalent (per-material base color from the material table +
per-material pattern) so textured rendering works out of the box.
"""

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


def sheet_from_atlas(atlas: np.ndarray) -> np.ndarray:
    """Pack f32[M,R,R,3] tiles into one u8 sheet laid out by the reference's
    leafUV addressing: material m occupies tile (x = m & 0xff, y = m >> 8).
    Returns uint8 [rows*R, cols*R, 3] with cols = min(M,256)."""
    M, R = atlas.shape[0], atlas.shape[1]
    cols = min(M, 256)
    rows = (M + 255) // 256
    sheet = np.zeros((rows * R, cols * R, 3), dtype=np.uint8)
    for m in range(M):
        x, y = m & 0xFF, m >> 8
        sheet[y * R : (y + 1) * R, x * R : (x + 1) * R] = (
            np.clip(atlas[m], 0, 1) * 255 + 0.5
        ).astype(np.uint8)
    return sheet


def atlas_from_sheet(sheet: np.ndarray, tile: int,
                     num_materials: int = NUM_MATERIALS) -> np.ndarray:
    """Slice a reference-style atlas sheet (uint8 [H,W,3/4]) into
    f32[M, tile, tile, 3] by the leafUV tile addressing (x = m & 0xff,
    y = m >> 8; shaders/World.Fragment.glsl:10-12)."""
    s = np.asarray(sheet)
    if s.dtype == np.uint8:
        s = s.astype(np.float32) / 255.0
    s = s[..., :3]
    out = np.zeros((num_materials, tile, tile, 3), dtype=np.float32)
    for m in range(num_materials):
        x, y = m & 0xFF, m >> 8
        ys, xs = y * tile, x * tile
        if ys + tile > s.shape[0] or xs + tile > s.shape[1]:
            raise ValueError(f"sheet {s.shape} too small for material {m} at tile {tile}")
        out[m] = s[ys : ys + tile, xs : xs + tile]
    return out


def load_atlas_png(path: str, tile: int, num_materials: int = NUM_MATERIALS) -> np.ndarray:
    """Load a PNG atlas sheet and slice it per material (the reference's
    TextureAtlas::init + leafUV, src/Atlas.cpp:29-33)."""
    from ..utils.png import load_png

    return atlas_from_sheet(load_png(path), tile, num_materials)


def save_atlas_png(path: str, atlas: np.ndarray) -> None:
    from ..utils.png import save_png

    save_png(path, sheet_from_atlas(atlas))


__all__ = ["default_atlas", "atlas_from_sheet", "sheet_from_atlas", "load_atlas_png",
           "save_atlas_png"]
