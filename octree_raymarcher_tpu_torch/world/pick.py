"""Edit-cursor picking: march one eye ray on the host to target edits.

Capability parity with the reference's per-frame CPU pick (computeTarget,
src/Main.cpp:314-319, via the CPU marcher chunkmarch src/Traverse.cpp:127-171)
that places the edit cursor where the view ray hits the surface.  A numpy
copy of octree_raymarcher_tpu/world/pick.py: the host oracle marcher walks
the host chunks, so picking never touches the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..march import cpu_ref


@dataclasses.dataclass
class PickResult:
    hit: bool
    point: np.ndarray          # world-space hit point
    cell_bmin: np.ndarray      # hit cell/texel min corner
    cell_size: float
    material: int
    t: float


def pick(world, origin, direction, cursor_scale: float = 1.0) -> PickResult | None:
    """March one ray through the (host) World; returns the hit cell snapped
    to a cursor box of ``cursor_scale`` times the hit cell size, or None."""
    origin = np.asarray(origin, dtype=np.float32)
    direction = np.asarray(direction, dtype=np.float32)
    direction = direction / max(np.linalg.norm(direction), 1e-12)
    h = cpu_ref.chunkmarch(world, origin, direction)
    if not h.hit:
        return None
    return PickResult(
        hit=True,
        point=origin + direction * np.float32(h.t),
        cell_bmin=np.asarray(h.bmin, dtype=np.float32),
        cell_size=float(h.size) * cursor_scale,
        material=int(h.material),
        t=float(h.t),
    )


def cursor_box(p: PickResult) -> tuple[np.ndarray, np.ndarray]:
    """The axis-aligned edit box for a pick (the ImaginaryCube analog,
    src/ImaginaryCube.cpp:59-62): centered on the hit cell, scaled."""
    center = p.cell_bmin + p.cell_size / 2.0
    half = np.float32(p.cell_size / 2.0)
    return center - half, center + half


__all__ = ["pick", "cursor_box", "PickResult"]
