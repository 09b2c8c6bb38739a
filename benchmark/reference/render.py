"""Per-ray shading in plain PyTorch ops (frozen copy of the port's
shade/render.py shade_hits_plain, without autograd links)."""

from __future__ import annotations

import dataclasses

import torch

from .constants import EPS
from .geometry import const, cube_normal, cube_uv, inverse_depth, length
from .envmap import sample_env
from .lights import LightRig
from .materials import MaterialTable
from .march import MarchResult
from .shadow import map_project_plain

@dataclasses.dataclass(frozen=True)
class RenderConfig:
    shadow: str = "none"            # "none" | "ray" | "map"
    max_steps: int = 512
    sky: tuple = (0.45, 0.65, 0.95)
    gamma: float = 2.2              # atlas decode gamma
    shadow_bias: float = 4.0        # map-shadow bias, in map texels
    # Accepted for callers of the reference and ignored: one kernel launch
    # covers the whole ray batch.
    tile: int = 8192
    # Static-world fast path: skip the per-step chunk-residency reads.
    assume_resident: bool = False
    # Per-ray traversal-step AOV.  Any true value gives the exact count (each
    # thread keeps its own counter, so the reference's "coarse" mode has no
    # reason to exist here); False returns zeros.
    steps_aov: "bool | str" = False


def shade_hits_plain(res: MarchResult, o, d, eye, lights: LightRig,
                     materials: MaterialTable, cfg: RenderConfig,
                     shadow_factor=None, atlas=None, envmap=None, shadowmap=None) -> dict:
    """Shading in plain PyTorch ops, in the kernel's operation order.  With
    ``shadowmap`` (depth, vp) the shadow factor is map_project_plain's, as
    the map-shadowed kernel computes it."""
    if shadowmap is not None:
        shadow_factor = map_project_plain(res, o, d, shadowmap[0], shadowmap[1],
                                          cfg.shadow_bias)
    t_hit = torch.where(res.hit, res.t, 0.0)
    p = o + d * (t_hit - EPS)[:, None]

    cmin = res.cell_bmin
    cmax = cmin + res.cell_size[:, None]
    n = cube_normal(p, cmin, cmax)

    table = materials.to(o.device)
    _, diffuse, specular, shininess = table.lookup(res.material)

    if atlas is not None:
        # Material-indexed tile texture atlas f32[M, R, R, 3], nearest
        # sampled by face UV (the reference's PNG atlas,
        # World.Fragment.glsl:5-15).
        uv = cube_uv(p, cmin, cmax)
        r = atlas.shape[1]
        ui = torch.clamp(uv[:, 0] * r, 0, r - 1).to(torch.int64)
        vi = torch.clamp(uv[:, 1] * r, 0, r - 1).to(torch.int64)
        mi = res.material.clamp(0, atlas.shape[0] - 1).to(torch.int64)
        tex = atlas.reshape(-1, 3)[(mi * r + vi) * r + ui]
        tex = torch.pow(torch.maximum(tex, const(tex, 1e-6)), cfg.gamma)
        diffuse = diffuse * tex
        specular = specular * tex

    shadow = (torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
              if shadow_factor is None else shadow_factor)
    rgb = lights.shade(n, p, eye, diffuse, specular, shininess, shadow)

    if envmap is not None:
        sky = sample_env(envmap, d)
    else:
        sky = torch.tensor(cfg.sky, dtype=torch.float32, device=p.device)
    rgb = torch.where(res.hit[:, None], rgb, sky)

    depth = torch.where(res.hit, inverse_depth(length(p - eye)), 1.0)
    return {"rgb": rgb, "depth": depth, "hit": res.hit, "material": res.material,
            "steps": res.steps, "point": p, "normal": n}
