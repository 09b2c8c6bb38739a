"""The forward render pass: march + shadow + Blinn-Phong shade + depth AOVs.

PyTorch counterpart of octree_raymarcher_tpu/shade/render.py: the march
(CUDA kernel K1, ops/march.py), the shadow (shade/shadow.py), and per-ray
shading (CUDA kernel K2, csrc/shade.cu) into the AOV dict of the reference
(rgb, depth, hit, material, steps, point, normal).  Per frame the kernels
launch in this order:

* ``shadow="none"``: K1, K2;
* ``shadow="ray"``: K1, K3 ray_prep, K1 (shadow rays), K2;
* ``shadow="map"``: K1 with its light-depth epilogue (the light bundle;
  skipped when ``shadowmap`` is given), K1, then K2 with the depth map,
  which projects its hit points into it itself.

On CPU tensors every stage runs its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import EPS
from ..core.geometry import cube_normal, cube_uv, inverse_depth, length
from ..kernels import Kernel, c_floats, ptr
from ..ops.march import MarchResult, march
from ..world.device import TorchWorld, resolve_device, to_device
from .envmap import sample_env
from .lights import LightRig
from .materials import MaterialTable
from .shadow import (
    host_vp,
    light_dir,
    map_bias,
    map_project_plain,
    map_shadow,
    ray_prep,
    ray_shadow,
    render_shadowmap,
    shadow_bundle,
)

# K2's four instantiations, one C entry: given a depth map, the map-shadowed
# ones; given an atlas or a sky map, the textured ones.
SHADE_KERNEL = Kernel("ort_shade")
SHADE_TEX_KERNEL = Kernel("ort_shade")
SHADE_MAP_KERNEL = Kernel("ort_shade")
SHADE_MAP_TEX_KERNEL = Kernel("ort_shade")
SHADE_KERNELS = {(False, False): SHADE_KERNEL, (False, True): SHADE_TEX_KERNEL,
                 (True, False): SHADE_MAP_KERNEL, (True, True): SHADE_MAP_TEX_KERNEL}

# Rows of a material table K2 holds (csrc/shade.cu kMaxMaterials), the
# floats of a row (MaterialTable.to_matrix), and where the eye, the sky, the
# light rig and the rows start in its host block (kBlock*).
SHADE_MAX_MATERIALS = 32
MATERIAL_ROW = 10
BLOCK_EYE, BLOCK_SKY, BLOCK_LIGHTS, BLOCK_ROWS = 0, 3, 6, 56


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


def _check_shadow(cfg: RenderConfig) -> None:
    if cfg.shadow not in ("none", "ray", "map"):
        raise ValueError(f"unknown shadow mode {cfg.shadow!r}")


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

    _, diffuse, specular, shininess = materials.to(o.device).lookup(res.material)

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
        tex = torch.pow(torch.clamp_min(tex, 1e-6), cfg.gamma)
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


@dataclasses.dataclass
class ShadeTables:
    """What K2 takes besides the per-ray arrays (csrc/shade.cu ShadeArgs):
    ``block``, the host floats its parameter block carries (the eye, the
    sky, the light rig and, for a material table on the host, its rows);
    ``eye``, the eye when it is on the card (else in the block);
    ``columns``, the card's diffuse, specular and shininess when the
    table is there (else its rows are in the block); ``num_materials``."""

    block: np.ndarray
    eye: torch.Tensor | None
    columns: tuple | None
    num_materials: int


def shade_tables(eye, lights: LightRig, materials: MaterialTable, cfg: RenderConfig,
                 device) -> ShadeTables:
    """Pack K2's tables for one launch on ``device``.  The rig, the sky and
    a host eye and host material table go by value, so a call uploads
    nothing; an eye or a table on the card is passed by pointer and never
    read back.  A table of more than ``SHADE_MAX_MATERIALS`` rows (or none)
    raises: the block holds no more."""
    m = materials.num_materials
    if not 1 <= m <= SHADE_MAX_MATERIALS:
        raise ValueError(f"the shading kernel takes a material table of 1 to "
                         f"{SHADE_MAX_MATERIALS} rows; this one has {m}")
    device = torch.device(device)
    on_card = materials.diffuse.device.type == "cuda"
    block = np.zeros(BLOCK_ROWS + (0 if on_card else m * MATERIAL_ROW), np.float32)
    eye_card = None
    if isinstance(eye, torch.Tensor) and eye.device.type == "cuda":
        eye_card = eye.to(device=device, dtype=torch.float32).reshape(3).contiguous()
    else:
        host = eye.detach().numpy() if isinstance(eye, torch.Tensor) else eye
        block[BLOCK_EYE:BLOCK_EYE + 3] = np.asarray(host, np.float32).reshape(3)
    block[BLOCK_SKY:BLOCK_SKY + 3] = np.asarray(cfg.sky, np.float32)
    block[BLOCK_LIGHTS:BLOCK_ROWS] = lights.to_vector()
    columns = None
    if on_card:
        t = materials.to(device)
        columns = tuple(c.to(torch.float32).contiguous()
                        for c in (t.diffuse, t.specular, t.shininess))
    else:
        block[BLOCK_ROWS:] = materials.to_matrix().numpy().reshape(-1)
    return ShadeTables(block, eye_card, columns, m)


def _shade_launch(res: MarchResult, o, d, tables: ShadeTables, cfg: RenderConfig,
                  shadow_factor=None, atlas=None, envmap=None, shadowmap=None) -> dict:
    """K2's launch with its tables packed by :func:`shade_tables` (no host
    copy, so it can be captured in a CUDA graph).  With ``shadowmap``
    (depth on the card, vp on the host) a map-shadowed instantiation runs,
    with an atlas or a sky map a textured one."""
    dev = o.device
    n = o.shape[0]
    f32 = torch.float32
    per_ray = {"hit": (res.hit, torch.bool), "t": (res.t, f32),
               "material": (res.material, torch.int32), "cell_bmin": (res.cell_bmin, f32),
               "cell_size": (res.cell_size, f32), "o": (o, f32), "d": (d, f32)}
    for name, (tns, dtype) in per_ray.items():
        if (tns.device != dev or tns.dtype != dtype or not tns.is_contiguous()
                or tns.shape[0] != n):
            raise ValueError(f"shade: {name} must be a contiguous {dtype}[{n}, ...] on {dev}")
    for tns in (tables.eye, *(tables.columns or ())):
        if tns is not None and (tns.device != dev or tns.dtype != f32
                                or not tns.is_contiguous()):
            raise ValueError(f"shade: the eye and material columns must be contiguous "
                             f"float32 on {dev}")
    if shadow_factor is not None:
        shadow_factor = to_device(shadow_factor, dev)
        if shadow_factor.shape != (n,):
            raise ValueError(f"shade: shadow_factor must be f32[{n}]")
    if atlas is not None and (atlas.ndim != 4 or atlas.shape[1] != atlas.shape[2]
                              or atlas.shape[3] != 3 or atlas.dtype != f32
                              or not atlas.is_contiguous() or atlas.device != dev):
        raise ValueError(f"atlas must be a contiguous f32[M, R, R, 3] on {dev}, got "
                         f"{atlas.dtype}{tuple(atlas.shape)}")
    if envmap is not None and (envmap.ndim != 3 or envmap.shape[2] != 3 or envmap.dtype != f32
                               or not envmap.is_contiguous() or envmap.device != dev):
        raise ValueError(f"envmap must be a contiguous f32[H, W, 3] on {dev}, got "
                         f"{envmap.dtype}{tuple(envmap.shape)}")
    depth_map, map_h, map_w, vp, bias = None, 0, 0, None, 0.0
    if shadowmap is not None:
        depth_map, vp = shadowmap[0], c_floats(host_vp(shadowmap[1]).reshape(16))
        if (depth_map.device != dev or depth_map.dtype != f32 or depth_map.ndim != 2
                or not depth_map.is_contiguous()):
            raise ValueError(f"shade: the shadow map depth must be a contiguous f32[H, W] "
                             f"on {dev}")
        map_h, map_w = depth_map.shape
        bias = map_bias(cfg.shadow_bias, map_w)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(n, dtype=torch.float32, device=dev)
    point = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cols = tables.columns or (None, None, None)
    # scratch for K2's gamma-decoded atlas: the texels, then the count of the
    # blocks that decoded them
    decoded = (None if atlas is None
               else torch.empty(atlas.numel() + 1, dtype=torch.float32, device=dev))
    textured = atlas is not None or envmap is not None
    kernel = SHADE_KERNELS[(shadowmap is not None, textured)]
    kernel(
        ptr(res.hit), ptr(res.t), ptr(res.material), ptr(res.cell_bmin),
        ptr(res.cell_size), ptr(o), ptr(d), ptr(tables.eye), ptr(shadow_factor),
        ptr(depth_map), map_h, map_w, vp, bias, tables.block.ctypes.data,
        tables.num_materials, ptr(cols[0]), ptr(cols[1]), ptr(cols[2]),
        ptr(atlas), 0 if atlas is None else atlas.shape[0],
        0 if atlas is None else atlas.shape[1], ptr(decoded),
        ptr(envmap), 0 if envmap is None else envmap.shape[0],
        0 if envmap is None else envmap.shape[1],
        float(cfg.gamma), n,
        ptr(rgb), ptr(depth), ptr(point), ptr(normal),
    )
    return {"rgb": rgb, "depth": depth, "hit": res.hit, "material": res.material,
            "steps": res.steps, "point": point, "normal": normal}


def shade_hits(res: MarchResult, origins, dirs, eye, lights: LightRig,
               materials: MaterialTable, cfg: RenderConfig, shadow_factor=None,
               atlas=None, envmap=None, shadowmap=None) -> dict:
    """Shade a MarchResult into RGB + AOVs.  On CUDA tensors this launches
    K2; on CPU tensors it runs :func:`shade_hits_plain`.  ``shadowmap``
    (depth f32[H, W], light_vp f32[4,4]) from :func:`render_shadowmap`
    shadows the hits by the map, with ``cfg.shadow_bias``, inside K2; it
    excludes ``shadow_factor``."""
    dev = res.t.device
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    if atlas is not None:
        atlas = to_device(atlas, dev)
    if envmap is not None:
        envmap = to_device(envmap, dev)
    if shadowmap is not None:
        if shadow_factor is not None:
            raise ValueError("shade_hits takes a shadow_factor or a shadowmap, not both")
        shadowmap = (to_device(shadowmap[0], dev), host_vp(shadowmap[1]))
    if o.is_cuda:
        return _shade_launch(res, o, d, shade_tables(eye, lights, materials, cfg, dev), cfg,
                             shadow_factor, atlas, envmap, shadowmap)
    return shade_hits_plain(res, o, d, to_device(eye, dev).reshape(3), lights, materials,
                            cfg, shadow_factor, atlas, envmap, shadowmap)


def _ray_shadow_hits(world: TorchWorld, res: MarchResult, o, d, lights: LightRig,
                     cfg: RenderConfig):
    """render()'s ray shadow: :func:`ray_shadow` with the start points and
    normals taken from the hit records inside K3's ray_prep."""
    start, dirs, live = ray_prep(res, o, d, light_dir(lights))
    sres = march(world, start, dirs, cfg.max_steps, live_start=live, device=res.hit.device)
    return (res.hit & sres.hit).to(torch.float32)


def render(
    world: TorchWorld,
    origins,
    dirs,
    eye,
    lights: LightRig | None = None,
    materials: MaterialTable | None = None,
    cfg: RenderConfig = RenderConfig(),
    atlas=None,
    shadowmap=None,
    envmap=None,
    device="cuda",
) -> dict:
    """Full forward pass over a ray batch on ``device`` (where ``world``
    lives).  Returns the AOV dict (rgb, depth, hit, material, steps, point,
    normal).  With ``cfg.shadow == "map"``, ``shadowmap`` (depth, light_vp)
    from :func:`render_shadowmap` is used when given, else the light pass
    runs here with the screen pass's ``max_steps`` and
    ``assume_resident``."""
    _check_shadow(cfg)
    lights = LightRig.default() if lights is None else lights
    materials = MaterialTable.default() if materials is None else materials
    dev = resolve_device(device)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    if cfg.shadow == "map" and shadowmap is None:
        shadowmap = render_shadowmap(world, lights, max_steps=cfg.max_steps,
                                     assume_resident=cfg.assume_resident)
    res = march(world, o, d, cfg.max_steps, steps_aov=bool(cfg.steps_aov),
                assume_resident=cfg.assume_resident, device=dev)
    shadow_factor = None
    if cfg.shadow == "ray":
        shadow_factor = _ray_shadow_hits(world, res, o, d, lights, cfg)
    if cfg.shadow != "map":
        shadowmap = None
    return shade_hits(res, o, d, eye, lights, materials, cfg, shadow_factor=shadow_factor,
                      atlas=atlas, envmap=envmap, shadowmap=shadowmap)


def render_frame(
    world: TorchWorld,
    origins,
    dirs,
    eye,
    lights: LightRig | None = None,
    materials: MaterialTable | None = None,
    cfg: RenderConfig = RenderConfig(),
    atlas=None,
    tile: int = 65536,
    envmap=None,
    fused: bool = False,
    compact: bool = False,
    compact_stride: int = 16,
    compact_schedule=None,
    device="cuda",
) -> dict:
    """Full-frame render: one launch of each kernel of :func:`render` for
    the whole batch.  ``tile``, ``fused``, ``compact``, ``compact_stride``
    and ``compact_schedule`` are accepted for callers of the reference and
    ignored (they chose among TPU schedules of the same result; the
    reference's compact path also returned a "lane_iters" count, which has
    no counterpart here)."""
    return render(world, origins, dirs, eye, lights, materials, cfg, atlas,
                  envmap=envmap, device=device)


__all__ = ["RenderConfig", "render", "render_frame", "render_shadowmap", "shadow_bundle",
           "map_shadow", "ray_shadow", "shade_hits", "shade_hits_plain", "shade_tables",
           "ShadeTables", "SHADE_KERNEL", "SHADE_TEX_KERNEL", "SHADE_MAP_KERNEL",
           "SHADE_MAP_TEX_KERNEL", "SHADE_MAX_MATERIALS"]
