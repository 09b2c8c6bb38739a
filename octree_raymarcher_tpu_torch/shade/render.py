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

The frame is differentiable as the reference's is: with respect to the
light rig, the material table's diffuse, specular and shininess, the atlas,
the sky map, the eye, and the ray origins and directions with the march
held fixed (the march, the shadow rays and the map compare carry no
gradient, as in JAX).  On CUDA tensors, when any of those requires grad,
:func:`shade_hits` runs an autograd Function whose forward is K2 and whose
backward is K8 (csrc/shade_bwd.cu); when none does, it runs K2 exactly as
it would anyway.  On CPU tensors autograd runs through
:func:`shade_hits_plain`, which is also K8's plain version
(:func:`shade_hits_vjp_plain`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import EPS
from ..core.geometry import const, cube_normal, cube_uv, inverse_depth, length
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
# Their wide instantiations (a rig on the card, or a table past
# SHADE_MAX_MATERIALS rows), counted apart.
SHADE_WIDE_KERNELS = {key: Kernel("ort_shade") for key in SHADE_KERNELS}
# K8, K2's VJP (csrc/shade_bwd.cu), in K2's four instantiations.
SHADE_BWD_KERNEL = Kernel("ort_shade_bwd")
SHADE_BWD_TEX_KERNEL = Kernel("ort_shade_bwd")
SHADE_BWD_MAP_KERNEL = Kernel("ort_shade_bwd")
SHADE_BWD_MAP_TEX_KERNEL = Kernel("ort_shade_bwd")
SHADE_BWD_KERNELS = {(False, False): SHADE_BWD_KERNEL, (False, True): SHADE_BWD_TEX_KERNEL,
                     (True, False): SHADE_BWD_MAP_KERNEL,
                     (True, True): SHADE_BWD_MAP_TEX_KERNEL}

# Rows of a material table K2's parameter block holds (csrc/shade.cuh
# kMaxMaterials; a larger table goes by pointer), the floats of a row
# (MaterialTable.to_matrix), and where the eye, the sky, the light rig and
# the rows start in its host block (kBlock*).
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


@dataclasses.dataclass
class ShadeTables:
    """What K2 takes besides the per-ray arrays (csrc/shade.cu ShadeArgs):
    ``block``, the host floats its parameter block carries (the eye, the
    sky, the light rig and, for a material table of at most
    ``SHADE_MAX_MATERIALS`` rows on the host, its rows); ``eye``, the eye
    when it is on the card (else in the block); ``columns``, the card's
    diffuse, specular and shininess when the table is there or is larger
    (else its rows are in the block); ``num_materials``; ``rig``, the rig's
    50 floats when they are on the card (else in the block)."""

    block: np.ndarray
    eye: torch.Tensor | None
    columns: tuple | None
    num_materials: int
    rig: torch.Tensor | None = None


def _check_rows(m: int) -> None:
    if m < 1:
        raise ValueError(f"the shading kernel takes a material table of at least 1 row; "
                         f"this one has {m}")


def shade_tables(eye, lights: LightRig, materials: MaterialTable, cfg: RenderConfig,
                 device) -> ShadeTables:
    """Pack K2's tables for one launch on ``device``.  The sky and a host
    eye, host rig and host table of at most ``SHADE_MAX_MATERIALS`` rows go
    by value, so a call uploads nothing; an eye, a rig or a table on the
    card is passed by pointer and never read back, and a larger host table
    is uploaded once.  A table of no rows raises."""
    m = materials.num_materials
    _check_rows(m)
    device = torch.device(device)
    by_pointer = materials.diffuse.device.type == "cuda" or m > SHADE_MAX_MATERIALS
    block = np.zeros(BLOCK_ROWS + (0 if by_pointer else m * MATERIAL_ROW), np.float32)
    eye_card = None
    if isinstance(eye, torch.Tensor) and eye.device.type == "cuda":
        eye_card = eye.to(device=device, dtype=torch.float32).reshape(3).contiguous()
    else:
        host = eye.detach().numpy() if isinstance(eye, torch.Tensor) else eye
        block[BLOCK_EYE:BLOCK_EYE + 3] = np.asarray(host, np.float32).reshape(3)
    block[BLOCK_SKY:BLOCK_SKY + 3] = np.asarray(cfg.sky, np.float32)
    rig = None
    if lights.on_card:
        rig = lights.to_tensor(device).contiguous()
    else:
        block[BLOCK_LIGHTS:BLOCK_ROWS] = lights.to_vector()
    columns = None
    if by_pointer:
        t = materials.to(device)
        columns = tuple(c.to(torch.float32).contiguous()
                        for c in (t.diffuse, t.specular, t.shininess))
    else:
        block[BLOCK_ROWS:] = materials.to_matrix().detach().numpy().reshape(-1)
    return ShadeTables(block, eye_card, columns, m, rig)


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
    for tns in (tables.eye, tables.rig, *(tables.columns or ())):
        if tns is not None and (tns.device != dev or tns.dtype != f32
                                or not tns.is_contiguous()):
            raise ValueError(f"shade: the eye, the rig and the material columns must be "
                             f"contiguous float32 on {dev}")
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
    wide = tables.rig is not None or tables.num_materials > SHADE_MAX_MATERIALS
    kernel = (SHADE_WIDE_KERNELS if wide else SHADE_KERNELS)[(shadowmap is not None, textured)]
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
        ptr(rgb), ptr(depth), ptr(point), ptr(normal), ptr(tables.rig),
    )
    return {"rgb": rgb, "depth": depth, "hit": res.hit, "material": res.material,
            "steps": res.steps, "point": point, "normal": normal}


def _requires_grad(*xs) -> bool:
    """Whether autograd records and a tensor among ``xs`` requires grad
    (numpy arrays and None have no such attribute)."""
    return torch.is_grad_enabled() and any(getattr(x, "requires_grad", False) for x in xs)


def _shade_bwd_launch(res: MarchResult, o, d, eye, rig, columns, cfg: RenderConfig, g_rgb,
                      g_depth, shadow_factor=None, atlas=None, envmap=None, shadowmap=None,
                      want_atlas: bool = True, want_env: bool = True, want_o: bool = False,
                      want_d: bool = False) -> dict:
    """K8's launch: the cotangents of K2's inputs given those of its rgb
    (f32[N, 3]) and depth (f32[N]) outputs (either may be None).  ``eye``
    f32[3], ``rig`` f32[50] and the table ``columns`` are on the card.
    Returns {"rig", "eye", "diffuse", "specular", "shininess", "atlas",
    "envmap", "origins", "dirs"}, None where not asked for."""
    dev = o.device
    n = o.shape[0]
    f32 = torch.float32
    diffuse, specular, shininess = columns
    m = diffuse.shape[0]
    for name, tns in (("g_rgb", g_rgb), ("g_depth", g_depth)):
        if tns is not None and (tns.device != dev or tns.dtype != f32
                                or not tns.is_contiguous() or tns.shape[0] != n):
            raise ValueError(f"shade backward: {name} must be a contiguous float32[{n}, ...] "
                             f"on {dev}")
    for tns in (eye, rig, diffuse, specular, shininess):
        if tns.device != dev or tns.dtype != f32 or not tns.is_contiguous():
            raise ValueError(f"shade backward: the eye, the rig and the material columns "
                             f"must be contiguous float32 on {dev}")
    if shadow_factor is not None:
        shadow_factor = to_device(shadow_factor, dev)
    depth_map, map_h, map_w, vp, bias = None, 0, 0, None, 0.0
    if shadowmap is not None:
        depth_map, vp = shadowmap[0], c_floats(host_vp(shadowmap[1]).reshape(16))
        map_h, map_w = depth_map.shape
        bias = map_bias(cfg.shadow_bias, map_w)
    out = {"rig": torch.zeros(50, dtype=f32, device=dev),
           "eye": torch.zeros(3, dtype=f32, device=dev),
           "diffuse": torch.zeros((m, 3), dtype=f32, device=dev),
           "specular": torch.zeros((m, 3), dtype=f32, device=dev),
           "shininess": torch.zeros(m, dtype=f32, device=dev),
           "atlas": (torch.zeros_like(atlas) if atlas is not None and want_atlas else None),
           "envmap": (torch.zeros_like(envmap) if envmap is not None and want_env else None),
           "origins": torch.empty((n, 3), dtype=f32, device=dev) if want_o else None,
           "dirs": torch.empty((n, 3), dtype=f32, device=dev) if want_d else None}
    textured = atlas is not None or envmap is not None
    kernel = SHADE_BWD_KERNELS[(shadowmap is not None, textured)]
    kernel(
        ptr(res.hit), ptr(res.t), ptr(res.material), ptr(res.cell_bmin), ptr(res.cell_size),
        ptr(o), ptr(d), ptr(eye), ptr(shadow_factor),
        ptr(depth_map), map_h, map_w, vp, bias, ptr(rig), m,
        ptr(diffuse), ptr(specular), ptr(shininess),
        ptr(atlas), 0 if atlas is None else atlas.shape[0],
        0 if atlas is None else atlas.shape[1],
        ptr(envmap), 0 if envmap is None else envmap.shape[0],
        0 if envmap is None else envmap.shape[1], float(cfg.gamma), n,
        ptr(g_rgb), ptr(g_depth), ptr(out["rig"]), ptr(out["eye"]), ptr(out["diffuse"]),
        ptr(out["specular"]), ptr(out["shininess"]), ptr(out["atlas"]), ptr(out["envmap"]),
        ptr(out["origins"]), ptr(out["dirs"]),
    )
    return out


class _ShadeFunction(torch.autograd.Function):
    """K2 forward, K8 backward.  Differentiable inputs: the rig f32[50],
    the table's diffuse, specular and shininess, the eye f32[3], the rays o
    and d, the atlas and the sky map; the outputs rgb, depth and point
    (normal carries none)."""

    @staticmethod
    def forward(ctx, res, cfg, shadow_factor, shadowmap, rig, diffuse, specular, shininess,
                eye, o, d, atlas, envmap):
        block = np.zeros(BLOCK_ROWS, np.float32)
        block[BLOCK_SKY:BLOCK_SKY + 3] = np.asarray(cfg.sky, np.float32)
        tables = ShadeTables(block, eye, (diffuse, specular, shininess), diffuse.shape[0], rig)
        out = _shade_launch(res, o, d, tables, cfg, shadow_factor, atlas, envmap, shadowmap)
        ctx.res, ctx.cfg, ctx.shadow_factor, ctx.shadowmap = res, cfg, shadow_factor, shadowmap
        ctx.save_for_backward(rig, diffuse, specular, shininess, eye, o, d, atlas, envmap)
        ctx.mark_non_differentiable(out["normal"])
        return out["rgb"], out["depth"], out["point"], out["normal"]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_depth, g_point, _g_normal):
        rig, diffuse, specular, shininess, eye, o, d, atlas, envmap = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = _shade_bwd_launch(
            ctx.res, o, d, eye, rig, (diffuse, specular, shininess), ctx.cfg,
            None if g_rgb is None else g_rgb.contiguous(),
            None if g_depth is None else g_depth.contiguous(),
            ctx.shadow_factor, atlas, envmap, ctx.shadowmap, want_atlas=need[11],
            want_env=need[12], want_o=need[9], want_d=need[10])
        g_o, g_d = g["origins"], g["dirs"]
        if g_point is not None:
            # point = o + d * (t_hit - EPS), the march held fixed
            if g_o is not None:
                g_o = g_o + g_point
            if g_d is not None:
                t_hit = torch.where(ctx.res.hit, ctx.res.t, 0.0)
                g_d = g_d + g_point * (t_hit - EPS)[:, None]
        return (None, None, None, None, g["rig"], g["diffuse"], g["specular"],
                g["shininess"], g["eye"], g_o, g_d, g["atlas"], g["envmap"])


def shade_hits(res: MarchResult, origins, dirs, eye, lights: LightRig,
               materials: MaterialTable, cfg: RenderConfig, shadow_factor=None,
               atlas=None, envmap=None, shadowmap=None) -> dict:
    """Shade a MarchResult into RGB + AOVs.  On CUDA tensors this launches
    K2; on CPU tensors it runs :func:`shade_hits_plain`.  ``shadowmap``
    (depth f32[H, W], light_vp f32[4,4]) from :func:`render_shadowmap`
    shadows the hits by the map, with ``cfg.shadow_bias``, inside K2; it
    excludes ``shadow_factor``.

    Differentiable in the rig's leaves, the table's diffuse, specular and
    shininess, the eye, the origins and directions (``res`` held fixed),
    the atlas and the sky map: on CUDA tensors, when any of them requires
    grad, K2 runs inside an autograd Function whose backward is K8 (the
    rig, the eye and the table then go to the card by pointer); otherwise
    K2 runs as it always does."""
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
    if not o.is_cuda:
        return shade_hits_plain(res, o, d, to_device(eye, dev).reshape(3), lights, materials,
                                cfg, shadow_factor, atlas, envmap, shadowmap)
    grad = torch.is_grad_enabled() and (lights.requires_grad or materials.requires_grad
                                        or _requires_grad(eye, o, d, atlas, envmap))
    if not grad:
        return _shade_launch(res, o, d, shade_tables(eye, lights, materials, cfg, dev), cfg,
                             shadow_factor, atlas, envmap, shadowmap)
    _check_rows(materials.num_materials)
    t = materials.to(dev)
    columns = [c.to(torch.float32).contiguous() for c in (t.diffuse, t.specular, t.shininess)]
    eye_t = to_device(eye, dev).reshape(3).contiguous()
    rgb, depth, point, normal = _ShadeFunction.apply(
        res, cfg, shadow_factor, shadowmap, lights.to_tensor(dev).contiguous(), *columns,
        eye_t, o, d, atlas, envmap)
    return {"rgb": rgb, "depth": depth, "hit": res.hit, "material": res.material,
            "steps": res.steps, "point": point, "normal": normal}


class _Float64Rows:
    """A material table whose lookup gathers each ray's float32 row from
    float64 columns: autograd then sums a row's per-ray gradients in
    float64.  A row of the bench frame takes up to a million of them, and a
    float32 running sum of that many small terms drifts by a percent."""

    def __init__(self, ambient, columns):
        self.ambient, self.columns = ambient, columns
        self.num_materials = ambient.shape[0]

    def to(self, device):
        return self

    def lookup(self, material_id):
        m = material_id.clamp(0, self.num_materials - 1).long()
        return (self.ambient[m], *(c[m].to(torch.float32) for c in self.columns))


def shade_hits_vjp_plain(res: MarchResult, o, d, eye, lights: LightRig,
                         materials: MaterialTable, cfg: RenderConfig, g_rgb, g_depth,
                         shadow_factor=None, atlas=None, envmap=None, shadowmap=None) -> dict:
    """K8's plain version: ``torch.autograd.grad`` of
    :func:`shade_hits_plain`'s rgb and depth against the cotangents
    ``g_rgb`` and ``g_depth`` (either may be None), on the device of the
    rays; the table's rows are summed in float64.  Returns the gradients of
    :func:`_shade_bwd_launch`'s keys (the rig as its 50 floats in
    VECTOR_LAYOUT order); atlas and envmap are None when not given."""
    dev = o.device
    rig = lights.to_tensor(dev).detach().requires_grad_(True)
    cols = [c.detach().to(device=dev, dtype=torch.float64).requires_grad_(True)
            for c in (materials.diffuse, materials.specular, materials.shininess)]
    table = _Float64Rows(materials.ambient.detach().to(dev), cols)
    eye_t = to_device(eye, dev).reshape(3).detach().requires_grad_(True)
    o_t = o.detach().requires_grad_(True)
    d_t = d.detach().requires_grad_(True)
    tex = {k: (None if v is None else v.detach().requires_grad_(True))
           for k, v in (("atlas", atlas), ("envmap", envmap))}
    with torch.enable_grad():
        out = shade_hits_plain(res, o_t, d_t, eye_t, LightRig.from_vector(rig), table, cfg,
                               shadow_factor, tex["atlas"], tex["envmap"], shadowmap)
        inputs = [rig, *cols, eye_t, o_t, d_t] + [v for v in tex.values() if v is not None]
        pairs = [(y, g) for y, g in ((out["rgb"], g_rgb), (out["depth"], g_depth))
                 if g is not None]
        grads = torch.autograd.grad([y for y, _ in pairs], inputs, [g for _, g in pairs],
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    keys = ["rig", "diffuse", "specular", "shininess", "eye", "origins", "dirs"]
    result = {k: g.to(torch.float32) for k, g in zip(keys, grads)}
    rest = iter(grads[len(keys):])
    result["atlas"] = None if atlas is None else next(rest)
    result["envmap"] = None if envmap is None else next(rest)
    return result


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
    ``assume_resident``.

    Differentiable as :func:`shade_hits` is, the marches held fixed.  The
    shadow modes read the directional light's direction on the host (one
    small read back for a rig on the card): the ray frame's shadow rays
    take no gradient through it, and the map frame without a ``shadowmap``
    refuses a direction that requires grad, as the reference's jax.grad
    does."""
    _check_shadow(cfg)
    lights = LightRig.default() if lights is None else lights
    materials = MaterialTable.default() if materials is None else materials
    dev = resolve_device(device)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    # the marches take no gradient (the reference's carries t in an int32
    # loop state): o and d reach the shading alone
    om = o.detach() if o.requires_grad else o
    dm = d.detach() if d.requires_grad else d
    if cfg.shadow == "map" and shadowmap is None:
        direction = lights.directional.direction
        if _requires_grad(direction):
            raise ValueError(
                "render(shadow='map') builds its light pass from the directional light's "
                "direction read on the host, as the reference does (whose jax.grad raises "
                "TracerArrayConversionError there), so it cannot differentiate with respect "
                "to that direction; pass shadowmap=render_shadowmap(world, lights) to "
                "differentiate the map-shadowed frame")
        shadowmap = render_shadowmap(world, lights, max_steps=cfg.max_steps,
                                     assume_resident=cfg.assume_resident)
    res = march(world, om, dm, cfg.max_steps, steps_aov=bool(cfg.steps_aov),
                assume_resident=cfg.assume_resident, device=dev)
    shadow_factor = None
    if cfg.shadow == "ray":
        shadow_factor = _ray_shadow_hits(world, res, om, dm, lights, cfg)
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
           "shade_hits_vjp_plain", "ShadeTables", "SHADE_KERNEL", "SHADE_TEX_KERNEL",
           "SHADE_MAP_KERNEL", "SHADE_MAP_TEX_KERNEL", "SHADE_BWD_KERNEL",
           "SHADE_BWD_TEX_KERNEL", "SHADE_BWD_MAP_KERNEL", "SHADE_BWD_MAP_TEX_KERNEL",
           "SHADE_MAX_MATERIALS"]
