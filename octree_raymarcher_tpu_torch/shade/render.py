"""The forward render pass: march + Blinn-Phong shade + depth AOVs.

PyTorch counterpart of octree_raymarcher_tpu/shade/render.py for
``shadow="none"``: the march (CUDA kernel K1, ops/march.py) and then
per-ray shading (CUDA kernel K2, csrc/shade.cu) into the AOV dict of the
reference (rgb, depth, hit, material, steps, point, normal).  On CPU tensors
both stages run their plain PyTorch versions.

Shadows ("ray", "map") are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import EPS
from ..core.geometry import cube_normal, cube_uv, inverse_depth, length
from ..kernels import Kernel, ptr
from ..ops.march import MarchResult, march
from ..world.device import TorchWorld, resolve_device, to_device
from .envmap import sample_env
from .lights import LightRig
from .materials import MaterialTable

SHADE_KERNEL = Kernel("ort_shade")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    shadow: str = "none"            # only "none" in this port so far
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
    if cfg.shadow == "none":
        return
    if cfg.shadow in ("ray", "map"):
        raise NotImplementedError(
            f"shadow={cfg.shadow!r} is not ported yet (ROADMAP queue A item 4: "
            "shadows); use shadow='none'"
        )
    raise ValueError(f"unknown shadow mode {cfg.shadow!r}")


def shade_hits_plain(res: MarchResult, o, d, eye, lights: LightRig,
                     materials: MaterialTable, cfg: RenderConfig,
                     shadow_factor=None, atlas=None, envmap=None) -> dict:
    """Shading in plain PyTorch ops, in the kernel's operation order."""
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


def _shade_cuda(res: MarchResult, o, d, eye, lights: LightRig,
                materials: MaterialTable, cfg: RenderConfig,
                shadow_factor=None, atlas=None, envmap=None) -> dict:
    """Launch K2 on PyTorch's current stream; outputs allocated here."""
    dev = o.device
    n = o.shape[0]
    mats = to_device(materials.to_matrix(), dev)
    light_vec = to_device(lights.to_vector(), dev)
    f32 = torch.float32
    per_ray = {"hit": (res.hit, torch.bool), "t": (res.t, f32),
               "material": (res.material, torch.int32), "cell_bmin": (res.cell_bmin, f32),
               "cell_size": (res.cell_size, f32), "o": (o, f32), "d": (d, f32)}
    for name, (tns, dtype) in per_ray.items():
        if (tns.device != dev or tns.dtype != dtype or not tns.is_contiguous()
                or tns.shape[0] != n):
            raise ValueError(f"shade: {name} must be a contiguous {dtype}[{n}, ...] on {dev}")
    if shadow_factor is not None:
        shadow_factor = to_device(shadow_factor, dev)
        if shadow_factor.shape != (n,):
            raise ValueError(f"shade: shadow_factor must be f32[{n}]")
    if atlas is not None and (atlas.ndim != 4 or atlas.shape[1] != atlas.shape[2]
                              or atlas.shape[3] != 3):
        raise ValueError(f"atlas must be f32[M, R, R, 3], got {tuple(atlas.shape)}")
    if envmap is not None and (envmap.ndim != 3 or envmap.shape[2] != 3):
        raise ValueError(f"envmap must be f32[H, W, 3], got {tuple(envmap.shape)}")
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(n, dtype=torch.float32, device=dev)
    point = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sky = [float(v) for v in cfg.sky]
    SHADE_KERNEL(
        ptr(res.hit), ptr(res.t), ptr(res.material), ptr(res.cell_bmin),
        ptr(res.cell_size), ptr(o), ptr(d), ptr(eye), ptr(shadow_factor),
        ptr(mats), mats.shape[0], ptr(light_vec),
        ptr(atlas), 0 if atlas is None else atlas.shape[0],
        0 if atlas is None else atlas.shape[1],
        ptr(envmap), 0 if envmap is None else envmap.shape[0],
        0 if envmap is None else envmap.shape[1],
        sky[0], sky[1], sky[2], float(cfg.gamma), n,
        ptr(rgb), ptr(depth), ptr(point), ptr(normal),
    )
    return {"rgb": rgb, "depth": depth, "hit": res.hit, "material": res.material,
            "steps": res.steps, "point": point, "normal": normal}


def shade_hits(res: MarchResult, origins, dirs, eye, lights: LightRig,
               materials: MaterialTable, cfg: RenderConfig, shadow_factor=None,
               atlas=None, envmap=None) -> dict:
    """Shade a MarchResult into RGB + AOVs.  On CUDA tensors this launches
    K2; on CPU tensors it runs :func:`shade_hits_plain`."""
    dev = res.t.device
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    eye = to_device(eye, dev).reshape(3)
    if atlas is not None:
        atlas = to_device(atlas, dev)
    if envmap is not None:
        envmap = to_device(envmap, dev)
    fn = _shade_cuda if o.is_cuda else shade_hits_plain
    return fn(res, o, d, eye, lights, materials, cfg, shadow_factor, atlas, envmap)


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
    normal).  ``shadowmap`` is accepted for callers of the reference; only
    ``cfg.shadow == "none"`` is supported."""
    _check_shadow(cfg)
    lights = LightRig.default() if lights is None else lights
    materials = MaterialTable.default() if materials is None else materials
    dev = resolve_device(device)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    res = march(world, o, d, cfg.max_steps, steps_aov=bool(cfg.steps_aov),
                assume_resident=cfg.assume_resident, device=dev)
    return shade_hits(res, o, d, eye, lights, materials, cfg,
                      atlas=atlas, envmap=envmap)


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
    """Full-frame render: one march launch and one shade launch for the
    whole batch.  ``tile``, ``fused``, ``compact``, ``compact_stride`` and
    ``compact_schedule`` are accepted for callers of the reference and
    ignored (they chose among TPU schedules of the same result)."""
    return render(world, origins, dirs, eye, lights, materials, cfg, atlas,
                  envmap=envmap, device=device)


__all__ = ["RenderConfig", "render", "render_frame", "shade_hits", "shade_hits_plain",
           "SHADE_KERNEL"]
