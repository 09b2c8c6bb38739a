"""The shaded frame in plain PyTorch: the light pass, the march, the shading.

What the port's ``render_frame`` computes for one ray batch with
``shadow="map"``: the 512 x 512 light bundle marched to its depth map, the
camera rays marched, then per-ray Blinn-Phong shading with the map compare,
the atlas and the sky map.  Rays are independent, so any block of rows gives
the rows of the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .lights import host_leaf
from .march import march_depth_plain, march_plain
from .render import RenderConfig, shade_hits_plain
from .shadow import light_vp, shadow_bundle


def shadow_map(world, lights, max_steps: int, assume_resident: bool,
               resolution=(512, 512), margin: float = 1.1):
    """(depth f32[H, W] on the world's device, light view-projection f32[4, 4]
    on the host) of the directional light's ortho pass over the world."""
    H, W = resolution
    ldir64 = host_leaf(lights.directional.direction).astype(np.float64)
    ldir64 = ldir64 / np.linalg.norm(ldir64)
    origins_rel, dirs, pv_rel, extent_half = shadow_bundle(ldir64, H, W, world.dims,
                                                           world.chunksize, margin)
    cs = world.chunksize
    center = world.chunkcoordmin.cpu().numpy().astype(np.float32) * np.float32(cs) + extent_half
    dev = world.device
    o = torch.from_numpy(origins_rel + center[None, :]).to(dev)
    d = torch.from_numpy(np.ascontiguousarray(dirs)).to(dev)
    vp = light_vp(pv_rel, center)
    depth = march_depth_plain(world, o, d, vp[2], max_steps, assume_resident)
    return depth.reshape(H, W), torch.from_numpy(vp)


def frame(world, o, d, eye, lights, materials, cfg: RenderConfig, atlas, envmap,
          shadowmap) -> dict:
    """The frame's outputs for rays (o, d): the shading's AOVs (rgb, depth,
    hit, material, point, normal) and the march's ``t``."""
    res = march_plain(world, o, d, cfg.max_steps, False, None, None, cfg.assume_resident)
    eye = torch.as_tensor(np.asarray(eye, dtype=np.float32), device=o.device)
    out = shade_hits_plain(res, o, d, eye, lights, materials, cfg, atlas=atlas,
                           envmap=envmap, shadowmap=shadowmap)
    out["t"] = res.t
    return out
