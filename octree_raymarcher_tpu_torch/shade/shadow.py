"""Shadows: the light-depth pass, the map projection and the ray shadow.

PyTorch counterpart of the shadow half of octree_raymarcher_tpu/shade/
render.py (``shadow_bundle``, ``render_shadowmap``, ``map_shadow``,
``ray_shadow``).  The marches are kernel K1 (ops/march.py); the per-ray
passes around them are kernel K3 (csrc/shadow.cu), each with its plain
PyTorch version here:

* :func:`ray_prep` - shadow-ray start points p + n*4EPS, the light
  direction and live = hit;
* :func:`shadow_resolve` - the along-ray ndc-z depth of the light bundle;
* :func:`map_project` - the projection of hit points into the light's depth
  map and the biased compare, times the hit mask.

The shadow-map frame runs neither of the last two: :func:`render_shadowmap`
resolves its light depth in K1's epilogue (ops/march.py ``march_depth``),
and ``render`` hands the depth map to the shading kernel K2, which projects
its own hit points.  Both use the arithmetic of ``shadow_resolve`` and
``map_project`` (csrc/shadow.cuh), which stay public, as does
:func:`map_shadow` of given points.

The light's view-projection ``vp`` is built on the host in float32 and the
kernels take it by value; ``vp*[p,1]`` sums its terms in one fixed order,
``((p.x*m0 + p.y*m1) + p.z*m2) + m3``, in the kernels and here alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import EPS
from ..core.geometry import cube_normal, vp_row
from ..kernels import Kernel, c_floats, ptr
from ..ops.march import MarchResult, light_depth_plain, march, march_depth
from ..world.device import TorchWorld, resolve_device, to_device
from .lights import LightRig, host_leaf
from .transforms import look_at, ortho

RAY_PREP_KERNEL = Kernel("ort_ray_prep")
SHADOW_RESOLVE_KERNEL = Kernel("ort_shadow_resolve")
MAP_PROJECT_KERNEL = Kernel("ort_map_project")

# Ray-bundle cache of render_shadowmap: the bundle depends only on the light
# direction, the map resolution, the world's shape and position, and the
# margin, so per frame it is pure reuse.  The world's position is keyed by
# its chunkcoordmin tensor and that tensor's version, so a frame loop reads
# it back from the card once, not every frame.  Bounded: an animated sun
# never re-hits a key, so only the most recent few entries are kept.
_SHADOW_CACHE_MAX = 4
_shadow_bundle_cache: dict = {}


def shadow_bundle(ldir64, H, W, dims, cs, margin: float = 1.1):
    """The world-center-relative ortho light-ray bundle and projection (host
    numpy).  Returns (origins_rel f32[H*W,3], dirs f32[H*W,3], pv_rel
    f32[4,4], extent_half f32[3])."""
    ldir64 = np.asarray(ldir64, dtype=np.float64)
    ldir64 = ldir64 / np.linalg.norm(ldir64)
    w, h, d = dims
    extent = np.array([w, h, d], dtype=np.float64) * cs
    radius = float(np.linalg.norm(extent) * 0.5 * margin)

    # The emitter plane sits behind the world so every ray crosses it.
    plane_rel = -ldir64 * (2.0 * radius)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(ldir64, up)) > 0.99:
        up = np.array([0.0, 0.0, 1.0])
    view_rel = look_at(plane_rel, (0.0, 0.0, 0.0), up)
    proj = ortho(-radius, radius, -radius, radius, 0.0, 8 * radius)
    pv_rel = (proj.astype(np.float64) @ view_rel.astype(np.float64)).astype(np.float32)

    right = np.cross(ldir64, up)
    right /= np.linalg.norm(right)
    upv = np.cross(right, ldir64)
    xs = ((np.arange(W) + 0.5) / W - 0.5) * 2 * radius
    ys = (0.5 - (np.arange(H) + 0.5) / H) * 2 * radius
    xx, yy = np.meshgrid(xs, ys)
    origins_rel = (
        plane_rel[None, None]
        + xx[..., None] * right[None, None]
        + yy[..., None] * upv[None, None]
    ).reshape(-1, 3).astype(np.float32)
    dirs = np.broadcast_to(ldir64.astype(np.float32), origins_rel.shape).copy()
    return origins_rel, dirs, pv_rel, (extent * 0.5).astype(np.float32)


def light_dir(lights: LightRig) -> np.ndarray:
    """Unit float32 direction toward the directional light, rounded as the
    reference's float32 ``-d / max(|d|, 1e-12)``.  Read on the host, as the
    reference's shadow pass reads it: a direction that is a tensor on the
    card costs one small read back, and no gradient flows through it (the
    shadow rays' march and the map's compare are not differentiable)."""
    l = -host_leaf(lights.directional.direction)
    nrm = np.sqrt(np.float32(l[0] * l[0] + l[1] * l[1]) + l[2] * l[2])
    return (l / np.maximum(nrm, np.float32(1e-12))).astype(np.float32)


def light_vp(pv_rel, center) -> np.ndarray:
    """``pv_rel @ translate(-center)`` in float32, the fourth column summed
    in the fixed order of the kernels."""
    pv = np.asarray(pv_rel, dtype=np.float32)
    c = -np.asarray(center, dtype=np.float32)
    vp = pv.copy()
    vp[:, 3] = ((pv[:, 0] * c[0] + pv[:, 1] * c[1]) + pv[:, 2] * c[2]) + pv[:, 3]
    return vp


def _bundle(world: TorchWorld, lights: LightRig, H: int, W: int, margin: float):
    """(origins f32[H*W,3], dirs f32[H*W,3]) on the world's device and the
    host vp f32[4,4] of the light pass, cached."""
    w, h, d = world.dims
    cs = world.chunksize
    ldir64 = host_leaf(lights.directional.direction).astype(np.float64)
    ldir64 = ldir64 / np.linalg.norm(ldir64)
    coordmin = world.chunkcoordmin
    key = (ldir64.tobytes(), H, W, (w, h, d), float(cs), float(margin), id(coordmin),
           coordmin._version)
    cached = _shadow_bundle_cache.get(key)
    if cached is None or cached[0] is not coordmin:
        origins_rel, dirs, pv_rel, extent_half = shadow_bundle(ldir64, H, W, (w, h, d),
                                                               cs, margin)
        center = coordmin.cpu().numpy().astype(np.float32) * np.float32(cs) + extent_half
        # the entry holds the tensor, so its id is not reused while cached
        cached = (coordmin, to_device(origins_rel + center[None, :], world.device),
                  to_device(dirs, world.device), light_vp(pv_rel, center))
        while len(_shadow_bundle_cache) >= _SHADOW_CACHE_MAX:
            _shadow_bundle_cache.pop(next(iter(_shadow_bundle_cache)))
        _shadow_bundle_cache[key] = cached
    return cached[1:]


def _hit_point(res: MarchResult, o, d):
    t_hit = torch.where(res.hit, res.t, 0.0)
    return o + d * (t_hit - EPS)[:, None]


def host_vp(vp) -> np.ndarray:
    """A light view-projection (tensor on any device, or array) as host
    float32 numpy; a CPU tensor or array is read without a device sync."""
    if isinstance(vp, torch.Tensor):
        vp = vp.detach().cpu().numpy()
    return np.asarray(vp, dtype=np.float32).reshape(4, 4)


def _check(n: int, dev, **tensors):
    """The kernels take contiguous float32 (bool for ``hit``) tensors of n
    rows on ``dev``; raise on anything else."""
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or t.shape[0] != n:
            raise ValueError(f"{name} must be a contiguous {dtype}[{n}, ...] tensor on {dev}")


def map_bias(bias_texels: float, W: int) -> float:
    """The map compare's bias in ndc z: ``bias_texels`` texels of a map W
    texels wide (a texel spans 1/(2W) along the ray), rounded to float32."""
    return float(np.float32(bias_texels / (2.0 * W)))


# ---- ray_prep -----------------------------------------------------------------

def ray_prep_plain(res: MarchResult, o, d, ldir, points=None, normals=None):
    """Shadow-ray start points, directions and liveness in plain PyTorch
    ops: start = p + n*4EPS with p, n the hit point and its cell's face
    normal (or the given ``points``/``normals``)."""
    if points is None:
        points = _hit_point(res, o, d)
        normals = cube_normal(points, res.cell_bmin,
                              res.cell_bmin + res.cell_size[:, None])
    start = points + normals * (4 * EPS)
    dirs = torch.as_tensor(ldir, device=start.device).expand(start.shape).contiguous()
    return start, dirs, res.hit.to(torch.int32)


def ray_prep(res: MarchResult, o, d, ldir, points=None, normals=None):
    """(start f32[N,3], dirs f32[N,3], live i32[N]) of the shadow rays.  On
    CUDA tensors this launches K3's ray_prep; on CPU tensors it runs
    :func:`ray_prep_plain`."""
    if not res.hit.is_cuda:
        return ray_prep_plain(res, o, d, ldir, points, normals)
    n = res.hit.shape[0]
    dev = res.hit.device
    f32 = torch.float32
    _check(n, dev, hit=(res.hit, torch.bool), t=(res.t, f32), cell_bmin=(res.cell_bmin, f32),
           cell_size=(res.cell_size, f32), o=(o, f32), d=(d, f32), points=(points, f32),
           normals=(normals, f32))
    if (points is None) != (normals is None) or (points is None and (o is None or d is None)):
        raise ValueError("ray_prep needs points and normals, or the rays o and d")
    start = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
    live = torch.empty(n, dtype=torch.int32, device=dev)
    lx, ly, lz = (float(v) for v in np.asarray(ldir, dtype=np.float32))
    RAY_PREP_KERNEL(
        ptr(res.hit), ptr(res.t), ptr(res.cell_bmin), ptr(res.cell_size), ptr(o), ptr(d),
        ptr(points), ptr(normals), lx, ly, lz, n, ptr(start), ptr(dirs), ptr(live),
    )
    return start, dirs, live


# ---- shadow_resolve -------------------------------------------------------------

def shadow_resolve_plain(o, d, hit, t, vp):
    """Along-ray ndc-z of the light bundle (1.0 where it missed), plain."""
    return light_depth_plain(o, d, hit, t, host_vp(vp)[2])


def shadow_resolve(o, d, hit, t, vp):
    """f32[N] light depth; K3's shadow_resolve on CUDA tensors."""
    if not o.is_cuda:
        return shadow_resolve_plain(o, d, hit, t, vp)
    f32 = torch.float32
    _check(o.shape[0], o.device, o=(o, f32), d=(d, f32), hit=(hit, torch.bool), t=(t, f32))
    depth = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    SHADOW_RESOLVE_KERNEL(ptr(o), ptr(d), ptr(hit), ptr(t), c_floats(host_vp(vp).reshape(16)),
                          o.shape[0], ptr(depth))
    return depth


# ---- map_project ------------------------------------------------------------------

def map_shadow_plain(points, shadow_depth, vp, bias_texels: float = 4.0, hit=None):
    """The map-shadow factor in plain PyTorch ops: project ``points`` into
    the light, compare their ndc z with the depth map's nearest texel plus
    ``bias_texels`` texels of depth, and multiply by ``hit`` when given."""
    H, W = shadow_depth.shape
    vp = host_vp(vp)
    cx, cy, cz, cw = (vp_row(points, vp[i]) for i in range(4))
    den = torch.clamp_min(cw.abs(), 1e-12)
    sg = torch.sign(cw)
    u = (cx / den * sg) * 0.5 + 0.5
    v = (cy / den * sg) * 0.5 + 0.5
    nz = cz / den * sg
    # clamp-then-truncate equals the reference's truncate-then-clip for
    # every finite value
    xi = torch.clamp(u * float(W), 0.0, W - 1).to(torch.int64)
    yi = torch.clamp((1.0 - v) * float(H), 0.0, H - 1).to(torch.int64)
    pixel_z = shadow_depth.reshape(-1)[yi * W + xi]
    bias = map_bias(bias_texels, W)
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    shadowed = inside & (nz > pixel_z + bias)
    if hit is not None:
        shadowed = shadowed & hit
    return shadowed.to(torch.float32)


def map_project_plain(res: MarchResult, o, d, shadow_depth, vp, bias_texels: float = 4.0):
    """render()'s map-shadow factor in plain PyTorch ops: the hit points
    projected against the depth map, times the hit mask."""
    return map_shadow_plain(_hit_point(res, o, d), shadow_depth, vp, bias_texels, res.hit)


def _map_project_cuda(points, o, d, hit, t, shadow_depth, vp, bias_texels):
    n = (points if points is not None else o).shape[0]
    H, W = shadow_depth.shape
    dev = shadow_depth.device
    f32 = torch.float32
    _check(n, dev, points=(points, f32), o=(o, f32), d=(d, f32), hit=(hit, torch.bool),
           t=(t, f32))
    _check(H, dev, shadow_depth=(shadow_depth, f32))
    factor = torch.empty(n, dtype=torch.float32, device=dev)
    MAP_PROJECT_KERNEL(ptr(points), ptr(o), ptr(d), ptr(hit), ptr(t), ptr(shadow_depth), H, W,
                       c_floats(host_vp(vp).reshape(16)), map_bias(bias_texels, W), n,
                       ptr(factor))
    return factor


def map_project(res: MarchResult, o, d, shadow_depth, vp, bias_texels: float = 4.0):
    """f32[N] map-shadow factor of the hit points of ``res``; K3's
    map_project on CUDA tensors."""
    if not res.hit.is_cuda:
        return map_project_plain(res, o, d, shadow_depth, vp, bias_texels)
    return _map_project_cuda(None, o, d, res.hit, res.t, shadow_depth, vp, bias_texels)


def map_shadow(points, shadow_depth, light_vp, bias_texels: float = 4.0, device="cuda"):
    """Project points into the light and compare along-ray depths (the
    reference's computeShadow).  The compare is in ortho ndc z, the depth
    render_shadowmap stores; ``bias_texels`` is in units of the map's own
    texel, whose footprint along the ray is 1/(2W) of ndc z.  ``points`` and
    ``shadow_depth`` go to ``device``: on ``cuda`` this launches K3's
    map_project, ``device="cpu"`` runs :func:`map_shadow_plain`."""
    dev = resolve_device(device)
    points = to_device(points, dev)
    shadow_depth = to_device(shadow_depth, dev)
    vp = host_vp(light_vp)
    if not points.is_cuda:
        return map_shadow_plain(points, shadow_depth, vp, bias_texels)
    return _map_project_cuda(points, None, None, None, None, shadow_depth, vp, bias_texels)


# ---- the light pass and the ray shadow -------------------------------------------

def render_shadowmap(world: TorchWorld, lights: LightRig, resolution=(512, 512),
                     margin: float = 1.1, tile: int = 65536, max_steps: int = 512,
                     compact: bool = False, compact_tile: int = 8192,
                     assume_resident: bool = False):
    """Depth-from-the-light pass: an ortho camera at the directional light
    over the world bounds, storing along-ray ndc z.  Returns (depth
    f32[H,W] on the world's device, light_vp f32[4,4] on the host: the
    kernels take it by value).

    One launch of K1 with its light-depth epilogue over the whole bundle
    (ops/march.py ``march_depth``; on the CPU its plain version,
    :func:`shadow_resolve_plain` of ``march_plain``).  ``tile``,
    ``compact`` and ``compact_tile`` are accepted for callers of the
    reference and ignored: they chose among TPU schedules of the same
    depth map, and ``compact=True`` does not return the reference's
    executed-lane count."""
    H, W = resolution
    origins, dirs, vp = _bundle(world, lights, H, W, margin)
    depth = march_depth(world, origins, dirs, vp[2], max_steps,
                        assume_resident=assume_resident, device=world.device)
    return depth.reshape(H, W), torch.from_numpy(vp)


def ray_shadow(world: TorchWorld, res: MarchResult, points, normals, lights: LightRig, cfg):
    """Hard shadow by marching from each hit toward the directional light.
    Miss pixels start their shadow ray dead.  The shadow march checks chunk
    residency whatever ``cfg.assume_resident`` says, as the reference's
    does."""
    dev = res.hit.device
    points = to_device(points, dev)
    normals = to_device(normals, dev)
    start, dirs, live = ray_prep(res, None, None, light_dir(lights), points, normals)
    sres = march(world, start, dirs, cfg.max_steps, live_start=live, device=dev)
    return (res.hit & sres.hit).to(torch.float32)


__all__ = ["shadow_bundle", "render_shadowmap", "map_shadow", "ray_shadow",
           "ray_prep", "ray_prep_plain", "shadow_resolve", "shadow_resolve_plain",
           "map_project", "map_project_plain", "map_shadow_plain", "light_dir", "light_vp", "host_vp",
           "map_bias",
           "RAY_PREP_KERNEL", "SHADOW_RESOLVE_KERNEL", "MAP_PROJECT_KERNEL"]
