"""Soft voxel compositing: the differentiable half of the renderer.

PyTorch counterpart of octree_raymarcher_tpu/diff/composite.py.  Alpha-
composites the segments of diff/segments.py under per-voxel density and
albedo parameters:

    sigma_i = softplus(density_raw[slot_i])
    alpha_i = 1 - exp(-sigma_i * (t1_i - t0_i))
    w_i     = alpha_i * prod_{j<i} (1 - alpha_j)
    rgb     = sum_i w_i * sigmoid(albedo_raw[slot_i]) + T_end * sky
    depth   = sum_i w_i * midpoint_i  (+ T_end * far)

:func:`composite` is a ``torch.autograd.Function``: on CUDA tensors its
forward is kernel K5 and its backward kernel K6 (csrc/composite.cu); on CPU
tensors they are :func:`composite_plain` and
:func:`composite_backward_plain`, the same formulas in the kernels' order.
The exclusive prefix of the transmittance is ``cumsum(tau) - tau`` and the
softplus is ``logaddexp(x, 0)``, as in the reference.  Both kernels walk
tiles of consecutive rays staged in shared memory; :func:`composite_plan`
sizes the tiles for a given K.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import Kernel, ptr
from ..world.device import TorchWorld, resolve_device, to_device
from .segments import SegmentBatch

COMPOSITE_FWD_KERNEL = Kernel("ort_composite_fwd")
COMPOSITE_BWD_KERNEL = Kernel("ort_composite_bwd")
SKY = (0.45, 0.65, 0.95)

SMEM_DEFAULT = 48 * 1024  # a block's shared memory without raising the kernel's limit
HOT_SLOTS = 8           # the coarse-LEAF slots K6 sums on chip: init_params_from_world's
                        # num_materials, the last slots of the layout
TILE_RAYS = 64          # rays per tile = threads per block (csrc/composite.cu kRays)
CHUNK = 16              # columns of a row staged at once (kChunk)


@dataclasses.dataclass(frozen=True)
class CompositePlan:
    """How K5 or K6 tiles the [N, K] segments (csrc/composite.cu)."""
    rays: int     # rays per tile = threads per block, whole warps
    chunk: int    # columns of a row staged at once (the whole row when K <= CHUNK)
    smem: int     # bytes of dynamic shared memory per block
    prefix_on_chip: bool = True   # K6: prefix sums in shared memory, else global scratch


def _smem_bytes(chunk: int, K: int, arrays: int, backward: bool,
                prefix_on_chip: bool = True) -> int:
    """csrc/composite.cu smem_floats, in bytes: ``arrays`` planes of
    TILE_RAYS x (chunk | 1); K5's weight plane; K6's prefix sums (TILE_RAYS
    x (K | 1), when on chip), hot table and per-warp exchange buffer."""
    floats = arrays * TILE_RAYS * (chunk | 1)
    if not backward:
        return 4 * (floats + TILE_RAYS * (chunk | 1))
    if prefix_on_chip:
        floats += TILE_RAYS * (K | 1)
    return 4 * (floats + 4 * HOT_SLOTS + 4 * TILE_RAYS)


def composite_plan(K: int, backward: bool, g_weights: bool = False) -> CompositePlan:
    """The launch plan of K5 (``backward=False``) or K6 for rows of K
    segments; ``g_weights`` says K6 stages an upstream dL/dweights too.

    Tiles of 64 rays with rows staged 16 columns at a time in one buffer:
    a block needs ~23 KB and about nine blocks share an SM, which on the
    H100 beat double-buffered whole rows (fewer, larger blocks) at the
    training path's K = 32 (PERF.md).  K6 keeps its prefix sums in
    shared memory while the block stays within 48 KB (K up to ~120), else
    in a global scratch, so that a long row costs no blocks per SM.  Every
    K >= 0 has a plan."""
    arrays = 4 if backward and g_weights else 3
    chunk = min(max(int(K), 1), CHUNK)
    on_chip = _smem_bytes(chunk, K, arrays, backward) <= SMEM_DEFAULT
    return CompositePlan(TILE_RAYS, chunk, _smem_bytes(chunk, K, arrays, backward, on_chip),
                         on_chip)


@dataclasses.dataclass
class VoxelParams:
    density_raw: torch.Tensor   # f32[P]    softplus -> density
    albedo_raw: torch.Tensor    # f32[P,3]  sigmoid -> color

    @property
    def num_slots(self) -> int:
        return self.density_raw.shape[0]

    @staticmethod
    def from_numpy(density_raw, albedo_raw, device="cuda") -> "VoxelParams":
        """Carry parameters across, e.g. the JAX package's VoxelParams
        leaves as numpy arrays."""
        dev = resolve_device(device)
        return VoxelParams(
            density_raw=torch.from_numpy(np.array(density_raw, dtype=np.float32)).to(dev),
            albedo_raw=torch.from_numpy(np.array(albedo_raw, dtype=np.float32)).to(dev))

    def to_numpy(self):
        """(density_raw, albedo_raw) as float32 numpy arrays."""
        return (self.density_raw.detach().cpu().numpy(),
                self.albedo_raw.detach().cpu().numpy())


def init_params_from_world(world: TorchWorld, materials=None, solid_density: float = 40.0,
                           num_materials: int = 8) -> VoxelParams:
    """Params under which the soft render approximates the hard render:
    solid voxels opaque with their material's diffuse color, empty voxels
    transparent.  Material ids are clipped in the pool's unsigned range
    (the int32 pool view widened with ``& 0xFFFFFFFF``), so a word >= 2^31
    maps to the last table row, as in the reference."""
    from ..shade.materials import MaterialTable

    materials = MaterialTable.default() if materials is None else materials
    dev = world.device
    twig = world.twig.to(torch.int64) & 0xFFFFFFFF
    mats = torch.cat([twig, torch.arange(num_materials, dtype=torch.int64, device=dev)])
    solid = mats != 0
    # softplus^-1 of the scalar target density (host float math only)
    dr_solid = float(np.log(np.expm1(max(float(solid_density), 1e-6))))
    density_raw = torch.where(solid, dr_solid, -8.0).to(torch.float32)
    diffuse = materials.diffuse.to(device=dev, dtype=torch.float32)
    mc = torch.clamp_max(mats, diffuse.shape[0] - 1)
    # the logit of each table row, then gathered per slot: the same values as
    # the reference's logit of the gathered colours, in one small op (a
    # CPU op over every slot runs in threads, and a thread's share has been
    # seen to come out of torch.log some 1e-4 off)
    c = torch.clamp(diffuse, 1e-4, 1 - 1e-4)
    albedo_raw = torch.log(c / (1 - c)).to(torch.float32)[mc]
    return VoxelParams(density_raw=density_raw, albedo_raw=albedo_raw.contiguous())


def _background(sky, sky_rgb, like):
    if sky_rgb is not None:
        return to_device(sky_rgb, like.device)
    return torch.tensor([float(v) for v in sky], dtype=torch.float32, device=like.device)


def composite_plain(slot, t0, t1, density_raw, albedo_raw, bg, far: float = 8192.0):
    """K5 in plain PyTorch ops, segment by segment in the kernel's order.
    ``bg`` is f32[3] or f32[N,3].  Returns (rgb, depth, opacity, weights);
    differentiable by torch.autograd."""
    n, K = slot.shape
    valid = slot >= 0
    sc = slot.clamp(0, density_raw.shape[0] - 1).long()
    x = density_raw[sc]
    sigma = torch.logaddexp(x, torch.zeros_like(x))
    tau = torch.where(valid, sigma * torch.clamp_min(t1 - t0, 0.0), 0.0)
    albedo = torch.sigmoid(albedo_raw[sc])                     # [N, K, 3]
    mid = 0.5 * (t0 + t1)
    csum = torch.zeros(n, dtype=torch.float32, device=slot.device)
    tau_sum = torch.zeros_like(csum)
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=slot.device)
    depth = torch.zeros_like(csum)
    weights = []
    for k in range(K):
        alpha = 1.0 - torch.exp(-tau[:, k])
        csum = csum + tau[:, k]
        w = alpha * torch.exp(-(csum - tau[:, k]))
        rgb = rgb + albedo[:, k] * w[:, None]
        depth = depth + w * mid[:, k]
        tau_sum = tau_sum + tau[:, k]
        weights.append(w)
    t_end = torch.exp(-tau_sum)
    rgb = rgb + t_end[:, None] * bg
    depth = depth + t_end * far
    weights = torch.stack(weights, dim=1) if weights else torch.zeros((n, 0), device=slot.device)
    return rgb, depth, 1.0 - t_end, weights


def composite_backward_plain(slot, t0, t1, density_raw, albedo_raw, bg, far, g_rgb, g_depth,
                             g_opacity, g_weights):
    """K6's formulas in plain PyTorch ops, in its order: recompute the
    prefix sums, then a reverse pass with the suffix sum of the prefix
    cotangents.  Upstream gradients may be None.  Returns (d_density_raw
    f32[P], d_albedo_raw f32[P,3], d_bg f32[N,3])."""
    n, K = slot.shape
    dev = slot.device
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    g_rgb = torch.zeros((n, 3), device=dev) if g_rgb is None else g_rgb
    g_depth = zeros if g_depth is None else g_depth
    g_opacity = zeros if g_opacity is None else g_opacity
    valid = slot >= 0
    sc = slot.clamp(0, density_raw.shape[0] - 1).long()
    x = density_raw[sc]
    sigma = torch.logaddexp(x, torch.zeros_like(x))
    dl = torch.clamp_min(t1 - t0, 0.0)
    tau = torch.where(valid, sigma * dl, 0.0)
    albedo = torch.sigmoid(albedo_raw[sc])
    mid = 0.5 * (t0 + t1)
    csum, tau_sum, prefix = zeros, zeros, []
    for k in range(K):
        csum = csum + tau[:, k]
        tau_sum = tau_sum + tau[:, k]
        prefix.append(csum)
    t_end = torch.exp(-tau_sum)
    bg_n = bg.expand(n, 3)
    g_end = ((g_rgb[:, 0] * bg_n[:, 0] + g_rgb[:, 1] * bg_n[:, 1]) + g_rgb[:, 2] * bg_n[:, 2]
             + g_depth * far - g_opacity)
    d_bg = g_rgb * t_end[:, None]
    d_density = torch.zeros_like(density_raw)
    d_albedo = torch.zeros_like(albedo_raw)
    R = zeros
    for k in range(K - 1, -1, -1):
        e = torch.exp(-tau[:, k])
        alpha = 1.0 - e
        T = torch.exp(-(prefix[k] - tau[:, k]))
        w = alpha * T
        a = albedo[:, k]
        gw = (g_rgb[:, 0] * a[:, 0] + g_rgb[:, 1] * a[:, 1]) + g_rgb[:, 2] * a[:, 2]
        if g_weights is not None:
            gw = g_weights[:, k] + gw
        gw = gw + g_depth * mid[:, k]
        bB = -(gw * alpha) * T
        R = R + bB
        dtau = gw * T * e + (R - bB) - t_end * g_end
        v = valid[:, k]
        dx = torch.where(v, dtau * dl[:, k] * torch.exp(x[:, k] - sigma[:, k]), 0.0)
        da = torch.where(v[:, None], g_rgb * w[:, None] * (a * (1.0 - a)), 0.0)
        d_density.index_add_(0, sc[:, k], dx)
        d_albedo.index_add_(0, sc[:, k], da)
    return d_density, d_albedo, d_bg


def _composite_fwd_cuda(slot, t0, t1, density_raw, albedo_raw, bg, far):
    n, K = slot.shape
    dev = slot.device
    plan = composite_plan(K, backward=False)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(n, dtype=torch.float32, device=dev)
    opacity = torch.empty(n, dtype=torch.float32, device=dev)
    weights = torch.empty((n, K), dtype=torch.float32, device=dev)
    COMPOSITE_FWD_KERNEL(ptr(slot), ptr(t0), ptr(t1), ptr(density_raw), ptr(albedo_raw),
                         ptr(bg), int(bg.ndim == 2), float(far), n, K, density_raw.shape[0],
                         plan.smem, ptr(rgb), ptr(depth), ptr(opacity), ptr(weights))
    return rgb, depth, opacity, weights


def _composite_bwd_cuda(slot, t0, t1, density_raw, albedo_raw, bg, far, g_rgb, g_depth,
                        g_opacity, g_weights):
    """K6.  The last 8 slots (the coarse-LEAF slots of
    init_params_from_world's layout) are summed per block before their
    atomics: a hint from the layout, not a condition of correctness."""
    n, K = slot.shape
    dev = slot.device
    P = density_raw.shape[0]
    hot_lo = max(P - HOT_SLOTS, 0)
    plan = composite_plan(K, backward=True, g_weights=g_weights is not None)
    scratch = None
    if not plan.prefix_on_chip:          # prefix sums per tile in global: [tile][k][ray]
        tiles = -(-n // plan.rays)
        scratch = torch.empty(tiles * plan.rays * K, dtype=torch.float32, device=dev)
    d_density = torch.zeros_like(density_raw)
    d_albedo = torch.zeros_like(albedo_raw)
    d_bg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    grads = [None if g is None else g.contiguous() for g in (g_rgb, g_depth, g_opacity,
                                                             g_weights)]
    COMPOSITE_BWD_KERNEL(ptr(slot), ptr(t0), ptr(t1), ptr(density_raw), ptr(albedo_raw),
                         ptr(bg), int(bg.ndim == 2), float(far), n, K, P, plan.smem, hot_lo,
                         *(ptr(g) for g in grads), ptr(scratch), ptr(d_density),
                         ptr(d_albedo), ptr(d_bg))
    return d_density, d_albedo, d_bg


class _Composite(torch.autograd.Function):
    """Forward K5 / backward K6 on CUDA tensors; the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, slot, t0, t1, density_raw, albedo_raw, bg, far):
        args = (slot, t0, t1, density_raw.detach(), albedo_raw.detach(), bg.detach(), far)
        if slot.is_cuda:
            out = _composite_fwd_cuda(*args)
        else:
            with torch.no_grad():
                out = composite_plain(*args)
        ctx.save_for_backward(slot, t0, t1, density_raw, albedo_raw, bg)
        ctx.far = far
        # outputs the loss does not use arrive as None, and K6 skips them
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_opacity, g_weights):
        slot, t0, t1, density_raw, albedo_raw, bg = ctx.saved_tensors
        fn = _composite_bwd_cuda if slot.is_cuda else composite_backward_plain
        with torch.no_grad():
            d_density, d_albedo, d_bg = fn(slot, t0, t1, density_raw.detach(),
                                           albedo_raw.detach(), bg.detach(), ctx.far,
                                           g_rgb, g_depth, g_opacity, g_weights)
        if not ctx.needs_input_grad[5]:
            d_bg = None
        elif bg.ndim == 1:
            d_bg = d_bg.sum(dim=0)
        return None, None, None, d_density, d_albedo, d_bg, None


def _check_segments(segments: SegmentBatch, params: VoxelParams):
    dev = params.density_raw.device
    for name, want in (("slot", torch.int32), ("t0", torch.float32), ("t1", torch.float32)):
        t = getattr(segments, name)
        if t.device != dev or t.dtype != want or t.ndim != 2:
            raise ValueError(f"segments.{name} must be a {want}[N, K] tensor on {dev}")
    n, k = segments.slot.shape
    if segments.t0.shape != (n, k) or segments.t1.shape != (n, k):
        raise ValueError("segments.slot, t0 and t1 must share one shape [N, K]")
    p = params.num_slots
    if (params.density_raw.dtype != torch.float32 or params.albedo_raw.dtype != torch.float32
            or params.density_raw.shape != (p,) or params.albedo_raw.shape != (p, 3)
            or params.albedo_raw.device != dev):
        raise ValueError("params must be density_raw f32[P] and albedo_raw f32[P, 3] on "
                         f"{dev}")


def composite(segments: SegmentBatch, params: VoxelParams, sky=SKY, far: float = 8192.0,
              sky_rgb=None) -> dict:
    """Returns dict(rgb f32[N,3], depth f32[N], opacity f32[N], weights
    f32[N,K]), all differentiable in ``params`` (and in ``sky_rgb``, a
    per-ray background f32[N,3] that overrides the constant ``sky``)."""
    _check_segments(segments, params)
    bg = _background(sky, sky_rgb, params.density_raw)
    if bg.shape not in ((3,), (segments.slot.shape[0], 3)):
        raise ValueError(f"sky_rgb must be f32[N, 3], got {tuple(bg.shape)}")
    rgb, depth, opacity, weights = _Composite.apply(
        segments.slot.contiguous(), segments.t0.contiguous(), segments.t1.contiguous(),
        params.density_raw.contiguous(), params.albedo_raw.contiguous(), bg.contiguous(),
        float(far))
    return {"rgb": rgb, "depth": depth, "opacity": opacity, "weights": weights}


def render_soft(world: TorchWorld, params: VoxelParams, origins, dirs, max_segments: int = 32,
                max_steps: int = 512, sky=SKY, envmap=None, device="cuda") -> dict:
    """Differentiable render = gradient-free geometry sampling (K4) +
    compositing (K5/K6).  ``envmap`` (equirect f32[H,W,3]) replaces the
    constant sky, sampled by ray direction; gradients reach both the voxel
    params and the map."""
    from ..shade.envmap import sample_env
    from .segments import sample_segments

    dev = resolve_device(device)
    segs = sample_segments(world, origins, dirs, max_segments, max_steps, device=dev)
    sky_rgb = None
    if envmap is not None:
        env = envmap if isinstance(envmap, torch.Tensor) else to_device(envmap, dev)
        sky_rgb = sample_env(env, to_device(dirs, dev))
    return composite(segs, params, sky, sky_rgb=sky_rgb)


__all__ = ["VoxelParams", "init_params_from_world", "composite", "composite_plain",
           "composite_backward_plain", "composite_plan", "CompositePlan", "render_soft",
           "COMPOSITE_FWD_KERNEL", "COMPOSITE_BWD_KERNEL"]
