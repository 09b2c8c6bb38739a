"""Ray-sharded rendering and training over a torch.distributed process group.

PyTorch counterpart of octree_raymarcher_tpu/parallel/render_sharded.py.
The reference shards the ray batch over its ``rays`` mesh axis with
``shard_map``; here every rank is given the whole batch and takes its
contiguous block (:meth:`RayMesh.ray_block`), the world's pools and the
voxel parameters are whole on every rank, and:

* the forward entry points run the port's ``render``/``march`` on the block
  (kernels K1 and K2, plus the shadow kernels when ``render_kwargs`` ask)
  and gather the rows with ``all_gather_into_tensor``, so every rank returns
  the global arrays, as the reference's ``P(RAYS_AXIS)`` outputs give;
* the train steps sample segments (K4) and composite (K5, backward K6) tile
  by tile on the block, sum the squared rgb error, and sum the gradients
  over the ranks with ``all_reduce`` (``reduce_scatter_tensor`` for ZeRO)
  before the optimizer steps; loss and gradients are divided by the padded
  global ray count, as the reference's.

The batch must split evenly over the ranks (:func:`pad_rays` pads it).

Spans (utils/metrics.py ``span``, recorded only under ``torch.profiler``):
each train step is one ``fit.shard_step``; each collective's launch one
``fit.allreduce`` (the gradients' ``all_reduce`` or ``reduce_scatter_tensor``,
the loss's ``all_reduce``, and the ``all_gather_into_tensor`` of the
renders, the marches and the ZeRO step's params); the waits on a step's
asynchronous collectives one ``fit.allreduce_wait``.  Every collective adds
the bytes handed to it to ``Collectives.total_bytes``, which each span
records.

Optimizer.  The reference takes an optax transform; here ``optimizer`` is a
factory of ``torch.optim.Optimizer`` over a list of tensors, for example
``functools.partial(torch.optim.Adam, lr=1e-2)`` (Adam's defaults, betas
0.9/0.999 and eps 1e-8, as diff/optim.py uses).  The optimizer state
``opt_state`` is such an optimizer built over its own copy of the params
(for ZeRO, of this rank's slice of them).  A step copies the params it is
given into it, steps it and returns new param tensors, so the call keeps the
reference's shape ``train_step(params, opt_state, world, origins, dirs,
targets) -> (params, opt_state, loss)`` and never changes the params passed
in.  The state is updated in place and returned.  ``opt_state=None`` starts
a fresh one.  The ZeRO step's optimizer must update element by element, as
Adam does, since each rank steps only its slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..diff.composite import SKY, VoxelParams, composite
from ..diff.optim import optimizer_step
from ..diff.segments import sample_segments
from ..ops.march import march
from ..ops.march_compact import default_schedule, march_frame_compact
from ..shade.render import render
from ..utils.metrics import Collectives, span
from ..world.device import to_device
from .mesh import RayMesh


def pad_rays(origins, dirs, n_shards: int):
    """Pad the ray batch to a multiple of n_shards with away-pointing rays."""
    n = origins.shape[0]
    pad = (-n) % n_shards
    if pad == 0:
        return origins, dirs, n
    o = np.concatenate([origins, np.full((pad, 3), 1e8, dtype=np.float32)])
    d = np.concatenate([dirs, np.tile(np.array([[0, 1, 0]], np.float32), (pad, 1))])
    return o, d, n


def _block(x, mesh: RayMesh, dtype=torch.float32) -> torch.Tensor:
    """This rank's rows of a global batch (numpy or a tensor), on its device."""
    return to_device(x[mesh.ray_block(x.shape[0])], mesh.device, dtype)


def _gather_rows(mesh: RayMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along the first axis in rank order."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with span("fit.allreduce"):
        Collectives.add(x)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def _all_reduce(mesh: RayMesh, x: torch.Tensor, async_op: bool = False):
    """Sum ``x`` over the ranks in place; the work handle when ``async_op``."""
    with span("fit.allreduce"):
        Collectives.add(x)
        return dist.all_reduce(x, group=mesh.group, async_op=async_op)


def _reduce_scatter(mesh: RayMesh, out: torch.Tensor, x: torch.Tensor):
    """Sum ``x`` over the ranks into this rank's slice ``out``,
    asynchronously; returns the work handle."""
    with span("fit.allreduce"):
        Collectives.add(x)
        return dist.reduce_scatter_tensor(out, x, group=mesh.group, async_op=True)


def _wait(works) -> None:
    """Make the current stream wait for every collective in ``works``."""
    with span("fit.allreduce_wait"):
        for work in works:
            work.wait()


def _sky(mesh: RayMesh) -> torch.Tensor:
    """The constant sky colour on the rank's device, made once per train
    step function: handed to ``composite`` as its background, it costs no
    copy from the host (and no wait on the stream) a tile."""
    return torch.tensor(SKY, dtype=torch.float32, device=mesh.device)


def render_sharded(mesh: RayMesh, world, origins, dirs, eye, **render_kwargs):
    """Forward render with rays sharded across the mesh; pools replicated.

    Returns ONLY the rgb AOV (f32[N,3], on the rank's device); use
    render()/render_frame() when the full AOV dict is needed.
    ``render_kwargs`` go to ``render`` (``cfg``, ``lights``, ``materials``,
    ``atlas``, ``envmap``, ``shadowmap``).  ``cfg.tile`` is accepted and
    ignored: the reference cut a shard into sub-tiles so that each TPU loop
    exits at its own worst ray; one launch per shard gives the same output."""
    out = render(world, _block(origins, mesh), _block(dirs, mesh), eye, device=mesh.device,
                 **render_kwargs)
    return _gather_rows(mesh, out["rgb"])


def render_frame_sharded(mesh: RayMesh, world, origins, dirs, eye, tile: int = 65536,
                         **render_kwargs):
    """Host-tiled + ray-sharded frame: the batch is cut into groups of
    ``mesh.size * tile`` rays (the last padded with away-pointing rays from
    1e9), each group one :func:`render_sharded` call; returns the rgb AOV of
    the ``n`` rays given."""
    o = torch.as_tensor(origins, dtype=torch.float32)
    d = torch.as_tensor(dirs, dtype=torch.float32)
    n = o.shape[0]
    group = mesh.size * int(tile)
    pad = (-n) % group
    if pad:
        o = torch.cat([o, torch.full((pad, 3), 1e9, dtype=torch.float32, device=o.device)])
        away = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=d.device)
        d = torch.cat([d, away.expand(pad, 3)])
    outs = [render_sharded(mesh, world, o[i:i + group], d[i:i + group], eye, **render_kwargs)
            for i in range(0, o.shape[0], group)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:n]


def march_sharded(mesh: RayMesh, world, origins, dirs, max_steps: int = 512):
    """Sharded forward march returning (hit, t, material) per ray, gathered
    in one collective (t travels as its int32 bits)."""
    res = march(world, _block(origins, mesh), _block(dirs, mesh), max_steps,
                device=mesh.device)
    rows = torch.stack([res.hit.to(torch.int32), res.t.view(torch.int32), res.material], dim=1)
    full = _gather_rows(mesh, rows)
    return (full[:, 0] != 0, full[:, 1].contiguous().view(torch.float32),
            full[:, 2].contiguous())


def march_sharded_compact(mesh: RayMesh, world, origins, dirs, max_steps: int = 512,
                          tile: int = 8192, stride: int = 16, schedule=None):
    """Sharded forward march with each rank's block stage-compacted
    (ops/march_compact.py: K9 and K10 on its own rays).  Returns (hit, t,
    material, executed) per ray, as :func:`march_sharded` (bit for bit the
    same), with ``executed`` int64[ranks]: each rank's lane_iters, gathered
    in the same collective as the rows (as two int32 words in one extra row
    a rank).  ``tile`` is accepted for callers of the reference and
    ignored."""
    if schedule is None:
        schedule = default_schedule(max_steps, stride)
    res, executed = march_frame_compact(world, _block(origins, mesh), _block(dirs, mesh),
                                        max_steps, schedule=schedule, device=mesh.device)
    rows = torch.stack([res.hit.to(torch.int32), res.t.view(torch.int32), res.material], dim=1)
    words = torch.zeros((1, 3), dtype=torch.int32, device=rows.device)
    words[0, :2] = executed.reshape(1).view(torch.int32)
    full = _gather_rows(mesh, torch.cat([rows, words])).view(mesh.size, rows.shape[0] + 1, 3)
    ray_rows = full[:, :-1].reshape(-1, 3)
    executed = full[:, -1, :2].reshape(-1).contiguous().view(torch.int64)
    return (ray_rows[:, 0] != 0, ray_rows[:, 1].contiguous().view(torch.float32),
            ray_rows[:, 2].contiguous(), executed)


def _tile_loss_grad(world, params: VoxelParams, o, d, target, max_segments: int, sky):
    """Sum of squared rgb error over one tile of rays and its gradient in
    (density_raw, albedo_raw): K4 (no grad), K5, then K6.  ``sky`` is the
    background f32[3] on the tile's device."""
    segs = sample_segments(world, o, d, max_segments, device=o.device)
    leaves = [params.density_raw.detach().requires_grad_(True),
              params.albedo_raw.detach().requires_grad_(True)]
    out = composite(segs, VoxelParams(*leaves), sky_rgb=sky)
    loss = ((out["rgb"] - target) ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _leaves(params: VoxelParams) -> list:
    return [params.density_raw, params.albedo_raw]


def _tiles(nloc: int, grad_tiles: int):
    """The reference's tile bounds over a block of ``nloc`` rays."""
    ntiles = max(1, min(grad_tiles, nloc))
    bounds = [round(i * nloc / ntiles) for i in range(ntiles + 1)]
    return [slice(bounds[i], bounds[i + 1]) for i in range(ntiles)]


def _all_sum(mesh: RayMesh, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(1)
    _all_reduce(mesh, x)
    return x.reshape(())


def make_sharded_train_step(mesh: RayMesh, world, optimizer, max_segments: int = 32,
                            overlap: bool = False, grad_tiles: int = 4):
    """Returns a train step: rays+targets sharded, params replicated,
    per-voxel grads all-reduced over the ranks before the optimizer update.

    Both modes split each rank's block into ``grad_tiles`` sequential tiles
    and sample segments per tile, as the reference does.
    ``overlap=False``: the tiles' gradients accumulate locally, then one
    blocking ``all_reduce`` per gradient.  ``overlap=True``: each tile's
    gradients are all-reduced asynchronously as soon as its backward ends,
    so the collective runs under the next tile's sampling and backward;
    every one is waited before the sum is read.  The gradients are the same
    sum, grouped per tile, so the two modes agree to ~1e-6 relative, not bit
    for bit (K6 also sums with atomics).  ``world`` is accepted for the
    reference's signature; the step marches the world it is given."""
    sky = _sky(mesh)

    def train_step(params: VoxelParams, opt_state, world_, origins, dirs, targets):
        with span("fit.shard_step"):
            n = origins.shape[0]
            o, d = _block(origins, mesh), _block(dirs, mesh)
            t = _block(targets, mesh)
            loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
            tile_grads, works = [], []
            for sl in _tiles(o.shape[0], grad_tiles):
                li, gi = _tile_loss_grad(world_, params, o[sl], d[sl], t[sl], max_segments, sky)
                if overlap:
                    works += [_all_reduce(mesh, g, async_op=True) for g in gi]
                loss = loss + li
                tile_grads.append(gi)
            _wait(works)
            grads = [functools.reduce(torch.add, gs) for gs in zip(*tile_grads)]
            if not overlap:
                for g in grads:
                    _all_reduce(mesh, g)
            loss = _all_sum(mesh, loss) / n
            leaves, opt_state = optimizer_step(optimizer, opt_state, _leaves(params),
                                               [g / n for g in grads])
            return VoxelParams(*(leaf.detach().clone() for leaf in leaves)), opt_state, loss

    return train_step


def _shard_pad(x: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Pad the leading axis to a multiple of n_dev (for reduce_scatter)."""
    pad = (-x.shape[0]) % n_dev
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def make_zero_train_step(mesh: RayMesh, world, optimizer, max_segments: int = 32,
                         grad_tiles: int = 4):
    """ZeRO-1-style sharded-optimizer train step: each tile's voxel grads,
    padded to a multiple of the rank count along the slot axis, are
    reduce-scattered asynchronously as the tile loop runs; every rank steps
    the optimizer on its 1/D slice of the params (its optimizer state holds
    only that slice), and the updated slices are all-gathered back to whole
    params.

    Returns (init_opt_state, train_step):
      init_opt_state(params) -> the optimizer over this rank's slice;
      train_step(params, opt_state, world, origins, dirs, targets)
        -> (params, opt_state, loss).

    Matches make_sharded_train_step up to the regrouping of the gradient
    sums (~1e-6 relative)."""
    n_dev = mesh.size
    sky = _sky(mesh)

    def my_shard(x: torch.Tensor) -> torch.Tensor:
        xp = _shard_pad(x, n_dev)
        sz = xp.shape[0] // n_dev
        return xp[mesh.rank * sz:(mesh.rank + 1) * sz]

    def init_opt_state(params: VoxelParams):
        return optimizer([my_shard(p).detach().clone() for p in _leaves(params)])

    def train_step(params: VoxelParams, opt_state, world_, origins, dirs, targets):
        with span("fit.shard_step"):
            o, d = _block(origins, mesh), _block(dirs, mesh)
            t = _block(targets, mesh)
            n_total = o.shape[0] * n_dev
            loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
            tile_shards, works, padded = [], [], []
            for sl in _tiles(o.shape[0], grad_tiles):
                li, gi = _tile_loss_grad(world_, params, o[sl], d[sl], t[sl], max_segments, sky)
                shards = []
                for g in gi:
                    gp = _shard_pad(g, n_dev)
                    out = gp.new_empty((gp.shape[0] // n_dev,) + tuple(gp.shape[1:]))
                    works.append(_reduce_scatter(mesh, out, gp))
                    padded.append(gp)       # alive until its collective is waited
                    shards.append(out)
                loss = loss + li
                tile_shards.append(shards)
            _wait(works)
            gshard = [functools.reduce(torch.add, gs) / n_total for gs in zip(*tile_shards)]
            loss = _all_sum(mesh, loss) / n_total
            leaves, opt_state = optimizer_step(optimizer, opt_state,
                                               [my_shard(p) for p in _leaves(params)], gshard)
            full = [_gather_rows(mesh, leaf.detach())[:p.shape[0]]
                    for leaf, p in zip(leaves, _leaves(params), strict=True)]
            return VoxelParams(*full), opt_state, loss

    return init_opt_state, train_step


__all__ = [
    "pad_rays",
    "render_sharded",
    "render_frame_sharded",
    "march_sharded",
    "march_sharded_compact",
    "make_sharded_train_step",
    "make_zero_train_step",
]
