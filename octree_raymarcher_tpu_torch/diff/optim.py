"""Inverse rendering: fit per-voxel density and albedo to target views.

PyTorch counterpart of octree_raymarcher_tpu/diff/optim.py: target images
rendered by the hard renderer, then Adam on the per-view L2 photometric
loss, which differentiates through composite() (K5 forward, K6 backward)
down to every voxel parameter.  ``torch.optim.Adam`` takes the place of
``optax.adam`` with the same defaults (betas 0.9/0.999, eps 1e-8).

Under ``torch.profiler`` :func:`sample_views` records the span
``fit.sample`` and :func:`photometric_loss` ``fit.loss``, around the
``fit.composite`` (with ``fit.background``) of each view; the backward
records ``fit.composite_bwd`` (diff/composite.py).
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from ..world.device import resolve_device, to_device
from .composite import VoxelParams, composite
from .segments import sample_segments_frame
from .segments_compact import sample_segments_compact


def sample_views(world, views, max_segments: int = 32, max_steps: int = 512,
                 tile: int = 65536, compact: bool = False, device="cuda"):
    """views: list of (origins, dirs, target_rgb).  Samples segments once
    (geometry is fixed while the params are optimised), so each step is
    pure compositing.  Returns a list of (segments, target) pairs.  One K4
    launch samples a view; ``compact=True`` samples it with the
    stage-compacted sampler (diff/segments_compact.py, K9 and K10), segment
    for segment the same.  ``tile`` is accepted for callers of the
    reference and ignored."""
    dev = resolve_device(device)
    cached = []
    with span("fit.sample"):
        for o, d, target in views:
            if compact:
                segs, _ = sample_segments_compact(world, o, d, max_segments, max_steps,
                                                  device=dev)
            else:
                segs = sample_segments_frame(world, o, d, max_segments, max_steps, device=dev)
            cached.append((segs, to_device(target, dev)))
    return cached


def photometric_loss(params: VoxelParams, cached):
    """Mean per-view L2 photometric loss over pre-sampled (segs, target)."""
    with span("fit.loss"):
        total = 0.0
        for segs, target in cached:
            out = composite(segs, params)
            total = total + torch.mean((out["rgb"] - target) ** 2)
        return total / len(cached)


def make_loss_fn(world, views, max_segments: int = 32, max_steps: int = 512, device="cuda"):
    """Closure form of (sample_views + photometric_loss)."""
    cached = sample_views(world, views, max_segments, max_steps, device=device)
    return lambda params: photometric_loss(params, cached)


def fit(world, views, params0: VoxelParams, steps: int = 100, lr: float = 0.05,
        max_segments: int = 32, compact: bool = False, device="cuda"):
    """Run Adam on the photometric loss; returns (params, loss_history).
    ``compact=True`` samples the views with the stage-compacted sampler (the
    same segments, so the same history).  The losses are read back after
    the last step."""
    cached = sample_views(world, views, max_segments, compact=compact, device=device)
    leaves = [params0.density_raw.detach().clone().requires_grad_(True),
              params0.albedo_raw.detach().clone().requires_grad_(True)]
    params = VoxelParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=lr)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = photometric_loss(params, cached)
        loss.backward()
        opt.step()
        history.append(loss.detach())
    out = VoxelParams(density_raw=leaves[0].detach(), albedo_raw=leaves[1].detach())
    return out, [float(v) for v in history]


def optimizer_step(optimizer, opt_state, values, grads):
    """One step of an optimizer held as state: ``opt_state`` (built by the
    factory ``optimizer`` over copies of ``values`` when None) takes
    ``values`` into its own tensors and ``grads`` as their gradients, and
    steps.  Returns (its tensors, opt_state); the tensors passed in are not
    changed."""
    if opt_state is None:
        opt_state = optimizer([v.detach().clone() for v in values])
    leaves = [p for group in opt_state.param_groups for p in group["params"]]
    with torch.no_grad():
        for leaf, v, g in zip(leaves, values, grads, strict=True):
            leaf.copy_(v)
            leaf.grad = g
    opt_state.step()
    for leaf in leaves:
        leaf.grad = None
    return leaves, opt_state


__all__ = ["sample_views", "photometric_loss", "make_loss_fn", "fit", "optimizer_step"]
