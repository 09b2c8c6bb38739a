"""The ray-sharded fit's global step in plain PyTorch: the loss and the
gradient as the port's ``make_sharded_train_step`` defines them, and the
first steps of Adam over them.

The entry's loss is the squared rgb error summed over the channels and over
every rank's rays, divided by the global ray count (not the per-channel
mean of ``fit.loss_and_grads``: three times it); its gradient is the sum of
the ranks' gradients over the same count.  Here each rank computes the
float64 sums of its own view (autograd through the plain composite), the
sums are gathered to rank 0 with one ``torch.distributed.gather`` a step and
added there in view order, and rank 0 steps ``fit.Adam``; its parameters are
broadcast before each step, so every rank differentiates at rank 0's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .fit import Adam, render


def view_sums(segs, target, density_raw, albedo_raw, sky, rows: int = 1 << 21,
              dtype=torch.float64):
    """(float64 sum over the view's rays and channels of the squared rgb
    error, its gradient in ``density_raw`` f64[P] and in ``albedo_raw``
    f64[P, 3]) of one view's segments (slot, t0, t1) against ``target``, in
    blocks of ``rows`` rays.  ``dtype`` is the precision of the parameters,
    the segment distances, the composite and the blocks' sums: float64 for
    the reference, bfloat16 for the control."""
    leaves = [density_raw.detach().to(dtype).requires_grad_(True),
              albedo_raw.detach().to(dtype).requires_grad_(True)]
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    grads = [torch.zeros(density_raw.shape, dtype=torch.float64, device=target.device),
             torch.zeros(albedo_raw.shape, dtype=torch.float64, device=target.device)]
    for i in range(0, target.shape[0], rows):
        s = tuple(x[i:i + rows] for x in segs)
        rgb = render(s, leaves[0], leaves[1], sky, rows)
        err = rgb - target[i:i + rows].to(rgb.dtype)
        part = (err * err).sum()
        g = torch.autograd.grad(part, leaves)
        grads[0] += g[0]
        grads[1] += g[1]
        total += part.detach().double()
    return total, grads[0], grads[1]


def global_step(rows, num_slots: int, n_rays: int):
    """(loss, d density_raw f32[P], d albedo_raw f32[P, 3]) of a global step
    from the ranks' flattened sums ``rows`` (each [1 + 4P]: the loss sum,
    then the two gradients), added in the order given, over ``n_rays``."""
    total = rows[0].clone()
    for r in rows[1:]:
        total += r
    total /= n_rays
    p = num_slots
    return (float(total[0]), total[1:1 + p].float(),
            total[1 + p:].reshape(p, 3).float())


def first_steps(views, density0, albedo0, lr: float, sky, n_rays: int, group=None,
                dtype=torch.float64):
    """The global steps over ``views``, this rank's (segments, target) of
    each step in order, from (``density0``, ``albedo0``), on every rank of
    ``group``.  Returns (losses, first gradient's norm by leaf, change's
    norm by leaf) on rank 0 and None on the others."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    root = 0 if group is None else dist.get_global_rank(group, 0)
    params = [density0.clone(), albedo0.clone()]
    adam = Adam(params, lr)
    p = density0.numel()
    losses, g1 = [], None
    for segs, target in views:
        for x in params:
            dist.broadcast(x, root, group=group)
        loss, gd, ga = view_sums(segs, target, params[0], params[1], sky, dtype=dtype)
        flat = torch.cat([loss.reshape(1), gd.reshape(-1).double(), ga.reshape(-1).double()])
        gathered = [torch.empty_like(flat) for _ in range(size)] if rank == 0 else None
        dist.gather(flat, gathered, dst=root, group=group)
        if rank == 0:
            loss, gd, ga = global_step(gathered, p, n_rays)
            losses.append(loss)
            if g1 is None:
                g1 = [float(gd.norm()), float(ga.norm())]
            adam.step([gd, ga])
    if rank != 0:
        return None
    return losses, g1, [float((x - x0).norm()) for x, x0 in zip(params, (density0, albedo0))]
