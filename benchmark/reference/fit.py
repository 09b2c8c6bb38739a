"""The voxel fit in plain PyTorch: ground-truth parameters from the world,
the soft composite with autograd, the photometric loss and Adam.

``init_params`` is a frozen copy of the port's ``init_params_from_world``;
Adam is written out (Kingma and Ba, 2015, with PyTorch's default betas and
eps), so that it shares no code with the optimizer the port calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .composite import composite_plain
from .materials import MaterialTable

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def init_params(world, solid_density: float = 40.0, num_materials: int = 8):
    """(density_raw f32[P], albedo_raw f32[P, 3]) under which the soft
    render approximates the hard one: solid slots opaque in their
    material's diffuse colour, empty slots transparent."""
    diffuse = MaterialTable.default().diffuse
    dev = world.device
    twig = world.twig.to(torch.int64) & 0xFFFFFFFF
    mats = torch.cat([twig, torch.arange(num_materials, dtype=torch.int64, device=dev)])
    solid = mats != 0
    dr_solid = float(np.log(np.expm1(max(float(solid_density), 1e-6))))
    density_raw = torch.where(solid, dr_solid, -8.0).to(torch.float32)
    diffuse = diffuse.to(device=dev, dtype=torch.float32)
    mc = torch.clamp_max(mats, diffuse.shape[0] - 1)
    c = torch.clamp(diffuse, 1e-4, 1 - 1e-4)
    albedo_raw = torch.log(c / (1 - c)).to(torch.float32)[mc]
    return density_raw, albedo_raw.contiguous()


def render(segs, density_raw, albedo_raw, sky, rows: int = 1 << 21):
    """f32[N, 3] composite of the segments (slot, t0, t1) over the sky, in
    blocks of ``rows`` rays; differentiable in the parameters.  The
    segment distances take the parameters' dtype."""
    slot, t0, t1 = segs
    t0, t1 = t0.to(density_raw.dtype), t1.to(density_raw.dtype)
    bg = torch.tensor([float(v) for v in sky], dtype=torch.float32, device=slot.device)
    out = [composite_plain(slot[i:i + rows], t0[i:i + rows], t1[i:i + rows], density_raw,
                           albedo_raw, bg)[0] for i in range(0, slot.shape[0], rows)]
    return torch.cat(out)


def loss_and_grads(views, density_raw, albedo_raw, sky, rows: int = 1 << 21,
                   dtype=torch.float64):
    """(loss, d density_raw, d albedo_raw) of the mean over ``views``
    [(segments, target)] of each view's mean squared rgb error, the
    gradients float32; each block's graph is freed before the next is
    built.  ``dtype`` is the precision of the parameters, the segment
    distances, the composite and the gradients' sums: float64 for the
    reference, so that its own rounding stays far below float32's (the
    eight hottest slots each sum millions of terms); bfloat16 for the
    control."""
    leaves = [density_raw.detach().to(dtype).requires_grad_(True),
              albedo_raw.detach().to(dtype).requires_grad_(True)]
    total = 0.0
    grads = [torch.zeros_like(density_raw, dtype=torch.float64),
             torch.zeros_like(albedo_raw, dtype=torch.float64)]
    for segs, target in views:
        n = target.shape[0]
        view_loss = 0.0
        for i in range(0, n, rows):
            s = tuple(x[i:i + rows] for x in segs)
            rgb = render(s, leaves[0], leaves[1], sky, rows)
            err = rgb - target[i:i + rows].to(rgb.dtype)
            part = (err * err).sum() / (3 * n * len(views))
            g = torch.autograd.grad(part, leaves)
            grads[0] += g[0]
            grads[1] += g[1]
            view_loss += float(part.detach())
        total += view_loss
    return total, grads[0].float(), grads[1].float()


class Adam:
    """Adam over a list of tensors, updated in place."""

    def __init__(self, params, lr: float):
        self.params = params
        self.lr = lr
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, grads):
        self.t += 1
        b1, b2 = BETAS
        for p, g, m, v in zip(self.params, grads, self.m, self.v, strict=True):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
