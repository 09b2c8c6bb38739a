"""The soft compositor in plain PyTorch ops (frozen copy of the port's
diff/composite.py composite_plain, differentiable by autograd).

One departure: the parameters are gathered by ``index_select``, whose
gradient is summed by ``index_add_``; a plain index's gradient is summed
one duplicate after another, and half of a frame's segments fall on eight
slots."""

from __future__ import annotations

import torch

SKY = (0.45, 0.65, 0.95)


def composite_plain(slot, t0, t1, density_raw, albedo_raw, bg, far: float = 8192.0):
    """K5 in plain PyTorch ops, segment by segment in the kernel's order.
    ``bg`` is f32[3] or f32[N,3].  Returns (rgb, depth, opacity, weights);
    differentiable by torch.autograd."""
    n, K = slot.shape
    valid = slot >= 0
    sc = slot.clamp(0, density_raw.shape[0] - 1).long()
    x = torch.index_select(density_raw, 0, sc.reshape(-1)).reshape(sc.shape)
    sigma = torch.logaddexp(x, torch.zeros_like(x))
    tau = torch.where(valid, sigma * torch.clamp_min(t1 - t0, 0.0), 0.0)
    albedo = torch.sigmoid(torch.index_select(albedo_raw, 0, sc.reshape(-1)).reshape(n, K, 3))
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
