"""The K-phase segment sampler in plain PyTorch ops (frozen copy of the
port's diff/segments.py sample_segments_plain)."""

from __future__ import annotations

import dataclasses

import torch

from .constants import EPS
from .geometry import escape_distance, inv_dir
from .march import budget_cap, budget_stride, march_plain
from .device import TorchWorld

@dataclasses.dataclass
class SegmentBatch:
    slot: torch.Tensor    # int32[N, K] param slot per segment (-1 = unused)
    t0: torch.Tensor      # float32[N, K] segment entry distance
    t1: torch.Tensor      # float32[N, K] segment exit distance
    count: torch.Tensor   # int32[N] segments recorded


def _phase_steps(max_steps: int, step_budget, steps_stride: int) -> int:
    """Per-phase loop bound: with a budget no phase can run past
    ceil(B/stride) charged stages, so the bound is capped there."""
    if step_budget is None:
        return max_steps
    stride = budget_stride(steps_stride)
    return min(max_steps, budget_cap(step_budget, stride))


def sample_segments_plain(world: TorchWorld, a, b, max_segments: int = 32,
                          max_steps: int = 512, num_materials: int = 8,
                          step_budget: int | None = None,
                          steps_stride: int = 16) -> SegmentBatch:
    """The K-phase sampler in plain PyTorch ops, in K4's operation order:
    phase k marches from the previous segment's t1 + EPS (the world entry
    for k = 0) to the next solid cell, then the segment is extracted from
    the hit record."""
    return _sample_segments_plain(world, a, b, max_segments, max_steps, num_materials,
                                  step_budget, steps_stride)[0]


def _sample_segments_plain(world: TorchWorld, a, b, max_segments: int = 32,
                           max_steps: int = 512, num_materials: int = 8,
                           step_budget: int | None = None, steps_stride: int = 16):
    """:func:`sample_segments_plain` and int64[N], each ray's march steps
    summed over its phases (with a budget, the charge), which sizes K4's
    work."""
    n = a.shape[0]
    dev = a.device
    g = inv_dir(b)
    twig_slots = world.twig.shape[0]
    phase_steps = _phase_steps(max_steps, step_budget, steps_stride)
    remaining = (None if step_budget is None
                 else torch.full((n,), int(step_budget), dtype=torch.int32, device=dev))
    slots, t0s, t1s = [], [], []
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    t_cur = live = None
    for _ in range(max_segments):
        res = march_plain(world, a, b, phase_steps, True, t_cur, live, False,
                          remaining, steps_stride)
        steps += res.steps
        if remaining is not None:
            remaining = remaining - res.steps
        hitm = res.hit
        t_hit = torch.where(hitm, res.t, 0.0)
        p = a + b * t_hit[:, None]
        esc = escape_distance(p, g, res.cell_bmin, res.cell_bmin + res.cell_size[:, None])
        t1 = t_hit + esc
        slot = torch.where(res.texel >= 0, res.texel,
                           twig_slots + res.material.clamp(0, num_materials - 1))
        slots.append(torch.where(hitm, slot, -1).to(torch.int32))
        t0s.append(t_hit)
        t1s.append(torch.where(hitm, t1, 0.0))
        count = count + hitm.to(torch.int32)
        t_cur = torch.where(hitm, t1 + EPS, 0.0)
        live = hitm.to(torch.int32)
    return SegmentBatch(slot=torch.stack(slots, dim=1), t0=torch.stack(t0s, dim=1),
                        t1=torch.stack(t1s, dim=1), count=count), steps
