"""Segment sampler: the geometry half of the differentiable renderer.

PyTorch counterpart of octree_raymarcher_tpu/diff/segments.py.  For each ray
it records up to K solid cells or texels the ray crosses as segments
``(param_slot, t_enter, t_exit)``.  Segment endpoints depend only on the
octree, never on the optimised per-voxel parameters, so the sampler runs
without gradients and compositing (diff/composite.py) differentiates
exactly.

On CUDA tensors :func:`sample_segments` launches kernel K4
(csrc/segments.cu), one thread per ray walking all K phases; on CPU tensors
it runs :func:`sample_segments_plain`, the reference's K-phase loop over
:func:`~octree_raymarcher_tpu_torch.ops.march.march_plain` in the kernel's
operation order.  :func:`sample_segments_ref` is the reference's one-loop
oracle, kept for the tests.

Param slot layout for a world with T twig-pool words:
  * twig texel:  slot = flat texel index into ``world.twig``;
  * coarse LEAF: slot = T + material id (shared per material).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import EPS, TWIG_SIZE, TWIG_WORDS
from ..core.geometry import const, enter_distance, escape_distance, inv_dir, is_inside
from ..kernels import Kernel, ptr
from ..ops.march import (
    budget_cap,
    budget_stride,
    check_world,
    loop_bound,
    march_plain,
    world_args,
)
from ..world.device import TorchWorld, resolve_device, to_device

SEGMENTS_KERNEL = Kernel("ort_segments")
_LEAF, _TWIG = 1, 3

THREADS = 128      # rays per block, one per thread (csrc/march_step.cuh kPathThreads)
WINDOW = 8         # columns staged per window: 32 bytes of a row, one sector


@dataclasses.dataclass(frozen=True)
class SegmentsPlan:
    """How K4 writes its [N, K] rows (csrc/segments.cu)."""
    cols: int      # columns of its rows a warp stages before it writes them
    smem: int      # bytes of dynamic shared memory per block


def segments_plan(K: int) -> SegmentsPlan:
    """K4's launch plan for rows of K segments: each warp stages a window
    of up to WINDOW columns of its 32 rows (slot, t0, t1) in shared memory
    at an odd row pitch, then writes the window as whole row spans.  Every
    K >= 1 has a plan; the shared memory does not grow with K."""
    cols = min(max(int(K), 1), WINDOW)
    return SegmentsPlan(cols, (THREADS // 32) * 3 * 32 * (cols | 1) * 4)


@dataclasses.dataclass
class SegmentBatch:
    slot: torch.Tensor    # int32[N, K] param slot per segment (-1 = unused)
    t0: torch.Tensor      # float32[N, K] segment entry distance
    t1: torch.Tensor      # float32[N, K] segment exit distance
    count: torch.Tensor   # int32[N] segments recorded


def num_param_slots(world: TorchWorld, num_materials: int = 8) -> int:
    return int(world.twig.shape[0]) + num_materials


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


def _segments_cuda(world, a, b, max_segments, max_steps, num_materials, step_budget,
                   steps_stride) -> SegmentBatch:
    """Launch K4 on PyTorch's current stream; outputs allocated here."""
    n, dev, K = a.shape[0], a.device, int(max_segments)
    out = SegmentBatch(slot=torch.empty((n, K), dtype=torch.int32, device=dev),
                       t0=torch.empty((n, K), dtype=torch.float32, device=dev),
                       t1=torch.empty((n, K), dtype=torch.float32, device=dev),
                       count=torch.empty(n, dtype=torch.int32, device=dev))
    stride = budget_stride(steps_stride)
    phase_steps = _phase_steps(max_steps, step_budget, steps_stride)
    budgeted = step_budget is not None
    cap = budget_cap(phase_steps, stride) if budgeted else loop_bound(phase_steps)
    if not budgeted and K * cap >= 2**31 - 1:
        raise ValueError(f"max_segments * max_steps must stay below 2^31, got {K} * {cap}")
    plan = segments_plan(K)
    SEGMENTS_KERNEL(
        *world_args(world), ptr(a), ptr(b), n, K, cap, int(budgeted),
        int(step_budget) if budgeted else 0, stride, int(world.twig.shape[0]),
        int(num_materials), plan.cols, plan.smem, ptr(out.slot), ptr(out.t0), ptr(out.t1),
        ptr(out.count),
    )
    return out


@torch.no_grad()
def sample_segments(world: TorchWorld, origins, dirs, max_segments: int = 32,
                    max_steps: int = 512, num_materials: int = 8,
                    step_budget: int | None = None, steps_stride: int = 16,
                    device="cuda") -> SegmentBatch:
    """Collect up to ``max_segments`` solid segments per ray.

    Each of the K phases gets a fresh ``max_steps`` loop bound, so a ray may
    spend up to K*max_steps iterations in all.  ``step_budget=B`` instead
    gives each ray one total budget across all phases, charged in
    ``steps_stride``-sized strides (a phase consuming s steps is charged
    stride*ceil(s/stride)), with each phase's bound capped at
    min(max_steps, ceil(B/stride)*stride).  On ``cuda`` this launches K4;
    ``device="cpu"`` runs :func:`sample_segments_plain`."""
    dev = resolve_device(device)
    check_world(world, dev)
    a = to_device(origins, dev)
    b = to_device(dirs, dev)
    if a.ndim != 2 or a.shape[1] != 3 or b.shape != a.shape:
        raise ValueError(f"origins/dirs must be f32[N,3], got {tuple(a.shape)}, {tuple(b.shape)}")
    fn = _segments_cuda if a.is_cuda else sample_segments_plain
    return fn(world, a, b, max_segments, max_steps, num_materials, step_budget, steps_stride)


def sample_segments_frame(world: TorchWorld, origins, dirs, max_segments: int = 32,
                          max_steps: int = 512, num_materials: int = 8, tile: int = 65536,
                          step_budget: int | None = None, steps_stride: int = 16,
                          device="cuda") -> SegmentBatch:
    """:func:`sample_segments` over the whole batch in one launch; ``tile``
    is accepted for callers of the reference and ignored."""
    return sample_segments(world, origins, dirs, max_segments, max_steps, num_materials,
                           step_budget, steps_stride, device=device)


def _descend(world: TorchWorld, p, tree_off):
    """Fixed-depth point location of the oracle: (word, cell_bmin, size)."""
    cs = const(p, world.chunksize)
    bm = torch.floor(p / cs) * world.chunksize
    size = torch.full((p.shape[0],), world.chunksize, dtype=torch.float32, device=p.device)
    word = world.tree[tree_off]
    for _ in range(world.depth):
        mb = ((word >> 30) & 3) == 2
        half = size * 0.5
        ge = p >= bm + half[:, None]
        child = (word & ((1 << 30) - 1)) + ge[:, 0].int() + 2 * ge[:, 1].int() + 4 * ge[:, 2].int()
        bm = torch.where(mb[:, None], bm + torch.where(ge, half[:, None], 0.0), bm)
        size = torch.where(mb, size - half, size)
        word = torch.where(mb, world.tree[tree_off + child.long()], word)
    return word, bm, size


@torch.no_grad()
def sample_segments_ref(world: TorchWorld, origins, dirs, max_segments: int = 32,
                        max_steps: int = 512, num_materials: int = 8,
                        step_budget: int | None = None, steps_stride: int = 16,
                        _stride_unroll: int = 4) -> SegmentBatch:
    """The reference's one-loop sampler (diff/segments.py:232-396) in plain
    PyTorch ops, a test oracle only: one loop over all rays, a solid test
    on the twig material pool, and one shared ``max_steps`` bound across all
    segments (or, with ``step_budget``, the charged-stride accounting with
    strides restarting at every recorded segment)."""
    dev = world.device
    a = to_device(origins, dev)
    b = to_device(dirs, dev)
    n, K = a.shape[0], max_segments
    g = inv_dir(b)
    cs = world.chunksize
    grid = torch.tensor([float(v) for v in world.dims], device=dev)
    lo = world.chunkcoordmin * cs
    hi = lo + grid * cs
    twig_slots = world.twig.shape[0]
    wi, hci, di = world.dims

    tn, enter_ok = enter_distance(a, g, lo, hi)
    inside0 = is_inside(a, lo, hi)
    t = torch.where(inside0, 0.0, tn + EPS)
    active = inside0 | enter_ok

    budgeted = step_budget is not None
    stride = max(_stride_unroll, (steps_stride // _stride_unroll) * _stride_unroll)
    phase_cap = ((max_steps + stride - 1) // stride) * stride
    slot = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    seg_t0 = torch.zeros((n, K), dtype=torch.float32, device=dev)
    seg_t1 = torch.zeros((n, K), dtype=torch.float32, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    psteps = torch.zeros(n, dtype=torch.int32, device=dev)
    spent = torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    bound = (step_budget + stride) if budgeted else max_steps

    for _ in range(bound):
        if not bool(active.any()):
            break
        if budgeted:
            boundary = (psteps % stride) == 0
            stop = active & boundary & ((spent >= step_budget) | (psteps >= phase_cap))
            active = active & ~stop
            spent = spent + torch.where(active & boundary, stride, 0).to(torch.int32)
        p = a + b * t[:, None]
        active = active & is_inside(p, lo, hi)
        q = torch.floor(p / const(p, cs)).to(torch.int32)
        ci = (torch.remainder(q[:, 0], wi) + torch.remainder(q[:, 2], di) * wi
              + torch.remainder(q[:, 1], hci) * wi * di).clamp(0, world.num_chunks - 1).long()
        cb = world.chunk_bmin[ci]
        active = active & is_inside(p, cb, cb + cs)
        tree_off = world.chunk_tree[ci].long()
        twig_off = world.chunk_twig[ci].long()

        word, bmin, size = _descend(world, p, tree_off)
        ty = (word >> 30) & 3
        payload = (word & ((1 << 30) - 1)).long()
        leafsize = size / const(size, TWIG_SIZE)
        toff = torch.clamp((p - bmin) / leafsize[:, None], 0, TWIG_SIZE - 1).to(torch.int64)
        tword = toff[:, 2] * (TWIG_SIZE * TWIG_SIZE) + toff[:, 1] * TWIG_SIZE + toff[:, 0]
        twig_idx = (twig_off + payload) * TWIG_WORDS + tword
        tex_mat = world.twig[twig_idx.clamp(0, twig_slots - 1)]
        is_twig = ty == _TWIG
        solid = active & ((ty == _LEAF) | (is_twig & (tex_mat != 0)))

        texel_min = bmin + toff.to(torch.float32) * leafsize[:, None]
        cell_esc = escape_distance(p, g, bmin, bmin + size[:, None])
        texel_esc = escape_distance(p, g, texel_min, texel_min + leafsize[:, None])
        esc = torch.where(is_twig, texel_esc, cell_esc)

        slot_id = torch.where(is_twig, twig_idx,
                              twig_slots + payload.clamp(0, num_materials - 1)).to(torch.int32)
        can = solid & (count < K)
        col = count.clamp(0, K - 1).long()
        slot[rows, col] = torch.where(can, slot_id, slot[rows, col])
        seg_t0[rows, col] = torch.where(can, t, seg_t0[rows, col])
        seg_t1[rows, col] = torch.where(can, t + esc, seg_t1[rows, col])
        full = solid & (count >= K)
        count = count + can.to(torch.int32)
        psteps = torch.where(active, torch.where(can, 0, psteps + 1), psteps).to(torch.int32)
        t = torch.where(active, t + esc + EPS, t)
        active = active & ~full
    return SegmentBatch(slot=slot, t0=seg_t0, t1=seg_t1, count=count)


__all__ = ["SegmentBatch", "sample_segments", "sample_segments_frame", "sample_segments_plain",
           "sample_segments_ref", "num_param_slots", "SEGMENTS_KERNEL"]
