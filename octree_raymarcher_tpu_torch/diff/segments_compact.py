"""Stage-compacted segment sampler: the K-phase sampler with the rays still
sampling re-packed across stages and phases.

PyTorch counterpart of octree_raymarcher_tpu/diff/segments_compact.py.  One
packed state is threaded through all K phases, phase after phase (every
stage of phase k, then phase k + 1, as the reference schedules them):

* each phase marches the packed rays with the stage schedule of the frame
  march (ops/march_compact.py): per stage one K9 stage (csrc/compact.cu, its
  sampler instantiation) over the live prefix and one K10 partition;
* a ray that hits ends its phase in that stage: its segment (slot, t0, t1)
  is extracted as K4 extracts it and written at its source row, column k,
  and the partition appends it, in order, to the next phase's rows, which
  resume at t1 + EPS; a ray that misses (or is live at the phase's cap)
  ends: its count and its empty columns are written;

so segments come out segment for segment those of
:func:`~octree_raymarcher_tpu_torch.diff.segments.sample_segments`.  On CPU
tensors :func:`sample_segments_compact_plain` runs the same stages in plain
PyTorch ops.  Launches: about K x (2 x len(schedule)) + 2.

As in the reference there is no ``step_budget``: use
``sample_segments(step_budget=...)`` for budgeted training runs.
"""

from __future__ import annotations

import torch

from ..core.constants import EPS
from ..core.geometry import escape_distance, inv_dir
from ..ops.march import loop_bound
from ..ops.march_compact import (
    Rows,
    SegmentSink,
    _rays,
    advance_plain,
    begin_rows,
    default_schedule,
    partition,
    stage_launch,
)
from ..world.device import TorchWorld
from .segments import SegmentBatch


def sampler_stage_plain(world, rows: Rows, flag, live, cap, final, assume_resident,
                        lane_iters, sink: SegmentSink, phase: int):
    """K9's sampler stage in plain ops: :func:`advance_plain`, then each hit's
    segment extracted as ``sample_segments_plain`` extracts it (the escape
    of the hit box, the slot), its flag 2 and its next parameter t1 + EPS
    (flag 0 in the last phase), the flags and t of the rays still live."""
    L, res, still, _ = advance_plain(world, rows, live, cap, assume_resident, lane_iters)
    go = still & (not final)
    hit = res.hit
    a, b = rows.o[:L][hit], rows.d[:L][hit]
    t_hit = res.t[hit]
    cmin, size = res.cell_bmin[hit], res.cell_size[hit]
    t1 = t_hit + escape_distance(a + b * t_hit[:, None], inv_dir(b), cmin, cmin + size[:, None])
    texel, material = res.texel[hit], res.material[hit]
    slot = torch.where(texel >= 0, texel,
                       sink.twig_slots + material.clamp(0, sink.num_materials - 1))
    at = rows.orig[:L][hit]
    sink.slot[at, phase] = slot.to(torch.int32)
    sink.t0[at, phase] = t_hit
    sink.t1[at, phase] = t1
    sink.count[at] = phase + 1
    f = go.to(torch.uint8)
    t_new = torch.where(go, res.t, rows.t[:L])
    if phase + 1 < sink.K:
        f[hit] = 2
        t_new[hit] = t1 + EPS
    flag[:L] = f
    rows.t[:L] = t_new


def _sample(world, origins, dirs, max_segments, max_steps, num_materials, stride, schedule,
            assume_resident, device, plain):
    if schedule is None:
        schedule = default_schedule(max_steps, stride)
    caps = [loop_bound(int(s)) for s in schedule]
    o, d, _ = _rays(world, origins, dirs, None, device)
    plain = (not o.is_cuda) if plain is None else plain
    n, dev, K = o.shape[0], o.device, int(max_segments)
    f32, i32 = torch.float32, torch.int32
    if plain:      # the stages write only the rows that end; the rest stay empty
        out = (torch.full((n, K), -1, dtype=i32, device=dev),
               torch.zeros((n, K), dtype=f32, device=dev),
               torch.zeros((n, K), dtype=f32, device=dev), torch.zeros(n, dtype=i32, device=dev))
    else:          # every row is written once
        out = (torch.empty((n, K), dtype=i32, device=dev),
               torch.empty((n, K), dtype=f32, device=dev),
               torch.empty((n, K), dtype=f32, device=dev), torch.empty(n, dtype=i32, device=dev))
    sink = SegmentSink(*out, twig_slots=int(world.twig.shape[0]),
                       num_materials=int(num_materials))
    executed = torch.zeros(K, dtype=torch.int64, device=dev)
    batch = SegmentBatch(slot=sink.slot, t0=sink.t0, t1=sink.t1, count=sink.count)
    if n == 0 or K == 0 or not caps:
        return batch, [executed[k] for k in range(K)]

    rows, spare, flag, live, scratch = begin_rows(world, o, d, None, plain, False, sink=sink)
    nxt = Rows.empty(n, dev, False)
    for k in range(K):
        next_count = None
        for i, cap in enumerate(caps):
            final = i == len(caps) - 1
            lane = executed[k:k + 1]
            if plain:
                sampler_stage_plain(world, rows, flag, live, cap, final, assume_resident, lane,
                                    sink, k)
            else:
                stage_launch(world, rows, flag, live, cap, final, assume_resident, lane,
                             sink=sink, phase=k)
            if final and k == K - 1:
                break                       # every ray has ended
            live, next_count = partition(flag, rows, live, spare, nxt, next_count, scratch,
                                         plain)
            rows, spare = spare, rows
        # the rays that hit in phase k start phase k + 1
        rows, nxt = nxt, rows
        live = next_count
    return batch, [executed[k] for k in range(K)]


@torch.no_grad()
def sample_segments_compact(world: TorchWorld, origins, dirs, max_segments: int = 32,
                            max_steps: int = 512, num_materials: int = 8, tile: int = 65536,
                            stride: int = 16, schedule=None, assume_resident: bool = False, *,
                            device="cuda"):
    """Collect up to ``max_segments`` solid segments per ray with the
    stage-compacted schedule.  Returns ``(SegmentBatch, executed_per_phase)``:
    the batch is segment for segment :func:`sample_segments`'s (no budget);
    the second value is a list of K 0-d int64 tensors, the lanes each phase
    executed (32 x each warp's trip count, summed over its stages; see
    ops/march_compact.py).  ``tile`` is accepted for callers of the reference
    and ignored.  On ``cuda`` this launches K9's sampler instantiation and
    K10; ``device="cpu"`` runs :func:`sample_segments_compact_plain`."""
    return _sample(world, origins, dirs, max_segments, max_steps, num_materials, stride,
                   schedule, assume_resident, device, None)


@torch.no_grad()
def sample_segments_compact_plain(world: TorchWorld, origins, dirs, max_segments: int = 32,
                                  max_steps: int = 512, num_materials: int = 8,
                                  tile: int = 65536, stride: int = 16, schedule=None,
                                  assume_resident: bool = False, *, device=None):
    """:func:`sample_segments_compact` in plain PyTorch ops on the device of
    ``world`` (or ``device``), with the same packed order and accounting."""
    return _sample(world, origins, dirs, max_segments, max_steps, num_materials, stride,
                   schedule, assume_resident, world.device if device is None else device, True)


__all__ = ["sample_segments_compact", "sample_segments_compact_plain", "sampler_stage_plain"]
