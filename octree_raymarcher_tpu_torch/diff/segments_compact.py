"""Stage-compacted segment sampler: the K-phase sampler with its phases
merged into one schedule of stages and the rays still sampling re-packed
between stages.

PyTorch counterpart of octree_raymarcher_tpu/diff/segments_compact.py,
whose schedule is phase-major (every stage of phase k, then phase k + 1).
Here the phases are merged: one packed state runs one schedule of stages
(:func:`sampler_schedule`: one phase cap, then doubling stages up to K
caps, 6 stages at K = 32 and ``max_steps`` 512), and in each stage a ray
marches on from where it stopped:

* a ray that hits writes its segment (slot, t0, t1, extracted as K4
  extracts it) at its source row, column k, and starts phase k + 1 at
  t1 + EPS at once, in the same stage, with the iterations the stage has
  left;
* a ray ends on a miss, at its phase's cap (``loop_bound`` of the
  schedule's sum, as in K4 every phase gets the whole cap) or after K
  segments: its count and its empty columns are written;
* a ray that spends the stage stays live, its phase and the iterations it
  spent in it in the rows' int32 column (csrc/compact.cuh kUsedBits), which
  K10 moves with the row;

so segments come out segment for segment those of
:func:`~octree_raymarcher_tpu_torch.diff.segments.sample_segments`.  On
CUDA tensors a call is one replay of a CUDA graph (ops/march_compact.py
:class:`CapturedCall`): K9's entry, a K10 pack, then per stage one K9
stage (csrc/compact.cu, its sampler instantiation) and one K10 partition,
``2 * len(stages) + 1`` kernels.  On CPU tensors
:func:`sample_segments_compact_plain` runs the same stages in plain
PyTorch ops.

Lanes per phase.  A warp's 32 x its trip count in a stage (the most
iterations a lane of its 32 consecutive packed rays ran there, over all
the phases it went through) is charged to the phase its first ray was in
at the stage's start; ``executed`` lists the K sums.

As in the reference there is no ``step_budget``: use
``sample_segments(step_budget=...)`` for budgeted training runs.
"""

from __future__ import annotations

import torch

from ..core.constants import EPS
from ..core.geometry import escape_distance, inv_dir
from ..ops.march import loop_bound, march_plain
from ..ops.march_compact import (
    Rows,
    SegmentSink,
    call_buffers,
    _rays,
    begin_rows,
    captured,
    default_schedule,
    launch_schedule,
    out_table,
    partition,
    warp_trips,
    world_key,
)
from ..world.device import TorchWorld
from .segments import SegmentBatch

USED_BITS = 20   # the state column: phase << USED_BITS | iterations spent in it
_MAX_K = 1 << (31 - USED_BITS)


def sampler_schedule(max_steps: int, max_segments: int, stride: int = 16,
                     schedule=None) -> tuple:
    """(stages, phase cap) of the phase-merged sampler: the first stages,
    then stages of twice the largest, doubling, until K phase caps are
    covered (the last cut to fit).  A given per-phase ``schedule`` sets the
    cap (its sum, each stage rounded up to the unroll) and the first
    stages.  Without one the cap is ``loop_bound(max_steps)``, as K4's, and
    the first stage is one whole cap: on the card one step a pass makes a
    stage cost its longest lane and no more, so short stages only add
    partitions (at K = 32 on the 1080p bench frame a stride-16 start took
    3.51 ms on an H100, one cap 2.58; PERF.md).  ``stride`` is checked as
    :func:`default_schedule` checks it."""
    per_phase = default_schedule(max_steps, stride) if schedule is None else schedule
    stages = [loop_bound(int(s)) for s in per_phase if int(s) > 0]
    cap = sum(stages)
    if schedule is None:
        stages = [cap] if cap else []
    total = int(max_segments) * cap
    covered, step = cap, max(stages, default=0)
    while covered < total:
        step *= 2
        stages.append(min(step, total - covered))
        covered += stages[-1]
    return tuple(stages), cap


def sampler_stage_plain(world, rows: Rows, flag, live, cap, final, assume_resident,
                        lanes, sink: SegmentSink, phase_cap: int):
    """K9's phase-merged sampler stage in plain ops: each packed ray marches
    ``march_plain`` resumed at its t with min(the stage's iterations left,
    its phase's left); a hit's segment is extracted as
    ``sample_segments_plain`` extracts it and written in its phase's column,
    and the ray goes on in its next phase at t1 + EPS, until the stage is
    spent; the flags, t and state of the rays left live; the warps' lanes
    added into ``lanes`` (int64[K]) at the phase of each warp's first ray."""
    L = int(live.reshape(()))
    dev, K = rows.o.device, sink.K
    i32 = torch.int32
    o, d, orig = rows.o[:L], rows.d[:L], rows.orig[:L]
    state = rows.charge[:L]
    phase, used = state >> USED_BITS, state & ((1 << USED_BITS) - 1)
    phase0 = phase.clone()
    t = rows.t[:L].clone()
    rem = torch.full((L,), int(cap), dtype=i32, device=dev)
    ran = torch.zeros(L, dtype=i32, device=dev)
    go = torch.zeros(L, dtype=torch.bool, device=dev)
    act = torch.arange(L, device=dev)
    while act.numel():
        allow = torch.minimum(rem[act], phase_cap - used[act])
        res = march_plain(world, o[act], d[act], 0, True, t[act], None, assume_resident,
                          expose_live_t=True, iter_caps=allow)
        still = ~res.hit & torch.isfinite(res.t)
        it = res.steps + (~res.hit & ~still).to(i32)
        ran[act] += it
        rem[act] -= it
        used[act] += it
        hit = res.hit
        h = act[hit]
        a, b, t_hit = o[h], d[h], res.t[hit]
        cmin, size = res.cell_bmin[hit], res.cell_size[hit]
        t1 = t_hit + escape_distance(a + b * t_hit[:, None], inv_dir(b), cmin,
                                     cmin + size[:, None])
        texel, material = res.texel[hit], res.material[hit]
        slot = torch.where(texel >= 0, texel,
                           sink.twig_slots + material.clamp(0, sink.num_materials - 1))
        at, col = orig[h], phase[h].long()
        sink.slot[at, col] = slot.to(i32)
        sink.t0[at, col] = t_hit
        sink.t1[at, col] = t1
        sink.count[at] = (col + 1).to(i32)
        phase[h] += 1
        on = phase[h] < K                     # the hits that start their next phase
        h, t1 = h[on], t1[on]
        t[h] = t1 + EPS
        used[h] = 0
        spent = act[still & (used[act] < phase_cap)]   # live at the stage's cap mid-phase
        t[spent] = res.t[still & (used[act] < phase_cap)]
        go[spent] = True
        more = rem[h] > 0
        go[h[~more]] = True                   # the next phase starts in the next stage
        act = h[more]
    if final:
        go.zero_()                            # every ray ends at the schedule's end
    trips = warp_trips(ran)
    lanes.index_add_(0, phase0[::32].long(), 32 * trips)
    flag[:L] = go.to(torch.uint8)
    rows.t[:L] = torch.where(go, t, rows.t[:L])
    rows.charge[:L] = torch.where(go, (phase << USED_BITS) | used, state)


def _sample(world, origins, dirs, max_segments, max_steps, num_materials, stride, schedule,
            assume_resident, device, plain):
    o, d, _ = _rays(world, origins, dirs, None, device)
    plain = (not o.is_cuda) if plain is None else plain
    n, dev, K = o.shape[0], o.device, int(max_segments)
    stages, phase_cap = sampler_schedule(max_steps, K, stride, schedule)
    if K >= _MAX_K or phase_cap >= 1 << USED_BITS:
        raise ValueError(f"the compacted sampler takes K < {_MAX_K} and a phase of fewer "
                         f"than {1 << USED_BITS} iterations, got K={K}, {phase_cap}")
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
    batch = SegmentBatch(slot=sink.slot, t0=sink.t0, t1=sink.t1, count=sink.count)
    if n == 0 or K == 0 or not stages:
        if n and K:
            sink.count.zero_()
            sink.slot.fill_(-1)
            sink.t0.zero_()
            sink.t1.zero_()
        executed = torch.zeros(K, dtype=torch.int64, device=dev)
        return batch, [executed[k] for k in range(K)]
    if not plain:
        executed = torch.empty(K, dtype=torch.int64, device=dev)
        key = (n, K, stages, phase_cap, int(num_materials), bool(assume_resident),
               world_key(world))
        opts = (K, phase_cap, sink.twig_slots, sink.num_materials)
        call = captured("sampler", key, lambda: call_buffers(n, dev, len(stages), False),
                        lambda bufs: launch_schedule(world, bufs, stages, assume_resident,
                                                     *opts))
        call.bufs["o"].copy_(o)
        call.bufs["d"].copy_(d)
        out_table(dev, sink=sink, lanes=executed, table=call.bufs["table"])
        call.replay()
        return batch, [executed[k] for k in range(K)]

    executed = torch.zeros(K, dtype=torch.int64, device=dev)
    rows, spare, flag, live, _ = begin_rows(world, o, d, None, True)
    for s, cap in enumerate(stages):
        final = s == len(stages) - 1
        sampler_stage_plain(world, rows, flag, live, cap, final, assume_resident, executed,
                            sink, phase_cap)
        if final:
            break                           # every ray has ended
        live, _ = partition(flag, rows, live, spare, plain=True)
        rows, spare = spare, rows
    return batch, [executed[k] for k in range(K)]


@torch.no_grad()
def sample_segments_compact(world: TorchWorld, origins, dirs, max_segments: int = 32,
                            max_steps: int = 512, num_materials: int = 8, tile: int = 65536,
                            stride: int = 16, schedule=None, assume_resident: bool = False, *,
                            device="cuda"):
    """Collect up to ``max_segments`` solid segments per ray with the
    stage-compacted schedule.  Returns ``(SegmentBatch, executed_per_phase)``:
    the batch is segment for segment :func:`sample_segments`'s (no budget);
    the second value is a list of K 0-d int64 tensors, the lanes charged to
    each phase (the module docstring's rule).  ``schedule`` is one phase's
    stages (:func:`sampler_schedule` extends it to K phases).  ``tile`` is
    accepted for callers of the reference and ignored.  On ``cuda`` this
    replays the captured call of K9's sampler instantiation and K10;
    ``device="cpu"`` runs :func:`sample_segments_compact_plain`."""
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


__all__ = ["sample_segments_compact", "sample_segments_compact_plain", "sampler_stage_plain",
           "sampler_schedule"]
