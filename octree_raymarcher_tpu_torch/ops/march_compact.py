"""Stage-compacted frame march: live rays re-packed between march stages.

PyTorch counterpart of octree_raymarcher_tpu/ops/march_compact.py.  The
march runs in stages from a ``schedule`` of per-stage iteration counts;
after each stage the rays still live are packed, in their order, into a
dense prefix of the next stage's rows, so a warp's 32 lanes are 32 live
rays and a warp runs at most one stage to its longest ray.  Results are bit
for bit those of one :func:`~octree_raymarcher_tpu_torch.ops.march.march`
(hit, t, material, cell, texel): every ray walks the same cells, only the
lane schedule differs.

On CUDA tensors a frame is: K9's entry over all rays, one K10 partition of
the rays that entered, then per stage one K9 stage over the packed prefix
and one K10 partition of the rays still live (none after the last stage):
``2 * len(schedule) + 1`` launches (csrc/compact.cu).  The live count stays
on the card; nothing between the stages waits for the host.  A ray writes
its record at its source index in the stage that ends it.  On CPU tensors
:func:`march_frame_compact_plain` runs the same stages with ``march_plain``
resumed at t, the partition by ``torch.cumsum``, and the same accounting.

Accounting (kernel and plain alike, from the same packed order):

* ``steps`` is the reference's coarse charge at warp granularity: a ray live
  at a stage's start is charged its warp's trip count that stage (the most
  iterations a lane of those 32 consecutive packed rays ran), so
  exact <= charge <= exact + the largest stage bound;
* the second value returned, ``lane_iters``, is the sum over stages and
  warps of 32 x the warp's trip count (int64), so
  ``sum(exact steps) / lane_iters`` is the compacted schedule's SIMT
  efficiency.  The reference counts tiles of 65,536 lanes; here a warp is 32,
  and a partial last warp counts 32: the values differ from the
  reference's.

``tile`` is accepted for callers of the reference and ignored: the warp is
the unit here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import MAX_STEPS
from ..core.geometry import inv_dir
from ..kernels import Kernel, ptr
from ..world.device import TorchWorld, resolve_device, to_device
from .march import MarchResult, _entry, check_world, loop_bound, march_plain, world_args

_UNROLL = 4   # the march loop's unroll; every stage bound but the last divides by it
WARP = 32     # lanes a warp: the unit of the charge and of the lane count
PART_TILE = 2048  # rays a K10 tile (csrc/compact.cu kPartTile)

# K9's instantiations (entry and stage, for the frame march and for the
# segment sampler) and K10, each counted apart.
COMPACT_ENTRY_KERNEL = Kernel("ort_compact_entry")
COMPACT_STAGE_KERNEL = Kernel("ort_compact_stage")
SAMPLER_ENTRY_KERNEL = Kernel("ort_compact_entry")
SAMPLER_STAGE_KERNEL = Kernel("ort_compact_stage")
PARTITION_KERNEL = Kernel("ort_partition")


def default_schedule(max_steps: int, stride: int = 16) -> tuple:
    """Stage schedule covering ``max_steps`` loop iterations: ``stride``
    iterations a stage for the first half of the budget, then doubling
    strides.  Every entry is a multiple of the march unroll (4) and the
    effective total matches one plain march of ``max_steps`` exactly (both
    round up to the unroll), keeping bit identity."""
    if stride % _UNROLL:
        raise ValueError(f"stride must be a multiple of {_UNROLL}, got {stride}")
    total = -(-max_steps // _UNROLL) * _UNROLL
    sched = []
    covered = 0
    step = stride
    while covered < total:
        if covered >= total // 2 and len(sched) >= 2:
            step = min(step * 2, total - covered)
            step = -(-step // _UNROLL) * _UNROLL
        take = min(step, total - covered)
        sched.append(take)
        covered += take
    return tuple(sched)


def _validate_schedule(schedule, max_steps):
    eff = sum(-(-s // _UNROLL) * _UNROLL for s in schedule)
    want = -(-max_steps // _UNROLL) * _UNROLL
    if eff != want:
        raise ValueError(
            f"schedule {schedule} covers {eff} effective iterations, but "
            f"max_steps={max_steps} needs exactly {want} (each stage rounds "
            f"up to the march unroll {_UNROLL}) for bit-identity with the "
            "plain march"
        )
    for s in schedule[:-1]:
        if s % _UNROLL:
            raise ValueError(
                f"every non-final stage bound must be a multiple of the "
                f"march unroll ({_UNROLL}); got {schedule}"
            )


@dataclasses.dataclass
class Rows:
    """Packed in-flight rows (csrc/compact.cuh Rows): the first ``live``
    of them hold the rays still marching."""
    o: torch.Tensor                    # f32[M, 3]
    d: torch.Tensor                    # f32[M, 3]
    t: torch.Tensor                    # f32[M] the parameter to resume at
    orig: torch.Tensor                 # int64[M] source index
    charge: torch.Tensor | None        # int32[M] coarse step charge (frame march only)

    @staticmethod
    def empty(m: int, dev, charge: bool) -> "Rows":
        f32 = torch.float32
        return Rows(torch.empty((m, 3), dtype=f32, device=dev),
                    torch.empty((m, 3), dtype=f32, device=dev),
                    torch.empty(m, dtype=f32, device=dev),
                    torch.empty(m, dtype=torch.int64, device=dev),
                    torch.empty(m, dtype=torch.int32, device=dev) if charge else None)

    def ptrs(self) -> tuple:
        return ptr(self.o), ptr(self.d), ptr(self.t), ptr(self.orig), ptr(self.charge)


@dataclasses.dataclass
class SegmentSink:
    """Where the sampler's stages write (its SegmentBatch's tensors)."""
    slot: torch.Tensor      # int32[N, K]
    t0: torch.Tensor        # f32[N, K]
    t1: torch.Tensor        # f32[N, K]
    count: torch.Tensor     # int32[N]
    twig_slots: int
    num_materials: int

    @property
    def K(self) -> int:
        return self.slot.shape[1]


def _result_ptrs(res: MarchResult | None) -> tuple:
    if res is None:
        return (None,) * 7
    return (ptr(res.hit), ptr(res.t), ptr(res.material), ptr(res.cell_bmin),
            ptr(res.cell_size), ptr(res.steps), ptr(res.texel))


def _sink_ptrs(sink: SegmentSink | None) -> tuple:
    if sink is None:
        return (None,) * 4
    return ptr(sink.slot), ptr(sink.t0), ptr(sink.t1), ptr(sink.count)


def warp_trips(iters: torch.Tensor) -> torch.Tensor:
    """int64[ceil(L/32)]: each warp's trip count, the most iterations a lane
    of 32 consecutive packed rays ran (a partial last warp pads with 0)."""
    pad = (-iters.shape[0]) % WARP
    lanes = torch.nn.functional.pad(iters.to(torch.int64), (0, pad))
    return lanes.view(-1, WARP).amax(dim=1)


class CompactFrameState:
    """In-flight state of a stage-compacted march, in packed order: the rows
    (``o``, ``d``, ``t``, source index ``orig``, coarse charge ``steps``; the
    first ``live_count`` are live), the executed lane count so far (int64,
    on the rays' device) and the result being written.  Produced by
    :func:`compact_begin`, advanced by :func:`compact_stages`, finished by
    :func:`compact_finish`.  ``history`` holds the live count after the
    entry's pack and after each stage (1-element tensors on the device)."""

    def __init__(self, rows, spare, flag, live, scratch, executed, result, plain):
        self.rows, self.spare, self.flag, self.block_counts = rows, spare, flag, scratch
        self.executed, self.result, self.plain = executed, result, plain
        self.history = [live]
        self.done = False

    o = property(lambda self: self.rows.o)
    d = property(lambda self: self.rows.d)
    t = property(lambda self: self.rows.t)
    orig = property(lambda self: self.rows.orig)
    steps = property(lambda self: self.rows.charge)
    live_count = property(lambda self: self.history[-1].reshape(()))


# ---- K10 and its plain version ---------------------------------------------------

def partition(flag, src: Rows, live_in, live_dst: Rows, next_dst: Rows | None = None,
              next_in=None, block_counts=None, plain: bool = False):
    """Stable partition of the prefix ``[0, live_in)`` of ``src`` by ``flag``:
    rays flagged 1 go, in their order, to the front of ``live_dst``; rays
    flagged 2 go, in their order, to ``next_dst`` after its first
    ``next_in`` rows.  ``live_in``/``next_in`` are 1-element int64 tensors
    (``next_in`` None is 0).  A ``src`` whose ``orig`` is None is in source
    order; a None ``charge`` is zero.  Returns (live_out, next_out), new
    1-element tensors (next_out None without ``next_dst``).  K10 on CUDA
    tensors (``block_counts``: int32[2 * ceil(M / 2048)] scratch), else (or
    with ``plain``) :func:`partition_plain`."""
    if plain or not flag.is_cuda:
        return partition_plain(flag, src, live_in, live_dst, next_dst, next_in)
    dev = flag.device
    live_out = torch.empty(1, dtype=torch.int64, device=dev)
    next_out = None if next_dst is None else torch.empty(1, dtype=torch.int64, device=dev)
    nxt = (None,) * 4 if next_dst is None else next_dst.ptrs()[:4]
    PARTITION_KERNEL(ptr(flag), *src.ptrs(), *live_dst.ptrs(), *nxt, ptr(live_in),
                     ptr(live_out), ptr(next_in), ptr(next_out), ptr(block_counts),
                     flag.shape[0])
    return live_out, next_out


def partition_plain(flag, src: Rows, live_in, live_dst: Rows, next_dst: Rows | None = None,
                    next_in=None):
    """K10 in plain PyTorch ops: destinations from ``torch.cumsum`` of each
    flag, as the reference's ``_compact`` builds its permutation."""
    L = int(live_in.reshape(()))
    f = flag[:L]
    orig = (torch.arange(L, dtype=torch.int64, device=f.device) if src.orig is None
            else src.orig[:L])
    charge = None
    if live_dst.charge is not None:
        charge = (torch.zeros(L, dtype=torch.int32, device=f.device) if src.charge is None
                  else src.charge[:L])
    outs = []
    for code, dst, base in ((1, live_dst, None), (2, next_dst, next_in)):
        if dst is None:
            outs.append(None)
            continue
        keep = f == code
        start = 0 if base is None else int(base.reshape(()))
        dest = (start + torch.cumsum(keep.to(torch.int64), 0) - 1)[keep]
        dst.o[dest] = src.o[:L][keep]
        dst.d[dest] = src.d[:L][keep]
        dst.t[dest] = src.t[:L][keep]
        dst.orig[dest] = orig[keep]
        if code == 1 and charge is not None:
            dst.charge[dest] = charge[keep]
        outs.append(torch.full((1,), start + dest.shape[0], dtype=torch.int64,
                               device=f.device))
    return outs[0], outs[1]


# ---- K9 (a): the entry ------------------------------------------------------------

def _entry_launch(world, o, d, live_start, t, flag, result=None, sink=None):
    kern = COMPACT_ENTRY_KERNEL if sink is None else SAMPLER_ENTRY_KERNEL
    kern(*world_args(world), ptr(o), ptr(d), ptr(live_start), o.shape[0], ptr(t), ptr(flag),
         int(sink is not None), *_result_ptrs(result), *_sink_ptrs(sink),
         0 if sink is None else sink.K)


def entry_plain(world, o, d, live_start):
    """K9's entry in plain ops: (start t f32[N], flag uint8[N]); the records
    of rays that never enter keep their initial (miss) values."""
    t, live0 = _entry(world, o, d, inv_dir(d), None, live_start)
    return t, live0.to(torch.uint8)


def partition_scratch(m: int, dev, plain: bool):
    """K10's per-tile counts for prefixes of at most ``m`` rays."""
    return None if plain else torch.empty(2 * -(-m // PART_TILE), dtype=torch.int32, device=dev)


def begin_rows(world, o, d, live_start, plain: bool, charge: bool, result=None, sink=None):
    """The entry and the first pack: (rows, spare rows, flag, live count,
    K10's scratch)."""
    n, dev = o.shape[0], o.device
    if plain:
        t, flag = entry_plain(world, o, d, live_start)
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        flag = torch.empty(n, dtype=torch.uint8, device=dev)
        _entry_launch(world, o, d, live_start, t, flag, result, sink)
    rows, spare = Rows.empty(n, dev, charge), Rows.empty(n, dev, charge)
    everyone = torch.full((1,), n, dtype=torch.int64, device=dev)
    scratch = partition_scratch(n, dev, plain)
    live, _ = partition(flag, Rows(o, d, t, None, None), everyone, rows, block_counts=scratch,
                        plain=plain)
    return rows, spare, flag, live, scratch


# ---- K9 (b), (c): a stage, and its plain version -----------------------------------

def stage_launch(world, rows: Rows, flag, live, cap, final, assume_resident, lane_iters,
                 result=None, sink=None, phase=0):
    """One K9 stage over the packed prefix: the frame march's (``result``)
    or the sampler's (``sink``, phase ``phase``)."""
    kern = COMPACT_STAGE_KERNEL if sink is None else SAMPLER_STAGE_KERNEL
    kern(*world_args(world), *rows.ptrs(), ptr(flag), ptr(live), flag.shape[0], int(cap),
         int(bool(final)), int(bool(assume_resident)), ptr(lane_iters),
         int(sink is not None), *_result_ptrs(result), *_sink_ptrs(sink),
         0 if sink is None else sink.K, int(phase), 0 if sink is None else sink.twig_slots,
         0 if sink is None else sink.num_materials)


def advance_plain(world, rows: Rows, live, cap, assume_resident, lane_iters):
    """The march half of a stage in plain ops: ``march_plain`` resumed at
    each packed ray's t for ``cap`` iterations, and the warp trip counts
    added to ``lane_iters`` (int64, 1 element) in place.  Returns (L, the
    march's result with the t of rays still live, still live, each ray's
    warp trip count)."""
    L = int(live.reshape(()))
    res = march_plain(world, rows.o[:L], rows.d[:L], cap, True, rows.t[:L], None,
                      assume_resident, None, 16, True, _UNROLL)
    still = ~res.hit & torch.isfinite(res.t)
    # iterations a lane ran: a ray that left the world or a resident chunk
    # ran one more than it counted steps
    iters = res.steps + (~res.hit & ~still).to(torch.int32)
    trips = warp_trips(iters)
    lane_iters += WARP * trips.sum()
    return L, res, still, trips.repeat_interleave(WARP)[:L].to(torch.int32)


def stage_plain(world, rows: Rows, flag, live, cap, final, assume_resident, lane_iters,
                result: MarchResult):
    """K9's frame-march stage in plain ops: :func:`advance_plain`, the
    charge, the records of the rays that end, the flags and t of the rest."""
    L, res, still, trip = advance_plain(world, rows, live, cap, assume_resident, lane_iters)
    go = still & (not final)
    charge = rows.charge[:L] + trip
    end = ~go
    at = rows.orig[:L][end]
    result.hit[at] = res.hit[end]
    result.t[at] = torch.where(res.hit, res.t, float("inf"))[end]
    result.material[at] = res.material[end]
    result.cell_bmin[at] = res.cell_bmin[end]
    result.cell_size[at] = res.cell_size[end]
    result.texel[at] = res.texel[end]
    result.steps[at] = charge[end]
    rows.charge[:L] = charge
    rows.t[:L] = torch.where(go, res.t, rows.t[:L])
    flag[:L] = go.to(torch.uint8)


def _run_stage(world, st: "CompactFrameState", cap, final, assume_resident):
    fn = stage_plain if st.plain else stage_launch
    fn(world, st.rows, st.flag, st.history[-1], cap, final, assume_resident, st.executed,
       st.result)


# ---- the public entry points ---------------------------------------------------------

def _miss_result(n, dev, plain: bool) -> MarchResult:
    """The result the stages write into: torch.empty on the card (every ray
    is written once), the miss record in plain ops (only ending rays are)."""
    if not plain:
        return MarchResult(
            hit=torch.empty(n, dtype=torch.bool, device=dev),
            t=torch.empty(n, dtype=torch.float32, device=dev),
            material=torch.empty(n, dtype=torch.int32, device=dev),
            cell_bmin=torch.empty((n, 3), dtype=torch.float32, device=dev),
            cell_size=torch.empty(n, dtype=torch.float32, device=dev),
            steps=torch.empty(n, dtype=torch.int32, device=dev),
            texel=torch.empty(n, dtype=torch.int32, device=dev))
    return MarchResult(
        hit=torch.zeros(n, dtype=torch.bool, device=dev),
        t=torch.full((n,), float("inf"), dtype=torch.float32, device=dev),
        material=torch.zeros(n, dtype=torch.int32, device=dev),
        cell_bmin=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        cell_size=torch.zeros(n, dtype=torch.float32, device=dev),
        steps=torch.zeros(n, dtype=torch.int32, device=dev),
        texel=torch.full((n,), -1, dtype=torch.int32, device=dev))


def _rays(world, origins, dirs, live_start, device):
    dev = resolve_device(device)
    check_world(world, dev)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"origins/dirs must be f32[N,3], got {tuple(o.shape)}, {tuple(d.shape)}")
    if live_start is not None:
        live_start = to_device(live_start, dev, torch.int32)
        if live_start.shape != (o.shape[0],):
            raise ValueError(f"live_start must have shape ({o.shape[0]},), got "
                             f"{tuple(live_start.shape)}")
    return o, d, live_start


def compact_begin(world: TorchWorld, origins, dirs, tile: int = 65536, live_start=None, *,
                  device="cuda", _plain=None):
    """The entry test and the first pack.  Returns (CompactFrameState, n).
    ``tile`` is accepted for callers of the reference and ignored."""
    o, d, live_start = _rays(world, origins, dirs, live_start, device)
    plain = (not o.is_cuda) if _plain is None else _plain
    n = o.shape[0]
    result = _miss_result(n, o.device, plain)
    executed = torch.zeros(1, dtype=torch.int64, device=o.device)
    if n == 0:
        empty = Rows.empty(0, o.device, True)
        st = CompactFrameState(empty, empty, torch.empty(0, dtype=torch.uint8),
                               torch.zeros(1, dtype=torch.int64, device=o.device), None,
                               executed, result, plain)
        st.done = True
        return st, 0
    rows, spare, flag, live, scratch = begin_rows(world, o, d, live_start, plain, True, result)
    return CompactFrameState(rows, spare, flag, live, scratch, executed, result, plain), n


def compact_stages(world: TorchWorld, st: CompactFrameState, schedule, tile: int = 65536,
                   assume_resident: bool = False, *, last: bool = False):
    """Run the stage schedule over the in-flight state: per stage one K9 and
    one K10 (or their plain versions).  With ``last`` the schedule's final
    stage ends every ray still live (as a miss) and needs no partition.
    Mutates and returns ``st``."""
    if st.done:
        return st
    for i, stage_steps in enumerate(schedule):
        final = last and i == len(schedule) - 1
        cap = loop_bound(stage_steps, _UNROLL)
        _run_stage(world, st, cap, final, assume_resident)
        if final:
            st.done = True
            break
        live, _ = partition(st.flag, st.rows, st.history[-1], st.spare,
                            block_counts=st.block_counts, plain=st.plain)
        st.rows, st.spare = st.spare, st.rows
        st.history.append(live)
    return st


def compact_finish(world: TorchWorld, st: CompactFrameState, n=None,
                   assume_resident: bool = False) -> MarchResult:
    """The result in source order: a ray still live ends as a miss with its
    charge (a stage of no iterations writes its record).  ``n`` and
    ``assume_resident`` are accepted for callers of the reference."""
    if not st.done:
        _run_stage(world, st, 0, True, assume_resident)
        st.done = True
    return st.result


def _compact(world, origins, dirs, max_steps, stride, assume_resident, live_start, schedule,
             device, plain):
    if schedule is None:
        schedule = default_schedule(max_steps, stride)
    schedule = tuple(int(s) for s in schedule)
    _validate_schedule(schedule, max_steps)
    st, _ = compact_begin(world, origins, dirs, live_start=live_start, device=device,
                          _plain=plain)
    compact_stages(world, st, schedule, assume_resident=assume_resident, last=True)
    return compact_finish(world, st, assume_resident=assume_resident), st


def march_frame_compact(world: TorchWorld, origins, dirs, max_steps: int = MAX_STEPS,
                        tile: int = 65536, stride: int = 16, assume_resident: bool = False,
                        live_start=None, schedule=None, *, device="cuda"):
    """March a frame with live rays re-packed between stages.  Returns
    ``(MarchResult, lane_iters)``: the result is bit for bit one
    :func:`march`'s, but ``steps`` carries the coarse charge; ``lane_iters``
    (a 0-d int64 tensor on the rays' device) is the executed lane count (see
    the module docstring).  ``stride`` must be a multiple of the unroll (4);
    ``schedule`` overrides :func:`default_schedule` and must cover exactly
    the plain march's effective iterations.  On ``cuda`` this launches K9
    and K10 (``2 * len(schedule) + 1`` launches); ``device="cpu"`` runs
    :func:`march_frame_compact_plain`."""
    res, st = _compact(world, origins, dirs, max_steps, stride, assume_resident, live_start,
                       schedule, device, None)
    return res, st.executed.reshape(())


def march_frame_compact_plain(world: TorchWorld, origins, dirs, max_steps: int = MAX_STEPS,
                              tile: int = 65536, stride: int = 16,
                              assume_resident: bool = False, live_start=None, schedule=None,
                              *, device=None):
    """:func:`march_frame_compact` in plain PyTorch ops on the device of
    ``world`` (or ``device``): the same stages, packed order and
    accounting, with ``march_plain`` resumed at t and a cumsum partition."""
    res, st = _compact(world, origins, dirs, max_steps, stride, assume_resident, live_start,
                       schedule, world.device if device is None else device, True)
    return res, st.executed.reshape(())


__all__ = ["march_frame_compact", "march_frame_compact_plain", "default_schedule",
           "compact_begin", "compact_stages", "compact_finish", "CompactFrameState",
           "partition", "partition_plain", "warp_trips", "COMPACT_ENTRY_KERNEL",
           "COMPACT_STAGE_KERNEL", "SAMPLER_ENTRY_KERNEL", "SAMPLER_STAGE_KERNEL",
           "PARTITION_KERNEL"]
