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
``2 * len(schedule) + 1`` kernels (csrc/compact.cu).  The live count stays
on the card; nothing between the stages waits for the host.  A ray writes
its record at its source index in the stage that ends it.

:func:`march_frame_compact` (and the sampler of diff/segments_compact.py)
captures those launches once in a CUDA graph (:class:`CapturedCall`) and
replays it: a call copies its rays into the graph's static buffers, points
the graph's output table at freshly allocated results, and replays.  The
graph is keyed on the ray count, the schedule, the options and every
pointer and size of the world it reads, so a world that moved (a K7 edit
that grew a pool) is captured anew, never read through stale pointers.  The
cache holds one graph for each of the three ray sets a shadowed frame
marches and one sampler call (:data:`GRAPH_SLOTS`); the least recently
used goes first.  ``compact_begin``/``compact_stages``/``compact_finish``
launch stage by stage, without a graph.

On CPU tensors :func:`march_frame_compact_plain` runs the same stages with
``march_plain`` resumed at t, the partition by ``torch.cumsum``, and the
same accounting.

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

import collections
import ctypes
import dataclasses

import torch

from ..core.constants import MAX_STEPS
from ..core.geometry import inv_dir
from ..kernels import Kernel, library, ptr
from ..world.device import TorchWorld, resolve_device, to_device
from .march import MarchResult, _entry, check_world, loop_bound, march_plain, world_args

_UNROLL = 4   # the march loop's unroll; every stage bound but the last divides by it
WARP = 32     # lanes a warp: the unit of the charge and of the lane count
PART_TILE = 2048  # rays a K10 tile (csrc/compact.cu kPartTile)
GRAPH_SLOTS = {"march": 3, "sampler": 1}   # captured calls kept, by path kind

# K9's instantiations (entry and stage, for the frame march and for the
# segment sampler) and K10, each counted apart.
COMPACT_ENTRY_KERNEL = Kernel("ort_compact_entry")
COMPACT_STAGE_KERNEL = Kernel("ort_compact_stage")
SAMPLER_ENTRY_KERNEL = Kernel("ort_compact_entry")
SAMPLER_STAGE_KERNEL = Kernel("ort_compact_stage")
PARTITION_KERNEL = Kernel("ort_partition")
KERNELS = (COMPACT_ENTRY_KERNEL, COMPACT_STAGE_KERNEL, SAMPLER_ENTRY_KERNEL,
           SAMPLER_STAGE_KERNEL, PARTITION_KERNEL)


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


def out_table(dev, result: MarchResult | None = None, sink: SegmentSink | None = None,
              lanes=None, table=None) -> torch.Tensor:
    """K9's output table (csrc/compact.cu Outs): the pointers of the result
    (or the sink) and of the lane count, int64[12] on the card, written by a
    copy from pinned memory that does not wait for the card."""
    vals = ((None,) * 7 if result is None else
            (result.hit, result.t, result.material, result.cell_bmin, result.cell_size,
             result.steps, result.texel))
    vals += (None,) * 4 if sink is None else (sink.slot, sink.t0, sink.t1, sink.count)
    vals += (lanes,)
    host = torch.tensor([ptr(v) or 0 for v in vals], dtype=torch.int64, pin_memory=True)
    if table is None:
        table = torch.empty(len(vals), dtype=torch.int64, device=dev)
    return table.copy_(host, non_blocking=True)


_loaded = False


def load_kernels() -> None:
    """Load K9's and K10's kernels once, so that a stream capture launches
    only loaded code."""
    global _loaded
    if not _loaded:
        err = library().ort_compact_load()
        if err != 0:
            raise RuntimeError(f"ort_compact_load: CUDA error {err} "
                               f"({library().ort_error_string(err).decode()})")
        _loaded = True


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
    entry's pack and after each stage (1-element tensors on the device);
    ``table`` is K9's output table (None in plain ops)."""

    def __init__(self, rows, spare, flag, live, scratch, executed, result, plain, table=None):
        self.rows, self.spare, self.flag, self.block_counts = rows, spare, flag, scratch
        self.executed, self.result, self.plain, self.table = executed, result, plain, table
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
              next_in=None, block_counts=None, plain: bool = False, live_out=None,
              next_out=None):
    """Stable partition of the prefix ``[0, live_in)`` of ``src`` by ``flag``:
    rays flagged 1 go, in their order, to the front of ``live_dst``; rays
    flagged 2 go, in their order, to ``next_dst`` after its first
    ``next_in`` rows.  ``live_in``/``next_in`` are 1-element int64 tensors
    (``next_in`` None is 0).  A ``src`` whose ``orig`` is None is in source
    order; a None ``charge`` is zero.  Returns (live_out, next_out),
    1-element tensors, new unless given (next_out None without
    ``next_dst``).  K10 on CUDA tensors (``block_counts``: int32[2 *
    ceil(M / 2048)] scratch), else (or with ``plain``)
    :func:`partition_plain`."""
    if plain or not flag.is_cuda:
        return partition_plain(flag, src, live_in, live_dst, next_dst, next_in)
    dev = flag.device
    if live_out is None:
        live_out = torch.empty(1, dtype=torch.int64, device=dev)
    if next_out is None and next_dst is not None:
        next_out = torch.empty(1, dtype=torch.int64, device=dev)
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

def _entry_launch(world, o, d, live_start, t, flag, table, K: int = 0):
    """K9's entry over all rays; ``K`` > 0 is the sampler's instantiation
    (a ray that never enters writes its empty row of K columns).  The entry
    also zeroes the lane counts of the table (1, or K)."""
    kern = COMPACT_ENTRY_KERNEL if K == 0 else SAMPLER_ENTRY_KERNEL
    kern(*world_args(world), ptr(o), ptr(d), ptr(live_start), o.shape[0], ptr(t), ptr(flag),
         int(K > 0), ptr(table), int(K))


def entry_plain(world, o, d, live_start):
    """K9's entry in plain ops: (start t f32[N], flag uint8[N]); the records
    of rays that never enter keep their initial (miss) values."""
    t, live0 = _entry(world, o, d, inv_dir(d), None, live_start)
    return t, live0.to(torch.uint8)


def partition_scratch(m: int, dev, plain: bool):
    """K10's per-tile counts for prefixes of at most ``m`` rays."""
    return None if plain else torch.empty(2 * -(-m // PART_TILE), dtype=torch.int32, device=dev)


def begin_rows(world, o, d, live_start, plain: bool, table=None, K: int = 0):
    """The entry and the first pack: (rows, spare rows, flag, live count,
    K10's scratch).  The rows carry the charge column (the sampler's
    state when ``K`` > 0)."""
    n, dev = o.shape[0], o.device
    if plain:
        t, flag = entry_plain(world, o, d, live_start)
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        flag = torch.empty(n, dtype=torch.uint8, device=dev)
        _entry_launch(world, o, d, live_start, t, flag, table, K)
    rows, spare = Rows.empty(n, dev, True), Rows.empty(n, dev, True)
    everyone = torch.full((1,), n, dtype=torch.int64, device=dev)
    scratch = partition_scratch(n, dev, plain)
    live, _ = partition(flag, Rows(o, d, t, None, None), everyone, rows, block_counts=scratch,
                        plain=plain)
    return rows, spare, flag, live, scratch


# ---- K9 (b), (c): a stage, and its plain version -----------------------------------

def stage_launch(world, rows: Rows, flag, live, cap, final, assume_resident, table,
                 K: int = 0, phase_cap: int = 0, twig_slots: int = 0, num_materials: int = 0):
    """One K9 stage over the packed prefix: the frame march's, or with ``K``
    > 0 the phase-merged sampler's (``phase_cap`` iterations a phase)."""
    kern = COMPACT_STAGE_KERNEL if K == 0 else SAMPLER_STAGE_KERNEL
    kern(*world_args(world), *rows.ptrs(), ptr(flag), ptr(live), flag.shape[0], int(cap),
         int(bool(final)), int(bool(assume_resident)), ptr(table), int(K > 0), int(K),
         int(phase_cap), int(twig_slots), int(num_materials))


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
    if st.plain:
        stage_plain(world, st.rows, st.flag, st.history[-1], cap, final, assume_resident,
                    st.executed, st.result)
    else:
        stage_launch(world, st.rows, st.flag, st.history[-1], cap, final, assume_resident,
                     st.table)


# ---- the captured call ----------------------------------------------------------------

class CapturedCall:
    """A compacted call's launches captured once in a CUDA graph, with the
    static buffers they read and write (``bufs``) and how many launches of
    each kernel a replay makes (``launches``, ``total`` in all; the capture
    launches nothing, so the counts and ``Kernel.total_launches`` move at
    each replay instead)."""

    def __init__(self, key, bufs: dict, build):
        self.key, self.bufs = key, bufs
        before = {k: k.launches for k in KERNELS}
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                build(bufs)
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)
        self.launches = {k: k.launches - before[k] for k in KERNELS}
        for k, c in self.launches.items():
            k.launches -= c
        self.total = sum(self.launches.values())
        Kernel.total_launches -= self.total

    def replay(self) -> None:
        self.graph.replay()
        for k, c in self.launches.items():
            k.launches += c
        Kernel.total_launches += self.total


_GRAPHS = {kind: collections.OrderedDict() for kind in GRAPH_SLOTS}


def captured(kind: str, key, bufs, build) -> CapturedCall:
    """The cached call of ``kind`` under ``key``, captured now if absent
    (``bufs()`` allocates its buffers, ``build(bufs)`` launches the call);
    the least recently used of the kind is dropped past its slots."""
    cache = _GRAPHS[kind]
    call = cache.get(key)
    if call is None:
        while len(cache) >= GRAPH_SLOTS[kind]:
            cache.popitem(last=False)
        load_kernels()
        call = cache[key] = CapturedCall(key, bufs(), build)
    cache.move_to_end(key)
    return call


def world_key(world) -> tuple:
    """Every pointer and size of the world that a captured launch reads."""
    return tuple(world_args(world))


def call_buffers(n, dev, stages, has_live) -> dict:
    """The static buffers of a captured call of ``n`` rays and ``stages``
    stages: the rays' copies, the entry's t and flags, two sets of rows,
    the live counts (``counts[0]`` = n), K10's scratch and the output
    table."""
    f32 = torch.float32
    counts = torch.empty(stages + 1, dtype=torch.int64, device=dev)
    counts[:1].fill_(n)
    return dict(o=torch.empty((n, 3), dtype=f32, device=dev),
                d=torch.empty((n, 3), dtype=f32, device=dev),
                live=torch.empty(n, dtype=torch.int32, device=dev) if has_live else None,
                t=torch.empty(n, dtype=f32, device=dev),
                flag=torch.empty(n, dtype=torch.uint8, device=dev),
                rows=Rows.empty(n, dev, True), spare=Rows.empty(n, dev, True),
                counts=counts,
                scratch=partition_scratch(n, dev, False),
                table=torch.empty(12, dtype=torch.int64, device=dev))


def launch_schedule(world, b: dict, caps, assume_resident, K: int = 0, phase_cap: int = 0,
                    twig_slots: int = 0, num_materials: int = 0) -> None:
    """The launches of a whole compacted call on the buffers ``b``
    (:func:`call_buffers`): the entry, the first pack, then per stage a K9
    stage and (but after the last) a K10 partition; ``counts[s]`` is the
    live count before stage s."""
    _entry_launch(world, b["o"], b["d"], b["live"], b["t"], b["flag"], b["table"], K)
    counts, rows, spare = b["counts"], b["rows"], b["spare"]
    partition(b["flag"], Rows(b["o"], b["d"], b["t"], None, None), counts[0:1], rows,
              block_counts=b["scratch"], live_out=counts[1:2])
    for s, cap in enumerate(caps):
        final = s == len(caps) - 1
        stage_launch(world, rows, b["flag"], counts[s + 1:s + 2], cap, final, assume_resident,
                     b["table"], K, phase_cap, twig_slots, num_materials)
        if not final:
            partition(b["flag"], rows, counts[s + 1:s + 2], spare, block_counts=b["scratch"],
                      live_out=counts[s + 2:s + 3])
            rows, spare = spare, rows


def _frame_replay(world, o, d, live_start, schedule, assume_resident):
    """march_frame_compact on the card: one replay of the captured call."""
    n, dev = o.shape[0], o.device
    caps = [loop_bound(s, _UNROLL) for s in schedule]
    key = (n, schedule, live_start is not None, bool(assume_resident), world_key(world))
    call = captured("march", key,
                    lambda: call_buffers(n, dev, len(caps), live_start is not None),
                    lambda b: launch_schedule(world, b, caps, assume_resident))
    b = call.bufs
    b["o"].copy_(o)
    b["d"].copy_(d)
    if live_start is not None:
        b["live"].copy_(live_start)
    result = _miss_result(n, dev, False)
    lanes = torch.empty(1, dtype=torch.int64, device=dev)
    out_table(dev, result, lanes=lanes, table=b["table"])
    call.replay()
    return result, lanes


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
    table = None if plain else out_table(o.device, result, lanes=executed)
    rows, spare, flag, live, scratch = begin_rows(world, o, d, live_start, plain, table)
    return CompactFrameState(rows, spare, flag, live, scratch, executed, result, plain,
                             table), n


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
    """(MarchResult, lane_iters int64[1]): one replay on the card, the
    stages in plain ops otherwise."""
    if schedule is None:
        schedule = default_schedule(max_steps, stride)
    schedule = tuple(int(s) for s in schedule)
    _validate_schedule(schedule, max_steps)
    if not plain:
        o, d, live = _rays(world, origins, dirs, live_start, device)
        if o.is_cuda and o.shape[0] > 0:
            return _frame_replay(world, o, d, live, schedule, assume_resident)
    st, _ = compact_begin(world, origins, dirs, live_start=live_start, device=device,
                          _plain=plain)
    compact_stages(world, st, schedule, assume_resident=assume_resident, last=True)
    return compact_finish(world, st, assume_resident=assume_resident), st.executed


def march_frame_compact(world: TorchWorld, origins, dirs, max_steps: int = MAX_STEPS,
                        tile: int = 65536, stride: int = 16, assume_resident: bool = False,
                        live_start=None, schedule=None, *, device="cuda"):
    """March a frame with live rays re-packed between stages.  Returns
    ``(MarchResult, lane_iters)``: the result is bit for bit one
    :func:`march`'s, but ``steps`` carries the coarse charge; ``lane_iters``
    (a 0-d int64 tensor on the rays' device) is the executed lane count (see
    the module docstring).  ``stride`` must be a multiple of the unroll (4);
    ``schedule`` overrides :func:`default_schedule` and must cover exactly
    the plain march's effective iterations.  On ``cuda`` this replays the
    call's CUDA graph of K9 and K10 (``2 * len(schedule) + 1`` kernels,
    captured on the first call of its shape and world); ``device="cpu"``
    runs :func:`march_frame_compact_plain`."""
    res, lanes = _compact(world, origins, dirs, max_steps, stride, assume_resident,
                          live_start, schedule, device, None)
    return res, lanes.reshape(())


def march_frame_compact_plain(world: TorchWorld, origins, dirs, max_steps: int = MAX_STEPS,
                              tile: int = 65536, stride: int = 16,
                              assume_resident: bool = False, live_start=None, schedule=None,
                              *, device=None):
    """:func:`march_frame_compact` in plain PyTorch ops on the device of
    ``world`` (or ``device``): the same stages, packed order and
    accounting, with ``march_plain`` resumed at t and a cumsum partition."""
    res, lanes = _compact(world, origins, dirs, max_steps, stride, assume_resident,
                          live_start, schedule, world.device if device is None else device,
                          True)
    return res, lanes.reshape(())


__all__ = ["march_frame_compact", "march_frame_compact_plain", "default_schedule",
           "compact_begin", "compact_stages", "compact_finish", "CompactFrameState",
           "CapturedCall", "call_buffers", "captured", "launch_schedule",
           "out_table", "partition", "partition_plain", "warp_trips", "COMPACT_ENTRY_KERNEL",
           "COMPACT_STAGE_KERNEL", "SAMPLER_ENTRY_KERNEL", "SAMPLER_STAGE_KERNEL",
           "PARTITION_KERNEL"]
