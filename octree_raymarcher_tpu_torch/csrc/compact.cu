// K9 (the stage march) and K10 (the stable partition): the stage-compacted
// march and segment sampler.
//
// Replaces the JAX package's stage-compacted schedule (B9, B10):
// octree_raymarcher_tpu/ops/march_compact.py `_prologue` (:133, entry and
// first pack), `_stage` (:152, a stage of `run_fast_loop` per tile, the
// coarse step charge and the executed-lane count), `_compact` (:109, the
// cumsum-built stable partition) and `_finalize` (:191, decode and
// unpermute), and diff/segments_compact.py `_phase_decode` (:55) and
// `_phase_repack` (:70), the K-phase sampler over one packed state.
//
// A frame's march runs as: the entry (K9a) over all N rays, a partition
// (K10) of the rays that entered into a dense prefix, then per stage of the
// schedule a stage march (K9b) over that prefix and a partition of the rays
// still live into the next prefix, in their order.  The last stage has no
// partition: every ray ends there.  The sampler (K9c) is phase-merged: a ray
// that hits writes its segment and starts its next phase at once, in the
// same stage, with the stage's iterations left; it ends on a miss, at its
// phase's cap or after K segments.  Its schedule covers K phases' iterations
// in a few stages (one phase cap, then doubling: 6 at K = 32;
// diff/segments_compact.py), not K schedules of them.
// The host captures the whole schedule once in a CUDA graph and replays it
// (ops/march_compact.py); every count the stages pass on stays on the card.
//
// What bounds it on an H100.  K9 is K1's loop (march_step.cuh run_march,
// called as K1 and K4 call it, so their code is unchanged): chains of
// dependent L2 loads and the divergence of a warp's lanes.  Re-packing is
// meant to cut the divergence: a warp's 32 lanes are 32 live rays, so a warp
// runs to the longest of its live rays for at most one stage.  What it costs:
// a launch and a partition per stage, the rows moved by each partition (40
// bytes a ray), and in each stage the first step's descent from the root.
//
// What this design does about it:
//   * K9's grid covers all N rays, a warp takes 32 consecutive packed rays,
//     and a warp past the live prefix leaves at once, so the warp whose trip
//     count is charged is the warp that ran.  (A persistent warp queue, a
//     grid of the resident blocks drawing chunks of 32 from a counter, made
//     no call faster: a stage's empty blocks and tail warps cost ~0.1 ms of
//     a camera march's 0.9, and its late stages are one warp's chain of
//     dependent steps, PERF.md.)
//   * Outputs through a table in device memory (Outs), rewritten by the host
//     before each call, so a captured graph writes each call's own tensors.
//     A ray reads the table only where it writes its record or segment.
//   * The sampler's stage steps every lane once a pass (run_march with a cap
//     of one, the path carried), so a lane that hits writes its segment and
//     goes on in its next phase while the others step on: a phase boundary
//     is not a point where the warp's lanes wait for each other, as it is in
//     K4 and would be in a loop of one march a phase.
//   * A ray that ends in a stage writes its record (hit record, or miss) at
//     its source index there and then: no decode pass and no unpermute at
//     the end.  The rays that never enter get theirs from the entry.
//   * The sampler's rows are written as K4 writes them, whole spans and each
//     column once: a lane stages its segments in a window of 8 columns in
//     shared memory, and the warp writes a lane's row, one column a lane,
//     when its window fills and at the stage's end (a ray that ended adds its
//     empty columns).  Written one element a hit after the entry filled
//     every row, the sampler took 3.36 ms on the 1080p bench frame at K = 32
//     against 2.59-2.63 (PERF.md).
//   * The step charge and the lane count are warp-level: each live lane adds
//     its warp's trip count (the most iterations a lane of it ran, one
//     reduction), and the warp's first lane adds 32 times it to the count.
//     In the sampler a lane's iterations in a stage add over its phases, and
//     the chunk's lanes go to the phase its first ray was in at the stage's
//     start.
//   * K10 is two kernels in one launch call: per tile of 2,048 rays its
//     counts of live and of next-phase rays (ballots), then the scatter: each
//     tile sums the counts of the tiles before it, ranks its rays by ballot
//     and population count in index order, and copies their rows.  The new
//     counts go to device memory.  Two passes need no tile counter and no
//     look-back, so no block ever waits on another.
//
// Arithmetic: a stage resumes at max(t, 0), clamped and with its sign
// cleared (march.cu's resume), as march_plain does with t_start; run_march
// is one step an iteration, so a march resumed at any iteration walks the
// cells of one unsplit march; with -fmad=false every stage walks the cells
// one launch of K1 walks, and K9 agrees with the plain versions
// (ops/march_compact.py, diff/segments_compact.py) bit for bit.

#include "compact.cuh"

namespace ort {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWin = 8;                // columns of its row a sampler lane stages
constexpr int kWinPitch = kWin | 1;    // words a lane's staged row takes (odd: no conflict)

// Where a call's results go: the MarchResult of the frame march, or the
// SegmentBatch of the sampler, and the lane count (the frame march's one
// total, the sampler's one a phase).  It lives in device memory and the
// host rewrites it before every call.
struct Outs {
    uint8_t* hit;
    float* t;
    int32_t* material;
    float* cell_bmin;
    float* cell_size;
    int32_t* steps;
    int32_t* texel;
    int32_t* slot;   // [N, K]
    float* t0;       // [N, K]
    float* t1;       // [N, K]
    int32_t* count;  // [N]
    unsigned long long* lanes;
};

struct EntryArgs {
    WorldArgs world;
    const float* o;
    const float* dirs;
    const int32_t* live_start;  // nullable
    int64_t n;
    float* t;                   // [N] the start parameter
    uint8_t* flag;              // [N] kLive or kEnded
    const Outs* out;
    int K;
};

struct StageArgs {
    WorldArgs world;
    Rows rows;
    uint8_t* flag;
    const int64_t* live_count;  // rays in the packed prefix
    int cap;                    // this stage's iterations
    int final_stage;            // a ray still live at the cap ends (a miss)
    int assume_resident;
    const Outs* out;
    int K;                      // sampler: segments a ray
    int phase_cap;              // sampler: iterations a phase
    int twig_slots;
    int num_materials;
};

// A pointer of the output table, loaded where it is used: a volatile load
// is not hoisted, so the table's pointers hold no register through a march.
template <class T>
__device__ __forceinline__ T* out_ptr(T* const& field) {
    T* p;
    asm volatile("ld.global.nc.u64 %0, [%1];" : "=l"(p) : "l"(&field));
    return p;
}

// A ray's record at its source index: K1's epilogue (march.cu), with the
// coarse charge as its steps.  A ray that did not hit writes the miss record.
__device__ __forceinline__ void write_result(const Outs* out, int64_t at, const MarchState& s,
                                             int steps) {
    out_ptr(out->hit)[at] = s.hit ? 1 : 0;
    out_ptr(out->t)[at] = s.hit ? s.t : INFINITY;
    out_ptr(out->material)[at] = s.rec.material;
    float* bmin = out_ptr(out->cell_bmin);
    bmin[3 * at] = s.rec.bx;
    bmin[3 * at + 1] = s.rec.by;
    bmin[3 * at + 2] = s.rec.bz;
    out_ptr(out->cell_size)[at] = s.rec.size;
    out_ptr(out->steps)[at] = steps;
    out_ptr(out->texel)[at] = s.rec.texel;
}

// The warp writes the segment columns [lo, hi) of `row`, one column a lane:
// those below `phase` from a lane's staged window (`st_*`, indexed by the
// column modulo kWin), the rest empty (slot -1, t0 = t1 = 0).
__device__ __forceinline__ void write_span(const Outs* out, int K, int64_t row, int lo, int hi,
                                           int phase, const int* st_slot, const float* st_t0,
                                           const float* st_t1, int lane) {
    int32_t* slot = out_ptr(out->slot);
    float* t0 = out_ptr(out->t0);
    float* t1 = out_ptr(out->t1);
    for (int c = lo + lane; c < hi; c += 32) {
        const bool seg = c < phase;
        const int w = c % kWin;
        const int64_t at = row * K + c;
        slot[at] = seg ? st_slot[w] : -1;
        t0[at] = seg ? st_t0[w] : 0.0f;
        t1[at] = seg ? st_t1[w] : 0.0f;
    }
}

// K9 (a): the world-entry slab test of every ray (march_jnp._entry_t_live,
// as K1 runs it); a ray that never enters is finished here: its miss
// record, or its count 0 and its K empty columns, which the warp writes as
// one span over its 32 consecutive rows.  The first thread zeroes the
// call's lane counts (one, or one a phase).
template <bool kSampler>
__global__ void __launch_bounds__(kPathThreads) compact_entry_kernel(const EntryArgs a) {
    const int lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t row0 = r - lane;
    if (row0 >= a.n) return;                 // the whole warp lies past the end
    if (r == 0) {
        for (int k = 0; k < (kSampler ? a.K : 1); ++k) a.out->lanes[k] = 0;
    }
    const bool exists = r < a.n;
    bool live = false;
    if (exists) {
        const Ray q = load_ray(a.o, a.dirs, r);
        float t0;
        entry_t_live(q, world_box(a.world), t0, live);
        if (a.live_start != nullptr) live = live && a.live_start[r] != 0;
        a.t[r] = start_t(t0);
        a.flag[r] = live ? kLive : kEnded;
    }
    if constexpr (kSampler) {
        const unsigned out = __ballot_sync(kFull, exists && !live);
        const int64_t span = (a.n - row0 < 32 ? a.n - row0 : 32) * a.K;
        for (int64_t e = lane; out != 0 && e < span; e += 32) {
            if ((out >> (e / a.K)) & 1u) {
                a.out->slot[row0 * a.K + e] = -1;
                a.out->t0[row0 * a.K + e] = 0.0f;
                a.out->t1[row0 * a.K + e] = 0.0f;
            }
        }
        if (exists && !live) a.out->count[r] = 0;
    } else {
        if (exists && !live) write_result(a.out, r, MarchState(), 0);
    }
}

// The frame march's stage for one chunk of 32 packed rays [base, base + 32)
// (the lanes past `live` idle): each live lane marches `cap` iterations,
// takes its warp's trip as its charge, and writes its record or its row.
__device__ __forceinline__ void march_chunk(const StageArgs& a, const Box& box, int64_t base,
                                            int64_t live, int lane) {
    const int64_t i = base + lane;
    const bool mine = i < live;
    const Ray q = load_ray(a.rows.o, a.rows.d, mine ? i : base);
    PathCache path;
    MarchState s;
    if (mine) {
        s = run_march<false>(a.world, box, q, start_t(fmaxf(a.rows.t[i], 0.0f)), true, a.cap, 0,
                             0, a.assume_resident != 0, path);
    }
    // iterations this lane ran: a ray that left the world or a resident chunk
    // ran one more than it counted steps
    const int iters = !mine ? 0 : ((s.hit || s.live) ? s.steps : s.steps + 1);
    const int trip = __reduce_max_sync(kFull, iters);
    if (lane == 0 && trip > 0) atomicAdd(out_ptr(a.out->lanes), 32ull * (unsigned)trip);
    if (!mine) return;
    const int charge = a.rows.charge[i] + trip;
    if (s.live && !a.final_stage) {
        a.flag[i] = kLive;
        a.rows.t[i] = s.t;
        a.rows.charge[i] = charge;
    } else {
        a.flag[i] = kEnded;
        write_result(a.out, a.rows.orig[i], s, charge);
    }
}

// The phase-merged sampler's stage for one chunk: every lane takes one step
// a pass (run_march with a cap of one, its path carried), so lanes in
// different phases step together and a phase boundary is no reconvergence
// point.  A hit stages its segment in the lane's window of kWin columns and
// starts the next phase at t1 + EPS at once; a miss, the phase's cap or the
// K-th segment ends the ray; a ray that spends the stage's iterations stays
// live with its phase and iterations.  A lane's row is written by the whole
// warp, a span of consecutive columns: its window when it fills, and at the
// stage's end what it staged since (with, for a ray that ended, its empty
// columns up to K, and its count).  The chunk's lanes are charged to the
// phase of its first ray at the stage's start.
__device__ __forceinline__ void sampler_chunk(const StageArgs& a, const Box& box, int64_t base,
                                              int64_t live, int lane) {
    __shared__ int sh_slot[kPathThreads / 32][32 * kWinPitch];
    __shared__ float sh_t0[kPathThreads / 32][32 * kWinPitch];
    __shared__ float sh_t1[kPathThreads / 32][32 * kWinPitch];
    const int wb = threadIdx.x >> 5;
    const int64_t i = base + lane;
    const bool mine = i < live;
    const Ray q = load_ray(a.rows.o, a.rows.d, mine ? i : base);
    const int state = mine ? a.rows.charge[i] : 0;
    int phase = state >> kUsedBits;
    int used = state & kUsedMask;
    int lo = phase;                     // the first column staged and not yet written
    int ran = 0;                        // iterations this lane ran in the stage
    float t = mine ? start_t(fmaxf(a.rows.t[i], 0.0f)) : 0.0f;
    bool ended = false, going = mine;
    PathCache path;
    while (__any_sync(kFull, going)) {
        bool full = false;
        if (going) {
            const MarchState s = run_march<false>(a.world, box, q, t, true, 1, 0, 0,
                                                  a.assume_resident != 0, path);
            ++ran;
            ++used;
            if (s.hit) {
                const Segment g = extract_segment(q, s, a.twig_slots, a.num_materials);
                const int w = lane * kWinPitch + phase % kWin;
                sh_slot[wb][w] = g.slot;
                sh_t0[wb][w] = g.t0;
                sh_t1[wb][w] = g.t1;
                t = start_t(fmaxf(g.t1 + kEps, 0.0f));   // the next phase, past the cell
                used = 0;
                ended = ++phase == a.K;
                full = phase % kWin == 0;
            } else if (!s.live) {
                ended = true;                             // left the world: a miss
            } else {
                t = s.t;
                ended = used >= a.phase_cap;              // live at the phase's cap: a miss
            }
            going = !ended && ran < a.cap;
        }
        unsigned m = __ballot_sync(kFull, full);          // windows that filled this pass
        if (m != 0) {
            __syncwarp();
            const int64_t row = mine ? a.rows.orig[i] : 0;
            for (; m != 0; m &= m - 1) {
                const int j = __ffs(m) - 1;
                const int hi = __shfl_sync(kFull, phase, j);
                write_span(a.out, a.K, __shfl_sync(kFull, row, j), __shfl_sync(kFull, lo, j),
                           hi, hi, sh_slot[wb] + j * kWinPitch, sh_t0[wb] + j * kWinPitch,
                           sh_t1[wb] + j * kWinPitch, lane);
            }
            __syncwarp();
            if (full) lo = phase;
        }
    }
    ended = mine && (ended || a.final_stage);
    const int end = ended ? a.K : phase;                  // columns this stage writes: [lo, end)
    unsigned m = __ballot_sync(kFull, mine && end > lo);
    if (m != 0) {
        __syncwarp();
        const int64_t row = mine ? a.rows.orig[i] : 0;
        for (; m != 0; m &= m - 1) {
            const int j = __ffs(m) - 1;
            write_span(a.out, a.K, __shfl_sync(kFull, row, j), __shfl_sync(kFull, lo, j),
                       __shfl_sync(kFull, end, j), __shfl_sync(kFull, phase, j),
                       sh_slot[wb] + j * kWinPitch, sh_t0[wb] + j * kWinPitch,
                       sh_t1[wb] + j * kWinPitch, lane);
        }
    }
    const int trip = __reduce_max_sync(kFull, ran);
    if (lane == 0 && trip > 0) {   // the chunk's first ray's phase at the stage's start
        atomicAdd(out_ptr(a.out->lanes) + (a.rows.charge[base] >> kUsedBits),
                  32ull * (unsigned)trip);
    }
    if (!mine) return;             // (only lane 0 rewrites row `base`, after it read it)
    if (ended) {
        a.flag[i] = kEnded;
        out_ptr(a.out->count)[a.rows.orig[i]] = phase;
    } else {
        a.flag[i] = kLive;
        a.rows.t[i] = t;
        a.rows.charge[i] = (phase << kUsedBits) | used;
    }
}

// K9 (b) and (c): one stage over the packed prefix [0, *live_count); the
// grid covers all N rays and a warp past the prefix leaves at once.
template <bool kSampler>
__global__ void __launch_bounds__(kPathThreads, kMinBlocks) compact_stage_kernel(const StageArgs a) {
    const int lane = threadIdx.x & 31;
    const int64_t live = *a.live_count;
    const int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
    if (base >= live) return;                // the whole warp lies past the prefix
    const Box box = world_box(a.world);
    if constexpr (kSampler) {
        sampler_chunk(a, box, base, live, lane);
    } else {
        march_chunk(a, box, base, live, lane);
    }
}

// ---- K10: the stable partition ------------------------------------------------

constexpr int kPartThreads = 256;
constexpr int kPartItems = 8;
constexpr int kPartTile = kPartThreads * kPartItems;   // rays a tile
constexpr int kPartWarps = kPartThreads / 32;

struct PartitionArgs {
    const uint8_t* flag;
    Rows src;
    Rows live_dst;            // its charge null when none rides
    Rows next_dst;            // its o null when no ray goes to a next phase
    const int64_t* live_in;   // rays in src's prefix
    int64_t* live_out;        // rays written to live_dst
    const int64_t* next_in;   // rays already in next_dst (nullable: none)
    int64_t* next_out;        // rays in next_dst after this call (nullable)
    int32_t* block_counts;    // [2 * tiles]: live and next-phase rays a tile
};

// Pass 1: each tile's counts of live and of next-phase rays.
__global__ void __launch_bounds__(kPartThreads) partition_count_kernel(const PartitionArgs a) {
    __shared__ int sh[2][kPartWarps];
    const int64_t live = *a.live_in;
    const int64_t tile0 = (int64_t)blockIdx.x * kPartTile;
    if (tile0 >= live) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int c1 = 0, c2 = 0;
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
        const int64_t i = tile0 + j * kPartThreads + threadIdx.x;
        const uint8_t f = i < live ? a.flag[i] : kEnded;
        c1 += __popc(__ballot_sync(kFull, f == kLive));
        c2 += __popc(__ballot_sync(kFull, f == kNext));
    }
    if (lane == 0) {
        sh[0][warp] = c1;
        sh[1][warp] = c2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int s1 = 0, s2 = 0;
        for (int w = 0; w < kPartWarps; ++w) {
            s1 += sh[0][w];
            s2 += sh[1][w];
        }
        a.block_counts[2 * blockIdx.x] = s1;
        a.block_counts[2 * blockIdx.x + 1] = s2;
    }
}

__device__ __forceinline__ void copy_row(const Rows& src, int64_t i, const Rows& dst, int64_t k) {
    dst.o[3 * k] = src.o[3 * i];
    dst.o[3 * k + 1] = src.o[3 * i + 1];
    dst.o[3 * k + 2] = src.o[3 * i + 2];
    dst.d[3 * k] = src.d[3 * i];
    dst.d[3 * k + 1] = src.d[3 * i + 1];
    dst.d[3 * k + 2] = src.d[3 * i + 2];
    dst.t[k] = src.t[i];
    dst.orig[k] = src.orig != nullptr ? src.orig[i] : i;
    if (dst.charge != nullptr) dst.charge[k] = src.charge != nullptr ? src.charge[i] : 0;
}

// Pass 2: each tile's offsets (the counts of the tiles before it), its rays
// ranked in index order, their rows copied; the tile holding the prefix's
// last ray (tile 0 for an empty prefix) writes the new counts.
__global__ void __launch_bounds__(kPartThreads) partition_scatter_kernel(const PartitionArgs a) {
    __shared__ int cnt[2][kPartItems][kPartWarps];
    __shared__ int64_t red[2][kPartWarps];
    __shared__ int64_t base[2];
    const int64_t live = *a.live_in;
    const int64_t last_tile = live > 0 ? (live - 1) / kPartTile : 0;
    if ((int64_t)blockIdx.x > last_tile) return;
    const int64_t tile0 = (int64_t)blockIdx.x * kPartTile;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    int64_t p1 = 0, p2 = 0;
    for (int64_t b = threadIdx.x; b < (int64_t)blockIdx.x; b += kPartThreads) {
        p1 += a.block_counts[2 * b];
        p2 += a.block_counts[2 * b + 1];
    }
    for (int off = 16; off > 0; off >>= 1) {
        p1 += __shfl_down_sync(kFull, p1, off);
        p2 += __shfl_down_sync(kFull, p2, off);
    }
    if (lane == 0) {
        red[0][warp] = p1;
        red[1][warp] = p2;
    }

    uint8_t f[kPartItems];
    unsigned b1[kPartItems], b2[kPartItems];
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
        const int64_t i = tile0 + j * kPartThreads + threadIdx.x;
        f[j] = i < live ? a.flag[i] : kEnded;
        b1[j] = __ballot_sync(kFull, f[j] == kLive);
        b2[j] = __ballot_sync(kFull, f[j] == kNext);
        if (lane == 0) {
            cnt[0][j][warp] = __popc(b1[j]);
            cnt[1][j][warp] = __popc(b2[j]);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t s1 = 0, s2 = a.next_in != nullptr ? *a.next_in : 0;
        for (int w = 0; w < kPartWarps; ++w) {
            s1 += red[0][w];
            s2 += red[1][w];
        }
        base[0] = s1;
        base[1] = s2;
        int e1 = 0, e2 = 0;   // exclusive offsets inside the tile, in index order
        for (int j = 0; j < kPartItems; ++j) {
            for (int w = 0; w < kPartWarps; ++w) {
                const int c1 = cnt[0][j][w], c2 = cnt[1][j][w];
                cnt[0][j][w] = e1;
                cnt[1][j][w] = e2;
                e1 += c1;
                e2 += c2;
            }
        }
        if ((int64_t)blockIdx.x == last_tile) {
            *a.live_out = s1 + e1;
            if (a.next_out != nullptr) *a.next_out = s2 + e2;
        }
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
        const int64_t i = tile0 + j * kPartThreads + threadIdx.x;
        if (f[j] == kLive) {
            copy_row(a.src, i, a.live_dst, base[0] + cnt[0][j][warp] + __popc(b1[j] & below));
        } else if (f[j] == kNext) {
            copy_row(a.src, i, a.next_dst, base[1] + cnt[1][j][warp] + __popc(b2[j] & below));
        }
    }
}

Rows rows(void* o, void* d, void* t, void* orig, void* charge) {
    Rows r;
    r.o = static_cast<float*>(o);
    r.d = static_cast<float*>(d);
    r.t = static_cast<float*>(t);
    r.orig = static_cast<int64_t*>(orig);
    r.charge = static_cast<int32_t*>(charge);
    return r;
}

}  // namespace
}  // namespace ort

extern "C" {

// Loads K9's and K10's kernels, so that a stream capture launches only
// loaded code (not a launch: bound apart from SIGNATURES, as
// ort_error_string is).
cudaError_t ort_compact_load(void) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, ort::compact_entry_kernel<false>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ort::compact_entry_kernel<true>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ort::compact_stage_kernel<false>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ort::compact_stage_kernel<true>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ort::partition_count_kernel);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ort::partition_scatter_kernel);
    return e;
}

// K9 (a) over n rays: `sampler` selects what a ray that never enters writes
// (its miss record, or its empty segment row), through the table `out`.
// Returns cudaGetLastError().
int ort_compact_entry(const void* tree, const void* twig, const void* twig_occ,
                      const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
                      const void* chunkcoordmin, float chunksize, int w, int h, int d,
                      int depth, int64_t twig_len, int64_t occ_len, const void* o,
                      const void* dirs, const void* live_start, int64_t n, void* t, void* flag,
                      int sampler, const void* out, int K, void* stream) {
    ort::EntryArgs a = {};
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.live_start = static_cast<const int32_t*>(live_start);
    a.n = n;
    a.t = static_cast<float*>(t);
    a.flag = static_cast<uint8_t*>(flag);
    a.out = static_cast<const ort::Outs*>(out);
    a.K = K;
    if (n > 0) {
        const int threads = ort::kPathThreads;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (sampler) {
            ort::compact_entry_kernel<true><<<blocks, threads, 0, st>>>(a);
        } else {
            ort::compact_entry_kernel<false><<<blocks, threads, 0, st>>>(a);
        }
    }
    return (int)cudaGetLastError();
}

// K9 (b), or (c) with `sampler`: one stage of `cap` iterations over the
// packed prefix [0, *live_count) of the rows, at most n rays; a block of 128
// threads per 128 of them.  Returns cudaGetLastError().
int ort_compact_stage(const void* tree, const void* twig, const void* twig_occ,
                      const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
                      const void* chunkcoordmin, float chunksize, int w, int h, int d,
                      int depth, int64_t twig_len, int64_t occ_len, void* o, void* dirs,
                      void* t, void* orig, void* charge, void* flag, const void* live_count,
                      int64_t n, int cap, int final_stage, int assume_resident, const void* out,
                      int sampler, int K, int phase_cap, int twig_slots, int num_materials,
                      void* stream) {
    ort::StageArgs a = {};
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.rows = ort::rows(o, dirs, t, orig, charge);
    a.flag = static_cast<uint8_t*>(flag);
    a.live_count = static_cast<const int64_t*>(live_count);
    a.cap = cap;
    a.final_stage = final_stage;
    a.assume_resident = assume_resident;
    a.out = static_cast<const ort::Outs*>(out);
    a.K = K;
    a.phase_cap = phase_cap;
    a.twig_slots = twig_slots;
    a.num_materials = num_materials;
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + ort::kPathThreads - 1) / ort::kPathThreads);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (sampler) {
            ort::compact_stage_kernel<true><<<blocks, ort::kPathThreads, 0, st>>>(a);
        } else {
            ort::compact_stage_kernel<false><<<blocks, ort::kPathThreads, 0, st>>>(a);
        }
    }
    return (int)cudaGetLastError();
}

// K10 over a prefix of at most m rays: its counts pass, then its scatter.
// `block_counts` holds 2 * ceil(m / 2048) int32.  Returns cudaGetLastError().
int ort_partition(const void* flag, void* src_o, void* src_d, void* src_t, void* src_orig,
                  void* src_charge, void* live_o, void* live_d, void* live_t, void* live_orig,
                  void* live_charge, void* next_o, void* next_d, void* next_t, void* next_orig,
                  const void* live_in, void* live_out, const void* next_in, void* next_out,
                  void* block_counts, int64_t m, void* stream) {
    ort::PartitionArgs a = {};
    a.flag = static_cast<const uint8_t*>(flag);
    a.src = ort::rows(src_o, src_d, src_t, src_orig, src_charge);
    a.live_dst = ort::rows(live_o, live_d, live_t, live_orig, live_charge);
    a.next_dst = ort::rows(next_o, next_d, next_t, next_orig, nullptr);
    a.live_in = static_cast<const int64_t*>(live_in);
    a.live_out = static_cast<int64_t*>(live_out);
    a.next_in = static_cast<const int64_t*>(next_in);
    a.next_out = static_cast<int64_t*>(next_out);
    a.block_counts = static_cast<int32_t*>(block_counts);
    const int64_t tiles = (m + ort::kPartTile - 1) / ort::kPartTile;
    const unsigned blocks = (unsigned)(tiles > 0 ? tiles : 1);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    ort::partition_count_kernel<<<blocks, ort::kPartThreads, 0, st>>>(a);
    ort::partition_scatter_kernel<<<blocks, ort::kPartThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
