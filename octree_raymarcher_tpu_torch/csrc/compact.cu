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
// partition: every ray ends there.  The sampler (K9c) runs the same stages
// phase after phase; a ray that hits ends its phase, its segment is written,
// and the partition appends it to the next phase's buffer.
//
// What bounds it on an H100.  K9 is K1's loop (march_step.cuh run_march,
// called as K1 and K4 call it, so their code is unchanged): chains of
// dependent L2 loads and the divergence of a warp's lanes.  Re-packing is
// meant to cut the divergence: a warp's 32 lanes are 32 live rays, so a warp
// runs to the longest of its live rays for at most one stage.  What it costs:
// the live count stays on the card (no host synchronisation, so each launch
// is sized for all N rays), a launch and a partition per stage, and the rows
// moved by each partition (40 bytes a ray; 36 for the sampler).  K10 moves
// bytes and nothing else.
//
// What this design does about it:
//   * K9 reads the live count from device memory, and its grid is sized for
//     all N rays: a warp past the live prefix leaves at once.  A warp takes
//     32 consecutive packed rays, so the warp whose trip count is charged is
//     the warp that ran.  (A persistent grid walking the prefix with a grid
//     stride ran slower, and so did this kernel with that loop in it: the
//     loop and the block's barrier for its lane count made the march's warps
//     4.7 times slower than K1's on the same rays, PERF.md.)
//   * A ray that ends in a stage writes its record (hit record, or miss) at
//     its source index there and then: no decode pass and no unpermute at
//     the end.  The rays that never enter get their miss records (or empty
//     segment rows) from the entry.
//   * The step charge and the lane count are warp-level: each live lane adds
//     its warp's trip count (the most iterations a lane of it ran, one
//     reduction), and the warp's first lane adds 32 times it to the count.
//   * K10 is two kernels in one launch call: per tile of 2,048 rays its
//     counts of live and of next-phase rays (ballots), then the scatter: each
//     tile sums the counts of the tiles before it, ranks its rays by ballot
//     and population count in index order, and copies their rows.  The new
//     counts go to device memory.  Two passes need no tile counter and no
//     look-back, so no block ever waits on another.
//
// Arithmetic: a stage resumes at max(t, 0), clamped and with its sign
// cleared (march.cu's resume), as march_plain does with t_start; with
// -fmad=false every stage walks the cells one launch of K1 walks, and K9
// agrees with the plain version (ops/march_compact.py) bit for bit.

#include "compact.cuh"

namespace ort {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// The MarchResult of the caller's N rays (the frame march).
struct ResultOut {
    uint8_t* hit;
    float* t;
    int32_t* material;
    float* cell_bmin;
    float* cell_size;
    int32_t* steps;
    int32_t* texel;
};

// The SegmentBatch of the caller's N rays (the sampler).
struct SegmentOut {
    int32_t* slot;   // [N, K]
    float* t0;       // [N, K]
    float* t1;       // [N, K]
    int32_t* count;  // [N]
    int K;
    int twig_slots;
    int num_materials;
};

struct EntryArgs {
    WorldArgs world;
    const float* o;
    const float* dirs;
    const int32_t* live_start;  // nullable
    int64_t n;
    float* t;                   // [N] the start parameter
    uint8_t* flag;              // [N] kLive or kEnded
    ResultOut res;
    SegmentOut seg;
};

struct StageArgs {
    WorldArgs world;
    Rows rows;
    uint8_t* flag;
    const int64_t* live_count;  // rays in the packed prefix
    int cap;                    // this stage's iterations
    int final_stage;            // a ray still live at the cap is a miss
    int assume_resident;
    unsigned long long* lane_iters;
    ResultOut res;
    SegmentOut seg;
    int phase;                  // sampler: the column a hit writes
};

// A ray's record at its source index: K1's epilogue (march.cu), with the
// coarse charge as its steps.  A ray that did not hit writes the miss record.
__device__ __forceinline__ void write_result(const ResultOut& r, int64_t at, const MarchState& s,
                                             int steps) {
    r.hit[at] = s.hit ? 1 : 0;
    r.t[at] = s.hit ? s.t : INFINITY;
    r.material[at] = s.rec.material;
    r.cell_bmin[3 * at] = s.rec.bx;
    r.cell_bmin[3 * at + 1] = s.rec.by;
    r.cell_bmin[3 * at + 2] = s.rec.bz;
    r.cell_size[at] = s.rec.size;
    r.steps[at] = steps;
    r.texel[at] = s.rec.texel;
}

// A ray that recorded `count` segments ends: columns count .. K-1 hold no
// segment (slot -1, t0 = t1 = 0), as K4 writes them.
__device__ __forceinline__ void write_tail(const SegmentOut& g, int64_t at, int count) {
    for (int c = count; c < g.K; ++c) {
        const int64_t k = at * g.K + c;
        g.slot[k] = -1;
        g.t0[k] = 0.0f;
        g.t1[k] = 0.0f;
    }
    g.count[at] = count;
}

// K9 (a): the world-entry slab test of every ray (march_jnp._entry_t_live,
// as K1 runs it); a ray that never enters is finished here.
template <bool kSampler>
__global__ void __launch_bounds__(kPathThreads) compact_entry_kernel(const EntryArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    const Ray q = load_ray(a.o, a.dirs, r);
    float t0;
    bool live;
    entry_t_live(q, world_box(a.world), t0, live);
    if (a.live_start != nullptr) live = live && a.live_start[r] != 0;
    a.t[r] = start_t(t0);
    a.flag[r] = live ? kLive : kEnded;
    if (!live) {
        if constexpr (kSampler) {
            write_tail(a.seg, r, 0);
        } else {
            write_result(a.res, r, MarchState(), 0);
        }
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
    const int64_t i = base + lane;
    const bool mine = i < live;
    const Ray q = load_ray(a.rows.o, a.rows.d, mine ? i : base);
    const Box box = world_box(a.world);
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
    if (lane == 0 && trip > 0) atomicAdd(a.lane_iters, 32ull * (unsigned)trip);
    if (!mine) return;
    const int64_t src = a.rows.orig[i];
    const bool go_on = s.live && !a.final_stage;
    if constexpr (!kSampler) {
        const int charge = a.rows.charge[i] + trip;
        if (go_on) {
            a.flag[i] = kLive;
            a.rows.t[i] = s.t;
            a.rows.charge[i] = charge;
        } else {
            a.flag[i] = kEnded;
            write_result(a.res, src, s, charge);
        }
    } else {
        if (go_on) {
            a.flag[i] = kLive;
            a.rows.t[i] = s.t;
        } else if (s.hit) {
            const Segment g = extract_segment(q, s, a.seg.twig_slots, a.seg.num_materials);
            const int64_t at = src * a.seg.K + a.phase;
            a.seg.slot[at] = g.slot;
            a.seg.t0[at] = g.t0;
            a.seg.t1[at] = g.t1;
            if (a.phase + 1 < a.seg.K) {
                a.flag[i] = kNext;
                a.rows.t[i] = g.t1 + kEps;   // the next phase resumes past the cell
            } else {
                a.flag[i] = kEnded;
                a.seg.count[src] = a.seg.K;
            }
        } else {
            a.flag[i] = kEnded;
            write_tail(a.seg, src, a.phase);
        }
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

ResultOut result_out(void* hit, void* t, void* material, void* cell_bmin, void* cell_size,
                     void* steps, void* texel) {
    ResultOut r;
    r.hit = static_cast<uint8_t*>(hit);
    r.t = static_cast<float*>(t);
    r.material = static_cast<int32_t*>(material);
    r.cell_bmin = static_cast<float*>(cell_bmin);
    r.cell_size = static_cast<float*>(cell_size);
    r.steps = static_cast<int32_t*>(steps);
    r.texel = static_cast<int32_t*>(texel);
    return r;
}

SegmentOut segment_out(void* slot, void* t0, void* t1, void* count, int K, int twig_slots,
                       int num_materials) {
    SegmentOut g;
    g.slot = static_cast<int32_t*>(slot);
    g.t0 = static_cast<float*>(t0);
    g.t1 = static_cast<float*>(t1);
    g.count = static_cast<int32_t*>(count);
    g.K = K;
    g.twig_slots = twig_slots;
    g.num_materials = num_materials;
    return g;
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

// K9 (a) over n rays: `sampler` selects what a ray that never enters writes
// (its miss record, or its empty segment row).  Returns cudaGetLastError().
int ort_compact_entry(const void* tree, const void* twig, const void* twig_occ,
                      const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
                      const void* chunkcoordmin, float chunksize, int w, int h, int d,
                      int depth, int64_t twig_len, int64_t occ_len, const void* o,
                      const void* dirs, const void* live_start, int64_t n, void* t, void* flag,
                      int sampler, void* hit, void* out_t, void* material, void* cell_bmin,
                      void* cell_size, void* steps, void* texel, void* slot, void* t0, void* t1,
                      void* count, int K, void* stream) {
    ort::EntryArgs a = {};
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.live_start = static_cast<const int32_t*>(live_start);
    a.n = n;
    a.t = static_cast<float*>(t);
    a.flag = static_cast<uint8_t*>(flag);
    a.res = ort::result_out(hit, out_t, material, cell_bmin, cell_size, steps, texel);
    a.seg = ort::segment_out(slot, t0, t1, count, K, 0, 1);
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
                      int64_t n, int cap, int final_stage, int assume_resident,
                      void* lane_iters, int sampler, void* hit, void* out_t, void* material,
                      void* cell_bmin, void* cell_size, void* steps, void* texel, void* slot,
                      void* t0, void* t1, void* count, int K, int phase, int twig_slots,
                      int num_materials, void* stream) {
    ort::StageArgs a = {};
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.rows = ort::rows(o, dirs, t, orig, charge);
    a.flag = static_cast<uint8_t*>(flag);
    a.live_count = static_cast<const int64_t*>(live_count);
    a.cap = cap;
    a.final_stage = final_stage;
    a.assume_resident = assume_resident;
    a.lane_iters = static_cast<unsigned long long*>(lane_iters);
    a.res = ort::result_out(hit, out_t, material, cell_bmin, cell_size, steps, texel);
    a.seg = ort::segment_out(slot, t0, t1, count, K, twig_slots, num_materials);
    a.phase = phase;
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
