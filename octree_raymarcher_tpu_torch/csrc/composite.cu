// K5 (forward) and K6 (backward): soft voxel compositing on coalesced segment
// tiles.
//
// Replaces the JAX package's compositor (B5):
// octree_raymarcher_tpu/diff/composite.py `composite` (:89-134) and the
// VJP that jax.grad derives for it.  Per ray, over its K segments:
//     sigma_k = logaddexp(density_raw[slot_k], 0)
//     tau_k   = slot_k >= 0 ? sigma_k * max(t1_k - t0_k, 0) : 0
//     alpha_k = 1 - exp(-tau_k)
//     T_k     = exp(-(C_k - tau_k)),  C_k = tau_0 + ... + tau_k
//     w_k     = alpha_k * T_k
//     rgb     = sum_k w_k * sigmoid(albedo_raw[slot_k]) + T_end * bg
//     depth   = sum_k w_k * (t0_k + t1_k) / 2 + T_end * far
//     opacity = 1 - T_end,  T_end = exp(-sum_k tau_k)
// The exclusive prefix is C_k - tau_k, as the reference writes it
// (cumsum(tau) - tau), not a running sum of the earlier taus, and softplus
// is logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)); both forms are kept in
// K5, K6 and the plain versions (diff/composite.py).  Each ray's sums run
// sequentially in k, in the plain versions' order.
//
// K6 recomputes the forward from the segments and runs the reverse pass of
// the reference's autodiff: dL/dT_k = G_k * alpha_k with
// G_k = dL/dw_k + g_rgb . a_k + g_depth * mid_k; the prefix's cotangent
// goes back through the cumsum as a reverse inclusive suffix sum R_k, from
// which tau_k's own term is taken off again (the "- tau" of the prefix);
// then dL/dtau_k = G_k * T_k * (1 - alpha_k) + (R_k - bB_k) - T_end * G_end.
// Gradients reach density_raw through d sigma/dx = exp(x - sigma) and
// albedo_raw through the sigmoid's derivative; d bg is written per ray.
//
// What bounds them on an H100: bytes.  A ray reads K segments (12 B each)
// and gathers the parameters of its valid ones (16 B each), and the forward
// writes K weights; a few dozen float operations and a handful of
// transcendentals per segment are far below the FP32 rate.  The design:
//
// K5:
//
// * Coalesced tiles.  A block owns a tile of kRays consecutive rays (two
//   warps, one ray per thread) and walks its tiles in a persistent loop.
//   The tile's rows of slot, t0, t1 are one contiguous span per array; the
//   block copies a chunk of kChunk columns of each span into shared memory
//   with 4-byte cp.async, neighbouring threads on neighbouring words, so
//   every byte crosses DRAM once, in full sectors (a whole row is one chunk
//   when K is at most kChunk).  Each word lands at row * stride + column
//   with an odd stride, so the 32 lanes of a warp, each walking its own row,
//   hit 32 different banks (a 16-byte copy could not place a row at an odd
//   stride, and its pieces straddle rows when K is not a multiple of 4).
//   The ragged last tile copies only the rays that exist.
// * One stage buffer: a chunk's copy overlaps the math of the other blocks
//   on the SM.  The bytes of shared memory are planned in Python
//   (diff/composite.py `composite_plan`).
// * K5 stages its weights in shared memory and stores each chunk as
//   coalesced spans; rgb, depth and opacity are written once per ray.
// * Invalid segments (slot < 0, anywhere in a row) have tau = 0, so alpha =
//   w = 0 and they add nothing; their parameter gathers are skipped, which
//   is exact for finite parameters.  Parameter gathers are issued for
//   kGroup segments at a time before their sequential math, so each thread
//   keeps several independent loads in flight.
//
// K6.  Measured on its earlier schedule (tiles of 64 rays, rows staged 16
// columns at a time, the recompute's prefix sums kept; PERF.md, kernel
// table): its warps spent 37% of their time waiting for staged chunks, the
// reverse pass gathered the density and recomputed the softplus again,
// about half the columns were trailing padding that paid the full math, and
// the scatter ran warp collectives on every column.  A version with one ray
// a lane held so much per ray on chip that 8 warps fitted an SM, and the
// kernel was bound by latency.  Its schedule now:
//
// * One warp, one tile of kTileRays rays, two lanes a ray.  A block is one
//   warp and walks its tiles in a persistent loop; its shared memory is its
//   own, so no warp waits for another.  A ray's columns alternate between
//   its kLanes lanes: each lane does the work of its own columns alone, and
//   the sums that run along the row (C_k forward, R backward) pass from lane
//   to lane by shuffles, column by column, in the plain versions' order.
//   Half the rays a warp and the same bytes a ray let twice the warps share
//   an SM (17 at the training path's K = 32, by registers).
// * Each row staged once.  While the block stays within 48 KB, the whole
//   rows of slot, t0, t1 (and dL/dw when given) are copied in with cp.async
//   (8-byte pieces for an even K, else 4), neighbouring lanes on
//   neighbouring pieces; a row's stride is kLanes x an odd count of words,
//   so a warp's 32 lanes, kLanes to a row, hit 32 banks.  Longer rows are
//   staged kChunk columns at a time, the reverse pass copying all but the
//   last chunk again.
// * The tile's last valid column.  A warp vote over the staged slots finds
//   the last column in which any row of the tile has a valid segment; both
//   passes stop there.  That is exact: a column past it has tau = 0, so C
//   and the total are unchanged, alpha = w = 0, its prefix cotangent
//   -(gw * 0) * T adds a zero that leaves R as it was (R is +0 there), and
//   it flushes nothing.  Columns before it are walked as before.  A nullable
//   int64[2] counter takes, once per tile, the tile's columns (rows * K) and
//   the columns past its last valid one (rows * (K - cut)).
// * The recompute's values kept for the reverse pass: with whole rows, tau
//   and d sigma/dx = exp(x - sigma) overwrite t0 and t1 in the staged row,
//   and dl, C_k (and the midpoint, for a depth gradient) are kept laid out
//   [value][k][ray] (a warp's words of one k are 32 banks); with chunked
//   rows tau, d sigma/dx and C_k are kept, in shared memory, or for the
//   longest rows in a global scratch of one area per resident block.  The
//   reverse pass gathers only the albedo: no density gather, no softplus.
// * The scatter of the parameter gradients is aggregated at two levels,
//   exact up to summation order: (1) a lane's consecutive segments on one
//   slot sum in registers; (2) the hot slots [hot_lo, hot_lo + 8) (the
//   coarse-LEAF slots, one per material, that half of all segments land on)
//   sum in each lane's registers, reduced across the warp and flushed with
//   at most 32 atomics when the block is done.  Any other run goes out at
//   once: one atomic for the density and two for the albedo (a float2 on
//   its 8-byte-aligned pair).  Grouping the warp's runs by slot first (a
//   __match_any_sync a column) cost more than the atomics it saved.  hot_lo
//   only routes sums; any slot gives the same sums up to their order.
// * Invalid segments before the cut are walked with the valid ones (their
//   lanes' values are selected away).  Each pass takes kBwdGroup columns a
//   lane at a time: their gathers and the work each column needs alone go
//   together, then the sums that run along the row.

#include "common.cuh"

namespace ort {
namespace {

constexpr int kHotSlots = 8;     // init_params_from_world's num_materials
constexpr int kRays = 64;        // rays per tile = threads per block
constexpr int kChunk = 16;       // columns of a row staged at once
constexpr int kGroup = 4;        // segments whose gathers are issued together
constexpr int kWarp = 32;        // K6: threads per block, one warp
constexpr int kLanes = 2;        // K6: lanes a ray, each on every kLanes-th column
constexpr int kTileRays = kWarp / kLanes;   // K6: rays per tile
constexpr int kBwdGroup = 4;     // K6: columns of a lane whose independent work goes together
constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory without raising its limit
constexpr unsigned kFull = 0xffffffffu;

struct CompositeArgs {
    const int32_t* slot;      // [N, K]
    const float* t0;          // [N, K]
    const float* t1;          // [N, K]
    const float* density;     // [P]
    const float* albedo;      // [P, 3]
    const float* bg;          // [3] or [N, 3]
    int bg_per_ray;
    float far;
    int64_t n;
    int K;
    int64_t P;
    // tiling
    int chunk;                // columns per staged chunk: K5 min(K, kChunk), at least 1;
                              // K6 bwd_chunk
    int stride;               // row stride in shared memory: K5 chunk | 1, K6 bwd_stride
    int nchunks;
    int64_t tiles;            // K5 tiles of kRays rays, K6 of kTileRays
    // forward outputs
    float* rgb;               // [N, 3]
    float* depth;             // [N]
    float* opacity;           // [N]
    float* weights;           // [N, K]
    // backward inputs (nullable upstream gradients) and outputs
    const float* g_rgb;
    const float* g_depth;
    const float* g_opacity;
    const float* g_weights;
    float* scratch;           // K6, longest rows: kept values, an area per resident block
    float* d_density;         // [P], accumulated
    float* d_albedo;          // [P, 3], accumulated
    float* d_bg;              // nullable: [N, 3]
    int64_t hot_lo;
    // K6 only
    int64_t scratch_blocks;   // resident blocks the global scratch has room for
    int pairs;                // K even and the staged arrays 8-byte aligned: copies of 8 bytes
    unsigned long long* columns;   // nullable int64[2]: tiles' columns, columns past the cuts
};

// Floats of K5's dynamic shared memory: `arrays` planes of kRays x stride
// and the weight plane (kRays x stride).  diff/composite.py `_smem_bytes`
// computes the same.
inline int64_t smem_floats(int stride, int arrays) {
    return (int64_t)(arrays + 1) * kRays * stride;
}

__device__ __forceinline__ float softplus(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Waits for this thread's copies, then for the whole block's.
__device__ __forceinline__ void cp_async_wait_block() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
}

// Walks the (row, column) words of chunk `c` of `tile`, rows limited to the
// rays that exist, with neighbouring threads on neighbouring words:
// fn(global index, shared index) for each.
template <typename Fn>
__device__ __forceinline__ void walk_chunk(const CompositeArgs& a, int64_t tile, int c, Fn fn) {
    const int c0 = c * a.chunk;
    const int w = min(a.chunk, a.K - c0);
    if (w <= 0) return;
    const int64_t ray0 = tile * kRays;
    const int rows = (int)min((int64_t)kRays, a.n - ray0);
    const int total = rows * w;
    int r = (int)threadIdx.x / w, col = (int)threadIdx.x % w;
    const int dr = (int)blockDim.x / w, dc = (int)blockDim.x % w;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        fn((ray0 + r) * a.K + c0 + col, r * a.stride + col);
        r += dr;
        col += dc;
        if (col >= w) { col -= w; ++r; }
    }
}

// Issues the copies of chunk `c` of `tile` of each staged array into `buf`.
__device__ __forceinline__ void load_chunk(const CompositeArgs& a, const float* const* src,
                                           int arrays, float* buf, int64_t tile, int c) {
    const int plane = kRays * a.stride;
    walk_chunk(a, tile, c, [&](int64_t g, int s) {
        for (int i = 0; i < arrays; ++i) cp_async4(buf + i * plane + s, src[i] + g);
    });
}

struct Seg {
    bool valid;
    int64_t s;      // clipped slot
    float x;        // density_raw[slot] (0 for an invalid segment)
    float sigma, dl, tau, mid;
};

__device__ __forceinline__ int64_t clip_slot(const CompositeArgs& a, int slot) {
    return clampl((int64_t)slot, 0, a.P - 1);
}

__device__ __forceinline__ Seg make_seg(const CompositeArgs& a, int slot, float x, float u,
                                        float v) {
    Seg g;
    g.valid = slot >= 0;
    g.s = clip_slot(a, slot);
    g.x = x;
    g.sigma = softplus(x);
    g.dl = fmaxf(v - u, 0.0f);
    g.tau = g.valid ? g.sigma * g.dl : 0.0f;
    g.mid = 0.5f * (u + v);
    return g;
}

__device__ __forceinline__ float gather_density(const CompositeArgs& a, int slot) {
    return slot >= 0 ? __ldg(a.density + clip_slot(a, slot)) : 0.0f;
}

// albedo_raw[slot]; 0 for an invalid segment (its sigmoid, 0.5, meets a
// weight of 0).
__device__ __forceinline__ V3 gather_albedo_raw(const CompositeArgs& a, int slot) {
    return slot >= 0 ? ld3(a.albedo + 3 * clip_slot(a, slot)) : V3{0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ V3 background(const CompositeArgs& a, int64_t r) {
    const float* b = a.bg + (a.bg_per_ray ? 3 * r : 0);
    return {b[0], b[1], b[2]};
}

// The tiles of this block, in the persistent loop.
__device__ __forceinline__ int64_t block_tiles(const CompositeArgs& a) {
    const int64_t b = blockIdx.x;
    return a.tiles > b ? (a.tiles - b + gridDim.x - 1) / gridDim.x : 0;
}

__global__ void __launch_bounds__(kRays) composite_fwd_kernel(const CompositeArgs a) {
    extern __shared__ __align__(16) float smem[];
    constexpr int arrays = 3;
    const int plane = kRays * a.stride;
    float* wplane = smem + arrays * plane;
    const float* src[arrays] = {reinterpret_cast<const float*>(a.slot), a.t0, a.t1};
    const int spt = a.nchunks;                       // steps per tile
    const int64_t steps = block_tiles(a) * spt;
    auto tile_of = [&](int64_t i) { return (int64_t)blockIdx.x + (i / spt) * gridDim.x; };

    float csum = 0.0f, tau_sum = 0.0f, depth = 0.0f;
    V3 rgb = {0.0f, 0.0f, 0.0f};
    for (int64_t i = 0; i < steps; ++i) {
        const int64_t tile = tile_of(i);
        const int c = (int)(i % spt);
        load_chunk(a, src, arrays, smem, tile, c);
        cp_async_wait_block();

        const int w = min(a.chunk, a.K - c * a.chunk);
        const int64_t r = tile * kRays + threadIdx.x;
        if (c == 0) {
            csum = 0.0f; tau_sum = 0.0f; depth = 0.0f;
            rgb = {0.0f, 0.0f, 0.0f};
        }
        if (r < a.n) {
            const int row = threadIdx.x * a.stride;
            const int32_t* sl = reinterpret_cast<const int32_t*>(smem) + row;
            const float* u0 = smem + plane + row;
            const float* u1 = smem + 2 * plane + row;
            float* wr = wplane + row;
            for (int k0 = 0; k0 < w; k0 += kGroup) {
                int s[kGroup];
                float x[kGroup];
                V3 ar[kGroup];
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    s[j] = k0 + j < w ? sl[k0 + j] : -1;
                    x[j] = gather_density(a, s[j]);
                    ar[j] = gather_albedo_raw(a, s[j]);
                }
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    const int k = k0 + j;
                    if (k >= w) break;
                    const Seg g = make_seg(a, s[j], x[j], u0[k], u1[k]);
                    const float alpha = 1.0f - expf(-g.tau);
                    csum = csum + g.tau;
                    const float T = expf(-(csum - g.tau));
                    const float wk = alpha * T;
                    const V3 alb = {sigmoid(ar[j].x), sigmoid(ar[j].y), sigmoid(ar[j].z)};
                    rgb = add(rgb, scale(alb, wk));
                    depth = depth + wk * g.mid;
                    tau_sum = tau_sum + g.tau;
                    wr[k] = wk;
                }
            }
            if (c == spt - 1) {
                const float t_end = expf(-tau_sum);
                const V3 bg = background(a, r);
                a.rgb[3 * r] = rgb.x + t_end * bg.x;
                a.rgb[3 * r + 1] = rgb.y + t_end * bg.y;
                a.rgb[3 * r + 2] = rgb.z + t_end * bg.z;
                a.depth[r] = depth + t_end * a.far;
                a.opacity[r] = 1.0f - t_end;
            }
        }
        __syncthreads();
        walk_chunk(a, tile, c, [&](int64_t g, int s) { a.weights[g] = wplane[s]; });
    }
}

// ---- K6 ------------------------------------------------------------------

// A row's staged words: kLanes x an odd count, so that the lanes of a warp,
// kLanes to a row each on its own column, hit 32 different banks.
inline int bwd_stride(int W) { return kLanes * (((W + kLanes - 1) / kLanes) | 1); }

// Values K6 keeps per column between its passes: with whole rows, tau and
// d sigma/dx take the places of t0 and t1 in the staged row and dl, C_k
// (and the midpoint, for a depth gradient) are kept; with rows in chunks,
// which the reverse pass copies again, tau, d sigma/dx and C_k are kept.
__host__ __device__ inline int kept_values(bool whole, bool depth) { return whole ? 2 + depth : 3; }

// Floats of K6's dynamic shared memory (one warp a block): `arrays` planes
// of kTileRays rows of bwd_stride(W) words for rows staged W columns at a
// time and, when they stay on chip, the kept values (kept_values x K x
// kTileRays).  diff/composite.py `_smem_bytes` computes the same.
inline int64_t bwd_smem_floats(int W, int K, int arrays, bool on_chip, bool depth) {
    const int64_t f = (int64_t)arrays * kTileRays * bwd_stride(W);
    return on_chip ? f + (int64_t)kept_values(W >= K, depth) * K * kTileRays : f;
}

// Whole rows are staged when the block stays within 48 KB with the kept
// values on chip; else rows go kChunk columns at a time.
inline int bwd_chunk(int K, int arrays, bool depth) {
    const int k = K < 1 ? 1 : K;
    return 4 * bwd_smem_floats(k, K, arrays, true, depth) <= kSmemDefault ? k : kChunk;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// Copies columns [c0, c0 + w) of the tile's rows (rays ray0.. ray0 + rows)
// of each staged array into `buf` (row stride bwd_stride(a.chunk)),
// neighbouring lanes on neighbouring pieces, then waits for them.  A piece
// is two words where K, c0 and w are even and the arrays 8-byte aligned
// (a.pairs), else one.
__device__ __forceinline__ void stage_rows(const CompositeArgs& a, const float* const* src,
                                           int arrays, float* buf, int64_t ray0, int rows,
                                           int c0, int w) {
    const int lane = threadIdx.x;
    const int plane = kTileRays * a.stride;
    const int pw = a.pairs && (c0 % 2 == 0) && (w % 2 == 0) ? 2 : 1;   // words a piece
    const int n = w / pw;                            // pieces a row
    if (n > 0) {
        int r = lane / n, col = lane % n;
        const int dr = kWarp / n, dc = kWarp % n;
        for (int e = lane; e < rows * n; e += kWarp) {
            const int64_t g = (ray0 + r) * a.K + c0 + pw * col;
            float* d = buf + r * a.stride + pw * col;
            for (int i = 0; i < arrays; ++i) {
                if (pw == 2) {
                    cp_async8(d + i * plane, src[i] + g);
                } else {
                    cp_async4(d + i * plane, src[i] + g);
                }
            }
            r += dr;
            col += dc;
            if (col >= n) { col -= n; ++r; }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
}

// Adds one flushed run's four sums to the gradients: the hot slots into the
// lane's registers `hot`, the others by global atomics, the albedo's three
// as a float2 on the row's 8-byte-aligned pair and a float.
__device__ __forceinline__ void flush_run(const CompositeArgs& a, float (&hot)[kHotSlots][4],
                                          int slot, const float v[4]) {
    const int64_t h = (int64_t)slot - a.hot_lo;
    if (h >= 0 && h < kHotSlots) {
#pragma unroll
        for (int j = 0; j < kHotSlots; ++j) {
            if (h == j) {
                for (int m = 0; m < 4; ++m) hot[j][m] = hot[j][m] + v[m];
            }
        }
        return;
    }
    atomicAdd(a.d_density + slot, v[0]);
    float* al = a.d_albedo + 3 * (int64_t)slot;
    if (slot & 1) {
        atomicAdd(al, v[1]);
        atomicAdd(reinterpret_cast<float2*>(al + 1), make_float2(v[2], v[3]));
    } else {
        atomicAdd(reinterpret_cast<float2*>(al), make_float2(v[1], v[2]));
        atomicAdd(al + 2, v[3]);
    }
}

// kWhole: the tile's whole rows are staged once and the kept values live in
// shared memory; else rows are staged a.chunk columns at a time and the
// kept values live in shared memory or (a.scratch) in global memory.
template <bool kWhole>
__global__ void __launch_bounds__(kWarp) composite_bwd_kernel(const CompositeArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x;
    const int h = lane & (kLanes - 1);               // this lane's columns: k = h mod kLanes
    const int rho = lane / kLanes;                   // its ray in the tile
    const int pair = lane & ~(kLanes - 1);           // the first lane of its ray
    const int K = a.K;
    const bool has_gw = a.g_weights != nullptr;
    const int arrays = has_gw ? 4 : 3;
    const bool has_depth = a.g_depth != nullptr;
    const int plane = kTileRays * a.stride;
    float* kept = kWhole || a.scratch == nullptr
                      ? smem + arrays * plane
                      : a.scratch + (int64_t)blockIdx.x * kept_values(false, false) * K * kTileRays;
    // kept value q of column k of this lane's ray: with whole rows dl, C_k and
    // the midpoint; else tau, d sigma/dx and C_k
    auto at = [&](int q, int k) -> float& { return kept[(q * K + k) * kTileRays + rho]; };
    constexpr int kC = kWhole ? 1 : 2;               // where C_k is kept
    const float* src[4] = {reinterpret_cast<const float*>(a.slot), a.t0, a.t1, a.g_weights};
    const int32_t* sl = reinterpret_cast<const int32_t*>(smem) + rho * a.stride;
    float* u0 = smem + plane + rho * a.stride;       // t0, then (whole rows) tau
    float* u1 = smem + 2 * plane + rho * a.stride;   // t1, then (whole rows) d sigma/dx
    const float* gwt = smem + 3 * plane + rho * a.stride;
    float hot[kHotSlots][4];
#pragma unroll
    for (int j = 0; j < kHotSlots; ++j) {
        for (int m = 0; m < 4; ++m) hot[j][m] = 0.0f;
    }
    const int W = a.chunk;
    constexpr int kSpan = kLanes * kBwdGroup;        // columns of a group, kBwdGroup a lane

    for (int64_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int64_t ray0 = tile * kTileRays;
        const int rows = (int)min((int64_t)kTileRays, a.n - ray0);
        const int64_t r = ray0 + rho;
        const bool live = rho < rows;
        if (kWhole) stage_rows(a, src, arrays, smem, ray0, rows, 0, K);

        // the tile's last valid column, by a vote over the rows
        int cut = K;
        if (kWhole) {
            while (cut > 0 && __ballot_sync(kFull, live && sl[cut - 1] >= 0) == 0) --cut;
        } else {
            const int32_t* row = a.slot + r * K;
            while (cut > 0 && __ballot_sync(kFull, live && __ldg(row + cut - 1) >= 0) == 0) --cut;
        }
        if (a.columns != nullptr && lane == 0) {
            atomicAdd(a.columns, (unsigned long long)rows * K);
            atomicAdd(a.columns + 1, (unsigned long long)rows * (K - cut));
        }

        V3 grgb = {0.0f, 0.0f, 0.0f};
        float gdep = 0.0f, gop = 0.0f;
        if (live) {
            if (a.g_rgb) grgb = V3{a.g_rgb[3 * r], a.g_rgb[3 * r + 1], a.g_rgb[3 * r + 2]};
            gdep = a.g_depth ? a.g_depth[r] : 0.0f;
            gop = a.g_opacity ? a.g_opacity[r] : 0.0f;
        }
        const int nc = (cut + W - 1) / W;             // chunks below the cut

        // ---- forward recompute: tau, d sigma/dx and C_k kept -------------------
        // A group's columns are spread over the ray's kLanes lanes; each lane
        // does its own columns' work, then the running sum passes from lane
        // to lane, column by column, in order.
        float csum = 0.0f;                           // C of the last column this lane summed
        for (int c = 0; c < nc; ++c) {
            const int c0 = c * W;
            const int w = min(W, cut - c0);
            if (!kWhole) {
                __syncwarp();
                stage_rows(a, src, arrays, smem, ray0, rows, c0, w);
            }
            const int b = kWhole ? c0 : 0;           // column c0's place in the staged row
            for (int k0 = 0; k0 < w; k0 += kSpan) {
                float tau[kBwdGroup];
#pragma unroll
                for (int q = 0; q < kBwdGroup; ++q) {
                    const int k = k0 + kLanes * q + h;
                    const int kk = min(k, w - 1);
                    const int sq = live && k < w ? sl[b + kk] : -1;
                    const Seg g = make_seg(a, sq, gather_density(a, sq), u0[b + kk], u1[b + kk]);
                    tau[q] = g.tau;
                    if (k < w) {
                        const float dsig = expf(g.x - g.sigma);
                        if (kWhole) {
                            u0[b + k] = g.tau;
                            u1[b + k] = dsig;
                            at(0, c0 + k) = g.dl;
                            if (has_depth) at(2, c0 + k) = g.mid;
                        } else {
                            at(0, c0 + k) = g.tau;
                            at(1, c0 + k) = dsig;
                        }
                    }
                }
#pragma unroll
                for (int t = 0; t < kSpan; ++t) {
                    if (k0 + t >= w) break;
                    const float prev = __shfl_sync(kFull, csum, pair | ((t - 1) & (kLanes - 1)));
                    if (h == (t & (kLanes - 1))) {
                        csum = prev + tau[t / kLanes];
                        at(kC, c0 + k0 + t) = csum;
                    }
                }
            }
        }
        // tau's total is C of the last column: the same sums in the same order
        const float c_end =
            cut > 0 ? __shfl_sync(kFull, csum, pair | ((cut - 1) & (kLanes - 1))) : 0.0f;
        const float t_end = expf(-c_end);
        float g_end = 0.0f;
        if (live) {
            const V3 bg = background(a, r);
            // dL/dT_end: through rgb's sky term, depth's far term and opacity
            g_end = dot(grgb, bg) + gdep * a.far - gop;
            if (a.d_bg != nullptr && h == 0) {
                a.d_bg[3 * r] = grgb.x * t_end;
                a.d_bg[3 * r + 1] = grgb.y * t_end;
                a.d_bg[3 * r + 2] = grgb.z * t_end;
            }
        }

        // ---- reverse pass --------------------------------------------------------
        // Per group: each lane's own columns alone (albedo, T, the sigmoids, the
        // prefix cotangent bB, the albedo gradients); the suffix sum R passed
        // from lane to lane, column by column, from the last; then each lane's
        // columns, last first: dL/dtau, the runs and their flushes.
        const float te = t_end * g_end;
        float R = 0.0f;                              // R of the last column this lane summed
        int run_slot = -1;                           // the lane's pending run (level 1)
        float run[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c = nc - 1; c >= 0; --c) {
            const int c0 = c * W;
            const int w = min(W, cut - c0);
            if (!kWhole && c != nc - 1) {
                __syncwarp();
                stage_rows(a, src, arrays, smem, ray0, rows, c0, w);
            }
            const int b = kWhole ? c0 : 0;
            for (int k0 = (w - 1) / kSpan * kSpan; k0 >= 0; k0 -= kSpan) {
                int s[kBwdGroup];
                V3 ar[kBwdGroup];
#pragma unroll
                for (int q = 0; q < kBwdGroup; ++q) {
                    const int k = k0 + kLanes * q + h;
                    s[q] = live && k < w ? sl[b + min(k, w - 1)] : -1;
                    ar[q] = gather_albedo_raw(a, s[q]);
                }
                float bB[kBwdGroup], p1[kBwdGroup], dl[kBwdGroup], dsig[kBwdGroup], Rk[kBwdGroup];
                float da[kBwdGroup][3];
#pragma unroll
                for (int q = 0; q < kBwdGroup; ++q) {
                    const int k = min(k0 + kLanes * q + h, w - 1);
                    float tau, mid;
                    if (kWhole) {
                        tau = u0[b + k];
                        dsig[q] = u1[b + k];
                        dl[q] = at(0, c0 + k);
                        mid = has_depth ? at(2, c0 + k) : 0.0f;   // else gdep * mid is a zero
                    } else {
                        const float u = u0[b + k], v = u1[b + k];
                        dl[q] = fmaxf(v - u, 0.0f);
                        mid = 0.5f * (u + v);
                        tau = at(0, c0 + k);
                        dsig[q] = at(1, c0 + k);
                    }
                    const float e = expf(-tau);
                    const float alpha = 1.0f - e;
                    const float T = expf(-(at(kC, c0 + k) - tau));
                    const float wk = alpha * T;
                    const float ax = sigmoid(ar[q].x);
                    const float ay = sigmoid(ar[q].y);
                    const float az = sigmoid(ar[q].z);
                    float gw = (grgb.x * ax + grgb.y * ay) + grgb.z * az;
                    if (has_gw) gw = gwt[b + k] + gw;
                    gw = gw + gdep * mid;
                    bB[q] = -(gw * alpha) * T;               // cotangent of C_k - tau_k
                    p1[q] = gw * T * e;
                    da[q][0] = grgb.x * wk * (ax * (1.0f - ax));
                    da[q][1] = grgb.y * wk * (ay * (1.0f - ay));
                    da[q][2] = grgb.z * wk * (az * (1.0f - az));
                }
#pragma unroll
                for (int t = kSpan - 1; t >= 0; --t) {
                    if (k0 + t >= w) continue;
                    const float prev = __shfl_sync(kFull, R, pair | ((t + 1) & (kLanes - 1)));
                    if (h == (t & (kLanes - 1))) {
                        R = prev + bB[t / kLanes];
                        Rk[t / kLanes] = R;
                    }
                }
#pragma unroll
                for (int q = kBwdGroup - 1; q >= 0; --q) {
                    if (s[q] < 0) continue;
                    const float dtau = p1[q] + (Rk[q] - bB[q]) - te;
                    const int slot = (int)clip_slot(a, s[q]);
                    const float d[4] = {dtau * dl[q] * dsig[q], da[q][0], da[q][1], da[q][2]};
                    if (slot == run_slot) {
                        for (int m = 0; m < 4; ++m) run[m] = run[m] + d[m];
                    } else {
                        if (run_slot >= 0) flush_run(a, hot, run_slot, run);
                        run_slot = slot;
                        for (int m = 0; m < 4; ++m) run[m] = d[m];
                    }
                }
            }
        }
        if (run_slot >= 0) flush_run(a, hot, run_slot, run);   // the lane's last run
        __syncwarp();                                // the staged rows are free again
    }

    // ---- the hot slots: the lanes' sums, then at most 32 atomics -------------
#pragma unroll
    for (int j = 0; j < kHotSlots; ++j) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float x = hot[j][m];
            for (int o = kWarp / 2; o > 0; o >>= 1) x = x + __shfl_xor_sync(kFull, x, o);
            const int64_t slot = a.hot_lo + j;
            if (lane == 4 * j + m && slot < a.P && x != 0.0f) {
                atomicAdd(m == 0 ? a.d_density + slot : a.d_albedo + 3 * slot + m - 1, x);
            }
        }
    }
}

CompositeArgs args(const void* slot, const void* t0, const void* t1, const void* density,
                   const void* albedo, const void* bg, int bg_per_ray, float far, int64_t n,
                   int K, int64_t P) {
    CompositeArgs a = {};
    a.slot = static_cast<const int32_t*>(slot);
    a.t0 = static_cast<const float*>(t0);
    a.t1 = static_cast<const float*>(t1);
    a.density = static_cast<const float*>(density);
    a.albedo = static_cast<const float*>(albedo);
    a.bg = static_cast<const float*>(bg);
    a.bg_per_ray = bg_per_ray;
    a.far = far;
    a.n = n; a.K = K; a.P = P;
    a.chunk = K < 1 ? 1 : (K < kChunk ? K : kChunk);
    a.stride = a.chunk | 1;
    a.nchunks = (K + a.chunk - 1) / a.chunk;
    if (a.nchunks < 1) a.nchunks = 1;
    a.tiles = (n + kRays - 1) / kRays;
    return a;
}

// Checks the planned shared memory against what K5 lays out and launches
// one persistent block per resident slot, at most one per tile.
template <typename Kernel>
int launch(Kernel kernel, const CompositeArgs& a, int arrays, int smem, void* stream) {
    if (a.n <= 0) return (int)cudaGetLastError();
    if (a.K < 0 || (int64_t)smem < 4 * smem_floats(a.stride, arrays)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSuccess;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
        return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRays, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t grid = a.tiles < (int64_t)per_sm * sms ? a.tiles : (int64_t)per_sm * sms;
    kernel<<<(unsigned)grid, kRays, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// K6: checks the planned shared memory against the layout, picks the
// whole-row or the chunked instantiation and launches one persistent
// one-warp block per resident slot, at most one per tile (and, with a
// global scratch, at most a.scratch_blocks).
int launch_bwd(const CompositeArgs& a, int arrays, int smem, void* stream) {
    if (a.n <= 0) return (int)cudaGetLastError();
    const bool on_chip = a.scratch == nullptr;
    const bool whole = a.chunk >= a.K;
    if (a.K < 0 || (whole && !on_chip) || smem > kSmemDefault ||
        (int64_t)smem < 4 * bwd_smem_floats(a.chunk, a.K, arrays, on_chip, a.g_depth != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const void* kernel = whole ? reinterpret_cast<const void*>(composite_bwd_kernel<true>)
                               : reinterpret_cast<const void*>(composite_bwd_kernel<false>);
    cudaError_t err = cudaSuccess;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
        return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarp, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int64_t grid = a.tiles < (int64_t)per_sm * sms ? a.tiles : (int64_t)per_sm * sms;
    if (!on_chip && grid > a.scratch_blocks) grid = a.scratch_blocks;
    if (grid < 1) return (int)cudaErrorInvalidValue;
    if (whole) {
        composite_bwd_kernel<true><<<(unsigned)grid, kWarp, smem,
                                     static_cast<cudaStream_t>(stream)>>>(a);
    } else {
        composite_bwd_kernel<false><<<(unsigned)grid, kWarp, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ort

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or the
// error that kept it from launching.  smem is the plan's bytes of dynamic
// shared memory (diff/composite.py `composite_plan`).
int ort_composite_fwd(const void* slot, const void* t0, const void* t1, const void* density,
                      const void* albedo, const void* bg, int bg_per_ray, float far,
                      int64_t n, int K, int64_t P, int smem, void* rgb, void* depth,
                      void* opacity, void* weights, void* stream) {
    ort::CompositeArgs a = ort::args(slot, t0, t1, density, albedo, bg, bg_per_ray, far, n,
                                     K, P);
    a.rgb = static_cast<float*>(rgb);
    a.depth = static_cast<float*>(depth);
    a.opacity = static_cast<float*>(opacity);
    a.weights = static_cast<float*>(weights);
    return ort::launch(ort::composite_fwd_kernel, a, 3, smem, stream);
}

// d_density and d_albedo must be zeroed (or hold a sum to add to).  scratch
// is null when the kept values stay in shared memory, else it holds
// scratch_blocks * 3 * K * 32 floats.  hot_lo is the first of the 8 slots
// summed per block.  columns, when not null, is an int64[2] the kernel adds
// to: the columns of the tiles it walked and those past each tile's last
// valid column.
int ort_composite_bwd(const void* slot, const void* t0, const void* t1, const void* density,
                      const void* albedo, const void* bg, int bg_per_ray, float far,
                      int64_t n, int K, int64_t P, int smem, int64_t hot_lo,
                      const void* g_rgb, const void* g_depth, const void* g_opacity,
                      const void* g_weights, void* scratch, int64_t scratch_blocks,
                      void* d_density, void* d_albedo, void* d_bg, void* columns,
                      void* stream) {
    ort::CompositeArgs a = ort::args(slot, t0, t1, density, albedo, bg, bg_per_ray, far, n,
                                     K, P);
    const int arrays = g_weights != nullptr ? 4 : 3;
    a.chunk = ort::bwd_chunk(K, arrays, g_depth != nullptr);
    const auto aligned8 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; };
    a.pairs = K % 2 == 0 && aligned8(slot) && aligned8(t0) && aligned8(t1) &&
              (g_weights == nullptr || aligned8(g_weights));
    a.stride = ort::bwd_stride(a.chunk);
    a.tiles = (n + ort::kTileRays - 1) / ort::kTileRays;
    a.hot_lo = hot_lo;
    a.g_rgb = static_cast<const float*>(g_rgb);
    a.g_depth = static_cast<const float*>(g_depth);
    a.g_opacity = static_cast<const float*>(g_opacity);
    a.g_weights = static_cast<const float*>(g_weights);
    a.scratch = static_cast<float*>(scratch);
    a.scratch_blocks = scratch_blocks;
    a.d_density = static_cast<float*>(d_density);
    a.d_albedo = static_cast<float*>(d_albedo);
    a.d_bg = static_cast<float*>(d_bg);
    a.columns = static_cast<unsigned long long*>(columns);
    return ort::launch_bwd(a, arrays, smem, stream);
}

}  // extern "C"
