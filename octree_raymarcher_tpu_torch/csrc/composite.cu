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
// * Coalesced tiles.  A block owns a tile of kRays consecutive rays (two
//   warps, one ray per thread) and walks its tiles in a persistent loop.  The tile's rows of slot, t0, t1 (and K6's upstream
//   dL/dw when given) are one contiguous span per array; the block copies
//   a chunk of kChunk columns of each span into shared memory with 4-byte
//   cp.async, neighbouring threads on neighbouring words, so every byte
//   crosses DRAM once, in full sectors (a whole row is one chunk when K is
//   at most kChunk).  Each word lands at row * stride + column with an
//   odd stride, so the 32 lanes of a warp, each walking its own row, hit 32
//   different banks (a 16-byte copy could not place a row at an odd
//   stride, and its pieces straddle rows when K is not a multiple of 4).
//   The ragged last tile copies only the rays that exist.
// * One stage buffer: a chunk's copy overlaps the math of the other blocks
//   on the SM, and a small block (~23 KB at K6) lets about nine of them
//   share it; on the H100 that beat double-buffered whole rows (PERF.md,
//   kernel table).  The bytes of shared memory and where K6's prefix sums
//   live are planned in Python (diff/composite.py `composite_plan`).  K6's
//   reverse pass walks the chunks back; it reads the last from the tile
//   the recompute used and copies the others again (from L2 at the
//   training path's sizes).
// * K5 stages its weights in shared memory and stores each chunk as
//   coalesced spans; rgb, depth and opacity are written once per ray.
// * K6 keeps the prefix sums C_k of its forward recompute in shared memory
//   (or, for long rows, in a global scratch laid out [tile][k][ray of
//   tile], so that a warp's 32 writes of one k are one line).  Its scatter of
//   the parameter gradients is aggregated at three levels, all exact up to
//   summation order: (1) consecutive segments of one ray on one slot sum in
//   registers; (2) at each k, the lanes that flush a run group themselves by
//   slot (__match_any_sync) and the lowest lane of each group sums the
//   group's values in lane order and issues the atomics once; (3) the hot
//   slots [hot_lo, hot_lo + 8) (the coarse-LEAF slots, one per material,
//   that half of all segments land on) accumulate in a shared-memory table
//   the block flushes with at most 32 atomics when it is done.  hot_lo only
//   routes sums; any slot gives the same sums up to their order.
// * Invalid segments (slot < 0, anywhere in a row) have tau = 0, so alpha =
//   w = 0 and they add nothing; their parameter gathers are skipped, which
//   is exact for finite parameters.  Parameter gathers are issued for
//   kGroup segments at a time before their sequential math, so each thread
//   keeps several independent loads in flight.

#include "common.cuh"

namespace ort {
namespace {

constexpr int kHotSlots = 8;     // init_params_from_world's num_materials
constexpr int kRays = 64;        // rays per tile = threads per block
constexpr int kChunk = 16;       // columns of a row staged at once
constexpr int kGroup = 4;        // segments whose gathers are issued together

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
    int chunk;                // columns per staged chunk: min(K, kChunk), at least 1
    int stride;               // chunk | 1: odd row stride in shared memory
    int nchunks;
    int64_t tiles;
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
    float* scratch;           // chunked plan: prefix sums [tile][k][ray of tile]
    float* d_density;         // [P], accumulated
    float* d_albedo;          // [P, 3], accumulated
    float* d_bg;              // nullable: [N, 3]
    int64_t hot_lo;
};

// Floats of dynamic shared memory: `arrays` planes of kRays x stride; K5's
// weight plane (kRays x stride); K6's prefix sums (kRays x (K | 1), unless
// they go to global scratch), hot table and per-warp exchange buffer.
// diff/composite.py `_smem_bytes` computes the same.
inline int64_t smem_floats(int stride, int K, int arrays, bool backward, bool prefix) {
    int64_t f = (int64_t)arrays * kRays * stride;
    if (!backward) return f + (int64_t)kRays * stride;
    if (prefix) f += (int64_t)kRays * (K | 1);
    return f + 4 * kHotSlots + 4 * kRays;
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

// Adds one flushed run's four sums to the gradients: into the block's hot
// table for the hot slots, else by global atomics.
__device__ __forceinline__ void flush_run(const CompositeArgs& a, float* hot, int64_t slot,
                                          const float v[4]) {
    const int64_t h = slot - a.hot_lo;
    if (h >= 0 && h < kHotSlots) {
        for (int j = 0; j < 4; ++j) atomicAdd(hot + 4 * h + j, v[j]);
    } else {
        atomicAdd(a.d_density + slot, v[0]);
        for (int j = 0; j < 3; ++j) atomicAdd(a.d_albedo + 3 * slot + j, v[1 + j]);
    }
}

// Warp-level aggregation: every lane of the warp calls this at the same k;
// `key` is the slot of the run the lane flushes, or -1.  The lanes of one
// slot group themselves, and the lowest sums the group in lane order and
// flushes once.  `buf` is the warp's 32 x float4 exchange buffer.
__device__ __forceinline__ void warp_scatter(const CompositeArgs& a, float* hot, float4* buf,
                                             int64_t key, const float v[4]) {
    const unsigned full = 0xffffffffu;
    if (__ballot_sync(full, key >= 0) == 0) return;
    const unsigned lane = threadIdx.x & 31;
    const unsigned group = __match_any_sync(full, (unsigned long long)key);
    if (key >= 0 && __popc(group) > 1) buf[lane] = make_float4(v[0], v[1], v[2], v[3]);
    __syncwarp();
    if (key >= 0 && (unsigned)(__ffs(group) - 1) == lane) {
        float s[4] = {v[0], v[1], v[2], v[3]};
        for (unsigned m = group & (group - 1); m != 0; m &= m - 1) {
            const float4 o = buf[__ffs(m) - 1];
            s[0] = s[0] + o.x; s[1] = s[1] + o.y; s[2] = s[2] + o.z; s[3] = s[3] + o.w;
        }
        flush_run(a, hot, key, s);
    }
    __syncwarp();
}

__global__ void __launch_bounds__(kRays) composite_bwd_kernel(const CompositeArgs a) {
    extern __shared__ __align__(16) float smem[];
    const bool has_gw = a.g_weights != nullptr;
    const int arrays = has_gw ? 4 : 3;
    const bool on_chip = a.scratch == nullptr;       // prefix sums in shared memory
    const int plane = kRays * a.stride;
    const int cstride = a.K | 1;
    float* p = smem + arrays * plane;
    float* cplane = p;
    if (on_chip) p += kRays * cstride;
    float* hot = p;
    float4* xbuf = reinterpret_cast<float4*>(p + 4 * kHotSlots) + (threadIdx.x & ~31u);
    const float* src[4] = {reinterpret_cast<const float*>(a.slot), a.t0, a.t1, a.g_weights};
    for (int i = threadIdx.x; i < 4 * kHotSlots; i += blockDim.x) hot[i] = 0.0f;

    // Per tile: chunks 0..n-1 forward (the recompute), then n-1..0 in
    // reverse, the last chunk once for both.
    const int nc = a.nchunks;
    const int spt = 2 * nc - 1;
    const int64_t steps = block_tiles(a) * spt;
    auto tile_of = [&](int64_t i) { return (int64_t)blockIdx.x + (i / spt) * gridDim.x; };
    auto chunk_of = [&](int64_t i) {
        const int j = (int)(i % spt);
        return j < nc ? j : 2 * nc - 2 - j;
    };

    float csum = 0.0f, tau_sum = 0.0f, t_end = 1.0f, g_end = 0.0f, R = 0.0f;
    float gdep = 0.0f, gop = 0.0f;
    V3 grgb = {0.0f, 0.0f, 0.0f};
    int64_t run_slot = -1;                           // the pending run (level 1)
    float run[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int64_t i = 0; i < steps; ++i) {
        const int64_t tile = tile_of(i);
        const int j = (int)(i % spt);
        const int c = chunk_of(i);
        load_chunk(a, src, arrays, smem, tile, c);
        cp_async_wait_block();

        const int c0 = c * a.chunk;
        const int w = min(a.chunk, a.K - c0);
        const int64_t r = tile * kRays + threadIdx.x;
        const bool live = r < a.n;
        const int row = threadIdx.x * a.stride;
        const int32_t* sl = reinterpret_cast<const int32_t*>(smem) + row;
        const float* u0 = smem + plane + row;
        const float* u1 = smem + 2 * plane + row;
        const float* gwt = smem + 3 * plane + row;
        // C_k of column k of this chunk
        auto prefix = [&](int k) -> float& {
            return on_chip ? cplane[threadIdx.x * cstride + c0 + k]
                           : a.scratch[(tile * a.K + c0 + k) * kRays + threadIdx.x];
        };

        if (j == 0) {
            csum = 0.0f; tau_sum = 0.0f; R = 0.0f;
            run_slot = -1;
            if (live) {
                grgb = a.g_rgb ? V3{a.g_rgb[3 * r], a.g_rgb[3 * r + 1], a.g_rgb[3 * r + 2]}
                               : V3{0.0f, 0.0f, 0.0f};
                gdep = a.g_depth ? a.g_depth[r] : 0.0f;
                gop = a.g_opacity ? a.g_opacity[r] : 0.0f;
            }
        }

        // ---- forward recompute: prefix sums and the total ----------------
        if (j < nc && live) {
            for (int k0 = 0; k0 < w; k0 += kGroup) {
                int s[kGroup];
                float x[kGroup];
#pragma unroll
                for (int q = 0; q < kGroup; ++q) {
                    s[q] = k0 + q < w ? sl[k0 + q] : -1;
                    x[q] = gather_density(a, s[q]);
                }
#pragma unroll
                for (int q = 0; q < kGroup; ++q) {
                    const int k = k0 + q;
                    if (k >= w) break;
                    const Seg g = make_seg(a, s[q], x[q], u0[k], u1[k]);
                    csum = csum + g.tau;
                    tau_sum = tau_sum + g.tau;
                    prefix(k) = csum;
                }
            }
            if (j == nc - 1) {
                t_end = expf(-tau_sum);
                const V3 bg = background(a, r);
                // dL/dT_end: through rgb's sky term, depth's far term and opacity
                g_end = dot(grgb, bg) + gdep * a.far - gop;
                if (a.d_bg != nullptr) {
                    a.d_bg[3 * r] = grgb.x * t_end;
                    a.d_bg[3 * r + 1] = grgb.y * t_end;
                    a.d_bg[3 * r + 2] = grgb.z * t_end;
                }
            }
        }

        // ---- reverse pass (every lane, for the warp collectives) ---------
        if (j >= nc - 1) {
            for (int k1 = w - 1; k1 >= 0; k1 -= kGroup) {
                int s[kGroup];
                float x[kGroup];
                V3 ar[kGroup];
#pragma unroll
                for (int q = 0; q < kGroup; ++q) {
                    s[q] = live && k1 - q >= 0 ? sl[k1 - q] : -1;
                    x[q] = gather_density(a, s[q]);
                    ar[q] = gather_albedo_raw(a, s[q]);
                }
#pragma unroll
                for (int q = 0; q < kGroup; ++q) {
                    const int k = k1 - q;
                    if (k < 0) break;
                    int64_t key = -1;
                    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    if (live) {
                        const Seg g = make_seg(a, s[q], x[q], u0[k], u1[k]);
                        const float e = expf(-g.tau);
                        const float alpha = 1.0f - e;
                        const float T = expf(-(prefix(k) - g.tau));
                        const float wk = alpha * T;
                        const float ax = sigmoid(ar[q].x);
                        const float ay = sigmoid(ar[q].y);
                        const float az = sigmoid(ar[q].z);
                        float gw = (grgb.x * ax + grgb.y * ay) + grgb.z * az;
                        if (has_gw) gw = gwt[k] + gw;
                        gw = gw + gdep * g.mid;
                        const float bB = -(gw * alpha) * T;      // cotangent of C_k - tau_k
                        R = R + bB;
                        const float dtau = gw * T * e + (R - bB) - t_end * g_end;
                        if (g.valid) {
                            const float d[4] = {
                                dtau * g.dl * expf(g.x - g.sigma),
                                grgb.x * wk * (ax * (1.0f - ax)),
                                grgb.y * wk * (ay * (1.0f - ay)),
                                grgb.z * wk * (az * (1.0f - az))};
                            if (g.s == run_slot) {
                                for (int m = 0; m < 4; ++m) run[m] = run[m] + d[m];
                            } else {
                                if (run_slot >= 0) {
                                    key = run_slot;
                                    for (int m = 0; m < 4; ++m) out[m] = run[m];
                                }
                                run_slot = g.s;
                                for (int m = 0; m < 4; ++m) run[m] = d[m];
                            }
                        }
                    }
                    warp_scatter(a, hot, xbuf, key, out);
                }
            }
            if (c == 0) {                            // the ray's last run
                warp_scatter(a, hot, xbuf, run_slot, run);
                run_slot = -1;
            }
        }
        __syncthreads();
    }

    // ---- the hot table to the gradients: at most 32 atomics ----------------
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * kHotSlots; i += blockDim.x) {
        const int64_t slot = a.hot_lo + i / 4;
        const float v = hot[i];
        if (slot < a.P && v != 0.0f) {
            atomicAdd(i % 4 == 0 ? a.d_density + slot : a.d_albedo + 3 * slot + i % 4 - 1, v);
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

// Checks the planned shared memory against what the kernel lays out and
// launches one persistent block per resident slot, at most one per tile.
template <typename Kernel>
int launch(Kernel kernel, const CompositeArgs& a, int arrays, bool backward, int smem,
           void* stream) {
    if (a.n <= 0) return (int)cudaGetLastError();
    if (a.K < 0 ||
        (int64_t)smem < 4 * smem_floats(a.stride, a.K, arrays, backward, a.scratch == nullptr)) {
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
    return ort::launch(ort::composite_fwd_kernel, a, 3, false, smem, stream);
}

// d_density and d_albedo must be zeroed (or hold a sum to add to).  scratch
// is null when the prefix sums stay in shared memory, else it holds tiles *
// 64 * K floats.  hot_lo is the first of the 8 slots summed per block.
int ort_composite_bwd(const void* slot, const void* t0, const void* t1, const void* density,
                      const void* albedo, const void* bg, int bg_per_ray, float far,
                      int64_t n, int K, int64_t P, int smem, int64_t hot_lo,
                      const void* g_rgb, const void* g_depth, const void* g_opacity,
                      const void* g_weights, void* scratch, void* d_density, void* d_albedo,
                      void* d_bg, void* stream) {
    ort::CompositeArgs a = ort::args(slot, t0, t1, density, albedo, bg, bg_per_ray, far, n,
                                     K, P);
    a.hot_lo = hot_lo;
    a.g_rgb = static_cast<const float*>(g_rgb);
    a.g_depth = static_cast<const float*>(g_depth);
    a.g_opacity = static_cast<const float*>(g_opacity);
    a.g_weights = static_cast<const float*>(g_weights);
    a.scratch = static_cast<float*>(scratch);
    a.d_density = static_cast<float*>(d_density);
    a.d_albedo = static_cast<float*>(d_albedo);
    a.d_bg = static_cast<float*>(d_bg);
    const int arrays = g_weights != nullptr ? 4 : 3;
    return ort::launch(ort::composite_bwd_kernel, a, arrays, true, smem, stream);
}

}  // extern "C"
