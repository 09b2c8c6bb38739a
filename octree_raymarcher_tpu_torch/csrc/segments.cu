// K4: the segment sampler, one thread per ray.
//
// Replaces the JAX package's K-phase sampler (B4):
// octree_raymarcher_tpu/diff/segments.py `sample_segments` (:96-175) with
// `_segment_from_hit` (:57-81), and the per-ray budget of B3
// (ops/march_jnp.py:596-616) that it threads through its phases.  For each
// ray it records up to K solid cells or texels as (param slot, t_enter,
// t_exit), in order along the ray:
//   * phase 0 starts at the world entry; phase k > 0 resumes at
//     t1 + EPS of the previous segment, live only if that phase hit;
//   * each phase is a fresh bounded march, the same loop as K1's
//     (march_step.cuh): loop_bound(phase_steps) iterations, or whole stages
//     of `stride` with a budget, where
//     phase_steps = min(max_steps, ceil(B/stride)*stride) (:145-150), and
//     the phase's charge comes off the ray's remaining budget;
//   * t1 = t_hit + escape_distance(p, g, cell) with p = o + d*t_hit, the
//     extraction's escape (clamped below EPS to BIGEPS, nothing added),
//     which differs from the march's in-loop escape (+EPS): not merged;
//   * slot = texel if the hit was a twig texel, else
//     twig_slots + clip(material, 0, num_materials-1);
//   * a phase that misses ends the ray: the remaining columns hold slot -1
//     and t0 = t1 = 0, as the JAX stack gives.
//
// What bounds it on an H100: like K1, chains of dependent L2 loads (the
// pools stay in L2) and warp divergence in per-ray step counts, and here
// also the K-slot output (12 B per slot, 796 MB at 1080p and K = 32), the
// only large byte stream, of which half is the tail (slot -1, t 0) of rays
// that stop before K.  The design keeps the whole K-phase walk in one
// thread's registers: no [N, K] state between phases, no relaunch per
// phase, and a ray that runs out of solid cells leaves the loop at once.
// The JAX package needed K separate marches only because its loop could
// carry one int32; here one loop writes all K segments, and each phase
// keeps its own fresh iteration cap so the result is the public sampler's,
// not the one-loop oracle's (which shares one bound across phases).
//
// * The octree path of march_step.cuh is carried across the phases: phase
//   k + 1 resumes at t1 + EPS, just past the cell phase k hit, and starts
//   from that path instead of the root.
// * Coalesced rows.  The 32 rays of a warp own 32 consecutive rows.  The
//   warp walks its phases in windows of `cols` columns (diff/segments.py
//   segments_plan: 8, one 32-byte sector of a row): each lane stages its
//   window's segments in shared memory at an odd row pitch (conflict-free),
//   then the warp writes the window as whole row spans, segment or tail, so
//   each sector is written once and whole.  Once no lane of the warp is
//   marching, the rest of its rows is tail, written as spans too.
// * At least 8 blocks of 128 threads a SM (64 registers; a few bytes of
//   spills), as K1.
// K4 runs the march loop with its budget check compiled in even without a
// budget: on the H100 the instantiation without it ran this kernel
// markedly slower (a diagnostic A/B of both builds in one chip call).

#include "march_step.cuh"

namespace ort {
namespace {

struct SegmentArgs {
    WorldArgs world;
    const float* o;
    const float* dirs;
    int64_t n;
    int K;
    int cap;                 // per-phase iteration cap
    int budget;              // total per-ray budget B
    int stride;
    int twig_slots;
    int num_materials;
    int cols;                // columns staged per window (diff/segments.py segments_plan)
    int32_t* out_slot;       // [N, K]
    float* out_t0;           // [N, K]
    float* out_t1;           // [N, K]
    int32_t* out_count;      // [N]
};

constexpr unsigned kFull = 0xffffffffu;

// Columns c0 .. K - 1 of rows row0 .. row0 + nrows - 1 hold no segment: the
// warp writes them as whole spans, lane after lane.
__device__ __forceinline__ void fill_tail(const SegmentArgs& a, int64_t row0, int nrows,
                                          int c0, int lane) {
    const int W = a.K - c0;
    for (int e = lane; W > 0 && e < nrows * W; e += 32) {
        const int i = e / W;
        const int64_t at = (row0 + i) * (int64_t)a.K + c0 + (e - i * W);
        a.out_slot[at] = -1;
        a.out_t0[at] = 0.0f;
        a.out_t1[at] = 0.0f;
    }
}

__global__ void __launch_bounds__(kPathThreads, kMinBlocks) segments_kernel(const SegmentArgs a) {
    extern __shared__ int stage[];
    const int lane = threadIdx.x & 31;
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t row0 = r - lane;
    if (row0 >= a.n) return;                 // the whole warp lies past the end
    const bool exists = r < a.n;
    const int64_t left = a.n - row0;
    const int nrows = left < 32 ? (int)left : 32;

    const Ray q = load_ray(a.o, a.dirs, exists ? r : row0);
    const Box box = world_box(a.world);
    float t0;
    bool live;
    entry_t_live(q, box, t0, live);
    live = live && exists;
    float t = start_t(t0);
    int remaining = a.budget;
    int count = 0;
    PathCache path;

    // this warp's window of its 32 rows: [slot | t0 | t1][lane][pitch]
    const int pitch = a.cols | 1;
    int* st_slot = stage + (threadIdx.x >> 5) * 3 * 32 * pitch;
    float* st_t0 = reinterpret_cast<float*>(st_slot + 32 * pitch);
    float* st_t1 = reinterpret_cast<float*>(st_slot + 64 * pitch);

    int c0 = 0;
    for (; c0 < a.K; c0 += a.cols) {
        if (!__any_sync(kFull, live)) break;
        const int c1 = min(c0 + a.cols, a.K);
        for (int k = c0; k < c1 && live; ++k) {
            const MarchState s = run_march<true>(a.world, box, q, t, live, a.cap, remaining,
                                                 a.stride, false, path);
            remaining -= s.charged;
            if (!s.hit) { live = false; break; }

            // ---- _segment_from_hit: escape of the hit box, slot, cursor --------
            const float t_hit = s.t;
            const float px = q.ax + q.bx * t_hit;
            const float py = q.ay + q.by * t_hit;
            const float pz = q.az + q.bz * t_hit;
            const float dx = fmaxf((s.rec.bx - px) * q.gx, ((s.rec.bx + s.rec.size) - px) * q.gx);
            const float dy = fmaxf((s.rec.by - py) * q.gy, ((s.rec.by + s.rec.size) - py) * q.gy);
            const float dz = fmaxf((s.rec.bz - pz) * q.gz, ((s.rec.bz + s.rec.size) - pz) * q.gz);
            float esc = fminf(dx, fminf(dy, dz));
            if (esc < kEps) esc = kBigEps;
            const float t1 = t_hit + esc;
            const int slot = s.rec.texel >= 0
                                 ? s.rec.texel
                                 : a.twig_slots + clampi(s.rec.material, 0, a.num_materials - 1);
            st_slot[lane * pitch + (k - c0)] = slot;
            st_t0[lane * pitch + (k - c0)] = t_hit;
            st_t1[lane * pitch + (k - c0)] = t1;
            ++count;
            t = start_t(fmaxf(t1 + kEps, 0.0f));
        }
        // flush the window: each row's span of it, staged segment or tail
        __syncwarp();
        const int W = c1 - c0;
        for (int base = 0; base < 32 * W; base += 32) {
            const int e = base + lane;
            const int i = e / W;
            const int j = e - i * W;
            const int cnt = __shfl_sync(kFull, count, i);
            if (e < nrows * W) {
                const bool seg = c0 + j < cnt;
                const int64_t at = (row0 + i) * (int64_t)a.K + c0 + j;
                a.out_slot[at] = seg ? st_slot[i * pitch + j] : -1;
                a.out_t0[at] = seg ? st_t0[i * pitch + j] : 0.0f;
                a.out_t1[at] = seg ? st_t1[i * pitch + j] : 0.0f;
            }
        }
        __syncwarp();
    }
    // columns from c0 on hold no segment in any row of the warp
    fill_tail(a, row0, nrows, c0, lane);
    if (exists) a.out_count[r] = count;
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ort_segments(const void* tree, const void* twig, const void* twig_occ,
                 const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
                 const void* chunkcoordmin, float chunksize, int w, int h, int d,
                 int depth, int64_t twig_len, int64_t occ_len, const void* o,
                 const void* dirs, int64_t n, int K, int cap, int has_budget, int budget,
                 int stride, int twig_slots, int num_materials, int cols, int smem,
                 void* out_slot, void* out_t0, void* out_t1, void* out_count, void* stream) {
    ort::SegmentArgs a;
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.n = n; a.K = K; a.cap = cap;
    // No budget is a budget no ray reaches (the wrapper keeps K * cap below
    // it): one instantiation with the stage check serves both cases.
    a.budget = has_budget ? budget : 0x7fffffff;
    a.stride = stride;
    a.twig_slots = twig_slots; a.num_materials = num_materials; a.cols = cols;
    a.out_slot = static_cast<int32_t*>(out_slot);
    a.out_t0 = static_cast<float*>(out_t0);
    a.out_t1 = static_cast<float*>(out_t1);
    a.out_count = static_cast<int32_t*>(out_count);
    if (n > 0) {
        const int threads = ort::kPathThreads;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ort::segments_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
