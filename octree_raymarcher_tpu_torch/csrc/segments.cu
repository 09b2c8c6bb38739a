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
// pools stay in L2) and warp divergence in per-ray step counts; the K-slot
// output (12 B per slot, 796 MB at 1080p and K = 32) is the only large byte
// stream.  The design keeps the whole K-phase walk in one thread's
// registers: no [N, K] state between phases, no relaunch per phase, and a
// ray that runs out of solid cells leaves the loop at once.  The JAX
// package needed K separate marches only because its loop could carry one
// int32; here one loop writes all K segments, and each phase keeps its own
// fresh iteration cap so the result is the public sampler's, not the
// one-loop oracle's (which shares one bound across phases).  Writes are per
// thread along its own row; staging them through shared memory would
// coalesce them.  K4 runs the march loop with its budget check
// compiled in even without a budget: on the H100 the instantiation without
// it ran this kernel markedly slower (a diagnostic A/B of both builds in one
// chip call), while K1 is faster without it, so K1 keeps both.

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
    int32_t* out_slot;       // [N, K]
    float* out_t0;           // [N, K]
    float* out_t1;           // [N, K]
    int32_t* out_count;      // [N]
};

__global__ void __launch_bounds__(128) segments_kernel(const SegmentArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;

    const Ray q = load_ray(a.o, a.dirs, r);
    const Box box = world_box(a.world);
    float t0;
    bool live;
    entry_t_live(q, box, t0, live);
    float t = start_t(t0);
    int remaining = a.budget;
    int count = 0;
    const int64_t row = r * (int64_t)a.K;

    for (int k = 0; k < a.K && live; ++k) {
        const MarchState s = run_march<true>(a.world, box, q, t, live, a.cap, remaining,
                                             a.stride, false);
        remaining -= s.charged;
        if (!s.hit) break;

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
        a.out_slot[row + k] = slot;
        a.out_t0[row + k] = t_hit;
        a.out_t1[row + k] = t1;
        ++count;
        t = start_t(fmaxf(t1 + kEps, 0.0f));
    }
    for (int k = count; k < a.K; ++k) {
        a.out_slot[row + k] = -1;
        a.out_t0[row + k] = 0.0f;
        a.out_t1[row + k] = 0.0f;
    }
    a.out_count[r] = count;
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
                 int stride, int twig_slots, int num_materials, void* out_slot,
                 void* out_t0, void* out_t1, void* out_count, void* stream) {
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
    a.twig_slots = twig_slots; a.num_materials = num_materials;
    a.out_slot = static_cast<int32_t*>(out_slot);
    a.out_t0 = static_cast<float*>(out_t0);
    a.out_t1 = static_cast<float*>(out_t1);
    a.out_count = static_cast<int32_t*>(out_count);
    if (n > 0) {
        const int threads = 128;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ort::segments_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
