// K1: the octree march, one thread per ray.
//
// Replaces the JAX package's lockstep march (B1) and its hit record (B2):
// octree_raymarcher_tpu/ops/march_jnp.py `_entry_t_live` (world-box slab
// entry), `_locate` (toroidal chunk lookup + depth-level descent),
// `_march_env` (`solid_probe`, `classify_and_escape`, `step_state`),
// `_run_loop` (the bounded while loop), and `_hit_record`/`reconstruct`
// (material, hit cell and flat texel at the frozen t), plus B3: the
// `t_start`/`live_start` resume of `march` (march_jnp.py:538-547), its
// `step_budget`/`steps_stride` stages (:596-616) and `_expose_live_t`
// (:642-652).
//
// What bounds it on an H100: not bytes.  At the bench scene the pools
// (tree 1.4 MiB, twig_occ 0.8 MiB, twig 25.5 MiB) fit in the 50 MB L2, and
// a ray takes ~17 steps.  Each step locates its point through a chain of
// dependent loads (chunk table, root, one tree word per level, occupancy),
// and a warp runs until its longest ray ends.
//
// What this design does about it: every ray keeps t, liveness and its step
// counter in registers and leaves the loop the moment it hits or escapes,
// so there is no lockstep carry and no re-pack between stages (the TPU's
// single-int32-carry rule and march_compact.py have no counterpart here).
// Each ray also keeps the octree path of its last step (the path cache of
// march_step.cuh): a step loads only below the first level whose child
// differs, about a third of the dependent loads on the bench scene
// (chip_smoke.py counts them).  Pool reads go through the read-only cache
// (__ldg).  Blocks of 128 threads, at least 8 of them a SM, keep many warps
// resident, so the scheduler always has another warp whose load has
// returned.  The caller orders rays in 128x128 screen blocks
// (shade/tiling.py), so the 32 rays of a warp are screen neighbours with
// similar paths and step counts; the chip smoke test prints the resulting
// SIMT efficiency.  On the H100 the shorter chains did not shorten the
// march (PERF.md): what bounds K1 now is open, and a warp-tile ray
// order and cheaper per-step arithmetic are the next things to try.
//
// The entry test and the bounded loop (locate, probe, escape, and the
// per-ray budget) are in march_step.cuh, shared with the segment sampler K4
// (segments.cu).  The budget is a template parameter here: the unbudgeted
// main-path march carries no budget state.  Arithmetic follows march_plain
// (ops/march.py) operation for operation; with -fmad=false the two agree bit
// for bit.
//
// The light pass of the shadow map (render_shadowmap) runs a third
// instantiation, march_kernel<false, true>, whose epilogue replaces the
// resolve of the JAX package's `_shadowmap_device` (shade/render.py:233-237):
// it writes only the light depth of the ray, row 2 of vp*[o + d*t, 1] where
// it hit and 1.0 where it missed (shadow.cuh light_depth, the arithmetic of
// K3's shadow_resolve), and skips the 33-byte hit record and the separate
// pass that read it back.  The march body is the same code; the epilogue is
// a template parameter so the camera-ray and shadow-ray instantiations
// compile as before.

#include "march_step.cuh"
#include "shadow.cuh"

namespace ort {
namespace {

struct MarchArgs {
    WorldArgs world;
    const float* o;
    const float* dirs;
    const float* t_start;        // nullable: resume parameter per ray
    const int32_t* live_start;   // nullable: 0/1 liveness per ray
    const int32_t* step_budget;  // nullable: per-ray budget (B3b)
    int64_t n;
    int cap;                     // loop bound: 4 * ceil(max_steps / 4), or
                                 // stages * stride with a budget
    int stride;                  // budget stage length
    int assume_resident;
    int steps_aov;
    int expose_live_t;           // rays live at the cap report their t
    uint8_t* out_hit;
    float* out_t;
    int32_t* out_material;
    float* out_cell_bmin;
    float* out_cell_size;
    int32_t* out_steps;
    int32_t* out_texel;
    float depth_row[4];          // kDepth: row 2 of the light's view-projection
    float* out_depth;            // kDepth: the light depth per ray
};

template <bool kBudget, bool kDepth>
__global__ void __launch_bounds__(kPathThreads, kMinBlocks) march_kernel(const MarchArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;

    const Ray q = load_ray(a.o, a.dirs, r);
    const Box box = world_box(a.world);

    // ---- entry (march_jnp._entry_t_live) or resume (t_start) -------------
    float t0;
    bool live;
    if (a.t_start == nullptr) {
        entry_t_live(q, box, t0, live);
    } else {
        t0 = fmaxf(a.t_start[r], 0.0f);
        live = true;
    }
    if (a.live_start != nullptr) live = live && a.live_start[r] != 0;

    PathCache path;
    const MarchState s = run_march<kBudget>(a.world, box, q, start_t(t0), live, a.cap,
                                            kBudget ? a.step_budget[r] : 0, a.stride,
                                            a.assume_resident != 0, path);

    if constexpr (kDepth) {
        a.out_depth[r] = light_depth(a.depth_row, {q.ax, q.ay, q.az}, {q.bx, q.by, q.bz},
                                     s.hit, s.t);
        return;
    }
    a.out_hit[r] = s.hit ? 1 : 0;
    a.out_t[r] = (s.hit || (a.expose_live_t && s.live)) ? s.t : INFINITY;
    a.out_material[r] = s.rec.material;
    a.out_cell_bmin[3 * r] = s.rec.bx;
    a.out_cell_bmin[3 * r + 1] = s.rec.by;
    a.out_cell_bmin[3 * r + 2] = s.rec.bz;
    a.out_cell_size[r] = s.rec.size;
    a.out_steps[r] = kBudget ? s.charged : (a.steps_aov ? s.steps : 0);
    a.out_texel[r] = s.rec.texel;
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ort_march(const void* tree, const void* twig, const void* twig_occ,
              const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
              const void* chunkcoordmin, float chunksize, int w, int h, int d,
              int depth, int64_t twig_len, int64_t occ_len, const void* o,
              const void* dirs, const void* t_start, const void* live_start,
              const void* step_budget, int64_t n, int cap, int stride,
              int assume_resident, int steps_aov, int expose_live_t,
              void* out_hit, void* out_t, void* out_material, void* out_cell_bmin,
              void* out_cell_size, void* out_steps, void* out_texel, void* stream) {
    ort::MarchArgs a;
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.t_start = static_cast<const float*>(t_start);
    a.live_start = static_cast<const int32_t*>(live_start);
    a.step_budget = static_cast<const int32_t*>(step_budget);
    a.n = n; a.cap = cap; a.stride = stride;
    a.assume_resident = assume_resident; a.steps_aov = steps_aov;
    a.expose_live_t = expose_live_t;
    a.out_hit = static_cast<uint8_t*>(out_hit);
    a.out_t = static_cast<float*>(out_t);
    a.out_material = static_cast<int32_t*>(out_material);
    a.out_cell_bmin = static_cast<float*>(out_cell_bmin);
    a.out_cell_size = static_cast<float*>(out_cell_size);
    a.out_steps = static_cast<int32_t*>(out_steps);
    a.out_texel = static_cast<int32_t*>(out_texel);
    if (n > 0) {
        const int threads = ort::kPathThreads;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (a.step_budget != nullptr) {
            ort::march_kernel<true, false><<<blocks, threads, 0, st>>>(a);
        } else {
            ort::march_kernel<false, false><<<blocks, threads, 0, st>>>(a);
        }
    }
    return (int)cudaGetLastError();
}

// The light pass of the shadow map: K1 with the light-depth epilogue, from
// the world entry, no budget.  `depth_row` is row 2 of the light's 4x4
// view-projection (4 floats on the host).  Returns cudaGetLastError().
int ort_march_depth(const void* tree, const void* twig, const void* twig_occ,
                    const void* chunk_bmin, const void* chunk_tree, const void* chunk_twig,
                    const void* chunkcoordmin, float chunksize, int w, int h, int d,
                    int depth, int64_t twig_len, int64_t occ_len, const void* o,
                    const void* dirs, int64_t n, int cap, int assume_resident,
                    const void* depth_row, void* out_depth, void* stream) {
    ort::MarchArgs a = {};
    a.world = ort::world_args(tree, twig, twig_occ, chunk_bmin, chunk_tree, chunk_twig,
                              chunkcoordmin, chunksize, w, h, d, depth, twig_len, occ_len);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.n = n; a.cap = cap;
    a.assume_resident = assume_resident;
    const float* row = static_cast<const float*>(depth_row);
    for (int i = 0; i < 4; ++i) a.depth_row[i] = row[i];
    a.out_depth = static_cast<float*>(out_depth);
    if (n > 0) {
        const int threads = ort::kPathThreads;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        ort::march_kernel<false, true><<<blocks, threads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

const char* ort_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
