// K1: the octree march, one thread per ray.
//
// Replaces the JAX package's lockstep march (B1) and its hit record (B2):
// octree_raymarcher_tpu/ops/march_jnp.py `_entry_t_live` (world-box slab
// entry), `_locate` (toroidal chunk lookup + depth-level descent),
// `_march_env` (`solid_probe`, `classify_and_escape`, `step_state`),
// `_run_loop` (the bounded while loop), and `_hit_record`/`reconstruct`
// (material, hit cell and flat texel at the frozen t), plus the
// `t_start`/`live_start` resume of `march` (B3, first half).
//
// What bounds it on an H100: not bytes.  At the bench scene the pools
// (tree 1.4 MiB, twig_occ 0.8 MiB, twig 25.5 MiB) fit in the 50 MB L2, and
// a ray reads only ~24 steps x (1 chunk-table word + up to `depth` tree
// words + 1 occupancy word).  Each of those reads depends on the one before
// it (the next node's address is in the word just read), so a step is a
// chain of ~depth+2 L2 round trips, and a warp runs until its longest ray
// ends.  The bound is load latency times chain length, divided by the warps
// in flight, and inflated by divergence in step count and descent depth.
//
// What this design does about it: every ray keeps t, liveness and its step
// counter in registers and leaves the loop the moment it hits or escapes,
// so there is no lockstep carry and no re-pack between stages (the TPU's
// single-int32-carry rule and march_compact.py have no counterpart here).
// Pool reads go through the read-only cache (__ldg).  Small 128-thread
// blocks and a small register footprint keep many warps resident per SM, so
// the scheduler always has another warp whose load has returned.  The caller
// orders rays in 128x128 screen blocks (shade/tiling.py), so the 32 rays of
// a warp are screen neighbours with similar paths and step counts; the
// chip smoke test prints the resulting SIMT efficiency.  Shared-memory chunk
// tables, ray reordering inside warps and treelet caching are later work.
//
// Arithmetic follows march_plain (ops/march.py) operation for operation, so
// with -fmad=false the two agree bit for bit: the texel coordinate is
// (p - bm) * inv_ls, the escape clamp is esc < EPS -> BIGEPS then + EPS, a
// step counts only while the ray is live and resident, and the chunk index
// is floor(p / cs) taken modulo the grid with a floor modulo.

#include "common.cuh"

namespace ort {
namespace {

struct MarchArgs {
    const int32_t* tree;
    const int32_t* twig;
    const int32_t* twig_occ;
    const float* chunk_bmin;
    const int32_t* chunk_tree;
    const int32_t* chunk_twig;
    const float* chunkcoordmin;
    float chunksize;
    int w, h, d, depth;
    int64_t twig_len, occ_len;
    const float* o;
    const float* dirs;
    const float* t_start;        // nullable: resume parameter per ray
    const int32_t* live_start;   // nullable: 0/1 liveness per ray
    int64_t n;
    int cap;                     // loop bound: 4 * ceil(max_steps / 4)
    int assume_resident;
    int steps_aov;
    uint8_t* out_hit;
    float* out_t;
    int32_t* out_material;
    float* out_cell_bmin;
    float* out_cell_size;
    int32_t* out_steps;
    int32_t* out_texel;
};

__global__ void __launch_bounds__(128) march_kernel(const MarchArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;

    const float ax = a.o[3 * r], ay = a.o[3 * r + 1], az = a.o[3 * r + 2];
    const float bx = a.dirs[3 * r], by = a.dirs[3 * r + 1], bz = a.dirs[3 * r + 2];
    const float gx = safe_inv(bx), gy = safe_inv(by), gz = safe_inv(bz);

    const float cs = a.chunksize;
    const float lox = __ldg(a.chunkcoordmin + 0) * cs;
    const float loy = __ldg(a.chunkcoordmin + 1) * cs;
    const float loz = __ldg(a.chunkcoordmin + 2) * cs;
    const float hix = lox + (float)a.w * cs;
    const float hiy = loy + (float)a.h * cs;
    const float hiz = loz + (float)a.d * cs;
    const int nchunks = a.w * a.h * a.d;

    // ---- entry (march_jnp._entry_t_live) or resume (t_start) -------------
    float t0;
    bool live;
    if (a.t_start == nullptr) {
        const float t1x = fminf((lox - ax) * gx, (hix - ax) * gx);
        const float t2x = fmaxf((lox - ax) * gx, (hix - ax) * gx);
        const float t1y = fminf((loy - ay) * gy, (hiy - ay) * gy);
        const float t2y = fmaxf((loy - ay) * gy, (hiy - ay) * gy);
        const float t1z = fminf((loz - az) * gz, (hiz - az) * gz);
        const float t2z = fmaxf((loz - az) * gz, (hiz - az) * gz);
        const float tnear = fmaxf(t1x, fmaxf(t1y, t1z));
        const float tfar = fminf(t2x, fminf(t2y, t2z));
        const bool inside0 = ax >= lox && ax <= hix && ay >= loy && ay <= hiy &&
                             az >= loz && az <= hiz;
        const bool enter_ok = tfar > tnear && tnear > 0.0f;
        t0 = (1.0f - (inside0 ? 1.0f : 0.0f)) * (tnear + kEps);
        live = inside0 || enter_ok;
    } else {
        t0 = fmaxf(a.t_start[r], 0.0f);
        live = true;
    }
    if (a.live_start != nullptr) live = live && a.live_start[r] != 0;
    // The packed-state start of the reference: clamp, then clear the sign.
    float t = fabsf(fminf(t0, kTClamp));

    bool hit = false;
    int steps = 0;
    int material = 0, texel = -1;
    float hbx = 0.0f, hby = 0.0f, hbz = 0.0f, hsize = 0.0f;

    for (int it = 0; it < a.cap && live; ++it) {
        const float tg = fminf(t, kTClamp);
        const float px = ax + bx * tg, py = ay + by * tg, pz = az + bz * tg;
        const bool in_world = px >= lox && px <= hix && py >= loy && py <= hiy &&
                              pz >= loz && pz <= hiz;
        if (!in_world) { live = false; break; }

        // ---- locate: toroidal chunk lookup ---------------------------------
        const float qx = floorf(px / cs), qy = floorf(py / cs), qz = floorf(pz / cs);
        int ci = imod((int)qx, a.w) + imod((int)qz, a.d) * a.w +
                 imod((int)qy, a.h) * (a.w * a.d);
        ci = clampi(ci, 0, nchunks - 1);
        float bmx = qx * cs, bmy = qy * cs, bmz = qz * cs;
        if (!a.assume_resident) {
            const bool in_chunk = __ldg(a.chunk_bmin + 3 * ci) == bmx &&
                                  __ldg(a.chunk_bmin + 3 * ci + 1) == bmy &&
                                  __ldg(a.chunk_bmin + 3 * ci + 2) == bmz;
            if (!in_chunk) { live = false; break; }
        }
        ++steps;

        // ---- locate: descent ------------------------------------------------
        const int tree_off = __ldg(a.chunk_tree + ci);
        const int twig_off = __ldg(a.chunk_twig + ci);
        float size = cs;
        int word = __ldg(a.tree + tree_off);
        for (int lv = 0; lv < a.depth; ++lv) {
            if (((word >> 30) & 3) != kBranch) break;
            const int payload = word & kU30;
            const float half = size * 0.5f;
            const int gex = px >= bmx + half;
            const int gey = py >= bmy + half;
            const int gez = pz >= bmz + half;
            bmx = bmx + (gex ? half : 0.0f);
            bmy = bmy + (gey ? half : 0.0f);
            bmz = bmz + (gez ? half : 0.0f);
            size = size - half;
            word = __ldg(a.tree + tree_off + payload + gex + 2 * gey + 4 * gez);
        }

        // ---- solid probe ----------------------------------------------------
        const int ty = (word >> 30) & 3;
        const int payload = word & kU30;
        const bool m_leaf = ty == kLeaf;
        const bool m_twig = ty == kTwig;
        const float leafsize = size * (1.0f / kTwigSize);
        const float inv_ls = 1.0f / leafsize;
        const int tox = trunc_clip((px - bmx) * inv_ls, 0.0f, kTwigSize - 1);
        const int toy = trunc_clip((py - bmy) * inv_ls, 0.0f, kTwigSize - 1);
        const int toz = trunc_clip((pz - bmz) * inv_ls, 0.0f, kTwigSize - 1);
        const int tword = toz * (kTwigSize * kTwigSize) + toy * kTwigSize + tox;
        bool solid = m_leaf;
        if (m_twig) {
            const int64_t oi = clampl((int64_t)(twig_off + payload) * 2 + (tword >> 5),
                                      0, a.occ_len - 1);
            solid = (__ldg(a.twig_occ + oi) >> (tword & 31)) & 1;
        }

        if (solid) {
            // ---- hit record (march_jnp._hit_record) at the frozen t ---------
            hit = true;
            live = false;
            const int64_t ti = clampl((int64_t)(twig_off + payload) * kTwigWords + tword,
                                      0, a.twig_len - 1);
            material = m_leaf ? payload : __ldg(a.twig + ti);
            hbx = bmx + (m_leaf ? 0.0f : (float)tox * leafsize);
            hby = bmy + (m_leaf ? 0.0f : (float)toy * leafsize);
            hbz = bmz + (m_leaf ? 0.0f : (float)toz * leafsize);
            hsize = m_leaf ? size : size + (leafsize - size);
            texel = m_leaf ? -1 : (int)ti;
            break;
        }

        // ---- advance: escape the (cell | texel) box ------------------------
        const float ex = bmx + (m_twig ? (float)tox * leafsize : 0.0f);
        const float ey = bmy + (m_twig ? (float)toy * leafsize : 0.0f);
        const float ez = bmz + (m_twig ? (float)toz * leafsize : 0.0f);
        const float esize = m_twig ? size + (leafsize - size) : size;
        const float dx = fmaxf((ex - px) * gx, (ex + esize - px) * gx);
        const float dy = fmaxf((ey - py) * gy, (ey + esize - py) * gy);
        const float dz = fmaxf((ez - pz) * gz, (ez + esize - pz) * gz);
        float esc = fminf(dx, fminf(dy, dz));
        if (esc < kEps) esc = esc + (kBigEps - esc);
        esc = esc + kEps;
        t = tg + esc;
    }

    a.out_hit[r] = hit ? 1 : 0;
    a.out_t[r] = hit ? t : INFINITY;
    a.out_material[r] = material;
    a.out_cell_bmin[3 * r] = hbx;
    a.out_cell_bmin[3 * r + 1] = hby;
    a.out_cell_bmin[3 * r + 2] = hbz;
    a.out_cell_size[r] = hsize;
    a.out_steps[r] = a.steps_aov ? steps : 0;
    a.out_texel[r] = texel;
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
              int64_t n, int cap, int assume_resident, int steps_aov,
              void* out_hit, void* out_t, void* out_material, void* out_cell_bmin,
              void* out_cell_size, void* out_steps, void* out_texel, void* stream) {
    ort::MarchArgs a;
    a.tree = static_cast<const int32_t*>(tree);
    a.twig = static_cast<const int32_t*>(twig);
    a.twig_occ = static_cast<const int32_t*>(twig_occ);
    a.chunk_bmin = static_cast<const float*>(chunk_bmin);
    a.chunk_tree = static_cast<const int32_t*>(chunk_tree);
    a.chunk_twig = static_cast<const int32_t*>(chunk_twig);
    a.chunkcoordmin = static_cast<const float*>(chunkcoordmin);
    a.chunksize = chunksize;
    a.w = w; a.h = h; a.d = d; a.depth = depth;
    a.twig_len = twig_len; a.occ_len = occ_len;
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.t_start = static_cast<const float*>(t_start);
    a.live_start = static_cast<const int32_t*>(live_start);
    a.n = n; a.cap = cap;
    a.assume_resident = assume_resident; a.steps_aov = steps_aov;
    a.out_hit = static_cast<uint8_t*>(out_hit);
    a.out_t = static_cast<float*>(out_t);
    a.out_material = static_cast<int32_t*>(out_material);
    a.out_cell_bmin = static_cast<float*>(out_cell_bmin);
    a.out_cell_size = static_cast<float*>(out_cell_size);
    a.out_steps = static_cast<int32_t*>(out_steps);
    a.out_texel = static_cast<int32_t*>(out_texel);
    if (n > 0) {
        const int threads = 128;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ort::march_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

const char* ort_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
