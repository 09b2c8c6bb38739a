// The octree march shared by K1 (march.cu) and K4 (segments.cu).
//
// One formula, one rounding: the world-entry slab test and the bounded march
// loop (locate, solid probe, escape, with the optional per-ray budget) live
// here once, so each phase of the segment sampler stops exactly where a
// first-hit march stops.  This is the JAX package's shared `_march_env`
// (ops/march_jnp.py:243), and it does for the kernels what that package's
// one compiled extraction `_extract_jit` (diff/segments.py:84-93) does for
// its samplers: every caller rounds alike.
//
// Arithmetic follows march_plain (ops/march.py) operation for operation, so
// with -fmad=false the kernels agree with it bit for bit: the texel
// coordinate is (p - bm) * inv_ls, the escape clamp is esc < EPS -> BIGEPS
// then + EPS, a step counts only while the ray is live and resident, and the
// chunk index is floor(p / cs) taken modulo the grid with a floor modulo.
//
// The path cache.  Locating a point is a chain of dependent loads: the chunk
// table, the chunk's root word, one tree word per level (each address is in
// the word before it), then the twig's occupancy word.  Most steps land in
// the cell next to the last one, or in the same twig, so the chain repeats
// loads already made.  Each ray keeps the path it located last (PathCache):
// the chunk, the child chosen at every level with the tree word read there,
// and its twig's two occupancy words.  A step still runs every compare of
// the descent from the root in the reference's order (so bm and size round
// as before), takes the cached word while the chunk and every choice so far
// match, and loads only below the first choice that differs; a texel step
// inside the same twig loads nothing.  The pools are read-only during a
// launch, so a skipped load is one whose address equals a load already
// made: the result is the full descent's.  The words of the first
// kPathLevels levels live in registers (that part of the descent is
// unrolled, so each index is a constant); kernels that march hold at least
// kMinBlocks blocks a SM, which caps them at 64 registers.
#pragma once

#include "common.cuh"

namespace ort {

// The pools and chunk table of a TorchWorld (world/device.py).
struct WorldArgs {
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
};

inline WorldArgs world_args(const void* tree, const void* twig, const void* twig_occ,
                            const void* chunk_bmin, const void* chunk_tree,
                            const void* chunk_twig, const void* chunkcoordmin,
                            float chunksize, int w, int h, int d, int depth,
                            int64_t twig_len, int64_t occ_len) {
    WorldArgs a;
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
    return a;
}

struct Box { float lox, loy, loz, hix, hiy, hiz; };

struct Ray { float ax, ay, az, bx, by, bz, gx, gy, gz; };

// The hit record of march_jnp._hit_record: material, hit cell (texel box
// inside twigs) and flat texel index (-1 for LEAF hits).
struct HitRecord {
    int material = 0, texel = -1;
    float bx = 0.0f, by = 0.0f, bz = 0.0f, size = 0.0f;
};

__device__ __forceinline__ Box world_box(const WorldArgs& w) {
    const float cs = w.chunksize;
    Box b;
    b.lox = __ldg(w.chunkcoordmin + 0) * cs;
    b.loy = __ldg(w.chunkcoordmin + 1) * cs;
    b.loz = __ldg(w.chunkcoordmin + 2) * cs;
    b.hix = b.lox + (float)w.w * cs;
    b.hiy = b.loy + (float)w.h * cs;
    b.hiz = b.loz + (float)w.d * cs;
    return b;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* dirs, int64_t r) {
    Ray q;
    q.ax = o[3 * r]; q.ay = o[3 * r + 1]; q.az = o[3 * r + 2];
    q.bx = dirs[3 * r]; q.by = dirs[3 * r + 1]; q.bz = dirs[3 * r + 2];
    q.gx = safe_inv(q.bx); q.gy = safe_inv(q.by); q.gz = safe_inv(q.bz);
    return q;
}

// march_jnp._entry_t_live: advance rays that start outside the world to its
// surface, kill rays that never enter.
__device__ __forceinline__ void entry_t_live(const Ray& q, const Box& b, float& t0,
                                             bool& live) {
    const float t1x = fminf((b.lox - q.ax) * q.gx, (b.hix - q.ax) * q.gx);
    const float t2x = fmaxf((b.lox - q.ax) * q.gx, (b.hix - q.ax) * q.gx);
    const float t1y = fminf((b.loy - q.ay) * q.gy, (b.hiy - q.ay) * q.gy);
    const float t2y = fmaxf((b.loy - q.ay) * q.gy, (b.hiy - q.ay) * q.gy);
    const float t1z = fminf((b.loz - q.az) * q.gz, (b.hiz - q.az) * q.gz);
    const float t2z = fmaxf((b.loz - q.az) * q.gz, (b.hiz - q.az) * q.gz);
    const float tnear = fmaxf(t1x, fmaxf(t1y, t1z));
    const float tfar = fminf(t2x, fminf(t2y, t2z));
    const bool inside0 = q.ax >= b.lox && q.ax <= b.hix && q.ay >= b.loy &&
                         q.ay <= b.hiy && q.az >= b.loz && q.az <= b.hiz;
    const bool enter_ok = tfar > tnear && tnear > 0.0f;
    t0 = (1.0f - (inside0 ? 1.0f : 0.0f)) * (tnear + kEps);
    live = inside0 || enter_ok;
}

// The packed-state start of the reference: clamp, then clear the sign.
__device__ __forceinline__ float start_t(float t0) { return fabsf(fminf(t0, kTClamp)); }

// Where a bounded march ends.  `t` is the hit parameter for a hit and the
// current parameter for a ray still live at the cap.
struct MarchState {
    bool hit = false, live = false;
    float t = 0.0f;
    int steps = 0;     // live, resident steps (the exact steps AOV)
    int charged = 0;   // budget charged: stride per stage entered
    HitRecord rec;
};

constexpr int kPathLevels = 8;    // levels a path keeps: all of them up to depth 10
constexpr int kPathThreads = 128; // threads per block of K1 and K4
constexpr int kMinBlocks = 8;     // resident blocks a SM, held by __launch_bounds__

// The octree path a ray located at its last step: the chunk (keyed by
// floor(p / chunksize), which fixes both the chunk index and its bmin on the
// toroidal grid) with its pool offsets, the tree word read at each of the
// first kPathLevels levels (word[0] is the chunk's root) and the child chosen
// there (3 bits a level), and the two occupancy words of the twig the path
// ends at.  Twigs sit at level depth - 2, so worlds up to depth 10 keep
// their whole path; a deeper one loads its levels past kPathLevels at every
// step.
struct PathCache {
    float qx = INFINITY, qy = 0.0f, qz = 0.0f;  // no chunk equals it: no path yet
    int tree_off = 0, twig_off = 0;
    uint32_t choices = 0;
    int occ0 = 0, occ1 = 0;
    int word[kPathLevels + 1];

    __device__ __forceinline__ uint32_t choice(int l) const { return (choices >> (3 * l)) & 7u; }
    __device__ __forceinline__ void set_choice(int l, uint32_t c) {
        choices = (choices & ~(7u << (3 * l))) | (c << (3 * l));
    }
};

// One level of the descent: the child of the cell (bm, size) that holds p,
// in the reference's order; moves bm and size to it and returns its index.
__device__ __forceinline__ uint32_t descend(float px, float py, float pz, float& bmx,
                                            float& bmy, float& bmz, float& size) {
    const float half = size * 0.5f;
    const int gex = px >= bmx + half;
    const int gey = py >= bmy + half;
    const int gez = pz >= bmz + half;
    bmx = bmx + (gex ? half : 0.0f);
    bmy = bmy + (gey ? half : 0.0f);
    bmz = bmz + (gez ? half : 0.0f);
    size = size - half;
    return (uint32_t)(gex + 2 * gey + 4 * gez);
}

// The bounded loop (march_jnp._run_loop) from parameter t; each iteration is
// one step: locate the point's chunk and cell, stop on a solid LEAF cell or
// twig texel (the hit record is taken there), else escape the cell or texel
// box.  A point outside the world or in a non-resident chunk ends the ray.
// Without a budget the loop runs at most `cap` iterations.  With one
// (march_jnp.py:596-616) the iterations fall into stages of `stride`: a ray
// enters a stage only while charged < budget, each stage entered charges a
// full stride, and a ray whose budget runs out is a miss.  The budget is a
// template parameter so the unbudgeted march carries no budget state, and
// the step is written inline so every exit is a plain break (a step function
// returning an outcome code cost K1 a reconvergence point per iteration).
//
// Locating a point reuses the path of the last step (`path`, carried by the
// caller across calls; see the path cache above).
template <bool kBudget>
__device__ __forceinline__ MarchState run_march(const WorldArgs& w, const Box& b, const Ray& q,
                                                float t, bool live, int cap, int budget,
                                                int stride, bool assume_resident,
                                                PathCache& path) {
    MarchState s;
    const float cs = w.chunksize;
    const int nchunks = w.w * w.h * w.d;
    int next_stage = 0;
    for (int it = 0; it < cap && live; ++it) {
        if (kBudget && it == next_stage) {
            if (s.charged >= budget) { live = false; break; }
            s.charged += stride;
            next_stage += stride;
        }
        const float tg = fminf(t, kTClamp);
        const float px = q.ax + q.bx * tg, py = q.ay + q.by * tg, pz = q.az + q.bz * tg;
        const bool in_world = px >= b.lox && px <= b.hix && py >= b.loy && py <= b.hiy &&
                              pz >= b.loz && pz <= b.hiz;
        if (!in_world) { live = false; break; }

        // ---- locate: toroidal chunk lookup (only when the chunk changed) -----
        const float qx = floorf(px / cs), qy = floorf(py / cs), qz = floorf(pz / cs);
        float bmx = qx * cs, bmy = qy * cs, bmz = qz * cs;
        bool same = qx == path.qx && qy == path.qy && qz == path.qz;
        if (!same) {
            int ci = imod((int)qx, w.w) + imod((int)qz, w.d) * w.w +
                     imod((int)qy, w.h) * (w.w * w.d);
            ci = clampi(ci, 0, nchunks - 1);
            if (!assume_resident) {
                const bool in_chunk = __ldg(w.chunk_bmin + 3 * ci) == bmx &&
                                      __ldg(w.chunk_bmin + 3 * ci + 1) == bmy &&
                                      __ldg(w.chunk_bmin + 3 * ci + 2) == bmz;
                if (!in_chunk) { live = false; break; }
            }
            path.qx = qx; path.qy = qy; path.qz = qz;
            path.tree_off = __ldg(w.chunk_tree + ci);
            path.twig_off = __ldg(w.chunk_twig + ci);
            path.word[0] = __ldg(w.tree + path.tree_off);
        }
        ++s.steps;

        // ---- locate: descent, loads only below the first new choice ------------
        float size = cs;
        int word = path.word[0];
#pragma unroll
        for (int lv = 0; lv < kPathLevels; ++lv) {
            if (lv >= w.depth || ((word >> 30) & 3) != kBranch) break;
            const int payload = word & kU30;
            const uint32_t child = descend(px, py, pz, bmx, bmy, bmz, size);
            same = same && child == path.choice(lv);
            if (same) {
                word = path.word[lv + 1];
            } else {
                word = __ldg(w.tree + path.tree_off + payload + (int)child);
                path.word[lv + 1] = word;
                path.set_choice(lv, child);
            }
        }
        for (int lv = kPathLevels; lv < w.depth; ++lv) {   // levels the path does not keep
            if (((word >> 30) & 3) != kBranch) break;
            const int payload = word & kU30;
            const uint32_t child = descend(px, py, pz, bmx, bmy, bmz, size);
            word = __ldg(w.tree + path.tree_off + payload + (int)child);
            same = false;
        }

        // ---- solid probe (a new twig's two occupancy words load together) -------
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
            if (!same) {
                const int64_t ob = (int64_t)(path.twig_off + payload) * 2;
                path.occ0 = __ldg(w.twig_occ + clampl(ob, 0, w.occ_len - 1));
                path.occ1 = __ldg(w.twig_occ + clampl(ob + 1, 0, w.occ_len - 1));
            }
            solid = (((tword >> 5) ? path.occ1 : path.occ0) >> (tword & 31)) & 1;
        }

        if (solid) {
            // ---- hit record (march_jnp._hit_record) at the frozen t --------------------
            const int64_t ti = clampl((int64_t)(path.twig_off + payload) * kTwigWords + tword,
                                      0, w.twig_len - 1);
            s.rec.material = m_leaf ? payload : __ldg(w.twig + ti);
            s.rec.bx = bmx + (m_leaf ? 0.0f : (float)tox * leafsize);
            s.rec.by = bmy + (m_leaf ? 0.0f : (float)toy * leafsize);
            s.rec.bz = bmz + (m_leaf ? 0.0f : (float)toz * leafsize);
            s.rec.size = m_leaf ? size : size + (leafsize - size);
            s.rec.texel = m_leaf ? -1 : (int)ti;
            s.hit = true;
            live = false;
            break;
        }

        // ---- advance: escape the (cell | texel) box --------------------------------
        const float ex = bmx + (m_twig ? (float)tox * leafsize : 0.0f);
        const float ey = bmy + (m_twig ? (float)toy * leafsize : 0.0f);
        const float ez = bmz + (m_twig ? (float)toz * leafsize : 0.0f);
        const float esize = m_twig ? size + (leafsize - size) : size;
        const float dx = fmaxf((ex - px) * q.gx, (ex + esize - px) * q.gx);
        const float dy = fmaxf((ey - py) * q.gy, (ey + esize - py) * q.gy);
        const float dz = fmaxf((ez - pz) * q.gz, (ez + esize - pz) * q.gz);
        float esc = fminf(dx, fminf(dy, dz));
        if (esc < kEps) esc = esc + (kBigEps - esc);
        esc = esc + kEps;
        t = tg + esc;
    }
    s.live = live;
    s.t = t;
    return s;
}

}  // namespace ort
