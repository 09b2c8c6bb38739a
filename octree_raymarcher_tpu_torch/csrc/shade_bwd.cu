// K8: the VJP of K2, the shading kernel (csrc/shade.cu), by hand.
//
// Replaces the reverse mode XLA derives for the JAX package's shading
// program (B6 backward): jax.grad through octree_raymarcher_tpu/shade/
// render.py `shade_hits` with respect to the light rig, the material
// table's diffuse, specular and shininess, the atlas, the sky map, the eye,
// and the ray origins and directions with the march held fixed (the JAX
// march carries t through an int32 loop state, so no gradient crosses it).
// The hit mask, the material, the cell, the shadow factor and the map
// compare carry none.
//
// One thread takes one ray, in a persistent loop over the rays.  It
// recomputes K2's forward for its ray from the same functions (shade.cuh),
// keeping the intermediates, then runs reverse mode by hand through the
// three lights (normalize, the clamps, powf, the attenuation, the spot
// cone), the atlas decode, the sky map's bilinear taps and the depth.  At a
// max or a clip a tie takes half the gradient, as jnp.maximum and jnp.clip
// do: a face normal perpendicular to the directional light makes n.l
// exactly 0 on every such face.
//
// Accumulation is what is hard: every ray adds into the same 53 floats (the
// rig and the eye) and a few table rows, and neighbouring rays into the
// same atlas texels and sky taps.  So (PERF.md, "Atomics on hot slots"):
// * the rig and the eye are summed per warp with shuffles into the warp's
//   row of a shared-memory table, and per block at the end into 53 global
//   atomics a block;
// * the table's 7 gradient floats a row are summed per warp over the lanes
//   that share a row, and per block in shared memory while M * 7 floats fit
//   (about 1,690 rows), flushed once a block; past that the warp sums go to
//   global atomics;
// * atlas texels and sky taps are summed per warp over the lanes that share
//   one (one pass per distinct key of the warp), then one atomic a key.
// Float atomics make the sums' order, and so their last bits, vary from
// run to run; the rest is exact to the forward's arithmetic.

#include <algorithm>

#include "shade.cuh"
#include "shadow.cuh"

namespace ort {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kAcc = kLightFloats + 3;   // the rig's 50 floats, then the eye
constexpr int kEye = kLightFloats;
constexpr int kRowGrad = 7;              // diffuse 3, specular 3, shininess
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;

struct ShadeBwdArgs {
    const uint8_t* hit;
    const float* t;
    const int32_t* material;
    const float* cell_bmin;
    const float* cell_size;
    const float* o;
    const float* dirs;
    const float* eye;         // [3] on the card
    const float* shadow;      // nullable: shadow factor per ray
    ShadowMap map;            // kMap: the light depth map
    const float* rig;         // [50] on the card
    const float* mat_diffuse;
    const float* mat_specular;
    const float* mat_shininess;
    int num_materials;
    const float* atlas;       // nullable: [Ma, R, R, 3]
    int atlas_materials, atlas_res;
    const float* envmap;      // nullable: [H, W, 3]
    int env_h, env_w;
    float gamma;
    int64_t n;
    const float* g_rgb;       // nullable: [N, 3]
    const float* g_depth;     // nullable: [N]
    float* g_rig;             // [50], accumulated
    float* g_eye;             // [3], accumulated
    float* g_diffuse;         // [M, 3], accumulated
    float* g_specular;        // [M, 3], accumulated
    float* g_shininess;       // [M], accumulated
    float* g_atlas;           // nullable: [Ma, R, R, 3], accumulated
    float* g_env;             // nullable: [H, W, 3], accumulated
    float* g_o;               // nullable: [N, 3], written
    float* g_d;               // nullable: [N, 3], written
    int rows_in_smem;
};

// d max(x, c) / dx with jnp.maximum's tie rule.
__device__ __forceinline__ float dmax(float x, float c) {
    return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// d clip(x, lo, hi) / dx for jnp.clip = minimum(maximum(x, lo), hi).
__device__ __forceinline__ float dclip(float x, float lo, float hi) {
    const float m = fmaxf(x, lo);
    return dmax(x, lo) * (m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f));
}

// The cotangent of u given g, the cotangent of u / max(|u|, 1e-12).
__device__ __forceinline__ V3 normalize_bwd(V3 g, V3 u) {
    const float len = length(u);
    const float m = fmaxf(len, 1e-12f);
    V3 r = {g.x / m, g.y / m, g.z / m};
    if (len > 0.0f) {
        const float gm = -dot(g, u) / (m * m) * dmax(len, 1e-12f);
        r = add(r, scale(u, gm / len));
    }
    return r;
}

// The cotangent of u given g, the cotangent of |u| (= len).
__device__ __forceinline__ V3 length_bwd(float g, V3 u, float len) {
    return len > 0.0f ? scale(u, g / len) : V3{0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ void add3(float* acc, int i, V3 v) {
    acc[i] += v.x;
    acc[i + 1] += v.y;
    acc[i + 2] += v.z;
}

// K2's blinn() with its intermediates.
struct BlinnFwd {
    V3 l_raw, l, h_raw, h;
    float nl, d, vh, x, s;
};

__device__ __forceinline__ BlinnFwd blinn_fwd(V3 n, V3 l_raw, V3 v, float shin) {
    BlinnFwd f;
    f.l_raw = l_raw;
    f.l = normalize(l_raw);
    f.h_raw = add(f.l, v);
    f.h = normalize(f.h_raw);
    f.nl = dot(n, f.l);
    f.d = fmaxf(f.nl, 0.0f);
    f.vh = dot(v, f.h);
    f.x = fmaxf(f.vh, 1e-6f);
    f.s = powf(f.x, shin);
    return f;
}

// Reverse of blinn_fwd: from the cotangents of d, s and the unit light
// vector l (g_l, from the spot cone), the cotangent of l_raw; adds the view
// vector's and the shininess's.
__device__ __forceinline__ V3 blinn_bwd(const BlinnFwd& f, V3 n, V3 v, float shin, float g_d,
                                        float g_s, V3 g_l, V3& g_v, float& g_shin) {
    const float g_x = shin == 0.0f ? 0.0f : g_s * (shin * powf(f.x, shin - 1.0f));
    g_shin += g_s * (logf(f.x) * f.s);
    const float g_vh = g_x * dmax(f.vh, 1e-6f);
    g_l = add(g_l, scale(n, g_d * dmax(f.nl, 0.0f)));
    g_v = add(g_v, scale(f.h, g_vh));
    const V3 g_hraw = normalize_bwd(scale(v, g_vh), f.h_raw);
    g_l = add(g_l, g_hraw);
    g_v = add(g_v, g_hraw);
    return normalize_bwd(g_l, f.l_raw);
}

// Reverse of light_terms: gA is the cotangent of amb, gDS that of diff and
// of spec; adds the rig's, the colours' and d's and s's cotangents.
__device__ __forceinline__ void terms_bwd(const float* L, float* acc, int amb, int dif, int spec,
                                          V3 gA, V3 gDS, float d, float s, V3 diffuse,
                                          V3 specular, float lit, V3& g_diffuse, V3& g_specular,
                                          float& g_d, float& g_s) {
    const V3 La = v3(L + amb), Ld = v3(L + dif), Ls = v3(L + spec);
    add3(acc, amb, mul(gA, diffuse));
    g_diffuse = add(g_diffuse, mul(gA, La));
    const V3 gl = scale(gDS, lit);
    const V3 gld = mul(gl, diffuse), gls = mul(gl, specular);
    add3(acc, dif, scale(gld, d));
    g_d += dot(gld, Ld);
    g_diffuse = add(g_diffuse, mul(gl, scale(Ld, d)));
    add3(acc, spec, scale(gls, s));
    g_s += dot(gls, Ls);
    g_specular = add(g_specular, mul(gl, scale(Ls, s)));
}

// Reverse of att = 1 / (kc + kl*dist + kq*dist*dist): adds kc's, kl's and
// kq's cotangents, returns dist's.
__device__ __forceinline__ float att_bwd(const float* L, float* acc, int kc, float g_att,
                                         float att, float dist) {
    const float g_den = -g_att * att * att;
    acc[kc] += g_den;
    acc[kc + 1] += g_den * dist;
    acc[kc + 2] += g_den * dist * dist;
    return g_den * (L[kc + 1] + 2.0f * L[kc + 2] * dist);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// Every lane of the warp calls this together: the lanes that share a key
// (>= 0) sum their kN values, and the lowest of them calls add(key, j, sum)
// once a value.  One pass per distinct key of the warp.
template <int kN, typename Add>
__device__ __forceinline__ void warp_scatter(long long key, const float* v, Add add) {
    const int lane = threadIdx.x & 31;
    unsigned todo = __ballot_sync(kFull, key >= 0);
    while (todo) {
        const int leader = __ffs(todo) - 1;
        const long long k = __shfl_sync(kFull, key, leader);
        const unsigned peers = __ballot_sync(kFull, key == k);
        todo &= ~peers;
        if (__popc(peers) == 1) {
            if (lane == leader) {
#pragma unroll
                for (int j = 0; j < kN; ++j) add(k, j, v[j]);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kN; ++j) {
                const float s = warp_sum(key == k ? v[j] : 0.0f);
                if (lane == leader) add(k, j, s);
            }
        }
    }
}

template <bool kMap, bool kTex>
__global__ void __launch_bounds__(kBwdThreads) shade_bwd_kernel(const __grid_constant__ ShadeBwdArgs a) {
    extern __shared__ float bwd_smem[];
    float* wacc = bwd_smem;                            // [kBwdWarps][kAcc]
    float* rows = bwd_smem + kBwdWarps * kAcc;         // [M][kRowGrad] when rows_in_smem
    __shared__ float L[kLightFloats];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int M = a.num_materials;
    for (int i = threadIdx.x; i < kLightFloats; i += blockDim.x) L[i] = __ldg(a.rig + i);
    const int nsm = kBwdWarps * kAcc + (a.rows_in_smem ? M * kRowGrad : 0);
    for (int i = threadIdx.x; i < nsm; i += blockDim.x) bwd_smem[i] = 0.0f;
    __syncthreads();

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < a.n; base += stride) {
        const int64_t r = base + threadIdx.x;
        float acc[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
        long long row_key = -1, tex_key = -1;
        float rg[kRowGrad] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float tg[3] = {0.0f, 0.0f, 0.0f};
        long long env_key[4] = {-1, -1, -1, -1};
        float env_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        V3 Gr = {0.0f, 0.0f, 0.0f};

        if (r < a.n) {
            const bool hit = a.hit[r] != 0;
            const V3 o = ld3(a.o + 3 * r);
            const V3 b = ld3(a.dirs + 3 * r);
            if (a.g_rgb != nullptr) Gr = ld3(a.g_rgb + 3 * r);
            V3 g_p = {0.0f, 0.0f, 0.0f};
            V3 g_b = {0.0f, 0.0f, 0.0f};
            float t_hit = 0.0f;
            if (hit) {
                // ---- K2's forward for a hit -----------------------------------
                const V3 cmin = ld3(a.cell_bmin + 3 * r);
                const float csz = a.cell_size[r];
                t_hit = a.t[r];
                const V3 p = add(o, scale(b, t_hit - kEps));
                const V3 cmax = {cmin.x + csz, cmin.y + csz, cmin.z + csz};
                const V3 n = cube_normal(p, cmin, cmax);
                const int mat = a.material[r];
                const int mi = clampi(mat, 0, M - 1);
                const V3 dif0 = ld3(a.mat_diffuse + 3 * mi);
                const V3 spec0 = ld3(a.mat_specular + 3 * mi);
                const float shin = __ldg(a.mat_shininess + mi);
                V3 diffuse = dif0, specular = spec0;
                V3 raw = {0.0f, 0.0f, 0.0f}, texg = {1.0f, 1.0f, 1.0f};
                long long lin = -1;
                if constexpr (kTex) {
                    if (a.atlas != nullptr) {
                        lin = atlas_lin(p, cmin, cmax, mat, a.atlas_res, a.atlas_materials);
                        raw = ld3(a.atlas + 3 * lin);
                        texg = {decode_gamma(raw.x, a.gamma), decode_gamma(raw.y, a.gamma),
                                decode_gamma(raw.z, a.gamma)};
                        diffuse = mul(diffuse, texg);
                        specular = mul(specular, texg);
                    }
                }
                float shadow;
                if constexpr (kMap) {
                    shadow = map_shadowed(a.map, p) ? 1.0f : 0.0f;
                } else {
                    shadow = a.shadow != nullptr ? a.shadow[r] : 0.0f;
                }
                const float lit = 1.0f - shadow;
                const V3 eye = ld3(a.eye);
                const V3 v_raw = sub(eye, p);
                const V3 v = normalize(v_raw);
                V3 g_v = {0.0f, 0.0f, 0.0f};
                V3 g_diffuse = {0.0f, 0.0f, 0.0f}, g_specular = {0.0f, 0.0f, 0.0f};
                float g_shin = 0.0f;
                const V3 zero = {0.0f, 0.0f, 0.0f};

                // ---- the point light --------------------------------------------
                {
                    const V3 lpos = v3(L + kPointPos);
                    const BlinnFwd f = blinn_fwd(n, sub(lpos, p), v, shin);
                    const V3 dvec = sub(p, lpos);
                    const float dist = length(dvec);
                    const float att = 1.0f / (L[kPointKc] + L[kPointKl] * dist +
                                              L[kPointKq] * dist * dist);
                    const Terms tm = light_terms(L, kPointAmb, kPointDif, kPointSpec, f.d, f.s,
                                                 diffuse, specular, lit);
                    const float g_att = dot(Gr, add(add(tm.amb, tm.diff), tm.spec));
                    const V3 gS = scale(Gr, att);
                    float g_d = 0.0f, g_s = 0.0f;
                    terms_bwd(L, acc, kPointAmb, kPointDif, kPointSpec, gS, gS, f.d, f.s,
                              diffuse, specular, lit, g_diffuse, g_specular, g_d, g_s);
                    const V3 gdv = length_bwd(att_bwd(L, acc, kPointKc, g_att, att, dist), dvec,
                                              dist);
                    g_p = add(g_p, gdv);
                    add3(acc, kPointPos, neg(gdv));
                    const V3 g_lraw = blinn_bwd(f, n, v, shin, g_d, g_s, zero, g_v, g_shin);
                    add3(acc, kPointPos, g_lraw);
                    g_p = sub(g_p, g_lraw);
                }
                // ---- the directional light ----------------------------------------
                {
                    const BlinnFwd f = blinn_fwd(n, neg(v3(L + kDirDir)), v, shin);
                    float g_d = 0.0f, g_s = 0.0f;
                    terms_bwd(L, acc, kDirAmb, kDirDif, kDirSpec, Gr, Gr, f.d, f.s, diffuse,
                              specular, lit, g_diffuse, g_specular, g_d, g_s);
                    const V3 g_lraw = blinn_bwd(f, n, v, shin, g_d, g_s, zero, g_v, g_shin);
                    add3(acc, kDirDir, neg(g_lraw));
                }
                // ---- the spotlight ----------------------------------------------------
                {
                    const V3 lpos = v3(L + kSpotPos);
                    const BlinnFwd f = blinn_fwd(n, sub(lpos, p), v, shin);
                    const V3 dvec = sub(p, lpos);
                    const float dist = length(dvec);
                    const float att = 1.0f / (L[kSpotKc] + L[kSpotKl] * dist +
                                              L[kSpotKq] * dist * dist);
                    const V3 sd_raw = neg(v3(L + kSpotDir));
                    const V3 sdn = normalize(sd_raw);
                    const float theta = dot(f.l, sdn);
                    const float cphi = L[kSpotCosPhi], cgam = L[kSpotCosGamma];
                    const float cone_raw = cphi - cgam;
                    const float cone = fmaxf(cone_raw, 1e-6f);
                    const float q = (theta - cgam) / cone;
                    const float intensity = fminf(fmaxf(q, 0.0f), 1.0f);
                    const Terms tm = light_terms(L, kSpotAmb, kSpotDif, kSpotSpec, f.d, f.s,
                                                 diffuse, specular, lit);
                    const V3 ds = add(tm.diff, tm.spec);
                    const float g_att = dot(Gr, add(tm.amb, scale(ds, intensity)));
                    const V3 gI = scale(Gr, att);
                    const float g_int = dot(gI, ds);
                    float g_d = 0.0f, g_s = 0.0f;
                    terms_bwd(L, acc, kSpotAmb, kSpotDif, kSpotSpec, gI, scale(gI, intensity),
                              f.d, f.s, diffuse, specular, lit, g_diffuse, g_specular, g_d, g_s);
                    const float g_q = g_int * dclip(q, 0.0f, 1.0f);
                    const float g_theta = g_q / cone;
                    const float g_cone = -g_q * (theta - cgam) / (cone * cone);
                    const float g_craw = g_cone * dmax(cone_raw, 1e-6f);
                    acc[kSpotCosPhi] += g_craw;
                    acc[kSpotCosGamma] -= g_theta + g_craw;
                    add3(acc, kSpotDir, neg(normalize_bwd(scale(f.l, g_theta), sd_raw)));
                    const V3 gdv = length_bwd(att_bwd(L, acc, kSpotKc, g_att, att, dist), dvec,
                                              dist);
                    g_p = add(g_p, gdv);
                    add3(acc, kSpotPos, neg(gdv));
                    const V3 g_lraw = blinn_bwd(f, n, v, shin, g_d, g_s, scale(sdn, g_theta),
                                                g_v, g_shin);
                    add3(acc, kSpotPos, g_lraw);
                    g_p = sub(g_p, g_lraw);
                }
                // ---- the depth: inverse_depth(|p - eye|) ----------------------------
                if (a.g_depth != nullptr) {
                    const V3 pe = sub(p, eye);
                    const float dist = length(pe);
                    const float dm = fmaxf(dist, 1e-6f);
                    const float span = 1.0f / 8192.0f - 8.0f;      // 1/FAR - 1/NEAR
                    const float g_dm = -(a.g_depth[r] / span) / (dm * dm);
                    const V3 gpe = length_bwd(g_dm * dmax(dist, 1e-6f), pe, dist);
                    g_p = add(g_p, gpe);
                    add3(acc, kEye, neg(gpe));
                }
                // ---- the view vector, the texel, the row ----------------------------
                const V3 g_vraw = normalize_bwd(g_v, v_raw);
                add3(acc, kEye, g_vraw);
                g_p = sub(g_p, g_vraw);
                V3 g_dif0 = g_diffuse, g_spec0 = g_specular;
                if (lin >= 0) {
                    g_dif0 = mul(g_diffuse, texg);
                    g_spec0 = mul(g_specular, texg);
                    const V3 g_tex = add(mul(g_diffuse, dif0), mul(g_specular, spec0));
                    const float gm1 = a.gamma - 1.0f;
                    tg[0] = g_tex.x * (a.gamma * powf(fmaxf(raw.x, 1e-6f), gm1)) *
                            dmax(raw.x, 1e-6f);
                    tg[1] = g_tex.y * (a.gamma * powf(fmaxf(raw.y, 1e-6f), gm1)) *
                            dmax(raw.y, 1e-6f);
                    tg[2] = g_tex.z * (a.gamma * powf(fmaxf(raw.z, 1e-6f), gm1)) *
                            dmax(raw.z, 1e-6f);
                    tex_key = lin;
                }
                row_key = mi;
                rg[0] = g_dif0.x; rg[1] = g_dif0.y; rg[2] = g_dif0.z;
                rg[3] = g_spec0.x; rg[4] = g_spec0.y; rg[5] = g_spec0.z;
                rg[6] = g_shin;
            } else if constexpr (kTex) {
                // ---- a miss: the sky map's bilinear taps ---------------------------
                if (a.envmap != nullptr) {
                    const SkyCoords c = sky_coords(b, a.env_h, a.env_w);
                    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
                    env_key[0] = c.i00; env_key[1] = c.i01;
                    env_key[2] = c.i10; env_key[3] = c.i11;
                    env_w[0] = gx * gy; env_w[1] = c.fx * gy;
                    env_w[2] = gx * c.fy; env_w[3] = c.fx * c.fy;
                    if (a.g_d != nullptr) {
                        const V3 c00 = ld3(a.envmap + 3 * c.i00);
                        const V3 c01 = ld3(a.envmap + 3 * c.i01);
                        const V3 c10 = ld3(a.envmap + 3 * c.i10);
                        const V3 c11 = ld3(a.envmap + 3 * c.i11);
                        const float g_fx = dot(Gr, add(scale(sub(c01, c00), gy),
                                                       scale(sub(c11, c10), c.fy)));
                        const float g_fy = dot(Gr, add(scale(sub(c10, c00), gx),
                                                       scale(sub(c11, c01), c.fx)));
                        const float g_u = g_fx * (float)a.env_w / (2.0f * kPi);
                        const float g_vv = g_fy * (float)a.env_h / kPi;
                        V3 g_nd = {0.0f, 0.0f, 0.0f};
                        const float den = c.nd.x * c.nd.x + c.nd.z * c.nd.z;
                        if (den > 0.0f) {
                            g_nd.x = -g_u * c.nd.z / den;
                            g_nd.z = g_u * c.nd.x / den;
                        }
                        const float s2 = 1.0f - c.cy * c.cy;
                        if (s2 > 0.0f) g_nd.y = -g_vv / sqrtf(s2) * dclip(c.nd.y, -1.0f, 1.0f);
                        g_b = normalize_bwd(g_nd, b);
                    }
                }
            }
            if (a.g_o != nullptr) {
                a.g_o[3 * r] = g_p.x;
                a.g_o[3 * r + 1] = g_p.y;
                a.g_o[3 * r + 2] = g_p.z;
            }
            if (a.g_d != nullptr) {
                const float s = t_hit - kEps;
                a.g_d[3 * r] = g_p.x * s + g_b.x;
                a.g_d[3 * r + 1] = g_p.y * s + g_b.y;
                a.g_d[3 * r + 2] = g_p.z * s + g_b.z;
            }
        }

        // ---- the warp's sums (every lane) ------------------------------------------
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
            const float s = warp_sum(acc[i]);
            if (lane == 0) wacc[warp * kAcc + i] += s;
        }
        if (a.rows_in_smem) {
            warp_scatter<kRowGrad>(row_key, rg, [&](long long k, int j, float s) {
                atomicAdd(rows + k * kRowGrad + j, s);
            });
        } else {
            warp_scatter<kRowGrad>(row_key, rg, [&](long long k, int j, float s) {
                float* dst = j < 3 ? a.g_diffuse + 3 * k + j
                                   : (j < 6 ? a.g_specular + 3 * k + j - 3 : a.g_shininess + k);
                atomicAdd(dst, s);
            });
        }
        if constexpr (kTex) {
            if (a.g_atlas != nullptr) {
                warp_scatter<3>(tex_key, tg, [&](long long k, int j, float s) {
                    atomicAdd(a.g_atlas + 3 * k + j, s);
                });
            }
            if (a.g_env != nullptr) {
                const float G[3] = {Gr.x, Gr.y, Gr.z};
#pragma unroll
                for (int tap = 0; tap < 4; ++tap) {
                    const float v[3] = {G[0] * env_w[tap], G[1] * env_w[tap], G[2] * env_w[tap]};
                    warp_scatter<3>(env_key[tap], v, [&](long long k, int j, float s) {
                        atomicAdd(a.g_env + 3 * k + j, s);
                    });
                }
            }
        }
    }

    // ---- the block's sums: 53 atomics, and the staged rows ---------------------------
    __syncthreads();
    for (int i = threadIdx.x; i < kAcc; i += blockDim.x) {
        float s = 0.0f;
        for (int w = 0; w < kBwdWarps; ++w) s += wacc[w * kAcc + i];
        if (s != 0.0f) atomicAdd(i < kEye ? a.g_rig + i : a.g_eye + i - kEye, s);
    }
    if (a.rows_in_smem) {
        for (int i = threadIdx.x; i < M * kRowGrad; i += blockDim.x) {
            const float s = rows[i];
            if (s == 0.0f) continue;
            const int k = i / kRowGrad, j = i % kRowGrad;
            float* dst = j < 3 ? a.g_diffuse + 3 * k + j
                               : (j < 6 ? a.g_specular + 3 * k + j - 3 : a.g_shininess + k);
            atomicAdd(dst, s);
        }
    }
}

template <bool kMap, bool kTex>
cudaError_t launch_bwd(const ShadeBwdArgs& a, size_t smem, cudaStream_t st) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, shade_bwd_kernel<kMap, kTex>, kBwdThreads, smem);
    }
    if (err != cudaSuccess) return err;
    const int64_t want = (a.n + kBwdThreads - 1) / kBwdThreads;
    const unsigned blocks =
        (unsigned)std::max<int64_t>(1, std::min<int64_t>(want, (int64_t)sms * std::max(per_sm, 1)));
    shade_bwd_kernel<kMap, kTex><<<blocks, kBwdThreads, smem, st>>>(a);
    return cudaSuccess;
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  The inputs
// are K2's (csrc/shade.cu ort_shade), with the eye, the rig (50 floats) and
// the table's columns on the card, and the upstream cotangents `g_rgb`
// [n, 3] and `g_depth` [n] (either may be null: zero).  `g_rig`, `g_eye`,
// `g_diffuse`, `g_specular`, `g_shininess` and, when given, `g_atlas` and
// `g_env` are added to (the caller zeroes them); `g_o` and `g_d`, when
// given, are written for every ray.
int ort_shade_bwd(const void* hit, const void* t, const void* material,
                  const void* cell_bmin, const void* cell_size, const void* o,
                  const void* dirs, const void* eye, const void* shadow,
                  const void* shadow_depth, int map_h, int map_w, const void* map_vp,
                  float map_bias, const void* rig, int num_materials,
                  const void* mat_diffuse, const void* mat_specular, const void* mat_shininess,
                  const void* atlas, int atlas_materials, int atlas_res,
                  const void* envmap, int env_h, int env_w, float gamma, int64_t n,
                  const void* g_rgb, const void* g_depth, void* g_rig, void* g_eye,
                  void* g_diffuse, void* g_specular, void* g_shininess, void* g_atlas,
                  void* g_env, void* g_o, void* g_d, void* stream) {
    if (num_materials < 1 || rig == nullptr || eye == nullptr || mat_diffuse == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    ort::ShadeBwdArgs a = {};
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.material = static_cast<const int32_t*>(material);
    a.cell_bmin = static_cast<const float*>(cell_bmin);
    a.cell_size = static_cast<const float*>(cell_size);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.eye = static_cast<const float*>(eye);
    a.shadow = static_cast<const float*>(shadow);
    if (shadow_depth != nullptr) {
        a.map = ort::shadow_map(shadow_depth, map_h, map_w, map_vp, map_bias);
    }
    a.rig = static_cast<const float*>(rig);
    a.mat_diffuse = static_cast<const float*>(mat_diffuse);
    a.mat_specular = static_cast<const float*>(mat_specular);
    a.mat_shininess = static_cast<const float*>(mat_shininess);
    a.num_materials = num_materials;
    a.atlas = static_cast<const float*>(atlas);
    a.atlas_materials = atlas_materials;
    a.atlas_res = atlas_res;
    a.envmap = static_cast<const float*>(envmap);
    a.env_h = env_h;
    a.env_w = env_w;
    a.gamma = gamma;
    a.n = n;
    a.g_rgb = static_cast<const float*>(g_rgb);
    a.g_depth = static_cast<const float*>(g_depth);
    a.g_rig = static_cast<float*>(g_rig);
    a.g_eye = static_cast<float*>(g_eye);
    a.g_diffuse = static_cast<float*>(g_diffuse);
    a.g_specular = static_cast<float*>(g_specular);
    a.g_shininess = static_cast<float*>(g_shininess);
    a.g_atlas = static_cast<float*>(g_atlas);
    a.g_env = static_cast<float*>(g_env);
    a.g_o = static_cast<float*>(g_o);
    a.g_d = static_cast<float*>(g_d);
    const size_t base = ort::kBwdWarps * ort::kAcc * sizeof(float);
    const size_t rows = (size_t)num_materials * ort::kRowGrad * sizeof(float);
    a.rows_in_smem = base + rows <= 48 * 1024;
    const size_t smem = base + (a.rows_in_smem ? rows : 0);
    if (n > 0) {
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const bool map = shadow_depth != nullptr;
        const bool tex = atlas != nullptr || envmap != nullptr;
        cudaError_t err;
        if (map && tex) {
            err = ort::launch_bwd<true, true>(a, smem, st);
        } else if (map) {
            err = ort::launch_bwd<true, false>(a, smem, st);
        } else if (tex) {
            err = ort::launch_bwd<false, true>(a, smem, st);
        } else {
            err = ort::launch_bwd<false, false>(a, smem, st);
        }
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
