// K2: per-ray shading of a march result, one thread per ray.
//
// Replaces the JAX package's shading program (B6):
// octree_raymarcher_tpu/shade/render.py `shade_hits` with
// shade/lights.py `LightRig.shade` (shade_point_light,
// shade_directional_light, shade_spotlight), shade/materials.py
// `MaterialTable.lookup` (a one-hot matmul there, a row of a shared-memory
// table here), the atlas nearest sample of render.py:87-105, shade/envmap.py
// `sample_env` (bilinear equirect sky) and core/geometry.py
// `cube_normal`/`cube_uv`/`inverse_depth`.
//
// What bounds it on an H100: issued instructions, not bytes.  A ray moves
// 41-49 bytes in and 40 out (179 MB at 1080p, 0.053 ms at the HBM rate),
// but a lit hit runs about a thousand instructions: every IEEE divide and
// sqrtf is a short sequence around one MUFU op, each powf a few dozen
// (three for the lights' Blinn terms, three for the atlas texel's gamma),
// and a sky sample an atan2f, an acosf and four taps.  Measured on one
// H100 (700 W) with a kernel that lit every ray as the reference does,
// then replaced a miss's rgb with the sky: dropping a quarter of its bytes
// (the point and normal stores, 24 of 89 a ray) saved 2-3% of its time,
// while dropping the misses' lighting saved 12-17% and the gamma decode 14%
// of the textured time (PERF.md, the K2 split).  So the design cuts
// instructions:
//
// * Each ray runs the branch its result takes.  The hit point and normal
//   are computed for every ray (they are AOVs for misses too); then a hit
//   runs the material, texel, shadow, the three lights and its depth, a
//   miss only its sky.  In the bench frame's 128-pixel block order 98.8% of
//   warps are all-hit or all-miss, so a sky warp runs no lighting and a lit
//   warp no sky; a mixed warp runs both branches.  The rgb a miss returns
//   is the value it always returned (its lighting was thrown away), and a
//   miss reads neither its t nor its material.
// * The atlas is gamma-decoded once per texel channel in a launch, not once
//   per hit: the first blocks decode it into scratch memory and count
//   themselves done, and a hit reads the decoded texel once they all are.
//   A hit of the first wave that finds the count short decodes its own
//   texel; both are the same powf of the same value, so the result does
//   not depend on which.  No decoded atlas outlives the launch.
// * Warp-uniform tables travel by value: the 50-float light rig, the sky
//   and a host eye sit in the kernel's parameter block and are read as
//   constant-bank operands, not as some 40 loads a lit ray, and the host
//   uploads nothing a call.  The material table, indexed per lane, is read
//   once per block into shared memory: from the parameter block when the
//   caller's table is on the host, from the card's columns when it is
//   there (never read back).
// * The sky's wrap takes one integer modulo for its two columns, not one a
//   tap (a modulo by a runtime width is a few dozen instructions).
//
// The map-shadowed frame (shadow="map") runs the map instantiations
// (kMap): they take the light depth map, its view-projection and bias by
// value and compute the map-shadow factor of render.py:428-439 in the hit
// branch from the point they shade (shadow.cuh map_shadowed, the
// arithmetic of K3's map_project).  No factor array is written or read.
// kTex instantiations carry the atlas and sky-map code, which the
// untextured frames do not compile in.
//
// The wide instantiations (kWide) take what the parameter block cannot: a
// rig on the card (a rig of card tensors, and the differentiable path of
// shade/render.py, pass its 50 floats by pointer, never read back) and a
// table of any number of rows (the reference's lookup takes any M; twig
// material ids are 16-bit).  Each block copies the rig into shared memory.
// A table of at most kMaxMaterials rows is staged in shared memory as the
// narrow instantiations stage it; a larger one is read per hit from the
// card's columns through __ldg (the read-only cache holds the rows the
// block's hits share; staging a large table would cost every block its
// copy).  Ids clip to M - 1 as lookup does.  The narrow instantiations (a
// host rig, at most kMaxMaterials rows) are unchanged by them.
//
// Arithmetic follows shade_hits_plain (shade/render.py) operation for
// operation; with -fmad=false only the libm functions (powf, atan2f, acosf,
// sqrtf is exact) may differ from PyTorch's by an ulp, and powf with the
// grass shininess of 1000 magnifies that to ~1e-4 relative.  The map-shadow
// factor has no libm call and equals map_project's bit for bit.

#include <algorithm>

#include "shade.cuh"
#include "shadow.cuh"

namespace ort {
namespace {

constexpr int kThreads = 128;
// Blocks that decode the atlas: at most one per SM, so all run in the
// launch's first wave.
constexpr int64_t kMaxDecoders = 128;

struct ShadeArgs {
    const uint8_t* hit;
    const float* t;
    const int32_t* material;
    const float* cell_bmin;
    const float* cell_size;
    const float* o;
    const float* dirs;
    const float* eye;         // nullable: the eye on the card, else eye_v
    V3 eye_v;
    const float* shadow;      // nullable: shadow factor per ray
    ShadowMap map;            // kMap: the light depth map
    float lights[kLightFloats];
    // The material table: rows by value when the columns are null, else
    // the card's columns diffuse [M, 3], specular [M, 3], shininess [M].
    float rows[kMaxMaterials * kMatStride];
    const float* mat_diffuse;
    const float* mat_specular;
    const float* mat_shininess;
    int num_materials;
    const float* atlas;       // nullable: [Ma, R, R, 3]
    int atlas_materials, atlas_res;
    // With an atlas: its texels gamma-decoded, [Ma * R * R * 3], written by
    // the first `decoders` blocks, and the count of those blocks done.
    float* decoded;
    int* decoded_done;
    int decoders;
    const float* envmap;      // nullable: [H, W, 3]
    int env_h, env_w;
    V3 sky;
    float gamma;
    int64_t n;
    float* out_rgb;
    float* out_depth;
    float* out_point;
    float* out_normal;
    // kWide: the rig on the card (else `lights`).
    const float* rig;
};

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// The gamma decode of one texel channel (render.py:100; shade.cuh
// decode_gamma, with the gamma read from the parameter block).
__device__ __forceinline__ float decode(const ShadeArgs& a, float c) {
    return powf(fmaxf(c, 1e-6f), a.gamma);
}

// The first `decoders` blocks decode the whole atlas, each a strided share,
// before their rays; then each counts itself done (a release).
__device__ __forceinline__ void decode_atlas(const ShadeArgs& a) {
    const int64_t total = (int64_t)a.atlas_materials * a.atlas_res * a.atlas_res * 3;
    const int64_t stride = (int64_t)a.decoders * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        a.decoded[i] = decode(a, __ldg(a.atlas + i));
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(a.decoded_done, 1);
}

// geometry.cube_uv + the nearest atlas texel, gamma-decoded
// (render.py:87-105); `m` is the ray's material id.  This and sky_sample
// keep their own copy of the texel and tap addresses (shade.cuh atlas_lin,
// sky_coords compute the same for K8), so that the narrow instantiations
// compile to the code they had before K8 and the wide ones existed,
// instruction for instruction.  The decoded atlas is
// read once every decoder block is done (an acquire); until then (the
// first wave of blocks) the ray decodes its texel itself.  Both give the
// same powf of the same texel.
__device__ __forceinline__ V3 atlas_texel(const ShadeArgs& a, V3 p, V3 cmin, V3 cmax, int m) {
    const bool decoded = load_acquire(a.decoded_done) == a.decoders;
    const float size = cmax.x - cmin.x;
    float u = 0.0f, v = 0.0f;
    if (fabsf(p.x - cmin.x) <= kEps) { u = p.y - cmin.y; v = p.z - cmin.z; }
    if (fabsf(p.x - cmax.x) <= kEps) { u = p.y - cmax.y; v = p.z - cmax.z; }
    if (fabsf(p.y - cmin.y) <= kEps) { u = p.x - cmin.x; v = p.z - cmin.z; }
    if (fabsf(p.y - cmax.y) <= kEps) { u = p.x - cmax.x; v = p.z - cmax.z; }
    if (fabsf(p.z - cmin.z) <= kEps) { u = p.x - cmin.x; v = p.y - cmin.y; }
    if (fabsf(p.z - cmax.z) <= kEps) { u = p.x - cmax.x; v = p.y - cmax.y; }
    const float den = fmaxf(size, 1e-30f);
    u = fabsf(u) / den;
    v = fabsf(v) / den;
    const int R = a.atlas_res;
    const float rf = (float)R;
    const int ui = trunc_clip(u * rf, 0.0f, (float)(R - 1));
    const int vi = trunc_clip(v * rf, 0.0f, (float)(R - 1));
    const int mi = clampi(m, 0, a.atlas_materials - 1);
    const int64_t lin = ((int64_t)mi * R + vi) * R + ui;
    if (decoded) {
        const float* d = a.decoded + 3 * lin;
        return {d[0], d[1], d[2]};
    }
    const V3 tex = ld3(a.atlas + 3 * lin);
    return {decode(a, tex.x), decode(a, tex.y), decode(a, tex.z)};
}

// envmap.sample_env (bilinear) in direction b: u wrapped, v clamped.  The
// second column is the first's wrap plus one, which equals imod(x0 + 1, W).
__device__ __forceinline__ V3 sky_sample(const ShadeArgs& a, V3 b) {
    const V3 nd = normalize(b);
    const float pi = 3.14159265358979323846f;
    const float u = atan2f(nd.z, nd.x) / (float)(2.0 * 3.14159265358979323846) + 0.5f;
    const float vv = acosf(fminf(fmaxf(nd.y, -1.0f), 1.0f)) / pi;
    const int H = a.env_h, W = a.env_w;
    const float x = u * (float)W - 0.5f;
    const float y = vv * (float)H - 0.5f;
    const float fx0 = floorf(x), fy0 = floorf(y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    const float fx = x - (float)x0, fy = y - (float)y0;
    const int xa = imod(x0, W);
    const int xb = xa + 1 == W ? 0 : xa + 1;
    const int64_t ra = (int64_t)clampi(y0, 0, H - 1) * W;
    const int64_t rb = (int64_t)clampi(y0 + 1, 0, H - 1) * W;
    const V3 c00 = ld3(a.envmap + 3 * (ra + xa));
    const V3 c01 = ld3(a.envmap + 3 * (ra + xb));
    const V3 c10 = ld3(a.envmap + 3 * (rb + xa));
    const V3 c11 = ld3(a.envmap + 3 * (rb + xb));
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    return add(add(add(scale(scale(c00, gx), gy), scale(scale(c01, fx), gy)),
                   scale(scale(c10, gx), fy)),
               scale(scale(c11, fx), fy));
}

// The three lights of LightRig.shade at hit point p (lights.py).
__device__ __forceinline__ V3 shade_lights(const float* L, V3 n, V3 p, V3 eye, V3 diffuse,
                                           V3 specular, float shin, float lit) {
    const V3 v = normalize(sub(eye, p));
    // ---- lights.shade_point_light -----------------------------------------
    V3 c;
    {
        const V3 lpos = v3(L + kPointPos);
        const V3 l = normalize(sub(lpos, p));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const float dist = length(sub(p, lpos));
        const float att = 1.0f / (L[kPointKc] + L[kPointKl] * dist +
                                  L[kPointKq] * dist * dist);
        const Terms tm = light_terms(L, kPointAmb, kPointDif, kPointSpec, d, s,
                                     diffuse, specular, lit);
        c = scale(add(add(tm.amb, tm.diff), tm.spec), att);
    }
    // ---- lights.shade_directional_light -------------------------------------
    {
        const V3 l = normalize(neg(v3(L + kDirDir)));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const Terms tm = light_terms(L, kDirAmb, kDirDif, kDirSpec, d, s,
                                     diffuse, specular, lit);
        c = add(c, add(add(tm.amb, tm.diff), tm.spec));
    }
    // ---- lights.shade_spotlight ---------------------------------------------
    {
        const V3 lpos = v3(L + kSpotPos);
        const V3 l = normalize(sub(lpos, p));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const float dist = length(sub(p, lpos));
        const float att = 1.0f / (L[kSpotKc] + L[kSpotKl] * dist +
                                  L[kSpotKq] * dist * dist);
        const float theta = dot(l, normalize(neg(v3(L + kSpotDir))));
        const float cphi = L[kSpotCosPhi], cgam = L[kSpotCosGamma];
        const float intensity =
            fminf(fmaxf((theta - cgam) / fmaxf(cphi - cgam, 1e-6f), 0.0f), 1.0f);
        const Terms tm = light_terms(L, kSpotAmb, kSpotDif, kSpotSpec, d, s,
                                     diffuse, specular, lit);
        c = add(c, scale(add(tm.amb, scale(add(tm.diff, tm.spec), intensity)), att));
    }
    return c;
}

// A row of the card's columns (the wide instantiations).
__device__ __forceinline__ MatRow global_row(const ShadeArgs& a, int m) {
    const V3 dif = ld3(a.mat_diffuse + 3 * m);
    const V3 spec = ld3(a.mat_specular + 3 * m);
    return {make_float4(dif.x, dif.y, dif.z, __ldg(a.mat_shininess + m)),
            make_float4(spec.x, spec.y, spec.z, 0.0f)};
}

// kWide: the rig comes from the card (or the block) into shared memory and
// the table has any number of rows: staged in shared memory up to
// kMaxMaterials, else read per hit from the card's columns.  The narrow
// instantiations (a host rig, at most kMaxMaterials rows) are unchanged.
template <bool kMap, bool kTex, bool kWide>
__global__ void __launch_bounds__(kThreads) shade_kernel(const __grid_constant__ ShadeArgs a) {
    // ---- the decoded atlas (first blocks), the material table (every block) ---
    if constexpr (kTex) {
        if (a.atlas != nullptr && (int)blockIdx.x < a.decoders) decode_atlas(a);
    }
    MatRow* table;
    const float* L;
    if constexpr (kWide) {
        __shared__ float rig[kLightFloats];
        __shared__ MatRow staged[kMaxMaterials];
        table = staged;
        for (int i = threadIdx.x; i < kLightFloats; i += blockDim.x) {
            rig[i] = a.rig != nullptr ? __ldg(a.rig + i) : a.lights[i];
        }
        const int m = threadIdx.x;
        if (a.num_materials <= kMaxMaterials && m < a.num_materials) {
            if (a.mat_diffuse != nullptr) {
                table[m] = global_row(a, m);
            } else {
                const float* row = a.rows + m * kMatStride;
                table[m] = {make_float4(row[kMatDif], row[kMatDif + 1], row[kMatDif + 2],
                                        row[kMatShin]),
                            make_float4(row[kMatSpec], row[kMatSpec + 1], row[kMatSpec + 2],
                                        0.0f)};
            }
        }
        L = rig;
    } else {
        __shared__ MatRow narrow[kMaxMaterials];
        table = narrow;
        L = a.lights;
        const int m = threadIdx.x;
        if (m < a.num_materials) {
            V3 dif, spec;
            float shin;
            if (a.mat_diffuse != nullptr) {
                dif = ld3(a.mat_diffuse + 3 * m);
                spec = ld3(a.mat_specular + 3 * m);
                shin = __ldg(a.mat_shininess + m);
            } else {
                dif = v3(a.rows + m * kMatStride + kMatDif);
                spec = v3(a.rows + m * kMatStride + kMatSpec);
                shin = a.rows[m * kMatStride + kMatShin];
            }
            table[m] = {make_float4(dif.x, dif.y, dif.z, shin),
                        make_float4(spec.x, spec.y, spec.z, 0.0f)};
        }
    }
    __syncthreads();

    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;

    // ---- every ray: hit point, geometry.cube_normal -----------------------------
    const bool hit = a.hit[r] != 0;
    const V3 o = ld3(a.o + 3 * r);
    const V3 b = ld3(a.dirs + 3 * r);
    const V3 cmin = ld3(a.cell_bmin + 3 * r);
    const float csz = a.cell_size[r];
    const float t_hit = hit ? a.t[r] : 0.0f;
    const V3 p = add(o, scale(b, t_hit - kEps));
    const V3 cmax = {cmin.x + csz, cmin.y + csz, cmin.z + csz};
    const V3 n = cube_normal(p, cmin, cmax);

    V3 rgb;
    float depth = 1.0f;
    if (hit) {
        // ---- materials.lookup, the atlas texel, the shadow, the lights ------------
        const int mat = a.material[r];
        const int mi = clampi(mat, 0, a.num_materials - 1);
        MatRow row;
        if constexpr (kWide) {
            row = a.num_materials <= kMaxMaterials ? table[mi] : global_row(a, mi);
        } else {
            row = table[mi];
        }
        V3 diffuse = {row.dif_shin.x, row.dif_shin.y, row.dif_shin.z};
        V3 specular = {row.spec.x, row.spec.y, row.spec.z};
        if constexpr (kTex) {
            if (a.atlas != nullptr) {
                const V3 texg = atlas_texel(a, p, cmin, cmax, mat);
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
        const V3 eye = a.eye != nullptr ? ld3(a.eye) : a.eye_v;
        rgb = shade_lights(L, n, p, eye, diffuse, specular, row.dif_shin.w, 1.0f - shadow);
        // ---- geometry.inverse_depth -------------------------------------------
        const float dist = length(sub(p, eye));
        const float inv_near = 8.0f;                       // 1 / NEAR
        const float span = 1.0f / 8192.0f - 8.0f;          // 1/FAR - 1/NEAR, exact
        depth = (1.0f / fmaxf(dist, 1e-6f) - inv_near) / span;
    } else {
        // ---- the sky ------------------------------------------------------------------
        rgb = a.sky;
        if constexpr (kTex) {
            if (a.envmap != nullptr) rgb = sky_sample(a, b);
        }
    }

    a.out_rgb[3 * r] = rgb.x;
    a.out_rgb[3 * r + 1] = rgb.y;
    a.out_rgb[3 * r + 2] = rgb.z;
    a.out_depth[r] = depth;
    a.out_point[3 * r] = p.x;
    a.out_point[3 * r + 1] = p.y;
    a.out_point[3 * r + 2] = p.z;
    a.out_normal[3 * r] = n.x;
    a.out_normal[3 * r + 1] = n.y;
    a.out_normal[3 * r + 2] = n.z;
}

template <bool kMap, bool kTex, bool kWide = false>
void launch(const ShadeArgs& a, cudaStream_t st) {
    const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
    shade_kernel<kMap, kTex, kWide><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  `block` is
// the host block of shade/render.py shade_tables: eye 3, sky 3, the rig's
// 50 floats, then `num_materials` rows of 10 floats unless the table's
// columns are on the card (`mat_diffuse`, `mat_specular`, `mat_shininess`).
// `eye` on the card overrides the block's eye, and `rig` (50 floats on the
// card) the block's rig.  With `shadow_depth` (an [map_h, map_w] light depth
// map, its row-major 4x4 `map_vp` on the host and `map_bias`) the
// map-shadowed instantiations run and `shadow` must be null; with an atlas
// or a sky map the textured ones.  A rig on the card or a table of more
// than kMaxMaterials rows (which must be on the card) takes the wide
// instantiations.  Returns cudaErrorInvalidValue for an empty table or a
// host table of more than kMaxMaterials rows.
int ort_shade(const void* hit, const void* t, const void* material,
              const void* cell_bmin, const void* cell_size, const void* o,
              const void* dirs, const void* eye, const void* shadow,
              const void* shadow_depth, int map_h, int map_w, const void* map_vp,
              float map_bias, const void* block, int num_materials,
              const void* mat_diffuse, const void* mat_specular, const void* mat_shininess,
              const void* atlas, int atlas_materials, int atlas_res, void* decoded,
              const void* envmap, int env_h, int env_w, float gamma, int64_t n,
              void* out_rgb, void* out_depth, void* out_point, void* out_normal,
              const void* rig, void* stream) {
    if (num_materials < 1 ||
        (num_materials > ort::kMaxMaterials && mat_diffuse == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const float* host = static_cast<const float*>(block);
    ort::ShadeArgs a = {};
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.material = static_cast<const int32_t*>(material);
    a.cell_bmin = static_cast<const float*>(cell_bmin);
    a.cell_size = static_cast<const float*>(cell_size);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.eye = static_cast<const float*>(eye);
    a.eye_v = {host[ort::kBlockEye], host[ort::kBlockEye + 1], host[ort::kBlockEye + 2]};
    a.shadow = static_cast<const float*>(shadow);
    if (shadow_depth != nullptr) {
        a.map = ort::shadow_map(shadow_depth, map_h, map_w, map_vp, map_bias);
    }
    for (int i = 0; i < ort::kLightFloats; ++i) a.lights[i] = host[ort::kBlockLights + i];
    a.mat_diffuse = static_cast<const float*>(mat_diffuse);
    a.mat_specular = static_cast<const float*>(mat_specular);
    a.mat_shininess = static_cast<const float*>(mat_shininess);
    if (mat_diffuse == nullptr) {
        for (int i = 0; i < num_materials * ort::kMatStride; ++i) {
            a.rows[i] = host[ort::kBlockRows + i];
        }
    }
    a.num_materials = num_materials;
    a.atlas = static_cast<const float*>(atlas);
    a.atlas_materials = atlas_materials;
    a.atlas_res = atlas_res;
    const int64_t blocks = (n + ort::kThreads - 1) / ort::kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (atlas != nullptr && n > 0) {
        const int64_t total = (int64_t)atlas_materials * atlas_res * atlas_res * 3;
        a.decoded = static_cast<float*>(decoded);
        a.decoded_done = reinterpret_cast<int*>(a.decoded + total);
        a.decoders = (int)std::min<int64_t>(
            {ort::kMaxDecoders, blocks, (total + ort::kThreads - 1) / ort::kThreads});
        const cudaError_t err = cudaMemsetAsync(a.decoded_done, 0, sizeof(int), st);
        if (err != cudaSuccess) return (int)err;
    }
    a.envmap = static_cast<const float*>(envmap);
    a.env_h = env_h; a.env_w = env_w;
    a.sky = {host[ort::kBlockSky], host[ort::kBlockSky + 1], host[ort::kBlockSky + 2]};
    a.gamma = gamma;
    a.n = n;
    a.out_rgb = static_cast<float*>(out_rgb);
    a.out_depth = static_cast<float*>(out_depth);
    a.out_point = static_cast<float*>(out_point);
    a.out_normal = static_cast<float*>(out_normal);
    a.rig = static_cast<const float*>(rig);
    if (n > 0) {
        const bool map = shadow_depth != nullptr;
        const bool tex = atlas != nullptr || envmap != nullptr;
        if (rig != nullptr || num_materials > ort::kMaxMaterials) {
            if (map && tex) {
                ort::launch<true, true, true>(a, st);
            } else if (map) {
                ort::launch<true, false, true>(a, st);
            } else if (tex) {
                ort::launch<false, true, true>(a, st);
            } else {
                ort::launch<false, false, true>(a, st);
            }
        } else if (map && tex) {
            ort::launch<true, true>(a, st);
        } else if (map) {
            ort::launch<true, false>(a, st);
        } else if (tex) {
            ort::launch<false, true>(a, st);
        } else {
            ort::launch<false, false>(a, st);
        }
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
