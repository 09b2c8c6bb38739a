// K2: per-ray shading of a march result, one thread per ray.
//
// Replaces the JAX package's shading program (B6):
// octree_raymarcher_tpu/shade/render.py `shade_hits` with
// shade/lights.py `LightRig.shade` (shade_point_light,
// shade_directional_light, shade_spotlight), shade/materials.py
// `MaterialTable.lookup` (a one-hot matmul there, a plain row read here),
// the atlas nearest sample of render.py:87-105, shade/envmap.py
// `sample_env` (bilinear equirect sky) and core/geometry.py
// `cube_normal`/`cube_uv`/`inverse_depth`.
//
// What bounds it on an H100: bytes.  A ray reads 49 bytes of march result
// and ray and writes 40 bytes of AOVs; the tables (materials, lights, atlas,
// sky map) are a few hundred KB that stay in L1/L2.  The arithmetic is a few
// hundred float operations and three powf per ray, well under the card's
// FP32 rate at 1080p.  So the design is one pass, every intermediate in
// registers: the JAX program's per-channel gathers and its [N,3]
// temporaries (hundreds of bytes per ray in the plain PyTorch version)
// become one read of each input and one write of each output.
//
// Arithmetic follows shade_hits_plain (shade/render.py) operation for
// operation; with -fmad=false only the libm functions (powf, atan2f, acosf,
// sqrtf is exact) may differ from PyTorch's by an ulp, and powf with the
// grass shininess of 1000 magnifies that to ~1e-4 relative.

#include "common.cuh"

namespace ort {
namespace {

// Flattened light rig (shade/lights.py LightRig.to_vector), 50 floats.
enum LightSlot {
    kPointPos = 0, kPointAmb = 3, kPointDif = 6, kPointSpec = 9,
    kPointKc = 12, kPointKl = 13, kPointKq = 14,
    kDirPos = 15, kDirDir = 18, kDirAmb = 21, kDirDif = 24, kDirSpec = 27,
    kSpotPos = 30, kSpotDir = 33, kSpotAmb = 36, kSpotDif = 39, kSpotSpec = 42,
    kSpotCosPhi = 45, kSpotCosGamma = 46, kSpotKc = 47, kSpotKl = 48, kSpotKq = 49,
};
// Material table row (shade/materials.py MaterialTable.to_matrix), 10 floats.
constexpr int kMatStride = 10, kMatDif = 3, kMatSpec = 6, kMatShin = 9;

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 ld3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 normalize(V3 a) {
    const float l = fmaxf(length(a), 1e-12f);
    return {a.x / l, a.y / l, a.z / l};
}

// lights._blinn_terms -> (diffuse factor, specular factor)
__device__ __forceinline__ void blinn(V3 n, V3 l, V3 v, float shin, float& d, float& s) {
    const V3 h = normalize(add(l, v));
    d = fmaxf(dot(n, l), 0.0f);
    s = powf(fmaxf(dot(v, h), 1e-6f), shin);
}

// The ambient, diffuse and specular terms of one light, before attenuation
// and cone intensity (lights.py: amb, diff, spec).
struct Terms { V3 amb, diff, spec; };

__device__ __forceinline__ Terms light_terms(const float* L, int amb, int dif, int spec,
                                             float d, float s, V3 diffuse, V3 specular,
                                             float lit) {
    return {mul(ld3(L + amb), diffuse),
            scale(mul(scale(ld3(L + dif), d), diffuse), lit),
            scale(mul(scale(ld3(L + spec), s), specular), lit)};
}

// envmap.sample_env (bilinear): one tap, u wrapped, v clamped.
__device__ __forceinline__ V3 env_tap(const float* env, int H, int W, int xi, int yi) {
    xi = imod(xi, W);
    yi = clampi(yi, 0, H - 1);
    return ld3(env + 3 * ((int64_t)yi * W + xi));
}

struct ShadeArgs {
    const uint8_t* hit;
    const float* t;
    const int32_t* material;
    const float* cell_bmin;
    const float* cell_size;
    const float* o;
    const float* dirs;
    const float* eye;
    const float* shadow;      // nullable: shadow factor per ray
    const float* materials;   // [M, 10]
    int num_materials;
    const float* lights;      // [50]
    const float* atlas;       // nullable: [Ma, R, R, 3]
    int atlas_materials, atlas_res;
    const float* envmap;      // nullable: [H, W, 3]
    int env_h, env_w;
    float sky_r, sky_g, sky_b;
    float gamma;
    int64_t n;
    float* out_rgb;
    float* out_depth;
    float* out_point;
    float* out_normal;
};

__global__ void __launch_bounds__(128) shade_kernel(const ShadeArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;

    const bool hit = a.hit[r] != 0;
    const V3 o = {a.o[3 * r], a.o[3 * r + 1], a.o[3 * r + 2]};
    const V3 b = {a.dirs[3 * r], a.dirs[3 * r + 1], a.dirs[3 * r + 2]};
    const float t_hit = hit ? a.t[r] : 0.0f;
    const V3 p = add(o, scale(b, t_hit - kEps));

    // ---- geometry.cube_normal -------------------------------------------
    const V3 cmin = {a.cell_bmin[3 * r], a.cell_bmin[3 * r + 1], a.cell_bmin[3 * r + 2]};
    const float csz = a.cell_size[r];
    const V3 cmax = {cmin.x + csz, cmin.y + csz, cmin.z + csz};
    const V3 center = scale(add(cmin, cmax), 0.5f);
    const V3 half = scale(sub(cmax, cmin), 0.5f);
    const V3 nr = {(p.x - center.x) / fmaxf(half.x, 1e-30f),
                   (p.y - center.y) / fmaxf(half.y, 1e-30f),
                   (p.z - center.z) / fmaxf(half.z, 1e-30f)};
    const float k = 1.0f + kEps;
    // float -> int32 saturates, as XLA's convert does.
    const V3 q = {truncf(fminf(fmaxf(nr.x * k, -2147483648.0f), 2147483648.0f)),
                  truncf(fminf(fmaxf(nr.y * k, -2147483648.0f), 2147483648.0f)),
                  truncf(fminf(fmaxf(nr.z * k, -2147483648.0f), 2147483648.0f))};
    const float qn = fmaxf(length(q), 1e-12f);
    const V3 n = {q.x / qn, q.y / qn, q.z / qn};

    // ---- materials.lookup (plain row read) --------------------------------
    const int m = clampi(a.material[r], 0, a.num_materials - 1);
    const float* row = a.materials + (int64_t)m * kMatStride;
    V3 diffuse = ld3(row + kMatDif);
    V3 specular = ld3(row + kMatSpec);
    const float shin = __ldg(row + kMatShin);

    if (a.atlas != nullptr) {
        // ---- geometry.cube_uv + nearest atlas texel ------------------------
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
        const int mi = clampi(a.material[r], 0, a.atlas_materials - 1);
        const int64_t lin = ((int64_t)mi * R + vi) * R + ui;
        const V3 tex = ld3(a.atlas + 3 * lin);
        const V3 texg = {powf(fmaxf(tex.x, 1e-6f), a.gamma),
                         powf(fmaxf(tex.y, 1e-6f), a.gamma),
                         powf(fmaxf(tex.z, 1e-6f), a.gamma)};
        diffuse = mul(diffuse, texg);
        specular = mul(specular, texg);
    }

    const float shadow = a.shadow != nullptr ? a.shadow[r] : 0.0f;
    const float lit = 1.0f - shadow;
    const V3 eye = ld3(a.eye);
    const float* L = a.lights;
    const V3 v = normalize(sub(eye, p));

    // ---- lights.shade_point_light -----------------------------------------
    V3 c;
    {
        const V3 lpos = ld3(L + kPointPos);
        const V3 l = normalize(sub(lpos, p));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const float dist = length(sub(p, lpos));
        const float att = 1.0f / (__ldg(L + kPointKc) + __ldg(L + kPointKl) * dist +
                                  __ldg(L + kPointKq) * dist * dist);
        const Terms tm = light_terms(L, kPointAmb, kPointDif, kPointSpec, d, s,
                                     diffuse, specular, lit);
        c = scale(add(add(tm.amb, tm.diff), tm.spec), att);
    }
    // ---- lights.shade_directional_light -------------------------------------
    {
        const V3 l = normalize(neg(ld3(L + kDirDir)));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const Terms tm = light_terms(L, kDirAmb, kDirDif, kDirSpec, d, s,
                                     diffuse, specular, lit);
        c = add(c, add(add(tm.amb, tm.diff), tm.spec));
    }
    // ---- lights.shade_spotlight ---------------------------------------------
    {
        const V3 lpos = ld3(L + kSpotPos);
        const V3 l = normalize(sub(lpos, p));
        float d, s;
        blinn(n, l, v, shin, d, s);
        const float dist = length(sub(p, lpos));
        const float att = 1.0f / (__ldg(L + kSpotKc) + __ldg(L + kSpotKl) * dist +
                                  __ldg(L + kSpotKq) * dist * dist);
        const float theta = dot(l, normalize(neg(ld3(L + kSpotDir))));
        const float cphi = __ldg(L + kSpotCosPhi), cgam = __ldg(L + kSpotCosGamma);
        const float intensity =
            fminf(fmaxf((theta - cgam) / fmaxf(cphi - cgam, 1e-6f), 0.0f), 1.0f);
        const Terms tm = light_terms(L, kSpotAmb, kSpotDif, kSpotSpec, d, s,
                                     diffuse, specular, lit);
        c = add(c, scale(add(tm.amb, scale(add(tm.diff, tm.spec), intensity)), att));
    }

    // ---- sky for misses ------------------------------------------------------
    V3 rgb = c;
    if (!hit) {
        if (a.envmap != nullptr) {
            const V3 nd = normalize(b);
            const float pi = 3.14159265358979323846f;
            const float u = atan2f(nd.z, nd.x) / (float)(2.0 * 3.14159265358979323846) + 0.5f;
            const float vv = acosf(fminf(fmaxf(nd.y, -1.0f), 1.0f)) / pi;
            const float x = u * (float)a.env_w - 0.5f;
            const float y = vv * (float)a.env_h - 0.5f;
            const float fx0 = floorf(x), fy0 = floorf(y);
            const int x0 = (int)fx0, y0 = (int)fy0;
            const float fx = x - (float)x0, fy = y - (float)y0;
            const V3 c00 = env_tap(a.envmap, a.env_h, a.env_w, x0, y0);
            const V3 c01 = env_tap(a.envmap, a.env_h, a.env_w, x0 + 1, y0);
            const V3 c10 = env_tap(a.envmap, a.env_h, a.env_w, x0, y0 + 1);
            const V3 c11 = env_tap(a.envmap, a.env_h, a.env_w, x0 + 1, y0 + 1);
            const float gx = 1.0f - fx, gy = 1.0f - fy;
            rgb = add(add(add(scale(scale(c00, gx), gy), scale(scale(c01, fx), gy)),
                          scale(scale(c10, gx), fy)),
                      scale(scale(c11, fx), fy));
        } else {
            rgb = {a.sky_r, a.sky_g, a.sky_b};
        }
    }

    // ---- geometry.inverse_depth -----------------------------------------------
    float depth = 1.0f;
    if (hit) {
        const float dist = length(sub(p, eye));
        const float inv_near = 8.0f;                       // 1 / NEAR
        const float span = 1.0f / 8192.0f - 8.0f;          // 1/FAR - 1/NEAR, exact
        depth = (1.0f / fmaxf(dist, 1e-6f) - inv_near) / span;
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

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ort_shade(const void* hit, const void* t, const void* material,
              const void* cell_bmin, const void* cell_size, const void* o,
              const void* dirs, const void* eye, const void* shadow,
              const void* materials, int num_materials, const void* lights,
              const void* atlas, int atlas_materials, int atlas_res,
              const void* envmap, int env_h, int env_w, float sky_r, float sky_g,
              float sky_b, float gamma, int64_t n, void* out_rgb, void* out_depth,
              void* out_point, void* out_normal, void* stream) {
    ort::ShadeArgs a;
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.material = static_cast<const int32_t*>(material);
    a.cell_bmin = static_cast<const float*>(cell_bmin);
    a.cell_size = static_cast<const float*>(cell_size);
    a.o = static_cast<const float*>(o);
    a.dirs = static_cast<const float*>(dirs);
    a.eye = static_cast<const float*>(eye);
    a.shadow = static_cast<const float*>(shadow);
    a.materials = static_cast<const float*>(materials);
    a.num_materials = num_materials;
    a.lights = static_cast<const float*>(lights);
    a.atlas = static_cast<const float*>(atlas);
    a.atlas_materials = atlas_materials;
    a.atlas_res = atlas_res;
    a.envmap = static_cast<const float*>(envmap);
    a.env_h = env_h; a.env_w = env_w;
    a.sky_r = sky_r; a.sky_g = sky_g; a.sky_b = sky_b;
    a.gamma = gamma;
    a.n = n;
    a.out_rgb = static_cast<float*>(out_rgb);
    a.out_depth = static_cast<float*>(out_depth);
    a.out_point = static_cast<float*>(out_point);
    a.out_normal = static_cast<float*>(out_normal);
    if (n > 0) {
        const int threads = 128;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ort::shade_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
