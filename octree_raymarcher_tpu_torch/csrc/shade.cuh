// The shading arithmetic that K2 (shade.cu) and its VJP K8 (shade_bwd.cu)
// share: the light rig's layout, the Blinn terms, the light terms and the
// material row; and, for K8, the atlas texel's address, its gamma decode
// and the sky map's bilinear taps, the operations of K2's atlas_texel,
// decode and sky_sample (which K2 keeps written out, so that its narrow
// instantiations keep their code).  K8 recomputes K2's forward from these,
// so both round every value the same way (-fmad=false) and the backward
// differentiates what the forward computed.
#pragma once

#include "common.cuh"

namespace ort {

// Flattened light rig (shade/lights.py LightRig.to_vector), 50 floats.
enum LightSlot {
    kPointPos = 0, kPointAmb = 3, kPointDif = 6, kPointSpec = 9,
    kPointKc = 12, kPointKl = 13, kPointKq = 14,
    kDirPos = 15, kDirDir = 18, kDirAmb = 21, kDirDif = 24, kDirSpec = 27,
    kSpotPos = 30, kSpotDir = 33, kSpotAmb = 36, kSpotDif = 39, kSpotSpec = 42,
    kSpotCosPhi = 45, kSpotCosGamma = 46, kSpotKc = 47, kSpotKl = 48, kSpotKq = 49,
};
constexpr int kLightFloats = 50;
// Material table row (shade/materials.py MaterialTable.to_matrix), 10 floats.
constexpr int kMatStride = 10, kMatDif = 3, kMatSpec = 6, kMatShin = 9;
// Rows the parameter block and the static shared table hold (shade/render.py
// SHADE_MAX_MATERIALS); a larger table goes by pointer.
constexpr int kMaxMaterials = 32;
// The host block (shade/render.py shade_tables): eye, sky, rig, rows.
constexpr int kBlockEye = 0, kBlockSky = 3, kBlockLights = 6, kBlockRows = 56;

__device__ __forceinline__ V3 v3(const float* p) { return {p[0], p[1], p[2]}; }

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
    return {mul(v3(L + amb), diffuse),
            scale(mul(scale(v3(L + dif), d), diffuse), lit),
            scale(mul(scale(v3(L + spec), s), specular), lit)};
}

// One material row in shared memory: (diffuse, shininess), (specular, 0).
struct MatRow { float4 dif_shin, spec; };

// The gamma decode of one atlas texel channel (render.py:100).
__device__ __forceinline__ float decode_gamma(float c, float gamma) {
    return powf(fmaxf(c, 1e-6f), gamma);
}

// geometry.cube_uv and the nearest texel of an atlas [Ma, R, R, 3]
// (render.py:87-105): the texel's index; `m` is the ray's material id.
__device__ __forceinline__ int64_t atlas_lin(V3 p, V3 cmin, V3 cmax, int m, int R, int Ma) {
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
    const float rf = (float)R;
    const int ui = trunc_clip(u * rf, 0.0f, (float)(R - 1));
    const int vi = trunc_clip(v * rf, 0.0f, (float)(R - 1));
    const int mi = clampi(m, 0, Ma - 1);
    return ((int64_t)mi * R + vi) * R + ui;
}

// envmap.sample_env's coordinates in direction b (bilinear): the unit
// direction, its clipped y, the four taps' texel indices (u wrapped, v
// clamped; the second column is the first's wrap plus one, which equals
// imod(x0 + 1, W)) and the fractions.
struct SkyCoords {
    V3 nd;
    float cy;
    int64_t i00, i01, i10, i11;
    float fx, fy;
};

__device__ __forceinline__ SkyCoords sky_coords(V3 b, int H, int W) {
    SkyCoords c;
    c.nd = normalize(b);
    const float pi = 3.14159265358979323846f;
    const float u = atan2f(c.nd.z, c.nd.x) / (float)(2.0 * 3.14159265358979323846) + 0.5f;
    c.cy = fminf(fmaxf(c.nd.y, -1.0f), 1.0f);
    const float vv = acosf(c.cy) / pi;
    const float x = u * (float)W - 0.5f;
    const float y = vv * (float)H - 0.5f;
    const float fx0 = floorf(x), fy0 = floorf(y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    c.fx = x - (float)x0;
    c.fy = y - (float)y0;
    const int xa = imod(x0, W);
    const int xb = xa + 1 == W ? 0 : xa + 1;
    const int64_t ra = (int64_t)clampi(y0, 0, H - 1) * W;
    const int64_t rb = (int64_t)clampi(y0 + 1, 0, H - 1) * W;
    c.i00 = ra + xa;
    c.i01 = ra + xb;
    c.i10 = rb + xa;
    c.i11 = rb + xb;
    return c;
}

}  // namespace ort
