// The shadow arithmetic, once for every kernel that needs it.
//
// K3 (shadow.cu) runs it as standalone passes; the map-shadowed K2
// (shade.cu) projects its own hit points with map_shadowed, and K1's
// light-depth epilogue (march.cu) resolves its hits with light_depth.  One
// definition keeps every route bit for bit equal to the others and to the
// plain versions of shade/shadow.py, with -fmad=false.
//
// The light's 4x4 view-projection is built on the host in float32 and
// passed by value.  vp*[p,1] sums its four terms in one fixed order,
// ((p.x*m0 + p.y*m1) + p.z*m2) + m3, as the plain versions do.
#pragma once

#include "common.cuh"

namespace ort {

constexpr float kFar = 8192.0f;   // core/constants.py FAR

struct Mat4 { float m[16]; };     // row-major

inline Mat4 mat4(const float* m) {
    Mat4 v;
    for (int i = 0; i < 16; ++i) v.m[i] = m[i];
    return v;
}

// One row of vp*[p,1]; `m` points at the row's four floats.
__device__ __forceinline__ float row_dot(const float* m, V3 p) {
    return ((p.x * m[0] + p.y * m[1]) + p.z * m[2]) + m[3];
}

// The along-ray ndc z that render_shadowmap stores for a light ray
// (shade/render.py:233-237 of the JAX package): row 2 of vp*[o + d*t, 1]
// where the ray hit, 1.0 where it missed.  `row2` is that row of vp.
__device__ __forceinline__ float light_depth(const float* row2, V3 o, V3 d, bool hit, float t) {
    const V3 p = add(o, scale(d, hit ? t : kFar));
    return hit ? row_dot(row2, p) : 1.0f;
}

// A light depth map and what its compare needs.
struct ShadowMap {
    const float* depth;   // [H, W] along-ray ndc z
    int H, W;
    Mat4 vp;
    float bias;           // bias_texels / (2W), rounded to float32
};

// map_shadow (shade/render.py:364-394 of the JAX package) for one point:
// the light projection, the sign-safe divide, the nearest texel of the
// depth map, the inside test and the biased compare.
__device__ __forceinline__ bool map_shadowed(const ShadowMap& m, V3 p) {
    const float cx = row_dot(m.vp.m, p);
    const float cy = row_dot(m.vp.m + 4, p);
    const float cz = row_dot(m.vp.m + 8, p);
    const float cw = row_dot(m.vp.m + 12, p);
    const float den = fmaxf(fabsf(cw), 1e-12f);
    const float sg = cw > 0.0f ? 1.0f : (cw < 0.0f ? -1.0f : 0.0f);
    const float nx = cx / den * sg, ny = cy / den * sg, nz = cz / den * sg;
    const float u = nx * 0.5f + 0.5f;
    const float v = ny * 0.5f + 0.5f;
    const int xi = trunc_clip(u * (float)m.W, 0.0f, (float)(m.W - 1));
    const int yi = trunc_clip((1.0f - v) * (float)m.H, 0.0f, (float)(m.H - 1));
    const float pixel_z = __ldg(m.depth + (int64_t)yi * m.W + xi);
    const bool inside = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
    return inside && nz > pixel_z + m.bias;
}

inline ShadowMap shadow_map(const void* depth, int H, int W, const void* vp, float bias) {
    ShadowMap m;
    m.depth = static_cast<const float*>(depth);
    m.H = H; m.W = W;
    m.vp = mat4(static_cast<const float*>(vp));
    m.bias = bias;
    return m;
}

}  // namespace ort
