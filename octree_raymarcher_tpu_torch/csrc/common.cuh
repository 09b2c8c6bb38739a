// Shared constants and scalar helpers of the port's CUDA kernels.
//
// Every kernel is built with -fmad=false and without --use_fast_math, so each
// a + b*c below rounds twice, exactly as the eager PyTorch plain versions and
// the JAX reference round it.  The formulas are written in the plain
// versions' order (octree_raymarcher_tpu_torch/ops/march.py,
// shade/render.py), including their 0/1 "lerp" forms where a sign of zero
// could otherwise differ.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ort {

constexpr float kEps = 1.0f / 4096.0f;      // core/constants.py EPS
constexpr float kBigEps = 1.0f / 16.0f;     // core/constants.py BIGEPS
constexpr float kTClamp = 1e8f;             // ops/march.py T_CLAMP
constexpr int kTwigSize = 4;
constexpr int kTwigWords = 64;
constexpr int kU30 = (1 << 30) - 1;
constexpr int kLeaf = 1, kBranch = 2, kTwig = 3;

__device__ __forceinline__ float safe_inv(float d) {
    const float tiny = 1e-30f;
    const float s = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
    return 1.0f / s;
}

// Floor modulo (jnp.mod / torch.remainder on ints); C's % truncates.
__device__ __forceinline__ int imod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int64_t clampl(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// int(clip(x, lo, hi)) for integral lo, hi: equal to the reference's
// truncate-then-clip (`.astype(int32)` then `clip`) for every finite x.
__device__ __forceinline__ int trunc_clip(float x, float lo, float hi) {
    return (int)fminf(fmaxf(x, lo), hi);
}

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

// geometry.cube_normal: the outward face normal of the box face nearest p.
// float -> int32 saturates, as XLA's convert does.
__device__ __forceinline__ V3 cube_normal(V3 p, V3 cmin, V3 cmax) {
    const V3 center = scale(add(cmin, cmax), 0.5f);
    const V3 half = scale(sub(cmax, cmin), 0.5f);
    const V3 nr = {(p.x - center.x) / fmaxf(half.x, 1e-30f),
                   (p.y - center.y) / fmaxf(half.y, 1e-30f),
                   (p.z - center.z) / fmaxf(half.z, 1e-30f)};
    const float k = 1.0f + kEps;
    const V3 q = {truncf(fminf(fmaxf(nr.x * k, -2147483648.0f), 2147483648.0f)),
                  truncf(fminf(fmaxf(nr.y * k, -2147483648.0f), 2147483648.0f)),
                  truncf(fminf(fmaxf(nr.z * k, -2147483648.0f), 2147483648.0f))};
    const float qn = fmaxf(length(q), 1e-12f);
    return {q.x / qn, q.y / qn, q.z / qn};
}

}  // namespace ort
