// K5 (forward) and K6 (backward): soft voxel compositing, one thread per ray.
//
// Replaces the JAX package's compositor (B5):
// octree_raymarcher_tpu/diff/composite.py `composite` (:89-134) and the
// VJP that jax.grad derives for it.  Per ray, over its K segments:
//     sigma_k = logaddexp(density_raw[slot_k], 0)
//     tau_k   = slot_k >= 0 ? sigma_k * max(t1_k - t0_k, 0) : 0
//     alpha_k = 1 - exp(-tau_k)
//     T_k     = exp(-(C_k - tau_k)),  C_k = tau_0 + ... + tau_k
//     w_k     = alpha_k * T_k
//     rgb     = sum_k w_k * sigmoid(albedo_raw[slot_k]) + T_end * bg
//     depth   = sum_k w_k * (t0_k + t1_k) / 2 + T_end * far
//     opacity = 1 - T_end,  T_end = exp(-sum_k tau_k)
// The exclusive prefix is C_k - tau_k, as the reference writes it
// (cumsum(tau) - tau), not a running sum of the earlier taus, and softplus
// is logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)); both forms are kept in
// K5, K6 and the plain versions (diff/composite.py).
//
// K6 recomputes the forward from the segments and runs the reverse pass of
// the reference's autodiff: dL/dT_k = G_k * alpha_k with
// G_k = dL/dw_k + g_rgb . a_k + g_depth * mid_k; the prefix's cotangent
// goes back through the cumsum as a reverse inclusive suffix sum R_k, from
// which tau_k's own term is taken off again (the "- tau" of the prefix);
// then dL/dtau_k = G_k * T_k * (1 - alpha_k) + (R_k - bB_k) - T_end * G_end.
// Gradients reach density_raw through d sigma/dx = exp(x - sigma) and
// albedo_raw through the sigmoid's derivative, scatter-added per slot with
// atomicAdd; d bg is written per ray.  The prefix sums C_k of the forward
// recompute go to a per-ray scratch row so the reverse pass reads back the
// exact forward values.
//
// What bounds them on an H100: bytes.  A ray reads K segments (12 B each)
// and gathers K params (16 B each), and the forward writes K weights; a few
// dozen float operations and three transcendentals per segment are far
// below the FP32 rate.  The design reads each segment once per pass, keeps
// every per-ray sum in registers and writes each output once.  The backward
// scatter is where contention is: the 8 coarse-LEAF slots (twig words +
// material) are shared by every ray that hits a coarse cell, so their
// atomics serialise.  A simple correct kernel first; a warp-level
// pre-reduction of equal slots is later work.

#include "common.cuh"

namespace ort {
namespace {

struct CompositeArgs {
    const int32_t* slot;      // [N, K]
    const float* t0;          // [N, K]
    const float* t1;          // [N, K]
    const float* density;     // [P]
    const float* albedo;      // [P, 3]
    const float* bg;          // [3] or [N, 3]
    int bg_per_ray;
    float far;
    int64_t n;
    int K;
    int64_t P;
    // forward outputs
    float* rgb;               // [N, 3]
    float* depth;             // [N]
    float* opacity;           // [N]
    float* weights;           // [N, K]
    // backward inputs (nullable upstream gradients) and outputs
    const float* g_rgb;
    const float* g_depth;
    const float* g_opacity;
    const float* g_weights;
    float* scratch;           // [N, K] prefix sums of the recompute
    float* d_density;         // [P], accumulated
    float* d_albedo;          // [P, 3], accumulated
    float* d_bg;              // nullable: [N, 3]
};

__device__ __forceinline__ float softplus(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Seg {
    bool valid;
    int64_t s;      // clipped slot
    float x;        // density_raw[slot]
    float sigma, dl, tau, mid;
};

__device__ __forceinline__ Seg load_seg(const CompositeArgs& a, int64_t i) {
    Seg g;
    const int slot = a.slot[i];
    g.valid = slot >= 0;
    g.s = clampl((int64_t)slot, 0, a.P - 1);
    g.x = __ldg(a.density + g.s);
    g.sigma = softplus(g.x);
    const float u = a.t0[i], v = a.t1[i];
    g.dl = fmaxf(v - u, 0.0f);
    g.tau = g.valid ? g.sigma * g.dl : 0.0f;
    g.mid = 0.5f * (u + v);
    return g;
}

__device__ __forceinline__ V3 background(const CompositeArgs& a, int64_t r) {
    const float* b = a.bg + (a.bg_per_ray ? 3 * r : 0);
    return {b[0], b[1], b[2]};
}

__global__ void __launch_bounds__(128) composite_fwd_kernel(const CompositeArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    const int64_t row = r * (int64_t)a.K;
    float csum = 0.0f, tau_sum = 0.0f;
    V3 rgb = {0.0f, 0.0f, 0.0f};
    float depth = 0.0f;
    for (int k = 0; k < a.K; ++k) {
        const Seg g = load_seg(a, row + k);
        const float alpha = 1.0f - expf(-g.tau);
        csum = csum + g.tau;
        const float T = expf(-(csum - g.tau));
        const float w = alpha * T;
        const V3 alb = {sigmoid(__ldg(a.albedo + 3 * g.s)),
                        sigmoid(__ldg(a.albedo + 3 * g.s + 1)),
                        sigmoid(__ldg(a.albedo + 3 * g.s + 2))};
        rgb = add(rgb, scale(alb, w));
        depth = depth + w * g.mid;
        tau_sum = tau_sum + g.tau;
        a.weights[row + k] = w;
    }
    const float t_end = expf(-tau_sum);
    const V3 bg = background(a, r);
    a.rgb[3 * r] = rgb.x + t_end * bg.x;
    a.rgb[3 * r + 1] = rgb.y + t_end * bg.y;
    a.rgb[3 * r + 2] = rgb.z + t_end * bg.z;
    a.depth[r] = depth + t_end * a.far;
    a.opacity[r] = 1.0f - t_end;
}

__global__ void __launch_bounds__(128) composite_bwd_kernel(const CompositeArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    const int64_t row = r * (int64_t)a.K;

    // ---- forward recompute: prefix sums and the total ----------------------
    float csum = 0.0f, tau_sum = 0.0f;
    for (int k = 0; k < a.K; ++k) {
        const Seg g = load_seg(a, row + k);
        csum = csum + g.tau;
        tau_sum = tau_sum + g.tau;
        a.scratch[row + k] = csum;
    }
    const float t_end = expf(-tau_sum);
    const V3 grgb = a.g_rgb ? V3{a.g_rgb[3 * r], a.g_rgb[3 * r + 1], a.g_rgb[3 * r + 2]}
                            : V3{0.0f, 0.0f, 0.0f};
    const float gdep = a.g_depth ? a.g_depth[r] : 0.0f;
    const float gop = a.g_opacity ? a.g_opacity[r] : 0.0f;
    const V3 bg = background(a, r);
    // dL/dT_end: through rgb's sky term, depth's far term and opacity
    const float g_end = dot(grgb, bg) + gdep * a.far - gop;
    if (a.d_bg != nullptr) {
        a.d_bg[3 * r] = grgb.x * t_end;
        a.d_bg[3 * r + 1] = grgb.y * t_end;
        a.d_bg[3 * r + 2] = grgb.z * t_end;
    }

    // ---- reverse pass ----------------------------------------------------------
    float R = 0.0f;   // reverse inclusive suffix sum of the prefix cotangents
    for (int k = a.K - 1; k >= 0; --k) {
        const Seg g = load_seg(a, row + k);
        const float e = expf(-g.tau);
        const float alpha = 1.0f - e;
        const float T = expf(-(a.scratch[row + k] - g.tau));
        const float w = alpha * T;
        const float ax = sigmoid(__ldg(a.albedo + 3 * g.s));
        const float ay = sigmoid(__ldg(a.albedo + 3 * g.s + 1));
        const float az = sigmoid(__ldg(a.albedo + 3 * g.s + 2));
        const float gw = (a.g_weights ? a.g_weights[row + k] : 0.0f) +
                         ((grgb.x * ax + grgb.y * ay) + grgb.z * az) + gdep * g.mid;
        const float bB = -(gw * alpha) * T;        // cotangent of C_k - tau_k
        R = R + bB;
        const float dtau = gw * T * e + (R - bB) - t_end * g_end;
        if (!g.valid) continue;
        const float dx = dtau * g.dl * expf(g.x - g.sigma);
        atomicAdd(a.d_density + g.s, dx);
        atomicAdd(a.d_albedo + 3 * g.s, grgb.x * w * (ax * (1.0f - ax)));
        atomicAdd(a.d_albedo + 3 * g.s + 1, grgb.y * w * (ay * (1.0f - ay)));
        atomicAdd(a.d_albedo + 3 * g.s + 2, grgb.z * w * (az * (1.0f - az)));
    }
}

CompositeArgs args(const void* slot, const void* t0, const void* t1, const void* density,
                   const void* albedo, const void* bg, int bg_per_ray, float far, int64_t n,
                   int K, int64_t P) {
    CompositeArgs a = {};
    a.slot = static_cast<const int32_t*>(slot);
    a.t0 = static_cast<const float*>(t0);
    a.t1 = static_cast<const float*>(t1);
    a.density = static_cast<const float*>(density);
    a.albedo = static_cast<const float*>(albedo);
    a.bg = static_cast<const float*>(bg);
    a.bg_per_ray = bg_per_ray;
    a.far = far;
    a.n = n; a.K = K; a.P = P;
    return a;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + 127) / 128); }

}  // namespace
}  // namespace ort

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int ort_composite_fwd(const void* slot, const void* t0, const void* t1, const void* density,
                      const void* albedo, const void* bg, int bg_per_ray, float far,
                      int64_t n, int K, int64_t P, void* rgb, void* depth, void* opacity,
                      void* weights, void* stream) {
    ort::CompositeArgs a = ort::args(slot, t0, t1, density, albedo, bg, bg_per_ray, far, n,
                                     K, P);
    a.rgb = static_cast<float*>(rgb);
    a.depth = static_cast<float*>(depth);
    a.opacity = static_cast<float*>(opacity);
    a.weights = static_cast<float*>(weights);
    if (n > 0) {
        ort::composite_fwd_kernel<<<ort::blocks_for(n), 128, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

// d_density and d_albedo must be zeroed (or hold a sum to add to).
int ort_composite_bwd(const void* slot, const void* t0, const void* t1, const void* density,
                      const void* albedo, const void* bg, int bg_per_ray, float far,
                      int64_t n, int K, int64_t P, const void* g_rgb, const void* g_depth,
                      const void* g_opacity, const void* g_weights, void* scratch,
                      void* d_density, void* d_albedo, void* d_bg, void* stream) {
    ort::CompositeArgs a = ort::args(slot, t0, t1, density, albedo, bg, bg_per_ray, far, n,
                                     K, P);
    a.g_rgb = static_cast<const float*>(g_rgb);
    a.g_depth = static_cast<const float*>(g_depth);
    a.g_opacity = static_cast<const float*>(g_opacity);
    a.g_weights = static_cast<const float*>(g_weights);
    a.scratch = static_cast<float*>(scratch);
    a.d_density = static_cast<float*>(d_density);
    a.d_albedo = static_cast<float*>(d_albedo);
    a.d_bg = static_cast<float*>(d_bg);
    if (n > 0) {
        ort::composite_bwd_kernel<<<ort::blocks_for(n), 128, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
