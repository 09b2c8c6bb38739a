// K3: the per-ray passes of the shadows, one thread per ray.
//
// Replaces the JAX package's shadow programs (B7) around the march (B1,
// kernel K1), octree_raymarcher_tpu/shade/render.py:
//   * ray_prep       - the start points of `ray_shadow` (:139-149) as
//                      `render` builds them (:421-426): p = o + d*(t_hit - EPS),
//                      the hit cell's cube_normal n, start = p + n*4EPS, the
//                      light direction per ray, and live = hit;
//   * shadow_resolve - the along-ray ndc-z resolve of `_shadowmap_device`
//                      (:233-237): p = o + d*(hit ? t : FAR), row 2 of
//                      vp*[p,1], or 1.0 where the light ray missed;
//   * map_project    - `map_shadow` (:364-394) times the hit mask (:437-439):
//                      the light projection, the sign-safe divide, the
//                      nearest texel of the depth map, the inside test and
//                      the compare against bias_texels/(2W).
//
// What bounds them on an H100: bytes.  Each is a few dozen float operations
// per ray against 25-60 bytes of ray I/O, far below the card's FP32 rate,
// and map_project adds one 4-byte gather from a 1 MiB depth map that stays
// in L2.  So each is one pass with every intermediate in registers; the JAX
// program's [N,4] homogeneous temporaries and the separate hit multiply
// become one read of each input and one write of each output.
//
// The shadowed frames no longer run the last two: render_shadowmap resolves
// its light depth in K1's epilogue (march.cu, march_depth) and the
// map-shadowed K2 projects its own hit points (shade.cu), both with the
// arithmetic of shadow.cuh that these passes use.  They stay as the public
// shadow_resolve, map_project and map_shadow(points) of shade/shadow.py.

#include "shadow.cuh"

namespace ort {
namespace {

__device__ __forceinline__ V3 load3(const float* p, int64_t r) {
    return {p[3 * r], p[3 * r + 1], p[3 * r + 2]};
}

__device__ __forceinline__ void store3(float* p, int64_t r, V3 v) {
    p[3 * r] = v.x; p[3 * r + 1] = v.y; p[3 * r + 2] = v.z;
}

// The shaded point of render(): o + d * (t_hit - EPS), t_hit = 0 on a miss.
__device__ __forceinline__ V3 hit_point(const float* o, const float* d, const uint8_t* hit,
                                        const float* t, int64_t r) {
    const float t_hit = hit[r] ? t[r] : 0.0f;
    return add(load3(o, r), scale(load3(d, r), t_hit - kEps));
}

struct RayPrepArgs {
    const uint8_t* hit;
    const float* t;
    const float* cell_bmin;
    const float* cell_size;
    const float* o;
    const float* d;
    const float* points;     // nullable: given points and normals instead
    const float* normals;
    float lx, ly, lz;        // unit direction toward the light
    int64_t n;
    float* out_start;
    float* out_dirs;
    int32_t* out_live;
};

__global__ void __launch_bounds__(128) ray_prep_kernel(const RayPrepArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    V3 p, nrm;
    if (a.points != nullptr) {
        p = load3(a.points, r);
        nrm = load3(a.normals, r);
    } else {
        p = hit_point(a.o, a.d, a.hit, a.t, r);
        const V3 cmin = load3(a.cell_bmin, r);
        const float csz = a.cell_size[r];
        nrm = cube_normal(p, cmin, {cmin.x + csz, cmin.y + csz, cmin.z + csz});
    }
    store3(a.out_start, r, add(p, scale(nrm, 4.0f * kEps)));
    store3(a.out_dirs, r, {a.lx, a.ly, a.lz});
    a.out_live[r] = a.hit[r] ? 1 : 0;
}

struct ResolveArgs {
    const float* o;
    const float* d;
    const uint8_t* hit;
    const float* t;
    Mat4 vp;
    int64_t n;
    float* out_depth;
};

__global__ void __launch_bounds__(128) shadow_resolve_kernel(const ResolveArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    a.out_depth[r] = light_depth(a.vp.m + 8, load3(a.o, r), load3(a.d, r), a.hit[r] != 0,
                                 a.t[r]);
}

struct ProjectArgs {
    const float* points;     // nullable: else the hit points of (o, d, t, hit)
    const float* o;
    const float* d;
    const uint8_t* hit;      // nullable with points: no hit mask
    const float* t;
    ShadowMap map;
    int64_t n;
    float* out_factor;
};

__global__ void __launch_bounds__(128) map_project_kernel(const ProjectArgs a) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    const V3 p = a.points != nullptr ? load3(a.points, r)
                                     : hit_point(a.o, a.d, a.hit, a.t, r);
    const bool shadowed = map_shadowed(a.map, p);
    const bool hit = a.hit == nullptr || a.hit[r] != 0;
    a.out_factor[r] = (shadowed && hit) ? 1.0f : 0.0f;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + 127) / 128); }

}  // namespace
}  // namespace ort

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int ort_ray_prep(const void* hit, const void* t, const void* cell_bmin,
                 const void* cell_size, const void* o, const void* d, const void* points,
                 const void* normals, float lx, float ly, float lz, int64_t n,
                 void* out_start, void* out_dirs, void* out_live, void* stream) {
    ort::RayPrepArgs a;
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.cell_bmin = static_cast<const float*>(cell_bmin);
    a.cell_size = static_cast<const float*>(cell_size);
    a.o = static_cast<const float*>(o);
    a.d = static_cast<const float*>(d);
    a.points = static_cast<const float*>(points);
    a.normals = static_cast<const float*>(normals);
    a.lx = lx; a.ly = ly; a.lz = lz;
    a.n = n;
    a.out_start = static_cast<float*>(out_start);
    a.out_dirs = static_cast<float*>(out_dirs);
    a.out_live = static_cast<int32_t*>(out_live);
    if (n > 0) {
        ort::ray_prep_kernel<<<ort::blocks_for(n), 128, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

int ort_shadow_resolve(const void* o, const void* d, const void* hit, const void* t,
                       const void* vp, int64_t n, void* out_depth, void* stream) {
    ort::ResolveArgs a;
    a.o = static_cast<const float*>(o);
    a.d = static_cast<const float*>(d);
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.vp = ort::mat4(static_cast<const float*>(vp));
    a.n = n;
    a.out_depth = static_cast<float*>(out_depth);
    if (n > 0) {
        ort::shadow_resolve_kernel<<<ort::blocks_for(n), 128, 0,
                                     static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

int ort_map_project(const void* points, const void* o, const void* d, const void* hit,
                    const void* t, const void* depth, int H, int W, const void* vp,
                    float bias, int64_t n, void* out_factor, void* stream) {
    ort::ProjectArgs a;
    a.points = static_cast<const float*>(points);
    a.o = static_cast<const float*>(o);
    a.d = static_cast<const float*>(d);
    a.hit = static_cast<const uint8_t*>(hit);
    a.t = static_cast<const float*>(t);
    a.map = ort::shadow_map(depth, H, W, vp, bias);
    a.n = n;
    a.out_factor = static_cast<float*>(out_factor);
    if (n > 0) {
        ort::map_project_kernel<<<ort::blocks_for(n), 128, 0,
                                  static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
