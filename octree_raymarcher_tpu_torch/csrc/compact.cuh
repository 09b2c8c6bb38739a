// The in-flight rows of the stage-compacted march and what K9 (the stage
// march) and K10 (the stable partition) share, both in compact.cu.
//
// A packed ray is one row of a set of buffers (Rows): its origin and
// direction, its march parameter t, its source index in the caller's batch
// (int64) and, for the frame march, its coarse step charge.  The sampler
// carries no charge, and neither carries its phase or the iterations spent in
// it: the schedule is phase-major (every stage of phase k, then phase k + 1),
// so every row of a buffer is at the same phase and stage, which the host
// passes to the launch.
#pragma once

#include "march_step.cuh"

namespace ort {

struct Rows {
    float* o;          // [M, 3]
    float* d;          // [M, 3]
    float* t;          // [M]
    int64_t* orig;     // [M]; null on a partition's input means the identity
    int32_t* charge;   // [M]; null where no charge rides (the sampler), and on
                       // the first pack's input, where it is zero
};

// What a stage leaves in a packed ray's flag for the partition.
constexpr uint8_t kEnded = 0;  // its record (or its segments' tail) is written
constexpr uint8_t kLive = 1;   // still marching: to the next stage's prefix
constexpr uint8_t kNext = 2;   // sampler: hit, resumes in the next phase

// A hit's segment (diff/segments.py `_segment_from_hit`) in K4's arithmetic
// (segments.cu): t1 is the hit parameter plus the escape of the hit box,
// clamped below EPS to BIGEPS with nothing added (the march's in-loop escape
// adds EPS: not merged); the slot is the texel, or the material's coarse
// slot past the twig pool.
struct Segment {
    int slot;
    float t0, t1;
};

__device__ __forceinline__ Segment extract_segment(const Ray& q, const MarchState& s,
                                                   int twig_slots, int num_materials) {
    const float t_hit = s.t;
    const float px = q.ax + q.bx * t_hit;
    const float py = q.ay + q.by * t_hit;
    const float pz = q.az + q.bz * t_hit;
    const float dx = fmaxf((s.rec.bx - px) * q.gx, ((s.rec.bx + s.rec.size) - px) * q.gx);
    const float dy = fmaxf((s.rec.by - py) * q.gy, ((s.rec.by + s.rec.size) - py) * q.gy);
    const float dz = fmaxf((s.rec.bz - pz) * q.gz, ((s.rec.bz + s.rec.size) - pz) * q.gz);
    float esc = fminf(dx, fminf(dy, dz));
    if (esc < kEps) esc = kBigEps;
    Segment g;
    g.t0 = t_hit;
    g.t1 = t_hit + esc;
    g.slot = s.rec.texel >= 0 ? s.rec.texel
                              : twig_slots + clampi(s.rec.material, 0, num_materials - 1);
    return g;
}

}  // namespace ort
