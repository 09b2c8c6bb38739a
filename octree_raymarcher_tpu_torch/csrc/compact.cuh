// The in-flight rows of the stage-compacted march and what K9 (the stage
// march) and K10 (the stable partition) share, both in compact.cu.
//
// A packed ray is one row of a set of buffers (Rows): its origin and
// direction, its march parameter t, its source index in the caller's batch
// (int64) and one int32 column: for the frame march its coarse step charge,
// for the sampler its state, the phase it is in and the iterations it has
// spent in that phase (kUsedBits below).  The sampler is phase-merged: a ray
// that hits starts its next phase in the same stage, so the rows of one
// buffer may be in different phases, and K10 moves the state with the row.
#pragma once

#include "march_step.cuh"

namespace ort {

struct Rows {
    float* o;          // [M, 3]
    float* d;          // [M, 3]
    float* t;          // [M]
    int64_t* orig;     // [M]; null on a partition's input means the identity
    int32_t* charge;   // [M] the charge or the sampler's state; null on the first
                       // pack's input, where it is zero (phase 0, no iteration)
};

// The sampler's state in the charge column: phase << kUsedBits | iterations
// spent in the phase (the wrapper keeps K and the phase cap below the limits).
constexpr int kUsedBits = 20;
constexpr int kUsedMask = (1 << kUsedBits) - 1;

// What a stage leaves in a packed ray's flag for the partition.
constexpr uint8_t kEnded = 0;  // its record (or its segments' tail) is written
constexpr uint8_t kLive = 1;   // still marching: to the next stage's prefix
constexpr uint8_t kNext = 2;   // to K10's second destination (no K9 stage sets it)

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
