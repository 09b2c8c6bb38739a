// K7: the pool patch of an edit batch, one block per descriptor.
//
// Replaces the JAX package's donated-buffer pool patch (B8),
// octree_raymarcher_tpu/world/alloc.py: `_patch` (:167) and `_patch_blend`
// (:178), driven by `_patch_range` (:185) from `WorldAllocator.modify`
// (:263-322), which runs three range patches (tree, twig, occupancy) and
// three chunk-table updates per touched chunk.  Here the host plans the
// whole batch (world/alloc.py: WorldAllocator.plan) into a table of
// descriptors (target array, destination word, source word, length) over
// one stream of words, stages both in one copy, and one launch writes every
// range: target[dst + i] = words[src + i] for i < length.
//
// The TPU shaping is not carried over: the power-of-two bucket and the blend
// with the pool's current content existed to bound XLA's compiles; K7 writes
// exactly `length` words, which leaves the same bits.  The occupancy words
// are not built on the host either.  A twig row starts on a 64-word twig
// boundary and covers whole twigs, so each warp's 32 consecutive words of
// an iteration are one aligned half of a twig: the warp's
// __ballot_sync(word != 0) is that half's occupancy word, bit k = lane k,
// the bits `occupancy_masks` gives (world/device.py).
//
// What bounds it on an H100: bytes, and at the sizes of an edit (kilobytes
// to a few megabytes) the launch.  Each word is read once and written once,
// coalesced; a block walks its descriptor in strides of the block, so the
// host cuts long ranges into pieces (PIECE_WORDS) to spread a full-chunk
// upload over many SMs.  The host checks every descriptor against its
// target's length before the launch.

#include "common.cuh"

namespace ort {
namespace {

constexpr int kPatchThreads = 256;
enum Target { kTree = 0, kTwigPool = 1, kChunkBmin = 2, kChunkTree = 3, kChunkTwig = 4 };

struct PatchArgs {
    int32_t* tree;
    int32_t* twig;
    int32_t* twig_occ;
    int32_t* chunk_bmin;     // float32 bits
    int32_t* chunk_tree;
    int32_t* chunk_twig;
    const int64_t* desc;     // [n_desc, 4]: target, dst, src, length
    const int32_t* words;
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
    return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__global__ void __launch_bounds__(kPatchThreads) patch_kernel(const PatchArgs a) {
    const int64_t* row = a.desc + 4 * (int64_t)blockIdx.x;
    const int target = (int)ld64(row);
    const int64_t dst = ld64(row + 1);
    const int64_t src = ld64(row + 2);
    const int64_t len = ld64(row + 3);
    int32_t* out = target == kTree ? a.tree
                 : target == kTwigPool ? a.twig
                 : target == kChunkBmin ? a.chunk_bmin
                 : target == kChunkTree ? a.chunk_tree : a.chunk_twig;
    const int32_t* in = a.words + src;
    if (target == kTwigPool) {
        // len and dst are multiples of 64 and the block of 32: the loop
        // condition is uniform within each warp, so every lane takes part
        // in each ballot.
        for (int64_t i = threadIdx.x; i < len; i += kPatchThreads) {
            const int32_t v = __ldg(in + i);
            out[dst + i] = v;
            const unsigned bits = __ballot_sync(0xffffffffu, v != 0);
            if ((threadIdx.x & 31) == 0) a.twig_occ[(dst + i) >> 5] = (int32_t)bits;
        }
    } else {
        for (int64_t i = threadIdx.x; i < len; i += kPatchThreads) {
            out[dst + i] = __ldg(in + i);
        }
    }
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  `staged`
// holds the descriptors as int64 from its start and the words from int32
// element `words_offset` on.
int ort_patch(void* tree, void* twig, void* twig_occ, void* chunk_bmin, void* chunk_tree,
              void* chunk_twig, const void* staged, int64_t n_desc, int64_t words_offset,
              void* stream) {
    ort::PatchArgs a;
    a.tree = static_cast<int32_t*>(tree);
    a.twig = static_cast<int32_t*>(twig);
    a.twig_occ = static_cast<int32_t*>(twig_occ);
    a.chunk_bmin = static_cast<int32_t*>(chunk_bmin);
    a.chunk_tree = static_cast<int32_t*>(chunk_tree);
    a.chunk_twig = static_cast<int32_t*>(chunk_twig);
    a.desc = static_cast<const int64_t*>(staged);
    a.words = static_cast<const int32_t*>(staged) + words_offset;
    if (n_desc > 0) {
        ort::patch_kernel<<<(unsigned)n_desc, ort::kPatchThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
