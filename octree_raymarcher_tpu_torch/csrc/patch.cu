// K7: the pool patch of an edit batch, one block per row.
//
// Replaces the JAX package's donated-buffer pool patch (B8),
// octree_raymarcher_tpu/world/alloc.py: `_patch` (:167) and `_patch_blend`
// (:178), driven by `_patch_range` (:185) from `WorldAllocator.modify`
// (:263-322), which runs three range patches (tree, twig, occupancy) and
// three chunk-table updates per touched chunk.  Here the host plans the
// whole batch (world/alloc.py: WorldAllocator.plan, layout) into rows
// (target array, destination word, source word, length) over one stream of
// words, copies the words to the card, and one launch writes every range:
// target[dst + i] = words[src + i] for i < length.
//
// The TPU shaping is not carried over: the power-of-two bucket and the blend
// with the pool's current content existed to bound XLA's compiles; K7 writes
// exactly `length` words, which leaves the same bits.  The occupancy words
// are not built on the host either: K7 derives them from the twig words it
// writes.
//
// What bounds it on an H100.  An edit batch reads and writes kilobytes to
// about two megabytes, which the card's memory moves in well under a
// microsecond; such a batch waits on the launch (a graph node of a
// one-element add_ takes ~1.3 us) and on the chain of dependent memory round
// trips inside its blocks.  The shift batch of the session (16 chunks, 13
// MB) is bound by bytes (3.9 us at 3.35 TB/s).  The design:
//
// * The rows travel by value.  A launch's rows, 16 bytes each (int32
//   target, dst, src, length), sit in its __grid_constant__ parameter block,
//   so a block reads its row from the constant bank and issues its first
//   word load at once, with no descriptor load in front of it.  The driver
//   copies the whole block at each launch, so three row capacities are
//   instantiated (kRowCaps) and the host takes the smallest that holds the
//   launch's rows (world/alloc.py launch_groups); a batch of more rows than
//   the largest goes in several launches of this kernel, in order on the
//   stream.  No path reads rows from device memory.
// * One round trip a piece.  The host cuts ranges into pieces of at most
//   kPieceWords and lays the word stream out so that each row's source is
//   congruent to its destination mod 4 (a multiple of 64 on the twig pool,
//   whose rows start on a twig).  A block copies a scalar head of at most 3
//   words up to the first 16-byte boundary of its destination, then int4
//   words, then a scalar tail of at most 3.  Each thread issues every load
//   of its share of the piece (kVecs int4, unrolled, and its head or tail
//   word) before its first store, so a piece costs one memory round trip
//   where a loop of one 4-byte load a step cost eight.  At shift size every
//   block's loads are in flight together, and the bytes bound it.
// * Occupancy from four ballots.  A twig row starts and ends on a twig, so
//   each warp's 32 int4 lanes of a round cover 128 twig words, two twigs,
//   four occupancy words.  One __ballot_sync per int4 component gives four
//   masks; bit k of the window's occupancy word j is component k % 4 of lane
//   8j + k / 4, the bit `occupancy_masks` (world/device.py) sets for word
//   32j + k.  Lanes 0-3 each interleave their byte of the four masks and
//   store one occupancy word.
//
// The host checks every row against its target's length, the word stream,
// int32, the piece size and the congruence before the launch (world/alloc.py
// check_batch), and every pointer's 16-byte alignment.

#include <cstring>

#include "common.cuh"

namespace ort {
namespace {

constexpr int kPatchThreads = 256;
constexpr int kPieceWords = 2048;                    // world/alloc.py PIECE_WORDS
constexpr int kVecs = kPieceWords / (4 * kPatchThreads);
static_assert(kVecs * 4 * kPatchThreads == kPieceWords, "a piece is whole int4 rounds");
constexpr int kRowCaps[3] = {64, 512, 2044};         // world/alloc.py ROW_CAPS
enum Target { kTree = 0, kTwigPool = 1, kChunkBmin = 2, kChunkTree = 3, kChunkTwig = 4 };

struct Row {
    int32_t target, dst, src, len;
};
static_assert(sizeof(Row) == 16, "a row is 16 bytes");

struct Pools {
    int32_t* tree;
    int32_t* twig;
    int32_t* twig_occ;
    int32_t* chunk_bmin;     // float32 bits
    int32_t* chunk_tree;
    int32_t* chunk_twig;
    const int32_t* words;
};

template <int kRows>
struct PatchArgs {
    Pools p;
    Row rows[kRows];
};
static_assert(sizeof(PatchArgs<kRowCaps[2]>) <= 32764, "the parameter limit of CUDA 12.1+");

// The 8 bits of x spread to bits 0, 4, ..., 28.
__device__ __forceinline__ unsigned spread4(unsigned x) {
    x = (x | (x << 12)) & 0x000F000Fu;
    x = (x | (x << 6)) & 0x03030303u;
    return (x | (x << 3)) & 0x11111111u;
}

template <int kRows>
__global__ void __launch_bounds__(kPatchThreads)
patch_kernel(const __grid_constant__ PatchArgs<kRows> a) {
    const Row r = a.rows[blockIdx.x];
    int32_t* out = r.target == kTree ? a.p.tree
                 : r.target == kTwigPool ? a.p.twig
                 : r.target == kChunkBmin ? a.p.chunk_bmin
                 : r.target == kChunkTree ? a.p.chunk_tree : a.p.chunk_twig;
    out += r.dst;
    const int32_t* in = a.p.words + r.src;
    const int head = min((4 - (r.dst & 3)) & 3, r.len);
    const int nvec = (r.len - head) >> 2;
    const int tail_at = head + 4 * nvec;
    const int tail = r.len - tail_at;
    const int4* in4 = reinterpret_cast<const int4*>(in + head);
    int4* out4 = reinterpret_cast<int4*>(out + head);
    const int tid = threadIdx.x;

    // Every load of the thread first ...
    int4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
        const int i = tid + u * kPatchThreads;
        v[u] = i < nvec ? __ldg(in4 + i) : make_int4(0, 0, 0, 0);
    }
    const int32_t hv = tid < head ? __ldg(in + tid) : 0;
    const int32_t tv = tid < tail ? __ldg(in + tail_at + tid) : 0;
    // ... then its stores.
    if (tid < head) out[tid] = hv;
    if (tid < tail) out[tail_at + tid] = tv;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
        const int i = tid + u * kPatchThreads;
        if (i < nvec) out4[i] = v[u];
    }
    if (r.target != kTwigPool) return;      // uniform in the block

    // A twig row: head and tail are empty, and lanes past the row hold zeros.
    const int lane = tid & 31;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
        const unsigned b0 = __ballot_sync(0xffffffffu, v[u].x != 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, v[u].y != 0);
        const unsigned b2 = __ballot_sync(0xffffffffu, v[u].z != 0);
        const unsigned b3 = __ballot_sync(0xffffffffu, v[u].w != 0);
        // first twig word of occupancy word `lane` of the warp's window
        const int word = 4 * (tid - lane + u * kPatchThreads) + 32 * lane;
        if (lane < 4 && word < r.len) {
            const int sh = 8 * lane;
            const unsigned bits = spread4((b0 >> sh) & 0xffu) | (spread4((b1 >> sh) & 0xffu) << 1)
                                | (spread4((b2 >> sh) & 0xffu) << 2)
                                | (spread4((b3 >> sh) & 0xffu) << 3);
            a.p.twig_occ[(r.dst + word) >> 5] = (int32_t)bits;
        }
    }
}

template <int kRows>
int launch(const Pools& p, const void* rows, int n_rows, cudaStream_t stream) {
    PatchArgs<kRows> a;
    a.p = p;
    std::memcpy(a.rows, rows, sizeof(Row) * n_rows);
    patch_kernel<kRows><<<(unsigned)n_rows, kPatchThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ort

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  `rows` is a
// host int32[n_rows, 4] (target, dst, src, length) that the launch carries
// in its parameter block of `row_cap` rows, one of ort::kRowCaps;
// cudaErrorInvalidValue for another capacity or n_rows outside [1, row_cap].
int ort_patch(void* tree, void* twig, void* twig_occ, void* chunk_bmin, void* chunk_tree,
              void* chunk_twig, const void* words, const void* rows, int n_rows, int row_cap,
              void* stream) {
    if (n_rows < 1 || n_rows > row_cap) return (int)cudaErrorInvalidValue;
    const ort::Pools p = {static_cast<int32_t*>(tree),       static_cast<int32_t*>(twig),
                          static_cast<int32_t*>(twig_occ),   static_cast<int32_t*>(chunk_bmin),
                          static_cast<int32_t*>(chunk_tree), static_cast<int32_t*>(chunk_twig),
                          static_cast<const int32_t*>(words)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (row_cap) {
        case ort::kRowCaps[0]: return ort::launch<ort::kRowCaps[0]>(p, rows, n_rows, st);
        case ort::kRowCaps[1]: return ort::launch<ort::kRowCaps[1]>(p, rows, n_rows, st);
        case ort::kRowCaps[2]: return ort::launch<ort::kRowCaps[2]>(p, rows, n_rows, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
