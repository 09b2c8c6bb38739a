"""Core constants of the sparse-voxel-octree format.

Capability parity with the reference engine's octree geometry
(reference: src/Octree.h:8-45, shaders/Chunkmarch.glsl:2-21), copied
unchanged from octree_raymarcher_tpu/core/constants.py: every march loop is
bounded, and the escape-distance degenerate-case clamp follows the GPU
marcher (Chunkmarch.glsl:107-114), so the JAX reference, the plain PyTorch
march and the CUDA kernel agree bit-wise on the same float32 arithmetic.
"""

# Node types (2-bit tag in the top bits of a 32-bit node word).
EMPTY = 0   # no geometry in this cell
LEAF = 1    # solid cell, payload = material id
BRANCH = 2  # payload = index of 8 consecutive child nodes
TWIG = 3    # payload = index into the twig (brick) pool

# Twig (brick) geometry: a twig terminates the tree TWIG_DEPTH levels early
# with a dense 4x4x4 grid of 16-bit material ids.
TWIG_DEPTH = 2
TWIG_SIZE = 1 << TWIG_DEPTH          # 4
TWIG_WORDS = TWIG_SIZE ** 3          # 64 texels per twig

# March epsilons (float32).  EPS nudges the ray past a cell boundary after a
# skip; BIGEPS replaces degenerate escape distances so no ray can stall.
EPS = 1.0 / 4096.0
BIGEPS = 1.0 / 16.0

# Default bounded step budgets. These mirror the reference
# GPU marcher's work bounds (256 chunk / 512 tree / 64 twig steps, depth<=32)
# but our unified single-loop marcher uses one budget: every iteration either
# terminates a ray or advances it past at least one cell/texel.
MAX_DEPTH = 16            # max octree descent depth
MAX_STEPS = 640           # unified marcher: total cell+texel advances per ray
MAX_STEPS_SINGLE = 512    # single-chunk marcher default

# Depth (z-buffer) encoding: inverse depth as in the reference pipeline.
NEAR = 0.125
FAR = 8192.0

# Node payload mask: low 30 bits.
OFFSET_MASK = (1 << 30) - 1
TYPE_SHIFT = 30
