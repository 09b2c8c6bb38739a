"""PyTorch + CUDA port of octree_raymarcher_tpu for NVIDIA Hopper (H100).

The JAX package ``octree_raymarcher_tpu`` is the reference; this package
mirrors its layout (core/, worldgen/, world/, ops/, shade/) so each module's
counterpart is easy to find.  Host world generation and packing are numpy
copies that give bit-identical pools; the device path is PyTorch with two
hand-written CUDA kernels (csrc/march.cu, csrc/shade.cu) built by nvcc on
first CUDA use (kernels.py).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, which runs the plain PyTorch versions of the
kernels.
"""
