"""The benchmark's plain reference: what the port computes, in plain PyTorch
and NumPy, for the comparison that decides ``correct``.

The modules are frozen copies of the port's plain versions (its host world
generation and packing, ``march_plain``, the light bundle and the map
compare, ``shade_hits_plain``, ``sample_segments_plain``,
``composite_plain``), taken with every CUDA path and kernel binding left
out; :mod:`.frame` and :mod:`.fit` put them together.  Nothing here imports
the port, JAX or the JAX package: a later change to the port cannot change
what it is held against.
"""
