"""The benchmark of the PyTorch and CUDA port (``octree_raymarcher_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  What
belongs to one configuration, traffic mix, loop, per-layer metric, kernel
layer or cell is a file of its own, found by its name (:mod:`.harness`).
"""
