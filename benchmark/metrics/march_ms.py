"""march_ms.<cell>: device ms per frame of the march layer's kernels (K1 on
the camera rays and on the light bundle), from the traced window."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "march", "trace_frames")
