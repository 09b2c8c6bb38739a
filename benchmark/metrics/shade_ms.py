"""shade_ms.<cell>: device ms per frame of K2, the shading."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "shade", "trace_frames")
