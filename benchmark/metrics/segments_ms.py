"""segments_ms.<cell>: device ms per step of the segment sampler (K4)."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "segments", "trace_steps")
