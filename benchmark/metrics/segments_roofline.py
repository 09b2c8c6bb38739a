"""segments_roofline.<cell>: the cell's fixed sampler bound per step
(benchmark/cells/) over segments_ms, in per cent."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    ms = per_unit_ms(record, "segments", "trace_steps")
    bound = work.get("segments_bound_ms")
    if ms is None or not bound:
        return None
    return 100.0 * bound / ms
