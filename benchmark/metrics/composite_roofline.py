"""composite_roofline.<cell>: the cell's fixed K5 + K6 bound per step
(benchmark/cells/) over composite_ms, in per cent."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    ms = per_unit_ms(record, "composite", "trace_steps")
    bound = work.get("composite_bound_ms")
    if ms is None or not bound:
        return None
    return 100.0 * bound / ms
