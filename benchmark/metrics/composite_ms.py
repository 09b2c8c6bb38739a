"""composite_ms.<cell>: device ms per step of the compositor (K5 and K6)."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "composite", "trace_steps")
