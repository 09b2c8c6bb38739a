"""march_roofline.<cell>: the cell's fixed march bound per frame (camera
rays and light bundle, benchmark/cells/) over march_ms, in per cent."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    ms = per_unit_ms(record, "march", "trace_frames")
    bound = work.get("march_bound_ms")
    if ms is None or not bound:
        return None
    return 100.0 * bound / ms
