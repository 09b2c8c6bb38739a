"""allreduce_roofline.<cell>: the all-reduce's share of its link bound, in
per cent: a ring all-reduce of S bytes over n ranks moves 2(n-1)/n S bytes
through each card's link, S being the bytes a step handed to collectives
(``allreduce_mb``); over the link's peak a direction (``link_bytes_per_s``
in benchmark/cells/), divided by ``allreduce_ms``."""

from benchmark.metrics._common import per_unit_ms
from benchmark.metrics._shard_steps import step_bytes


def read(record: dict, work: dict):
    ms = per_unit_ms(record, "allreduce", "trace_steps")
    size, n, peak = step_bytes(record), record.get("ranks"), work.get("link_bytes_per_s")
    if ms is None or not size or not n or n < 2 or not peak:
        return None
    return 100.0 * (2.0 * (n - 1) / n * size / peak * 1e3) / ms
