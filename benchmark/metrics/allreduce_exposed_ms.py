"""allreduce_exposed_ms.<cell>: device ms a step in which an NCCL kernel
ran and no other kernel, copy or memset did: the all-reduce that the
overlap failed to hide, over the traced window."""

from benchmark import harness
from benchmark.metrics._shard_steps import exposed_seconds


def read(record: dict, work: dict):
    t, count = record.get("trace"), record.get("trace_steps")
    if not t or not count:
        return None
    s = exposed_seconds(t, harness.layer_patterns("allreduce"))
    return None if s is None else s * 1e3 / count
