"""allreduce_mb.<cell>: MB (10^6 bytes) a step handed to collectives, the
port's counter (``Collectives``) read from its ``fit.shard_step`` spans over
the traced window."""

from benchmark.metrics._shard_steps import step_bytes


def read(record: dict, work: dict):
    b = step_bytes(record)
    return None if b is None else b * 1e-6
