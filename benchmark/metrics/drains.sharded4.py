"""drains.sharded4: span boundaries a step, over all of the port's spans,
at which the current CUDA stream had nothing left to run, a step being a
``fit.shard_step`` and what opens after it (``drains.py`` counts the
one-card fit's steps by their ``fit.loss``)."""

from benchmark.metrics._shard_steps import per_step


def read(record: dict, work: dict):
    return per_step(record, lambda r: r["drains"])
