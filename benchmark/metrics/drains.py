"""drains.<cell>: span boundaries a frame or step, over all of the port's
spans, at which the current CUDA stream had nothing left to run (the card
idle, waiting on the host inside that span), over the traced window."""

from benchmark.metrics._spans import per_unit


def read(record: dict, work: dict):
    return per_unit(record, lambda r: r["drains"])
