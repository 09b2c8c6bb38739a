"""launches.<cell>: the port's kernel launches a frame or step (the launch
counts of its outermost spans), over the traced window."""

from benchmark.metrics._spans import per_unit


def read(record: dict, work: dict):
    return per_unit(record, lambda r: r["launches"] if r["parent"] is None else None)
