"""composite_host_ms.<cell>: host ms a step inside the port's
``fit.composite`` spans (the checks, the background and K5's enqueue),
over the traced window's steps."""

from benchmark.metrics._spans import per_unit


def read(record: dict, work: dict):
    return per_unit(record, lambda r: (r["end_ns"] - r["start_ns"]) * 1e-6
                    if r["name"] == "fit.composite" else None)
