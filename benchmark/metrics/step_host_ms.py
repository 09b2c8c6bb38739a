"""step_host_ms.<cell>: host ms per fit step in the measured window, around
the step's enqueue (sampling, loss, backward, Adam), averaged."""

from benchmark.metrics._common import mean


def read(record: dict, work: dict):
    return mean(record.get("step_host_ms"))
