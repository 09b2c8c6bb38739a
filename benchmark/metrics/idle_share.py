"""idle_share.<cell>: per cent of the traced window of frames or steps in
which the device ran nothing."""

from benchmark.metrics._common import idle_share


def read(record: dict, work: dict):
    return idle_share(record)
