"""light_pass_ms.<cell>: device ms per frame of the light pass's kernel
(K1's light-depth instantiation, which the port launches inside its
``render.light_pass`` span), from the traced window."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "light_pass", "trace_frames")
