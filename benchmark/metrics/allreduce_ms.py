"""allreduce_ms.<cell>: device ms a step of the NCCL kernels (the gradients'
and the loss's all-reduces, ``layers/allreduce/``), from the traced window;
a kernel's time includes its wait for the other ranks."""

from benchmark.metrics._common import per_unit_ms


def read(record: dict, work: dict):
    return per_unit_ms(record, "allreduce", "trace_steps")
