"""Per-layer metric ``rtdetr_ms.cascade_rtdetr``: device ms a call of the
program's span ``cascade.person_rtdetr`` (the whole person detector:
ResNet-50-vd, the hybrid encoder, the query selection, the decoder and
heads, and the person column's top-K): the stream's time from reaching the
span to finishing its work, busy plus waiting for launches
(``prpe_tpu_torch/utils/profiling.py``). Nothing where the program keeps no
such span."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    return mean_device_ms(summary, "cascade.person_rtdetr")
