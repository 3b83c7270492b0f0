"""Per-layer metric ``detect_stage_ms.cascade``: device ms a call of the
program's span ``cascade.detect`` (both detectors' forwards, their decode
and NMS (K1)): the stream's time from reaching the span to finishing its
work, busy plus waiting for launches
(``prpe_tpu_torch/utils/profiling.py``)."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    return mean_device_ms(summary, "cascade.detect")
