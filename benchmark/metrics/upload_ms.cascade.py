"""Per-layer metric ``upload_ms.cascade``: device ms a call of the program's
span ``cascade.upload`` (the frames' and the gallery's upload and the uint8
frames' conversion to the compute dtype): the stream's time from reaching
the span to finishing its work, busy plus waiting for launches
(``prpe_tpu_torch/utils/profiling.py``)."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    return mean_device_ms(summary, "cascade.upload")
