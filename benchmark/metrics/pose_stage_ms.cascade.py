"""Per-layer metric ``pose_stage_ms.cascade``: device ms a call of the
program's span ``cascade.pose`` (the gate, top-G, the pose crops, ViTPose-B
and the heatmap decode): the stream's time from reaching the span to
finishing its work, busy plus waiting for launches
(``prpe_tpu_torch/utils/profiling.py``)."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    return mean_device_ms(summary, "cascade.pose")
