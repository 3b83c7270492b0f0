"""Per-layer metric ``rtdetr_backbone_ms.cascade_rtdetr``: device ms a call of
the program's span ``rtdetr.backbone`` (ResNet-50-vd): the stream's time
from reaching the span to finishing its work, busy plus waiting for launches
(``prpe_tpu_torch/utils/profiling.py``). Nothing where the program keeps no
such span."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    return mean_device_ms(summary, "rtdetr.backbone")
