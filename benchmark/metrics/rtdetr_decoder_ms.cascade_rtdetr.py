"""Per-layer metric ``rtdetr_decoder_ms.cascade_rtdetr``: device ms a call of
the program's spans ``rtdetr.select`` (the decoder's input projections, the
anchors, the top-300 query selection) and ``rtdetr.decoder`` (the six
decoder layers, each with one deformable-attention launch, and the heads),
summed (``prpe_tpu_torch/utils/profiling.py``). Nothing where the program
keeps no such spans."""

from benchmark.program_trace import mean_device_ms


def read(summary, ctx):
    parts = [mean_device_ms(summary, name) for name in ("rtdetr.select", "rtdetr.decoder")]
    return None if None in parts else sum(parts)
