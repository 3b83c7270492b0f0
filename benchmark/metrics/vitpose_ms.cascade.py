"""Per-layer metric ``vitpose_ms.cascade``: device ms a call of the work launched inside
ViTPose's forward (``nn/vit.py``, K2 included)."""


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    seconds = sum(summary["module_s"].get(m, 0.0) for m in ('vitpose',))
    return seconds * 1e3 / summary["calls"]
