"""Per-layer metric ``irnet_ms.cascade``: device ms a call of the work launched inside IR-50's
forward (``nn/irnet.py``)."""


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    seconds = sum(summary["module_s"].get(m, 0.0) for m in ('irnet',))
    return seconds * 1e3 / summary["calls"]
