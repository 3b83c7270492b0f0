"""Per-layer metric ``glue_ms.cascade``: device ms a call of the work launched outside the
four models: uploads, decode, NMS (K1), top-k, crops, matching, the gate,
heatmap decode and the answers' copies to the host."""


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    seconds = sum(summary["module_s"].get(m, 0.0) for m in ('(outside)',))
    return seconds * 1e3 / summary["calls"]
