"""Per-layer metric ``device_idle_share.cascade_rtdetr``: the share of the
traced window in which no kernel, copy or fill ran on the card (one minus
the union of their intervals), in %."""


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
