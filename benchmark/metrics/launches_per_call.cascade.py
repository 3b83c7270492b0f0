"""Per-layer metric ``launches_per_call.cascade``: kernel launches a call in the trace, a
count of the host's eager dispatch."""


def read(summary, ctx):
    if not summary["launches"]:
        return None
    return summary["launches"] / summary["calls"]
