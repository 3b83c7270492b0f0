"""Per-layer metric ``host_us_per_launch.cascade``: host us a kernel launch:
the program's span ``cascade.call`` less its ``cascade.upload`` (host time
that dispatches kernels rather than waits on the copy), averaged over the
traced calls, over the trace's kernel launches a call. Nothing without
launches."""

from benchmark.program_trace import host_ms, spans


def read(summary, ctx):
    rows = [host_ms(c["cascade.call"]) - host_ms(c["cascade.upload"])
            for c in spans(summary) if "cascade.call" in c and "cascade.upload" in c]
    if not rows or not summary["launches"]:
        return None
    return 1e3 * (sum(rows) / len(rows)) / (summary["launches"] / summary["calls"])
