"""Per-layer metric ``runner_host_ms.cascade``: host ms a call of the program's
span ``cascade.call`` (all of the runner's ``run``, under the profiler),
averaged over the traced calls. Against the stage spans' device ms it says
whether the host's eager dispatch or the device sets the pace."""

from benchmark.program_trace import host_ms, spans


def read(summary, ctx):
    rows = [host_ms(c["cascade.call"]) for c in spans(summary) if "cascade.call" in c]
    return sum(rows) / len(rows) if rows else None
