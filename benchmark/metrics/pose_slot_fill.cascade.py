"""Per-layer metric ``pose_slot_fill.cascade``: the share of ViTPose's pose
slots (top-G) that hold a gated person, over the traced calls, in %: the
program's counters ``pose_slots_used`` over ``pose_slots``. The rest of the
slots run the model on nothing."""

from benchmark.program_trace import fill


def read(summary, ctx):
    return fill(summary, "pose_slots_used", "pose_slots")
