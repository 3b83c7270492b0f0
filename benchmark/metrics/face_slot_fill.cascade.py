"""Per-layer metric ``face_slot_fill.cascade``: the share of IR-50's face slots
(top-F) that hold a valid face, over the traced calls, in %: the program's
counters ``face_slots_used`` over ``face_slots``. The rest of the slots run
the model on nothing."""

from benchmark.program_trace import fill


def read(summary, ctx):
    return fill(summary, "face_slots_used", "face_slots")
