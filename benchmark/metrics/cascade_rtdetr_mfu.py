"""Per-layer metric ``cascade_rtdetr_mfu``: the whole call's share of the
card's peak: the reference's FLOPs a call
(``reference/flops_rtdetr.py::cascade_rtdetr_flops``: RT-DETR and the face
YOLO on every frame, IR-50 on every face slot, ViTPose on every pose slot)
times the traced calls, over the traced window and the peak of the
configuration's dtype, in %."""

from benchmark.reference.flops import PEAKS
from benchmark.reference.flops_rtdetr import cascade_rtdetr_flops


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    u = ctx["units"]
    flops = cascade_rtdetr_flops(ctx["cfg"], int(u["frames_per_call"]), int(u["face_slots"]),
                                 int(u["pose_slots"]))
    rate = flops * summary["calls"] / summary["window_s"]
    return 100.0 * rate / PEAKS["flops_per_s"][ctx["cfg"]["dtype"]]
