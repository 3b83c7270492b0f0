"""Per-layer metric ``yolo_ms.cascade``: device ms a call of the work launched inside the
two detectors' forwards (``nn/yolo.py``)."""


def read(summary, ctx):
    if not summary["busy_s"]:
        return None
    seconds = sum(summary["module_s"].get(m, 0.0) for m in ('person_yolo', 'face_yolo'))
    return seconds * 1e3 / summary["calls"]
