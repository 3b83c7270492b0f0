"""Per-layer metric ``msda_roofline.cascade_rtdetr``: the deformable-attention
kernel (``csrc/ms_deform_attn.cu``) against its roofline: its launches'
least time (``reference/flops_rtdetr.py::msda_least_s`` at the call's
frames and the configuration's queries, positions, heads, head width,
levels and points) over its traced time, in %. Nothing when the kernel did
not run."""

from benchmark.reference.flops_rtdetr import msda_least_s, msda_shapes


def read(summary, ctx):
    rows = [row for name, row in summary["ops"].items() if "msda_kernel" in name]
    seconds = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if not launches or not seconds:
        return None
    shapes = msda_shapes(ctx["cfg"], int(ctx["units"]["frames_per_call"]))
    return 100.0 * launches * msda_least_s(shapes, ctx["cfg"]["dtype"]) / seconds
