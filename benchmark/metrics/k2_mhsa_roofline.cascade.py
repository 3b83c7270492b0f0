"""Per-layer metric ``k2_mhsa_roofline.cascade``: the packed attention kernel K2
(``csrc/mhsa.cu``) against its roofline: its launches' least time
(``reference/flops.py::mhsa_least_s`` at the pose slots, the ViT's tokens,
heads and head width) over its traced time, in %. Nothing when K2 did not
run."""

from benchmark.reference.flops import mhsa_least_s, vit_tokens


def read(summary, ctx):
    rows = [row for name, row in summary["ops"].items()
            if "mhsa_" in name and "_kernel" in name]
    seconds = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if not launches or not seconds:
        return None
    p = ctx["cfg"]["pose"]
    least = mhsa_least_s(int(ctx["units"]["pose_slots"]), vit_tokens(p), p["heads"],
                         p["hidden"] // p["heads"], ctx["cfg"]["dtype"])
    return 100.0 * launches * least / seconds
