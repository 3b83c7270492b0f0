"""Readings that the limits of ``correct`` are set from, for one cell, in one
process: the program's numbers over several seeds (each a set-up, a short
window of the cell's ``check_calls`` calls at its load and the check), then the
control's (the reference in float8 in the program's place) over others.

    python3 benchmark/control.py --workload cascade.b128 --seeds 1 2 3 --control-seeds 4 5 6 \\
        [--faults half_batch ...] [--out FILE]

Prints one JSON line a seed and, last, for each number the largest program
reading (the lower), the smallest control reading (the upper), their ratio
and the smallest reading of each fault planted (``--faults``, read on the
control seeds). Runs on the card; the CPU tests call :func:`readings` at a tiny size.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(workload: str, seeds, kind: str, root=harness.ROOT, device=None, dtype=None):
    """-> one dict of the check's numbers a seed, each from a run of
    ``harness.run`` with the cell's ``check_calls`` calls in place of the
    window. ``kind``: ``program``, ``control``, or a fault the driver plants
    (its ``FAULTS``)."""
    _, _, traffic, _ = harness.load_cell(root, workload)
    out = []
    for seed in seeds:
        result = harness.run(workload, seed, 0.0, False, root, device, dtype, kind=kind,
                             calls=traffic["check_calls"])
        out.append({"seed": seed, "kind": kind,
                    **{k: v["value"] for k, v in result["check"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    help="faults of the driver's FAULTS to read, on the control seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    prog = readings(args.workload, args.seeds, "program")
    ctrl = readings(args.workload, args.control_seeds, "control")
    faults = [r for f in args.faults
              for r in readings(args.workload, args.control_seeds, f)]
    summary = {}
    for k in prog[0]:
        if k in ("seed", "kind"):
            continue
        lower = max(r[k] for r in prog if r[k] is not None)
        read = [r[k] for r in ctrl if r[k] is not None]  # a control with no number sets none
        upper = min(read) if read else None
        summary[k] = {"lower": lower, "upper": upper,
                      "ratio": upper / lower if upper is not None and lower else None}
        for f in args.faults:
            summary[k][f] = min((r[k] for r in faults if r["kind"] == f and r[k] is not None),
                                default=None)
    line = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
            "program": prog, "control": ctrl, "faults": faults, "summary": summary}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
