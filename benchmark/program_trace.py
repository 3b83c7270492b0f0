"""The program's own records of a traced run's calls, for the per-layer
readers whose ``source`` is ``program_span`` or ``program_counter``.

While a ``torch.profiler`` records, ``prpe_tpu_torch/utils/profiling.py``
keeps the spans (host ns on the trace's clock, device ms) and the counters
of every call of the cascade runner. A reader takes those of the traced
window: the last ``summary["calls"]`` calls of the latest traced stretch.
Where the program keeps none (a tree without them, the control, a fault),
each function here gives nothing and the reader None.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

PROFILING = "prpe_tpu_torch.utils.profiling"


def _program():
    """The program's tracing module if this process loaded one that keeps
    records; the reader never imports the program itself."""
    mod = sys.modules.get(PROFILING)
    return mod if hasattr(mod, "spans") and hasattr(mod, "counters") else None


def counters(summary) -> List[Dict[str, int]]:
    """The counters of each traced call."""
    mod = _program()
    return mod.counters()[-summary["calls"]:] if mod else []


def spans(summary) -> List[Dict[str, dict]]:
    """Per traced call: span name -> its record."""
    mod = _program()
    calls: Dict[int, Dict[str, dict]] = {}
    for r in mod.spans() if mod else []:
        calls.setdefault(r["call"], {})[r["name"]] = r
    return list(calls.values())[-summary["calls"]:]


def host_ms(record: dict) -> float:
    return (record["host_end_ns"] - record["host_start_ns"]) / 1e6


def mean_device_ms(summary, name: str) -> Optional[float]:
    """Device ms of span ``name``, averaged over the traced calls."""
    rows = [c[name]["device_ms"] for c in spans(summary) if name in c]
    return sum(rows) / len(rows) if rows else None


def fill(summary, used: str, slots: str) -> Optional[float]:
    """Sum of counter ``used`` over the sum of ``slots``, in %."""
    rows = [c for c in counters(summary) if used in c and slots in c]
    total = sum(c[slots] for c in rows)
    return 100.0 * sum(c[used] for c in rows) / total if total else None
