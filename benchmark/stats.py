"""The statistics the benchmark reports."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of ``values`` (``statistics.quantiles``'
    inclusive method; a single value is its own percentile)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def beyond(values: Sequence[float], q: int) -> int:
    """How many of ``values`` lie above their ``q``-th percentile."""
    cut = percentile(values, q)
    return sum(v > cut for v in values)
