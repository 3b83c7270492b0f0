"""Profiling and tracing helpers (``prpe_tpu/utils/``)."""

from prpe_tpu_torch.utils.profiling import Throughput, count_flops, trace  # noqa: F401

__all__ = ["Throughput", "count_flops", "trace"]
