"""Profiling and tracing helpers (``prpe_tpu/utils/``)."""

from prpe_tpu_torch.utils.profiling import count_flops, trace  # noqa: F401

__all__ = ["count_flops", "trace"]
