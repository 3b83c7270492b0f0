"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version. Importing these modules builds nothing: a source is
compiled at its first launch, or by ``build_all`` (``_build.py``)."""

from prpe_tpu_torch.ops.kernels._build import build_all, launches, reset_launches  # noqa: F401
