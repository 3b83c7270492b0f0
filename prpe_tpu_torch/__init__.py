"""PyTorch/CUDA port of ``prpe_tpu`` for one NVIDIA H100.

The package mirrors ``prpe_tpu``'s layout and names. It imports torch and
numpy only: never JAX, flax, or anything from ``prpe_tpu``, which stays the
reference the port is tested against. The two Pallas kernels on the serving
path are CUDA C++ kernels under ``csrc/``, built at first use by
``ops/kernels/_build.py``.
"""
