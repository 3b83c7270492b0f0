"""Mixed-precision policy (``prpe_tpu/core/dtypes.py``): fp32 parameters,
a compute dtype, fp32 accumulation.

bf16 compute with fp32 parameters and no loss scaling (bf16 has fp32's
exponent range) on the card, as the JAX package chooses it on the TPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # losses / reductions always accumulate in fp32
    accum_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree: Any) -> Any:
        """Every floating tensor of a nested dict / list / tuple in the
        compute dtype; other leaves (integer tensors, numbers) as they
        are."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self.cast_to_compute(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


def default_policy(bf16: bool = True, device=None) -> DTypePolicy:
    """bf16 compute on a CUDA ``device`` (where JAX gives it on the TPU),
    fp32 compute otherwise."""
    if bf16 and device is not None and torch.device(device).type == "cuda":
        return DTypePolicy()
    return DTypePolicy(compute_dtype=torch.float32)
