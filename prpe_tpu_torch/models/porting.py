"""Weight bridge: JAX/flax variable trees -> the port's ``state_dict``.

The port's modules carry the flax module names, so a leaf at
``params/<path>/<leaf>`` becomes ``<path>.<torch leaf>`` with these layout
changes:

* conv kernel (kh, kw, I/g, O) -> (O, I/g, kh, kw), depthwise and
  ``PatchEmbed`` included;
* Dense kernel (I, O) -> (O, I);
* BatchNorm / LayerNorm ``scale`` -> ``weight``; ``batch_stats`` ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``;
* IR-Net ``output_linear``: the JAX model flattens NHWC (h, w, c), the port
  NCHW (c, h, w), so the rows are permuted;
* PReLU ``alpha``, biases and the folded ``pos_embed`` table as they are.

Numpy only: the caller hands in the variable tree (``jax.device_get`` of
the flax variables, or any nested dict of arrays).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _output_linear_rows(kernel: np.ndarray, channels: int) -> np.ndarray:
    """(h*w*c, E) NHWC-flatten kernel -> (E, c*h*w) NCHW-flatten weight."""
    spatial = int(round((kernel.shape[0] // channels) ** 0.5))
    if spatial * spatial * channels != kernel.shape[0]:
        raise ValueError(f"output_linear rows {kernel.shape[0]} are not {channels} * s^2")
    w = kernel.reshape(spatial, spatial, channels, -1).transpose(3, 2, 0, 1)
    return w.reshape(w.shape[0], -1)


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of a JAX model (the cascade or
    one of its component models) -> the state dict of the matching port
    module, as fp32 CPU tensors."""
    leaves = dict(_flatten(variables.get("params", {})))
    stats = dict(_flatten(variables.get("batch_stats", {})))
    out: Dict[str, torch.Tensor] = {}
    for path, value in leaves.items():
        *mods, leaf = path
        if leaf == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 2:
            if mods and mods[-1] == "output_linear":
                bn_scale = leaves[tuple(mods[:-1]) + ("output_bn", "scale")]
                value = _output_linear_rows(value, bn_scale.shape[0])
            else:
                value = value.T
        out[".".join(mods + [_LEAF.get(leaf, leaf)])] = value
    for path, value in stats.items():
        *mods, leaf = path
        out[".".join(mods + [_LEAF[leaf]])] = value
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}
