"""Eval BatchNorm and the activation after it in one pass: the CUDA kernel
``csrc/bn_act.cu`` and its plain version.

``y = act(x * scale + bias)`` with per-channel ``scale`` and ``bias`` in the
activation dtype, rounded to it after the product, after the sum and after
the activation, as the separate PyTorch ops round (``nn/common.py::
BatchNorm``'s eval expression, ``prpe_tpu/nn/common.py::inference_bn``).
``act`` is ``"none"``, ``"silu"`` (``F.silu``), ``"prelu"`` (``nn/common.py::
PReLU``: ``where(y >= 0, y, alpha * y)``) or ``"relu"`` (``F.relu``, after
the BatchNorms of ResNet-50-vd in ``nn/resnet.py``). It replaces no TPU
kernel.

An optional ``residual`` of ``x``'s dtype, sizes and strides is added
between the BatchNorm and the activation, ``act(x * scale + bias +
residual)``, rounded after the add too, as ATen's separate add rounds: the
last BatchNorm of a ResNet-50-vd bottleneck with its shortcut and ReLU, and
a RepVGG block's two branches and SiLU (``nn/rtdetr.py``). Such a launch
also counts in the route ``bn_act_residual``.

The launch is the custom op ``prpe::bn_act`` (a fake implementation gives
its output), so an exported program holds it as one node. Its CPU
implementation is the plain version; its CUDA implementation launches the
kernel, which takes bf16 and fp32 tensors of up to ``MAX_CHANNELS``
channels that are dense in NCHW order or channels-last, and raises
``ValueError`` for any other CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from prpe_tpu_torch.ops.kernels._build import INT, PTR, Library

# every launch counts in "bn_act"; one with a residual in "bn_act_residual" too
LIBRARY = Library("bn_act", {f"prpe_bn_act_{dt}": [PTR] * 6 + [INT] * 5 + [PTR]
                             for dt in ("f32", "bf16")}, routes=("bn_act", "bn_act_residual"))
ACTS = {"none": 0, "silu": 1, "prelu": 2, "relu": 3}
# most channels the kernel stages in shared memory (``kMaxChannels``)
MAX_CHANNELS = 4096
_MAX_ITEMS = 2**31 - 1
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 alpha: Optional[torch.Tensor], act: str, dim: int,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch: ``x * scale + bias`` over channel axis ``dim``, then
    ``+ residual`` where given, then ``act``; ``scale``, ``bias`` and
    ``alpha`` are (C,) in ``x``'s dtype."""
    shape = [1] * x.dim()
    shape[dim] = -1
    y = x * scale.view(shape) + bias.view(shape)
    if residual is not None:
        y = y + residual
    if act == "silu":
        return F.silu(y)
    if act == "prelu":
        return torch.where(y >= 0, y, alpha.view(shape) * y)
    if act == "relu":
        return F.relu(y)
    return y


def geometry(x: torch.Tensor, dim: int) -> Optional[Tuple[int, int, int]]:
    """``(outer, C, inner)`` of ``x`` in memory order, with the channel axis
    ``dim`` (negative counts from the end): dense in ``x``'s dimension order
    (NCHW, (N, C)), or a 4-D channels-last tensor with the channel axis 1
    (inner 1). None for any other layout."""
    dim %= x.dim()
    c = x.shape[dim]
    if x.is_contiguous():
        inner = math.prod(x.shape[dim + 1:])
    elif x.dim() == 4 and dim == 1 and x.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    else:
        return None
    return x.numel() // max(c * inner, 1), c, inner


def _check(x, scale, bias, alpha, dim: int, residual=None) -> Tuple[int, int, int]:
    """``(outer, C, inner)`` of a tensor the kernel takes: bf16 or fp32, at
    most ``MAX_CHANNELS`` channels, fewer than 2^31 elements (its indices
    are 32-bit), in a layout that :func:`geometry` reads, with ``scale``,
    ``bias`` and ``alpha`` (where given) contiguous (C,) tensors of its
    dtype on its device, and ``residual`` (where given) of its dtype,
    device, sizes and strides (those of axes longer than 1: the kernel
    reads it at ``x``'s offsets). Raises ``ValueError`` otherwise."""
    if x.dtype not in _SUFFIX:
        raise ValueError(f"bn_act: the kernel takes bf16 and fp32, not {x.dtype}")
    shape = geometry(x, dim)
    if shape is None:
        raise ValueError(f"bn_act: the kernel takes NCHW-dense or channels-last tensors, not "
                         f"shape {tuple(x.shape)} with strides {x.stride()} over axis {dim}")
    c = shape[1]
    if not 0 < c <= MAX_CHANNELS or x.numel() > _MAX_ITEMS:
        raise ValueError(f"bn_act: {c} channels (at most {MAX_CHANNELS}) and {x.numel()} "
                         f"elements (at most {_MAX_ITEMS})")
    for name, t in (("scale", scale), ("bias", bias), ("alpha", alpha)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device
                              or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"bn_act: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"contiguous {t.is_contiguous()}; x is {x.dtype} with {c} "
                             f"channels on {x.device}")
    if residual is not None and (
            residual.dtype != x.dtype or residual.device != x.device
            or residual.shape != x.shape
            or any(a != b for n, a, b in zip(x.shape, x.stride(), residual.stride()) if n > 1)):
        raise ValueError(f"bn_act: residual is {residual.dtype} {tuple(residual.shape)} with "
                         f"strides {residual.stride()} on {residual.device}; x is {x.dtype} "
                         f"{tuple(x.shape)} with strides {x.stride()} on {x.device}")
    return shape


def _launch(x, scale, bias, alpha, act: str, dim: int, residual=None) -> torch.Tensor:
    """Launch ``prpe_bn_act_<dtype>`` on a CUDA tensor, checked once
    (:func:`_check`)."""
    outer, c, inner = _check(x, scale, bias, alpha, dim, residual)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    routes = ("bn_act",) if residual is None else ("bn_act", "bn_act_residual")
    LIBRARY.launch(f"prpe_bn_act_{_SUFFIX[x.dtype]}", routes, x, x.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), None if alpha is None else alpha.data_ptr(),
                   None if residual is None else residual.data_ptr(), y.data_ptr(),
                   outer, c, inner, ACTS[act], x.get_device())
    return y


@torch.library.custom_op("prpe::bn_act", mutates_args=(), device_types="cpu")
def _bn_act_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               alpha: Optional[torch.Tensor], act: str, dim: int,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    return bn_act_plain(x, scale, bias, alpha, act, dim, residual)


@_bn_act_op.register_kernel("cuda")
def _(x, scale, bias, alpha, act, dim, residual=None):
    return _launch(x, scale, bias, alpha, act, dim, residual)


@_bn_act_op.register_fake
def _(x, scale, bias, alpha, act, dim, residual=None):
    return torch.empty_like(x)


def bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           alpha: Optional[torch.Tensor], act: str, dim: int = 1,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(x * scale + bias + residual)`` over channel axis ``dim`` in
    ``x``'s dtype, rounded as :func:`bn_act_plain` rounds; no add where
    ``residual`` is None. ``scale``, ``bias`` and ``alpha`` (``act``
    "prelu" only) are contiguous (C,) tensors in ``x``'s dtype on its
    device; ``residual`` has ``x``'s dtype, device, sizes and strides. A
    CUDA tensor launches the kernel, or raises ``ValueError`` where the
    kernel does not take it (:func:`_check`); a CPU tensor takes the plain
    version."""
    if act not in ACTS or (act == "prelu") != (alpha is not None):
        raise ValueError(f"bn_act: act {act!r} with alpha {'given' if alpha is not None else None}")
    return _bn_act_op(x, scale, bias, alpha, act, dim, residual)
