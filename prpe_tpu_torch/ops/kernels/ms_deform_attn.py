"""Multi-scale deformable attention, forward only: the CUDA kernel
``csrc/ms_deform_attn.cu`` and its plain version.

``value`` (B, S, H, D) holds the L levels' maps, of ``shapes`` ``[h_0, w_0,
h_1, w_1, ...]``, one after the other along S, row-major; ``locations``
(B, Lq, H, L, P, 2) are (x, y) in [0, 1] and ``weights`` (B, Lq, H, L, P)
the attention weights, softmaxed over a head's L * P points. The result
(B, Lq, H * D), in ``value``'s dtype, is for each query and head the
weighted sum of the value bilinearly sampled at its points, with
``F.grid_sample``'s semantics (``align_corners=False``, zero padding).

The plain version is the published ``deformable_attention_core_func``
(RT-DETR, ``rtdetr_pytorch/src/zoo/rtdetr/utils.py``): one ``grid_sample``
a level, a stack, a multiply and a sum. The kernel makes one launch and
accumulates in fp32, rounding once at the output; it replaces no TPU
kernel (the JAX package has no detection transformer).

The launch is the custom op ``prpe::ms_deform_attn`` (a fake implementation
gives its output's shape), so an exported program holds it as one node. Its
CPU implementation is the plain version; its CUDA implementation launches
the kernel, which takes a bf16 or fp32 ``value`` dense in (B, S, H, D)
order with heads of 64 or 128 bytes (RT-DETR's D 32 in bf16 or fp32), up
to ``MAX_LEVELS`` levels, and fp32 ``locations`` and ``weights`` dense in
their order, and raises ``ValueError`` for any other CUDA tensor. It is
inference only: a call that would record a gradient raises
``RuntimeError``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from prpe_tpu_torch.ops.kernels._build import INT, PTR, Library

LIBRARY = Library("ms_deform_attn", {f"prpe_msda_{dt}": [PTR] * 5 + [INT] * 8 + [PTR]
                                     for dt in ("f32", "bf16")}, routes=("msda",))
# most levels the kernel takes (``kMaxLevels``)
MAX_LEVELS = 8
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def ms_deform_attn_plain(value: torch.Tensor, shapes: Sequence[int], locations: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch in ``value``'s dtype (``locations`` and ``weights`` are
    cast to it): per level one ``F.grid_sample``, then the weighted sum."""
    b, _, heads, dim = value.shape
    _, len_q, _, levels, points, _ = locations.shape
    sizes = [shapes[2 * l] * shapes[2 * l + 1] for l in range(levels)]
    grids = 2 * locations.to(value.dtype) - 1
    sampled = []
    for l, v in enumerate(value.split(sizes, dim=1)):
        h, w = shapes[2 * l], shapes[2 * l + 1]
        v = v.flatten(2).permute(0, 2, 1).reshape(b * heads, dim, h, w)
        g = grids[:, :, :, l].permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    attn = weights.to(value.dtype).permute(0, 2, 1, 3, 4).reshape(b * heads, 1, len_q,
                                                                 levels * points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attn).sum(-1)
    return out.reshape(b, heads * dim, len_q).permute(0, 2, 1)


def _check(value: torch.Tensor, shapes: Sequence[int], locations: torch.Tensor,
           weights: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors."""
    if value.dtype not in _SUFFIX or value.dim() != 4 or not value.is_contiguous():
        raise ValueError(f"ms_deform_attn: the kernel takes a dense (B, S, H, D) bf16 or fp32 "
                         f"value, not {value.dtype} {tuple(value.shape)} strides {value.stride()}")
    b, s, heads, dim = value.shape
    if dim * value.element_size() not in (64, 128):
        raise ValueError(f"ms_deform_attn: heads of {dim} {value.dtype} values are not 64 or "
                         f"128 bytes")
    if locations.dim() != 6 or locations.shape[-1] != 2:
        raise ValueError(f"ms_deform_attn: locations {tuple(locations.shape)} are not "
                         f"(B, Lq, H, L, P, 2)")
    _, len_q, _, levels, points, _ = locations.shape
    if not 0 < levels <= MAX_LEVELS or len(shapes) != 2 * levels:
        raise ValueError(f"ms_deform_attn: {levels} levels (at most {MAX_LEVELS}) with "
                         f"shapes {list(shapes)}")
    if sum(shapes[2 * l] * shapes[2 * l + 1] for l in range(levels)) != s:
        raise ValueError(f"ms_deform_attn: the levels {list(shapes)} do not cover {s} positions")
    if tuple(locations.shape[:3]) != (b, len_q, heads) or \
            tuple(weights.shape) != (b, len_q, heads, levels, points):
        raise ValueError(f"ms_deform_attn: locations {tuple(locations.shape)} and weights "
                         f"{tuple(weights.shape)} do not fit value {tuple(value.shape)}")
    for name, t in (("locations", locations), ("weights", weights)):
        if t.dtype != torch.float32 or t.device != value.device or not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be dense fp32 on {value.device}, not "
                             f"{t.dtype} on {t.device} with strides {t.stride()}")
    if value.numel() >= 2**31 or locations.numel() >= 2**31:
        raise ValueError("ms_deform_attn: 2^31 elements or more")


def _launch(value, shapes, locations, weights) -> torch.Tensor:
    """Launch ``prpe_msda_<dtype>`` on CUDA tensors, checked first."""
    _check(value, shapes, locations, weights)
    b, s, heads, dim = value.shape
    _, len_q, _, levels, points, _ = locations.shape
    out = torch.empty(b, len_q, heads * dim, dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    levels_arg = (ctypes.c_int * len(shapes))(*shapes)
    LIBRARY.launch(f"prpe_msda_{_SUFFIX[value.dtype]}", LIBRARY.routes, value, value.data_ptr(),
                   locations.data_ptr(), weights.data_ptr(), out.data_ptr(),
                   ctypes.addressof(levels_arg), b, s, heads, dim, len_q, levels, points,
                   value.get_device())
    return out


@torch.library.custom_op("prpe::ms_deform_attn", mutates_args=(), device_types="cpu")
def _msda_op(value: torch.Tensor, shapes: List[int], locations: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    return ms_deform_attn_plain(value, shapes, locations, weights).contiguous()


@_msda_op.register_kernel("cuda")
def _(value, shapes, locations, weights):
    return _launch(value, shapes, locations, weights)


@_msda_op.register_fake
def _(value, shapes, locations, weights):
    b, _, heads, dim = value.shape
    return value.new_empty(b, locations.shape[1], heads * dim)


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[int], locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention of ``value`` at ``locations`` with ``weights``
    -> (B, Lq, H * D) in ``value``'s dtype. CUDA tensors launch the kernel
    (or raise where it does not take them, :func:`_check`); CPU tensors take
    the plain version. The op has no backward: a call that would record a
    gradient raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (value, locations, weights)):
        raise RuntimeError("prpe::ms_deform_attn is inference only: call it under "
                           "torch.no_grad or torch.inference_mode")
    return _msda_op(value, [int(n) for n in shapes], locations, weights)
