"""ViTPose (``prpe_tpu/nn/vit.py``).

ViT-B/16 over 256x192 crops: patch-embed conv (k = s = 16, padding 2), one
folded (P, C) positional table, pre-LN blocks, then the simple decoder
(ReLU -> bilinear x4 -> 3x3 conv) or the classic one (two transposed convs
as flax computes them, then a 1x1 conv). ``ViTPose`` takes NHWC crops and
returns heatmaps (B, K, H, W).

The attention of every block follows ``PRPE_ATTN_MODE``, read at forward
time as the JAX package reads it at trace time (:func:`attn_mode`):

- ``pallas_packed`` (default): the packed kernel over (B, T, C), no
  transposes (``mhsa_packed``);
- ``pallas``, ``pallas_unrolled``, ``pallas_bh`` and any other
  ``pallas_<x>``: the (B, H, T, D) kernel (``mhsa_bhtd``), with the
  transposes around it that these modes pay in the JAX package;
- ``pallas_lnfused``: the whole LN -> q/k/v -> attention -> proj ->
  residual half-block in one kernel (``fused_ln_mhsa``) in eval mode; in
  train mode the module path, whose attention is then the (B, H, T, D)
  kernel, as the JAX package's training forward takes;
- ``einsum_bf16sm``: plain matmuls, softmax in the activation dtype;
- anything else: plain matmuls, fp32 softmax cast back.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prpe_tpu_torch.nn.common import (
    BatchNorm, Conv2d, LayerNorm, Linear, bilinear_resize, fast_gelu,
)
from prpe_tpu_torch.ops.kernels.attention import mhsa_bhtd, mhsa_packed
from prpe_tpu_torch.ops.kernels.ln_mhsa import fused_ln_mhsa

_LN_EPS = 1e-12


def attn_mode() -> str:
    """``PRPE_ATTN_MODE`` (default ``pallas_packed``); the legacy
    ``PRPE_FUSED_ATTENTION=1`` means ``pallas_unrolled`` when the mode is
    unset."""
    mode = os.environ.get("PRPE_ATTN_MODE", "pallas_packed")
    if os.environ.get("PRPE_FUSED_ATTENTION") == "1" and "PRPE_ATTN_MODE" not in os.environ:
        mode = "pallas_unrolled"
    return mode


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     softmax_in_input_dtype: bool) -> torch.Tensor:
    """The JAX package's einsum path over packed (B, T, H*D) tensors, with
    its roundings: logits from a matmul in the input dtype, scaled by
    d^-1/2 rounded to that dtype; then either an fp32 softmax cast back, or
    ``jax.nn.softmax`` step by step in the input dtype (max, exp, fp32 sum
    rounded back, divide); P V in the input dtype."""
    b, t, c = q.shape
    d = c // heads
    split = lambda x: x.view(b, t, heads, d).transpose(1, 2)  # noqa: E731
    scale = torch.tensor(d ** -0.5, dtype=q.dtype).item()
    s = (split(q) @ split(k).transpose(-1, -2)) * scale
    if softmax_in_input_dtype:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.float().sum(-1, keepdim=True).to(e.dtype)
    else:
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return (p @ split(v)).transpose(1, 2).reshape(b, t, c)


class MHSA(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = Linear(hidden, hidden)
        self.k = Linear(hidden, hidden)
        self.v = Linear(hidden, hidden)
        self.proj = Linear(hidden, hidden)

    def forward(self, x):
        b, t, c = x.shape
        q, k, v = self.q(x), self.k(x), self.v(x)
        mode = attn_mode()
        if not mode.startswith("pallas"):
            out = einsum_attention(q, k, v, self.heads, mode == "einsum_bf16sm")
        elif (mode[len("pallas_"):] or "batched") == "packed":
            out = mhsa_packed(q, k, v, self.heads)
        else:
            def heads(y):  # (B, T, C) -> contiguous (B, H, T, D)
                return y.view(b, t, self.heads, -1).transpose(1, 2).contiguous()

            out = mhsa_bhtd(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(b, t, c)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = LayerNorm(hidden, eps=_LN_EPS)
        self.attn = MHSA(hidden, heads)
        self.ln2 = LayerNorm(hidden, eps=_LN_EPS)
        self.fc1 = Linear(hidden, hidden * mlp_ratio)
        self.fc2 = Linear(hidden * mlp_ratio, hidden)

    def forward(self, x):
        if attn_mode() == "pallas_lnfused" and not self.training:
            # the fused half-block has no backward: inference only, as in
            # the JAX package; a training forward takes the module path
            a = self.attn
            x = fused_ln_mhsa(x, self.ln1.weight, self.ln1.bias, a.q.weight,
                              a.q.bias, a.k.weight, a.k.bias, a.v.weight, a.v.bias,
                              a.proj.weight, a.proj.bias, a.heads, self.ln1.eps)
        else:
            x = x + self.attn(self.ln1(x))
        return x + self.fc2(fast_gelu(self.fc1(self.ln2(x))))


class ViTPoseBackbone(nn.Module):
    """ViT encoder -> (B, hidden, H/16, W/16) feature map."""

    def __init__(self, image_size: Tuple[int, int] = (256, 192), patch_size: int = 16,
                 hidden: int = 768, layers: int = 12, heads: int = 12, mlp_ratio: int = 4):
        super().__init__()
        h, w = image_size
        self.grid = ((h + 4 - patch_size) // patch_size + 1, (w + 4 - patch_size) // patch_size + 1)
        self.patch_embed = Conv2d(3, hidden, patch_size, patch_size, 2)
        self.pos_embed = nn.Parameter(torch.empty(self.grid[0] * self.grid[1], hidden))
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block{i}", ViTBlock(hidden, heads, mlp_ratio))
        self.ln_final = LayerNorm(hidden, eps=_LN_EPS)

    def _init_extra(self, generator: torch.Generator) -> None:
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed(x)  # (B, C, gh, gw)
        b, c, gh, gw = x.shape
        # tokens contiguous in (B, T, C): from channels-first crops the
        # transposed view would carry its layout through every residual add
        # (a copy before each LayerNorm and GEMM), and the kernels take
        # contiguous tensors only
        x = x.flatten(2).transpose(1, 2).contiguous() + self.pos_embed.to(x.dtype)[None]
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x)
        return x.transpose(1, 2).reshape(b, c, gh, gw)


class SimpleDecoder(nn.Module):
    """ReLU -> bilinear x``scale`` (align_corners=False) -> 3x3 conv."""

    def __init__(self, hidden: int, num_keypoints: int = 17, scale_factor: int = 4):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = Conv2d(hidden, num_keypoints, 3, 1, 1)

    def forward(self, x):
        x = F.relu(x)
        _, _, h, w = x.shape
        x = bilinear_resize(x, (h * self.scale_factor, w * self.scale_factor), align_corners=False)
        return self.conv(x)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``ConvTranspose(features, (k, k), strides=(s, s), padding=[(p, p),
    (p, p)])``: ``lax.conv_transpose`` with explicit padding and an unflipped
    kernel, i.e. a stride-1 convolution over the input dilated by ``s``
    with ``p`` on each side (output ``s * (n - 1) + 2p - k + 2``).

    The same map is ``F.conv_transpose2d`` with padding ``k - 1 - p`` and
    the weight spatially flipped with input and output swapped; the weight
    here is held in that (in, out, k, k) layout (the bridge flips the flax
    kernel) and cast to the input dtype, as ``Conv2d`` does.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, padding: int):
        super().__init__(cin, cout, kernel, stride, kernel - 1 - padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class ClassicDecoder(nn.Module):
    """2x (deconv 4x4 / 2 + BatchNorm + ReLU) -> 1x1 conv: (h, w) features
    -> (4h - 6, 4w - 6) heatmaps (16x12 -> 30x22 -> 58x42)."""

    def __init__(self, hidden: int, num_keypoints: int = 17):
        super().__init__()
        self.deconv0 = ConvTranspose(hidden, 256, 4, 2, 1)
        self.bn0 = BatchNorm(256, 1e-5)
        self.deconv1 = ConvTranspose(256, 256, 4, 2, 1)
        self.bn1 = BatchNorm(256, 1e-5)
        self.conv = Conv2d(256, num_keypoints, 1)

    def forward(self, x):
        x = F.relu(self.bn0(self.deconv0(x)))
        x = F.relu(self.bn1(self.deconv1(x)))
        return self.conv(x)


class ViTPose(nn.Module):
    """Backbone + decoder (``"simple"`` or ``"classic"``): NHWC crops ->
    heatmaps (B, K, H, W)."""

    def __init__(self, image_size: Tuple[int, int] = (256, 192), num_keypoints: int = 17,
                 hidden: int = 768, layers: int = 12, heads: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 16, scale_factor: int = 4, dtype: torch.dtype = torch.float32,
                 decoder: str = "simple"):
        super().__init__()
        self.dtype = dtype
        self.backbone = ViTPoseBackbone(image_size, patch_size, hidden, layers, heads, mlp_ratio)
        if decoder == "simple":
            self.head = SimpleDecoder(hidden, num_keypoints, scale_factor)
        else:  # as the JAX package: anything but "simple" is the classic one
            self.head = ClassicDecoder(hidden, num_keypoints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.head(self.backbone(x))
