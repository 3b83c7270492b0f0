"""ViTPose with the simple decoder (``prpe_tpu/nn/vit.py``).

ViT-B/16 over 256x192 crops: patch-embed conv (k = s = 16, padding 2), one
folded (P, C) positional table, pre-LN blocks whose attention runs through
the packed MHSA kernel in the natural (B, T, C) layout, then ReLU ->
bilinear x4 -> 3x3 conv. ``ViTPose`` takes NHWC crops and returns heatmaps
(B, K, H, W).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prpe_tpu_torch.nn.common import Conv2d, LayerNorm, Linear, bilinear_resize, fast_gelu
from prpe_tpu_torch.ops.kernels.attention import mhsa_packed

_LN_EPS = 1e-12


class MHSA(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = Linear(hidden, hidden)
        self.k = Linear(hidden, hidden)
        self.v = Linear(hidden, hidden)
        self.proj = Linear(hidden, hidden)

    def forward(self, x):
        out = mhsa_packed(self.q(x), self.k(x), self.v(x), self.heads)
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
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.to(x.dtype)[None]
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


class ViTPose(nn.Module):
    """Backbone + simple decoder: NHWC crops -> heatmaps (B, K, H, W)."""

    def __init__(self, image_size: Tuple[int, int] = (256, 192), num_keypoints: int = 17,
                 hidden: int = 768, layers: int = 12, heads: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 16, scale_factor: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ViTPoseBackbone(image_size, patch_size, hidden, layers, heads, mlp_ratio)
        self.head = SimpleDecoder(hidden, num_keypoints, scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.head(self.backbone(x))
