"""ViTPose-B with the simple decoder in plain fp32 torch.

Written from the published model (arXiv:2204.12484; the geometry of
usyd-community/vitpose-base-simple): a 16x16 patch embedding with padding 2
over 256x192 crops (a 16x12 grid), one learned positional table, pre-LN
blocks (LayerNorm eps 1e-12, separate q, k and v projections, softmax
attention with scale d^-1/2, exact GELU MLP), a final LayerNorm, then ReLU,
bilinear x4 (align_corners=False) and a 3x3 convolution to 17 heatmaps.

The parameter names are chosen to equal the program's (``backbone.block<i>.
attn.q.weight`` ...), so its key map is the identity. Inputs are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import lowp


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, t, c = x.shape
        split = lambda y: lowp(y, self).view(b, t, self.heads, -1).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        p = torch.softmax(q @ k.transpose(-1, -2) * (c // self.heads) ** -0.5, dim=-1)
        return self.proj((lowp(p, self) @ v).transpose(1, 2).reshape(b, t, c))


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=1e-12)
        self.attn = Attention(hidden, heads)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-12)
        self.fc1 = nn.Linear(hidden, hidden * mlp_ratio)
        self.fc2 = nn.Linear(hidden * mlp_ratio, hidden)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class Backbone(nn.Module):
    def __init__(self, image_size, patch: int, hidden: int, layers: int, heads: int,
                 mlp_ratio: int):
        super().__init__()
        gh = (image_size[0] + 4 - patch) // patch + 1
        gw = (image_size[1] + 4 - patch) // patch + 1
        self.patch_embed = nn.Conv2d(3, hidden, patch, patch, 2)
        self.pos_embed = nn.Parameter(torch.zeros(gh * gw, hidden))
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block{i}", Block(hidden, heads, mlp_ratio))
        self.ln_final = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x):
        x = self.patch_embed(x)
        b, c, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2) + self.pos_embed[None]
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        return self.ln_final(x).transpose(1, 2).reshape(b, c, gh, gw)


class Head(nn.Module):
    def __init__(self, hidden: int, keypoints: int, scale: int):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(hidden, keypoints, 3, 1, 1)

    def forward(self, x):
        x = F.interpolate(F.relu(x), scale_factor=self.scale, mode="bilinear",
                          align_corners=False)
        return self.conv(x)


class ViTPose(nn.Module):
    """NCHW crops (B, 3, 256, 192) -> heatmaps (B, 17, 64, 48)."""

    def __init__(self, image_size=(256, 192), keypoints: int = 17, hidden: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: int = 4, patch: int = 16,
                 scale: int = 4):
        super().__init__()
        self.backbone = Backbone(image_size, patch, hidden, layers, heads, mlp_ratio)
        self.head = Head(hidden, keypoints, scale)

    def forward(self, x):
        return self.head(self.backbone(x))
