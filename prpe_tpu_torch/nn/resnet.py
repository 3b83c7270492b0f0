"""ResNet trunk of the combined model (``prpe_tpu/nn/resnet.py``), NCHW inside.

torchvision's v1.5 ResNet cut after ``layer4``: the stride sits in the
bottleneck's 3x3 conv, the convs carry no bias and BatchNorm uses eps 1e-5.
``ResNetTrunk`` takes NHWC images and returns the (B, H/32, W/32, 2048)
features as an NHWC view of NCHW memory, which the adapters take back
without a copy.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from prpe_tpu_torch.nn.common import BatchNorm, Conv2d, max_pool

_BN_EPS = 1e-5


class Bottleneck(nn.Module):
    """1x1 -> strided 3x3 -> 1x1 (4x width) + shortcut, then ReLU."""

    def __init__(self, cin: int, features: int, strides: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features, _BN_EPS)
        self.conv2 = Conv2d(features, features, 3, strides, 1, bias=False)
        self.bn2 = BatchNorm(features, _BN_EPS)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4, _BN_EPS)
        if downsample:
            self.downsample_conv = Conv2d(cin, features * 4, 1, strides, bias=False)
            self.downsample_bn = BatchNorm(features * 4, _BN_EPS)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + shortcut)


@contextlib.contextmanager
def _stats_frozen(block: nn.Module):
    """The BatchNorms of ``block`` keep their running statistics inside."""
    bns = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.freeze_stats = False


class ResNetTrunk(nn.Module):
    """conv1 .. layer4, no pooling head: NHWC (B, H, W, 3) -> NHWC
    (B, H/32, W/32, 2048).

    ``remat`` recomputes each bottleneck block on the backward pass
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` per block in the JAX
    package) when the trunk trains; the recomputation holds the running
    BatchNorm statistics, so they move once a step, as in JAX. A forward
    with no trainable trunk parameter ignores it."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, _BN_EPS)
        self.blocks = []
        cin, features = 64, 64
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(cin, features, 2 if (stage > 0 and block == 0) else 1,
                                                 downsample=block == 0))
                self.blocks.append(name)
                cin = features * 4
            features *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        remat = (self.remat and self.training and torch.is_grad_enabled()
                 and any(p.requires_grad for p in self.parameters()))
        for name in self.blocks:
            block = getattr(self, name)
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=lambda b=block: (contextlib.nullcontext(), _stats_frozen(b)))
            else:
                x = block(x)
        return x.permute(0, 2, 3, 1)
