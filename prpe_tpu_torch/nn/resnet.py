"""ResNet trunks, NCHW inside.

``ResNetTrunk``, the combined model's (``prpe_tpu/nn/resnet.py``):
torchvision's v1.5 ResNet cut after ``layer4``: the stride sits in the
bottleneck's 3x3 conv, the convs carry no bias and BatchNorm uses eps 1e-5.
It takes NHWC images and returns the (B, H/32, W/32, 2048) features as an
NHWC view of NCHW memory, which the adapters take back without a copy.

``ResNetVD``, RT-DETR's backbone (``nn/rtdetr.py``): PResNet variant d
(He et al., "Bag of Tricks", arXiv:1812.01187; ``rtdetr_pytorch/src/nn/
backbone/presnet.py``), which the JAX package does not have. Its module
names are the published ones (``conv1.conv1_1.conv``, ``res_layers.1.
blocks.0.short.conv.norm`` ...). Every BatchNorm is eval-only (the
published one is frozen) and runs with the ReLU after it as one
``prpe::bn_act`` where no gradient is recorded; a bottleneck's last one
adds the shortcut in the same op.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List, Optional, Sequence

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


# ---- ResNet-50-vd (RT-DETR's PResNet, variant d) ------------------------------

class ConvNormLayer(nn.Module):
    """Bias-free conv (padding (k - 1) // 2) + BatchNorm (eps 1e-5) + ``act``
    (None, ``"relu"`` or ``"silu"``): RT-DETR's ``ConvNormLayer``."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1, act: Optional[str] = None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, s, (k - 1) // 2, bias=False)
        self.norm = BatchNorm(cout, _BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x), self.act)

    def add_act(self, x: torch.Tensor, residual: torch.Tensor, act: str) -> torch.Tensor:
        """``act(norm(conv x) + residual)``: the BatchNorm, the add and
        ``act`` one op where no gradient is recorded."""
        return self.norm(self.conv(x), act, residual)


class ShortcutD(nn.Module):
    """Variant d's shortcut of a strided block: 2x2 average pool
    (``ceil_mode``), then a 1x1 ConvNormLayer."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvNormLayer(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.avg_pool2d(x, 2, 2, 0, ceil_mode=True))


class BottleNeckD(nn.Module):
    """1x1 -> 3x3 carrying the stride -> 1x1 (4x width), each with its
    BatchNorm, ReLU after the first two; ``relu(main + shortcut)``, the
    last BatchNorm, the add and the ReLU in one op."""

    def __init__(self, cin: int, width: int, stride: int, shortcut: bool):
        super().__init__()
        self.branch2a = ConvNormLayer(cin, width, 1, 1, "relu")
        self.branch2b = ConvNormLayer(width, width, 3, stride, "relu")
        self.branch2c = ConvNormLayer(width, width * 4, 1, 1)
        self.shortcut = shortcut
        if not shortcut:
            self.short = (ShortcutD(cin, width * 4) if stride == 2
                          else ConvNormLayer(cin, width * 4, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short = x if self.shortcut else self.short(x)
        return self.branch2c.add_act(self.branch2b(self.branch2a(x)), short, "relu")


class Blocks(nn.Module):
    def __init__(self, cin: int, width: int, count: int, stage: int):
        super().__init__()
        self.blocks = nn.ModuleList()
        for i in range(count):
            self.blocks.append(BottleNeckD(cin, width, 2 if i == 0 and stage != 2 else 1,
                                           shortcut=i != 0))
            cin = width * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class ResNetVD(nn.Module):
    """ResNet-50-vd: the deep stem (three 3x3 ConvNormLayers with ReLU, 3 ->
    32 stride 2 -> 32 -> 64, then a 3x3 stride-2 max pool) and four
    bottleneck stages of 3, 4, 6 and 3 blocks, widths 64, 128, 256, 512.
    NHWC (B, H, W, 3) -> the last three stages' NCHW maps: C3 512 at H/8, C4
    1024 at H/16, C5 2048 at H/32."""

    out_channels = (512, 1024, 2048)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Sequential(OrderedDict([
            ("conv1_1", ConvNormLayer(3, 32, 3, 2, "relu")),
            ("conv1_2", ConvNormLayer(32, 32, 3, 1, "relu")),
            ("conv1_3", ConvNormLayer(32, 64, 3, 1, "relu")),
        ]))
        self.res_layers = nn.ModuleList()
        cin = 64
        for i, (count, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            self.res_layers.append(Blocks(cin, width, count, i + 2))
            cin = width * 4

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool(self.conv1(x.to(self.dtype).permute(0, 3, 1, 2)), 3, 2, 1)
        outs = []
        for i, stage in enumerate(self.res_layers):
            x = stage(x)
            if i > 0:
                outs.append(x)
        return outs
