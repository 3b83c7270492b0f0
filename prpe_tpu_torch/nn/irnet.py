"""IR-Net face-embedding backbones (``prpe_tpu/nn/irnet.py``), NCHW inside.

``IRNet`` takes NHWC crops and returns ``(embedding, norm)``: the
L2-normalised embedding and the fp32 pre-normalisation norm. Depths 18 to
100 stack ``BasicBlockIR``, 152 and 200 ``BottleneckIR`` (2048 output
channels); ``mode="ir_se"`` adds a squeeze-excitation block to each unit.
``input_channels`` is 3 for face crops and 64 in the combined model, whose
adapter feeds the face branch. In train mode a ``Dropout(0.4)`` acts after
the output BatchNorm. The output linear reads the NCHW flatten
order (c, h, w); the weight bridge permutes the JAX model's (h, w, c) rows
to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prpe_tpu_torch.nn.common import BatchNorm, Conv2d, Dropout, Linear, PReLU

_BN_EPS = 1e-5

# (depth, num_units) per stage, keyed by num_layers
_BLOCKS = {
    18: ((64, 2), (128, 2), (256, 2), (512, 2)),
    34: ((64, 3), (128, 4), (256, 6), (512, 3)),
    50: ((64, 3), (128, 4), (256, 14), (512, 3)),
    100: ((64, 3), (128, 13), (256, 30), (512, 3)),
    152: ((256, 3), (512, 8), (1024, 36), (2048, 3)),
    200: ((256, 3), (512, 24), (1024, 36), (2048, 3)),
}


class SEModule(nn.Module):
    """Squeeze-excitation: x * sigmoid(fc2(relu(fc1(mean_hw(x)))))."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _IRUnit(nn.Module):
    """The shortcut shared by both unit kinds: a strided subsample when the
    width is kept, else a strided 1x1 conv + BatchNorm."""

    def __init__(self, cin: int, depth: int, stride: int, use_se: bool):
        super().__init__()
        self.stride = stride
        if cin != depth:
            self.shortcut_conv = Conv2d(cin, depth, 1, stride, bias=False)
            self.shortcut_bn = BatchNorm(depth, _BN_EPS)
        else:
            self.shortcut_conv = None
        self.se = SEModule(depth) if use_se else None

    def shortcut(self, x):
        if self.shortcut_conv is None:
            # MaxPool2d(1, stride) == strided subsample
            return x[:, :, ::self.stride, ::self.stride]
        return self.shortcut_bn(self.shortcut_conv(x))

    def finish(self, r, x):
        if self.se is not None:
            r = self.se(r)
        return r + self.shortcut(x)


class BasicBlockIR(_IRUnit):
    def __init__(self, cin: int, depth: int, stride: int, use_se: bool = False):
        super().__init__(cin, depth, stride, use_se)
        self.bn0 = BatchNorm(cin, _BN_EPS)
        self.conv1 = Conv2d(cin, depth, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(depth, _BN_EPS)
        self.prelu = PReLU(depth)
        self.conv2 = Conv2d(depth, depth, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(depth, _BN_EPS)

    def forward(self, x):
        r = self.conv1(self.bn0(x))
        r = self.conv2(self.bn1(r, self.prelu))
        return self.finish(self.bn2(r), x)


class BottleneckIR(_IRUnit):
    """1x1 -> 3x3 -> strided 1x1 at a quarter of the output width."""

    def __init__(self, cin: int, depth: int, stride: int, use_se: bool = False):
        super().__init__(cin, depth, stride, use_se)
        mid = depth // 4
        self.bn0 = BatchNorm(cin, _BN_EPS)
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid, _BN_EPS)
        self.prelu1 = PReLU(mid)
        self.conv2 = Conv2d(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(mid, _BN_EPS)
        self.prelu2 = PReLU(mid)
        self.conv3 = Conv2d(mid, depth, 1, stride, bias=False)
        self.bn3 = BatchNorm(depth, _BN_EPS)

    def forward(self, x):
        r = self.bn1(self.conv1(self.bn0(x)), self.prelu1)
        r = self.bn2(self.conv2(r), self.prelu2)
        return self.finish(self.bn3(self.conv3(r)), x)


class IRNet(nn.Module):
    """IR / IR-SE backbone -> (embedding (B, E), norm (B, 1) fp32)."""

    def __init__(self, num_layers: int = 50, input_size: int = 112,
                 embedding_size: int = 512, dtype: torch.dtype = torch.float32,
                 mode: str = "ir", input_channels: int = 3, dropout_rate: float = 0.4):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"IRNet mode {mode!r} is not 'ir' or 'ir_se'")
        self.dtype = dtype
        self.num_layers, self.mode = num_layers, mode
        self.input_conv = Conv2d(input_channels, 64, 3, 1, 1, bias=False)
        self.input_bn = BatchNorm(64, _BN_EPS)
        self.input_prelu = PReLU(64)
        block = BasicBlockIR if num_layers <= 100 else BottleneckIR
        cin = 64
        blocks = []
        for depth, num_units in _BLOCKS[num_layers]:
            for u in range(num_units):
                blocks.append(block(cin, depth, 2 if u == 0 else 1, mode == "ir_se"))
                cin = depth
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"body{i}", blk)
        spatial = input_size // 16
        self.output_bn = BatchNorm(cin, _BN_EPS)
        self.dropout = Dropout(dropout_rate)
        self.output_linear = Linear(cin * spatial * spatial, embedding_size)
        self.output_bn1d = BatchNorm(embedding_size, _BN_EPS, affine=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.input_bn(self.input_conv(x), self.input_prelu)
        for i in range(self.n_blocks):
            x = getattr(self, f"body{i}")(x)
        x = self.dropout(self.output_bn(x)).flatten(1)  # (c, h, w) order
        x = self.output_bn1d(self.output_linear(x))
        # the norm in fp32 at least (a float64 model's in float64)
        norm = torch.linalg.vector_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                                        dim=1, keepdim=True).clamp(min=1e-12)
        return x / norm.to(x.dtype), norm


def build_irnet(name: str = "ir_50", **kw) -> IRNet:
    """``ir_<depth>`` / ``ir_se_<depth>`` -> IRNet (``ir_101`` is depth 100)."""
    parts = name.split("_")
    num_layers = int(parts[-1])
    if num_layers == 101:
        num_layers = 100
    return IRNet(num_layers=num_layers, mode="ir_se" if "se" in parts else "ir", **kw)
