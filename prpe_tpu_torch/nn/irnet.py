"""IR-Net face-embedding backbone (``prpe_tpu/nn/irnet.py``), NCHW inside.

``IRNet`` takes NHWC crops and returns ``(embedding, norm)``: the
L2-normalised 512-d embedding and the fp32 pre-normalisation norm. The
output linear reads the NCHW flatten order (c, h, w); the weight bridge
permutes the JAX model's (h, w, c) rows to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from prpe_tpu_torch.nn.common import BatchNorm, Conv2d, Linear, PReLU

_BN_EPS = 1e-5

# (depth, num_units) per stage, keyed by num_layers
_BLOCKS = {
    18: ((64, 2), (128, 2), (256, 2), (512, 2)),
    34: ((64, 3), (128, 4), (256, 6), (512, 3)),
    50: ((64, 3), (128, 4), (256, 14), (512, 3)),
    100: ((64, 3), (128, 13), (256, 30), (512, 3)),
}


class BasicBlockIR(nn.Module):
    def __init__(self, cin: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if cin != depth:
            self.shortcut_conv = Conv2d(cin, depth, 1, stride, bias=False)
            self.shortcut_bn = BatchNorm(depth, _BN_EPS)
        else:
            self.shortcut_conv = None
        self.bn0 = BatchNorm(cin, _BN_EPS)
        self.conv1 = Conv2d(cin, depth, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(depth, _BN_EPS)
        self.prelu = PReLU(depth)
        self.conv2 = Conv2d(depth, depth, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(depth, _BN_EPS)

    def forward(self, x):
        if self.shortcut_conv is None:
            # MaxPool2d(1, stride) == strided subsample
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        r = self.conv1(self.bn0(x))
        r = self.conv2(self.prelu(self.bn1(r)))
        return self.bn2(r) + shortcut


class IRNet(nn.Module):
    """IR backbone -> (embedding (B, 512), norm (B, 1) fp32)."""

    def __init__(self, num_layers: int = 50, input_size: int = 112,
                 embedding_size: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.input_conv = Conv2d(3, 64, 3, 1, 1, bias=False)
        self.input_bn = BatchNorm(64, _BN_EPS)
        self.input_prelu = PReLU(64)
        cin = 64
        blocks = []
        for depth, num_units in _BLOCKS[num_layers]:
            for u in range(num_units):
                blocks.append(BasicBlockIR(cin, depth, 2 if u == 0 else 1))
                cin = depth
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"body{i}", blk)
        spatial = input_size // 16
        self.output_bn = BatchNorm(cin, _BN_EPS)
        self.output_linear = Linear(cin * spatial * spatial, embedding_size)
        self.output_bn1d = BatchNorm(embedding_size, _BN_EPS, affine=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.input_prelu(self.input_bn(self.input_conv(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"body{i}")(x)
        x = self.output_bn(x).flatten(1)  # (c, h, w) order
        x = self.output_bn1d(self.output_linear(x))
        norm = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True).clamp(min=1e-12)
        return x / norm.to(x.dtype), norm
