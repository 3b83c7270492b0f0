"""Adapters from the shared trunk's features to each task branch
(``prpe_tpu/nn/adapters.py``), NCHW inside.

Each adapter takes the trunk's NHWC (B, h, w, 2048) features, reduces them
with a 1x1 conv, resizes bilinearly with ``align_corners=True`` to its
branch's input size, narrows the channels with conv + BatchNorm +
activation stages, and returns an NHWC view for the branch model:

* ``YoloAdapter``: SiLU stages down to a 3-channel (B, 160, 160, 3)
  pseudo-image, standardised per image and channel with the population std,
  then a sigmoid;
* ``AdaFaceAdapter``: per-channel PReLU stages down to (B, 112, 112, 64);
* ``VitPoseAdapter``: GELU stages (``fast_gelu``) down to (B, 256, 192, 3).

Unlike the trunk's, the adapters' convs carry a bias.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from prpe_tpu_torch.nn.common import BatchNorm, Conv2d, PReLU, bilinear_resize, fast_gelu


class _ConvBNAct(nn.Module):
    """Conv (k x k, 'same' padding, with bias) + BatchNorm (eps 1e-5) + act."""

    def __init__(self, cin: int, cout: int, kernel: int, act: str):
        super().__init__()
        if act not in ("silu", "gelu", "prelu"):
            raise ValueError(act)
        self.act = act
        self.conv = Conv2d(cin, cout, kernel, 1, kernel // 2, bias=True)
        self.bn = BatchNorm(cout, 1e-5)
        self.prelu = PReLU(cout) if act == "prelu" else None

    def forward(self, x):
        x = self.conv(x)
        if self.act == "gelu":
            return fast_gelu(self.bn(x))
        return self.bn(x, self.prelu if self.act == "prelu" else "silu")


class _Adapter(nn.Module):
    """reduce (1x1, 2048 -> 512) -> resize to ``target_size`` -> the
    ``stages`` (name, cout, kernel) in order, all with activation ``act``."""

    def __init__(self, target_size: Tuple[int, int], act: str,
                 stages: Sequence[Tuple[str, int, int]], cin: int = 2048):
        super().__init__()
        self.target_size = tuple(target_size)
        self.reduce = _ConvBNAct(cin, 512, 1, act)
        self.stages = [name for name, _, _ in stages]
        c = 512
        for name, cout, kernel in stages:
            self.add_module(name, _ConvBNAct(c, cout, kernel, act))
            c = cout

    def adapt(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC features -> NCHW branch input."""
        x = self.reduce(x.permute(0, 3, 1, 2))
        x = bilinear_resize(x, self.target_size, align_corners=True)
        for name in self.stages:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.adapt(x).permute(0, 2, 3, 1)


class YoloAdapter(_Adapter):
    """2048-channel features -> (B, 160, 160, 3) standardised pseudo-image."""

    def __init__(self, target_size: Tuple[int, int] = (160, 160)):
        super().__init__(target_size, "silu", (("spatial", 512, 3), ("down1", 256, 1),
                                               ("down2", 128, 3), ("down3", 64, 1),
                                               ("out", 3, 3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.adapt(x)
        # per image and channel: subtract the mean, divide by the population
        # std (ddof 0, as jnp.std) plus 1e-6
        mean = x.mean((2, 3), keepdim=True)
        std = torch.std(x, dim=(2, 3), correction=0, keepdim=True)
        return torch.sigmoid((x - mean) / (std + 1e-6)).permute(0, 2, 3, 1)


class AdaFaceAdapter(_Adapter):
    """2048-channel features -> (B, 112, 112, 64) face-branch input."""

    def __init__(self, target_size: Tuple[int, int] = (112, 112)):
        super().__init__(target_size, "prelu", (("down1", 256, 3), ("down2", 128, 3),
                                                ("out", 64, 3)))


class VitPoseAdapter(_Adapter):
    """2048-channel features -> (B, 256, 192, 3) pose-branch input."""

    def __init__(self, target_size: Tuple[int, int] = (256, 192)):
        super().__init__(target_size, "gelu", (("down1", 256, 3), ("down2", 128, 3),
                                               ("out", 3, 3)))
