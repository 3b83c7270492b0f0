"""YOLOv11 detector (``prpe_tpu/nn/yolo.py``): CSP-DarkNet backbone, PAN-FPN
neck and the decoupled DFL head, NCHW inside.

``YOLO`` takes NHWC images and returns the raw per-level maps as NHWC
(B, H, W, 4 * reg_max + nc), like the JAX model; :func:`decode_predictions`
turns them into cxcywh pixel boxes and sigmoid scores.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from prpe_tpu_torch.nn.common import Conv2d, ConvBN, max_pool, nearest_upsample
from prpe_tpu_torch.ops.anchors import dfl_decode, make_anchors

STRIDES = (8, 16, 32)

VARIANTS = {
    "n": dict(csp=(False, True), depth=(1, 1, 1, 1, 1, 1), width=(3, 16, 32, 64, 128, 256)),
    "t": dict(csp=(False, True), depth=(1, 1, 1, 1, 1, 1), width=(3, 24, 48, 96, 192, 384)),
    "s": dict(csp=(False, True), depth=(1, 1, 1, 1, 1, 1), width=(3, 32, 64, 128, 256, 512)),
    "m": dict(csp=(True, True), depth=(1, 1, 1, 1, 1, 1), width=(3, 64, 128, 256, 512, 512)),
    "l": dict(csp=(True, True), depth=(2, 2, 2, 2, 2, 2), width=(3, 64, 128, 256, 512, 512)),
    "x": dict(csp=(True, True), depth=(2, 2, 2, 2, 2, 2), width=(3, 96, 192, 384, 768, 768)),
}


class Residual(nn.Module):
    def __init__(self, ch: int, e: float = 0.5):
        super().__init__()
        mid = int(ch * e)
        self.conv1 = ConvBN(ch, mid, 3, p=1)
        self.conv2 = ConvBN(mid, ch, 3, p=1)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class CSPModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.conv1 = ConvBN(cin, half)
        self.res0 = Residual(half, e=1.0)
        self.res1 = Residual(half, e=1.0)
        self.conv2 = ConvBN(cin, half)
        self.conv3 = ConvBN(2 * half, cout)

    def forward(self, x):
        y = self.res1(self.res0(self.conv1(x)))
        return self.conv3(torch.cat([y, self.conv2(x)], dim=1))


class CSP(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, csp: bool, r: int):
        super().__init__()
        c = cout // r
        self.c = c
        self.n = n
        self.conv1 = ConvBN(cin, 2 * c)
        for i in range(n):
            self.add_module(f"m{i}", CSPModule(c, c) if csp else Residual(c))
        self.conv2 = ConvBN((2 + n) * c, cout)

    def forward(self, x):
        y = self.conv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.conv2(torch.cat(parts, dim=1))


class SPP(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        self.k = k
        self.conv1 = ConvBN(cin, cin // 2)
        self.conv2 = ConvBN(cin // 2 * 4, cout)

    def forward(self, x):
        x = self.conv1(x)
        y1 = max_pool(x, self.k, 1, self.k // 2)
        y2 = max_pool(y1, self.k, 1, self.k // 2)
        y3 = max_pool(y2, self.k, 1, self.k // 2)
        return self.conv2(torch.cat([x, y1, y2, y3], dim=1))


class Attention(nn.Module):
    """Spatial self-attention over H*W tokens plus a depthwise positional
    branch; per head the channels are [q(dk), k(dk), v(dh)]. Plain einsum and
    softmax: the JAX package has no kernel here."""

    def __init__(self, ch: int, num_head: int):
        super().__init__()
        self.num_head = num_head
        self.dh = ch // num_head
        self.dk = self.dh // 2
        self.qkv = ConvBN(ch, ch + self.dk * num_head * 2, act=False)
        self.pe = ConvBN(ch, ch, 3, p=1, groups=ch, act=False)
        self.proj = ConvBN(ch, ch, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, dk, dh = self.num_head, self.dk, self.dh
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, nh, 2 * dk + dh)
        q, k, v = qkv.split([dk, dk, dh], dim=-1)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dk ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        pos = self.pe(v.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return self.proj(out + pos)


class PSABlock(nn.Module):
    def __init__(self, ch: int, num_head: int):
        super().__init__()
        self.attn = Attention(ch, num_head)
        self.ffn1 = ConvBN(ch, ch * 2)
        self.ffn2 = ConvBN(ch * 2, ch, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class PSA(nn.Module):
    def __init__(self, ch: int, n: int):
        super().__init__()
        self.half = ch // 2
        self.n = n
        self.conv1 = ConvBN(ch, 2 * self.half)
        for i in range(n):
            self.add_module(f"blk{i}", PSABlock(self.half, max(1, ch // 128)))
        self.conv2 = ConvBN(2 * self.half, ch)

    def forward(self, x):
        y = self.conv1(x)
        a, bb = y[:, :self.half], y[:, self.half:]
        for i in range(self.n):
            bb = getattr(self, f"blk{i}")(bb)
        return self.conv2(torch.cat([a, bb], dim=1))


class DarkNet(nn.Module):
    def __init__(self, width: Sequence[int], depth: Sequence[int], csp: Sequence[bool]):
        super().__init__()
        w, d, c = width, depth, csp
        self.p1_conv = ConvBN(w[0], w[1], 3, 2, 1)
        self.p2_conv = ConvBN(w[1], w[2], 3, 2, 1)
        self.p2_csp = CSP(w[2], w[3], d[0], c[0], r=4)
        self.p3_conv = ConvBN(w[3], w[3], 3, 2, 1)
        self.p3_csp = CSP(w[3], w[4], d[1], c[0], r=4)
        self.p4_conv = ConvBN(w[4], w[4], 3, 2, 1)
        self.p4_csp = CSP(w[4], w[4], d[2], c[1], r=2)
        self.p5_conv = ConvBN(w[4], w[5], 3, 2, 1)
        self.p5_csp = CSP(w[5], w[5], d[3], c[1], r=2)
        self.p5_spp = SPP(w[5], w[5])
        self.p5_psa = PSA(w[5], d[4])

    def forward(self, x):
        x = self.p2_csp(self.p2_conv(self.p1_conv(x)))
        p3 = self.p3_csp(self.p3_conv(x))
        p4 = self.p4_csp(self.p4_conv(p3))
        x = self.p5_spp(self.p5_csp(self.p5_conv(p4)))
        return p3, p4, self.p5_psa(x)


class DarkFPN(nn.Module):
    def __init__(self, width: Sequence[int], depth: Sequence[int], csp: Sequence[bool]):
        super().__init__()
        w, d, c = width, depth, csp
        self.h1 = CSP(w[5] + w[4], w[4], d[5], c[0], r=2)
        self.h2 = CSP(w[4] + w[4], w[3], d[5], c[0], r=2)
        self.h3 = ConvBN(w[3], w[3], 3, 2, 1)
        self.h4 = CSP(w[3] + w[4], w[4], d[5], c[0], r=2)
        self.h5 = ConvBN(w[4], w[4], 3, 2, 1)
        self.h6 = CSP(w[4] + w[5], w[5], d[5], c[1], r=2)

    def forward(self, feats):
        p3, p4, p5 = feats
        p4 = self.h1(torch.cat([nearest_upsample(p5), p4], dim=1))
        p3 = self.h2(torch.cat([nearest_upsample(p4), p3], dim=1))
        p4 = self.h4(torch.cat([self.h3(p3), p4], dim=1))
        p5 = self.h6(torch.cat([self.h5(p4), p5], dim=1))
        return p3, p4, p5


class Head(nn.Module):
    """Decoupled box (DFL) / class head; raw NCHW maps per level."""

    def __init__(self, nc: int, filters: Sequence[int], reg_max: int = 16):
        super().__init__()
        self.nc = nc
        box_ch = max(64, filters[0] // 4)
        cls_ch = max(80, filters[0], nc)
        for i, f in enumerate(filters):
            self.add_module(f"box{i}_0", ConvBN(f, box_ch, 3, p=1))
            self.add_module(f"box{i}_1", ConvBN(box_ch, box_ch, 3, p=1))
            self.add_module(f"box{i}_out", Conv2d(box_ch, 4 * reg_max, 1))
            self.add_module(f"cls{i}_0", ConvBN(f, f, 3, p=1, groups=f))
            self.add_module(f"cls{i}_1", ConvBN(f, cls_ch))
            self.add_module(f"cls{i}_2", ConvBN(cls_ch, cls_ch, 3, p=1, groups=cls_ch))
            self.add_module(f"cls{i}_3", ConvBN(cls_ch, cls_ch))
            self.add_module(f"cls{i}_out", Conv2d(cls_ch, nc, 1))
        self.levels = len(filters)

    def _init_extra(self, generator: torch.Generator) -> None:
        # box bias ones; class bias log(5 / nc / (640 / stride)^2)
        for i, stride in zip(range(self.levels), STRIDES):
            getattr(self, f"box{i}_out").bias.fill_(1.0)
            getattr(self, f"cls{i}_out").bias.fill_(math.log(5.0 / self.nc / (640.0 / stride) ** 2))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            b = x
            for name in ("0", "1", "out"):
                b = getattr(self, f"box{i}_{name}")(b)
            c = x
            for name in ("0", "1", "2", "3", "out"):
                c = getattr(self, f"cls{i}_{name}")(c)
            outs.append(torch.cat([b, c], dim=1))
        return outs


class YOLO(nn.Module):
    """Full detector: NHWC images -> list of NHWC raw maps per level."""

    def __init__(self, nc: int = 80, variant: str = "n", dtype: torch.dtype = torch.float32):
        super().__init__()
        spec = VARIANTS[variant]
        w, d, c = spec["width"], spec["depth"], spec["csp"]
        self.dtype = dtype
        self.net = DarkNet(w, d, c)
        self.fpn = DarkFPN(w, d, c)
        self.head = Head(nc, (w[3], w[4], w[5]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        outs = self.head(list(self.fpn(self.net(x))))
        return [o.permute(0, 2, 3, 1) for o in outs]


def decode_predictions(level_outputs: Sequence[torch.Tensor], nc: int, reg_max: int = 16,
                       strides: Sequence[int] = STRIDES) -> torch.Tensor:
    """Eval-mode decode of NHWC level maps -> (B, A, 4 + nc): cxcywh pixel
    boxes followed by sigmoid scores."""
    b = level_outputs[0].shape[0]
    no = 4 * reg_max + nc
    level_hw = [tuple(x.shape[1:3]) for x in level_outputs]
    x = torch.cat([o.reshape(b, -1, no) for o in level_outputs], dim=1)
    anchor_points, stride_tensor = make_anchors(level_hw, strides, dtype=x.dtype, device=x.device)
    boxes_xyxy = dfl_decode(x[..., :4 * reg_max], anchor_points, reg_max)
    x1y1, x2y2 = boxes_xyxy[..., :2], boxes_xyxy[..., 2:]
    boxes = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * stride_tensor
    scores = torch.sigmoid(x[..., 4 * reg_max:])
    return torch.cat([boxes, scores], dim=-1)
