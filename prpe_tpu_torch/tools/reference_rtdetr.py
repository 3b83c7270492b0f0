"""RT-DETR-R50's eval forward as plain torch modules in fp32: the yardstick
that the port's ``nn/rtdetr.py`` and its deformable-attention kernel are
held against.

Written from the published code (github.com/lyuwenyu/RT-DETR,
``rtdetr_pytorch/src/nn/backbone/presnet.py``, ``src/zoo/rtdetr/
hybrid_encoder.py``, ``rtdetr_decoder.py``, ``utils.py``, configuration
``configs/rtdetr/rtdetr_r50vd_6x_coco.yml``) and the paper (Zhao et al.,
arXiv:2304.08069): ResNet-50-vd, the hybrid encoder (AIFI and CCFM), the
anchors, the query selection, the six decoder layers and their heads. The
deformable attention is the published ``deformable_attention_core_func``:
one ``F.grid_sample`` a level.

It uses ``torch.nn``'s own BatchNorm2d (eval), LayerNorm, GELU and ReLU and
no module or kernel of the port, and holds cuDNN and cuBLAS to fp32
products (:func:`exact_fp32`). The state-dict names are the published ones,
which the port uses too. Departures from the published code:

* the attention is written out (``q k^T / sqrt(d)``, softmax, ``@ v``) with
  ``nn.MultiheadAttention``'s parameter names, in place of the module;
* the training-only parts (denoising queries, auxiliary outputs,
  ``denoising_class_embed``) are left out;
* the frozen BatchNorm is ``nn.BatchNorm2d`` in eval mode, which computes
  the same ``(x - mean) / sqrt(var + eps) * weight + bias`` (eps 1e-5);
* the top-300 is a stable sort (:func:`top_queries`), ties to the lower
  anchor;
* :func:`persons` reads the person column (label 0) of the last layer's
  logits through a sigmoid, gates it at a threshold and keeps the top
  ``k`` queries, in place of the published 80-class top-300 post-process.

``tests/test_torch_rtdetr.py`` holds the port against this file on the CPU;
``benchmark/reference/rtdetr.py`` is its frozen copy, which
``tests/test_torch_harness.py`` holds equal to it.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def exact_fp32():
    """Float32 products without TF32 inside; the flags as they were after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class ConvNormLayer(nn.Module):
    def __init__(self, cin, cout, k, s=1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, (k - 1) // 2, bias=False)
        self.norm = nn.BatchNorm2d(cout)
        self.act = {"relu": nn.ReLU(), "silu": nn.SiLU(), None: nn.Identity()}[act]

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


# ---- ResNet-50-vd ------------------------------------------------------------

class BottleNeck(nn.Module):
    def __init__(self, cin, width, stride, shortcut):
        super().__init__()
        self.branch2a = ConvNormLayer(cin, width, 1, 1, "relu")
        self.branch2b = ConvNormLayer(width, width, 3, stride, "relu")
        self.branch2c = ConvNormLayer(width, width * 4, 1, 1)
        self.shortcut = shortcut
        if not shortcut:
            if stride == 2:
                self.short = nn.Sequential(OrderedDict([
                    ("pool", nn.AvgPool2d(2, 2, 0, ceil_mode=True)),
                    ("conv", ConvNormLayer(cin, width * 4, 1, 1))]))
            else:
                self.short = ConvNormLayer(cin, width * 4, 1, stride)

    def forward(self, x):
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        return F.relu(out + (x if self.shortcut else self.short(x)))


class Blocks(nn.Module):
    def __init__(self, cin, width, count, stage):
        super().__init__()
        self.blocks = nn.ModuleList()
        for i in range(count):
            self.blocks.append(BottleNeck(cin, width, 2 if i == 0 and stage != 2 else 1, i != 0))
            cin = width * 4

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class PResNet(nn.Module):
    """ResNet-50-vd: NCHW -> [C3, C4, C5]."""

    def __init__(self, counts=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Sequential(OrderedDict([
            ("conv1_1", ConvNormLayer(3, 32, 3, 2, "relu")),
            ("conv1_2", ConvNormLayer(32, 32, 3, 1, "relu")),
            ("conv1_3", ConvNormLayer(32, 64, 3, 1, "relu"))]))
        self.res_layers = nn.ModuleList()
        cin = 64
        for i, (n, w) in enumerate(zip(counts, (64, 128, 256, 512))):
            self.res_layers.append(Blocks(cin, w, n, i + 2))
            cin = w * 4

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        outs = []
        for i, layer in enumerate(self.res_layers):
            x = layer(x)
            if i >= 1:
                outs.append(x)
        return outs


# ---- the hybrid encoder ------------------------------------------------------

class Attention(nn.Module):
    """Multi-head attention under ``nn.MultiheadAttention``'s names."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        b, t, d = q.shape
        w, bias = self.in_proj_weight, self.in_proj_bias
        split = lambda x: x.view(b, -1, self.heads, d // self.heads).transpose(1, 2)  # noqa: E731
        q = split(F.linear(q, w[:d], bias[:d]))
        k = split(F.linear(k, w[d:2 * d], bias[d:2 * d]))
        v = split(F.linear(v, w[2 * d:], bias[2 * d:]))
        p = torch.softmax(q @ k.transpose(-1, -2) * (d // self.heads) ** -0.5, -1)
        return self.out_proj((p @ v).transpose(1, 2).reshape(b, t, d))


class EncoderLayer(nn.Module):
    def __init__(self, dim, heads, ffn):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, src, pos):
        q = k = src + pos
        src = self.norm1(src + self.self_attn(q, k, src))
        return self.norm2(src + self.linear2(F.gelu(self.linear1(src))))


class Encoder(nn.Module):
    def __init__(self, dim, heads, ffn):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(dim, heads, ffn)])

    def forward(self, x, pos):
        for layer in self.layers:
            x = layer(x, pos)
        return x


class RepVggBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvNormLayer(ch, ch, 3, 1)
        self.conv2 = ConvNormLayer(ch, ch, 1, 1)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, cin, cout, n=3):
        super().__init__()
        self.conv1 = ConvNormLayer(cin, cout, 1, 1, "silu")
        self.conv2 = ConvNormLayer(cin, cout, 1, 1, "silu")
        self.bottlenecks = nn.Sequential(*[RepVggBlock(cout) for _ in range(n)])

    def forward(self, x):
        return self.bottlenecks(self.conv1(x)) + self.conv2(x)


def sincos_2d(w, h, dim, temperature=10000.0):
    """The published ``build_2d_sincos_position_embedding``."""
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                                    torch.arange(h, dtype=torch.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim)
    out_w = grid_w.flatten()[..., None] @ omega[None]
    out_h = grid_h.flatten()[..., None] @ omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class HybridEncoder(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), dim=256, heads=8, ffn=1024):
        super().__init__()
        self.dim = dim
        self.input_proj = nn.ModuleList(nn.Sequential(nn.Conv2d(c, dim, 1, bias=False),
                                                      nn.BatchNorm2d(dim)) for c in in_channels)
        self.encoder = nn.ModuleList([Encoder(dim, heads, ffn)])
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(ConvNormLayer(dim, dim, 1, 1, "silu")
                                           for _ in range(n - 1))
        self.fpn_blocks = nn.ModuleList(CSPRepLayer(2 * dim, dim) for _ in range(n - 1))
        self.downsample_convs = nn.ModuleList(ConvNormLayer(dim, dim, 3, 2, "silu")
                                              for _ in range(n - 1))
        self.pan_blocks = nn.ModuleList(CSPRepLayer(2 * dim, dim) for _ in range(n - 1))

    def forward(self, feats):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        h, w = proj[-1].shape[2:]
        src = proj[-1].flatten(2).permute(0, 2, 1)
        memory = self.encoder[0](src, sincos_2d(w, h, self.dim).to(src.device))
        proj[-1] = memory.permute(0, 2, 1).reshape(-1, self.dim, h, w)
        n = len(proj)
        inner = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            high = self.lateral_convs[n - 1 - idx](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.fpn_blocks[n - 1 - idx](torch.cat([up, proj[idx - 1]], 1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.cat([down, inner[idx + 1]], 1)))
        return outs


# ---- the decoder -------------------------------------------------------------

def deformable_attention_core_func(value, value_spatial_shapes, sampling_locations,
                                   attention_weights):
    """The published core: value (B, S, H, D), locations (B, Lq, H, L, P, 2)
    in [0, 1], weights (B, Lq, H, L, P) -> (B, Lq, H * D)."""
    bs, _, n_head, c = value.shape
    _, len_q, _, n_levels, n_points, _ = sampling_locations.shape
    split_shape = [h * w for h, w in value_spatial_shapes]
    value_list = value.split(split_shape, dim=1)
    sampling_grids = 2 * sampling_locations - 1
    sampling_value_list = []
    for level, (h, w) in enumerate(value_spatial_shapes):
        value_l_ = value_list[level].flatten(2).permute(0, 2, 1).reshape(bs * n_head, c, h, w)
        sampling_grid_l_ = sampling_grids[:, :, :, level].permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampling_value_list.append(F.grid_sample(value_l_, sampling_grid_l_, mode="bilinear",
                                                 padding_mode="zeros", align_corners=False))
    attention_weights = attention_weights.permute(0, 2, 1, 3, 4).reshape(
        bs * n_head, 1, len_q, n_levels * n_points)
    output = (torch.stack(sampling_value_list, dim=-2).flatten(-2) * attention_weights).sum(-1)
    return output.reshape(bs, n_head * c, len_q).permute(0, 2, 1)


class MSDeformableAttention(nn.Module):
    def __init__(self, dim=256, heads=8, levels=3, points=4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        total = heads * levels * points
        self.sampling_offsets = nn.Linear(dim, total * 2)
        self.attention_weights = nn.Linear(dim, total)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, reference_points, value, value_spatial_shapes):
        bs, len_q = query.shape[:2]
        value = self.value_proj(value).reshape(bs, value.shape[1], self.heads, -1)
        offsets = self.sampling_offsets(query).reshape(bs, len_q, self.heads, self.levels,
                                                       self.points, 2)
        weights = F.softmax(self.attention_weights(query).reshape(
            bs, len_q, self.heads, self.levels * self.points), -1).reshape(
            bs, len_q, self.heads, self.levels, self.points)
        locations = (reference_points[:, :, None, :, None, :2]
                     + offsets / self.points * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(deformable_attention_core_func(value, value_spatial_shapes,
                                                               locations, weights))


class DecoderLayer(nn.Module):
    def __init__(self, dim=256, heads=8, ffn=1024, levels=3, points=4):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn = MSDeformableAttention(dim, heads, levels, points)
        self.norm2 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, tgt, ref, memory, shapes, pos):
        q = k = tgt + pos
        tgt = self.norm1(tgt + self.self_attn(q, k, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + pos, ref, memory, shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    def __init__(self, cin, hidden, cout, num_layers):
        super().__init__()
        h = [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip([cin] + h, h + [cout]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if i < len(self.layers) - 1 else layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, num_layers, **kw):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(**kw) for _ in range(num_layers))


def inverse_sigmoid(x, eps=1e-5):
    x = x.clip(min=0.0, max=1.0)
    return torch.log(x.clip(min=eps) / (1 - x).clip(min=eps))


def anchors_of(shapes, grid_size=0.05, eps=0.01):
    """The published ``_generate_anchors``: logit-space anchors (1, N, 4),
    +inf where invalid, and the validity (1, N, 1)."""
    anchors = []
    for lvl, (h, w) in enumerate(shapes):
        grid_y, grid_x = torch.meshgrid(torch.arange(end=h, dtype=torch.float32),
                                        torch.arange(end=w, dtype=torch.float32), indexing="ij")
        grid_xy = torch.stack([grid_x, grid_y], -1)
        grid_xy = (grid_xy.unsqueeze(0) + 0.5) / torch.tensor([w, h], dtype=torch.float32)
        wh = torch.ones_like(grid_xy) * grid_size * (2.0 ** lvl)
        anchors.append(torch.cat([grid_xy, wh], -1).reshape(-1, h * w, 4))
    anchors = torch.cat(anchors, 1)
    valid = ((anchors > eps) * (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    return torch.where(valid, anchors, torch.inf), valid


class RTDETRTransformer(nn.Module):
    def __init__(self, num_classes=80, dim=256, num_queries=300, heads=8, ffn=1024, levels=3,
                 points=4, num_layers=6):
        super().__init__()
        self.num_queries = num_queries
        self.input_proj = nn.ModuleList(nn.Sequential(OrderedDict([
            ("conv", nn.Conv2d(dim, dim, 1, bias=False)), ("norm", nn.BatchNorm2d(dim))]))
            for _ in range(levels))
        self.decoder = Decoder(num_layers, dim=dim, heads=heads, ffn=ffn, levels=levels,
                               points=points)
        self.query_pos_head = MLP(4, 2 * dim, dim, 2)
        self.enc_output = nn.Sequential(nn.Linear(dim, dim), nn.LayerNorm(dim))
        self.enc_score_head = nn.Linear(dim, num_classes)
        self.enc_bbox_head = MLP(dim, dim, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(dim, num_classes) for _ in range(num_layers))
        self.dec_bbox_head = nn.ModuleList(MLP(dim, dim, 4, 3) for _ in range(num_layers))

    def encoder_input(self, feats):
        """-> the memory (B, N, dim) and the levels' (h, w)."""
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        return (torch.cat([f.flatten(2).permute(0, 2, 1) for f in proj], 1),
                [tuple(f.shape[2:]) for f in proj])

    def encoder_heads(self, memory, shapes):
        """-> the anchors' query features, class logits and box logits."""
        anchors, valid = anchors_of(shapes)
        anchors, valid = anchors.to(memory.device), valid.to(memory.device)
        output_memory = self.enc_output(valid.to(memory.dtype) * memory)
        return (output_memory, self.enc_score_head(output_memory),
                self.enc_bbox_head(output_memory) + anchors)

    def decode(self, target, ref_unact, memory, shapes):
        """The decoder layers from the selected queries -> the last layer's
        logits and sigmoid boxes."""
        ref = F.sigmoid(ref_unact)
        out = target
        for i, layer in enumerate(self.decoder.layers):
            pos = self.query_pos_head(ref)
            out = layer(out, ref.unsqueeze(2), memory, shapes, pos)
            new_ref = F.sigmoid(self.dec_bbox_head[i](out) + inverse_sigmoid(ref))
            if i == len(self.decoder.layers) - 1:
                return self.dec_score_head[i](out), new_ref
            ref = new_ref

    def select(self, output_memory, coords, idx):
        """The queries and box logits of the anchors ``idx`` (B, Q)."""
        target = output_memory.gather(1, idx[..., None].repeat(1, 1, output_memory.shape[-1]))
        return target, coords.gather(1, idx[..., None].repeat(1, 1, 4))


def top_queries(logits, k):
    """The ``k`` anchors of each frame with the largest class logit, ties to
    the lower anchor (a stable sort, where the published code calls
    ``torch.topk``, whose tie order is unspecified)."""
    return torch.sort(logits.max(-1).values, dim=-1, descending=True, stable=True)[1][:, :k]


def detect(model, x):
    """RT-DETR on NCHW frames in [0, 1] -> the last layer's logits (B, Q,
    classes), its sigmoid cxcywh boxes (B, Q, 4) and the anchors selected
    (B, Q). A function rather than a ``forward``, so that no module returns
    the integer indices."""
    dec = model.decoder
    memory, shapes = dec.encoder_input(model.encoder(model.backbone(x)))
    output_memory, logits, coords = dec.encoder_heads(memory, shapes)
    idx = top_queries(logits, dec.num_queries)
    out_logits, out_boxes = dec.decode(*dec.select(output_memory, coords, idx), memory, shapes)
    return out_logits, out_boxes, idx


class RTDETR(nn.Module):
    """NCHW frames in [0, 1] -> logits (B, Q, classes) and sigmoid cxcywh
    boxes (B, Q, 4) (:func:`detect`, which also gives the anchors)."""

    def __init__(self, num_classes=80, dim=256, num_queries=300, heads=8, ffn=1024, levels=3,
                 points=4, num_layers=6):
        super().__init__()
        self.backbone = PResNet()
        self.encoder = HybridEncoder((512, 1024, 2048), dim, heads, ffn)
        self.decoder = RTDETRTransformer(num_classes, dim, num_queries, heads, ffn, levels,
                                         points, num_layers)

    def forward(self, x):
        return detect(self, x)[:2]


def persons(logits, boxes, threshold: float, k: int, size: float) -> Dict[str, torch.Tensor]:
    """Per frame the top ``k`` queries by the sigmoid of the person column
    (label 0), those above ``threshold`` valid, ties to the lower query ->
    xyxy pixel boxes (B, k, 4), scores (B, k), valid (B, k), the queries
    (B, k)."""
    scores = torch.sigmoid(logits[..., 0])
    gated = torch.where(scores > threshold, scores, torch.full_like(scores, float("-inf")))
    s, q = torch.sort(gated, dim=-1, descending=True, stable=True)
    s, q = s[:, :k], q[:, :k]
    valid = torch.isfinite(s)
    cx, cy, w, h = torch.gather(boxes, 1, q[..., None].expand(-1, -1, 4)).unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * size
    return {"boxes": xyxy * valid[..., None], "scores": torch.where(valid, s, 0.0),
            "valid": valid, "queries": q}

