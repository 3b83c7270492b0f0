"""RT-DETR, the real-time detection transformer (Zhao et al., "DETRs Beat
YOLOs on Real-time Object Detection", arXiv:2304.08069), at eval: the
cascade's NMS-free person detector (``infer/cascade.py``,
``person_detector="rtdetr"``). The JAX package has no counterpart.

NHWC RGB frames in [0, 1] (no mean or std) ->

* ``backbone``: ResNet-50-vd (``nn/resnet.py::ResNetVD``), C3, C4, C5;
* ``encoder`` (``HybridEncoder``): a 1x1 conv + BatchNorm to ``hidden`` per
  level; AIFI, one post-norm transformer encoder layer over the stride-32
  map with 2-D sin-cos positions; CCFM, the top-down and bottom-up fusion
  of ConvNormLayers and ``CSPRepLayer``s (SiLU);
* ``decoder`` (``RTDETRTransformer``): its own 1x1 conv + BatchNorm per
  level, flattened into the memory (8400 positions at 640^2); anchors in
  logit space (invalid ones +inf, their memory zeroed); ``enc_output``,
  the class head and the top-``num_queries`` anchors by their largest class
  logit; then ``num_layers`` post-norm decoder layers (self-attention over
  the queries, multi-scale deformable cross-attention
  (``ops/kernels/ms_deform_attn.py``, one ``prpe::ms_deform_attn`` a layer),
  a ReLU FFN), each refining the boxes; the last layer's class logits and
  boxes are the output.

The module names are the published ones (``rtdetr_pytorch/src/zoo/rtdetr/``,
``configs/rtdetr/rtdetr_r50vd_6x_coco.yml``): ``backbone.*`` as in
``presnet.py``, ``encoder.*`` as in ``hybrid_encoder.py``, ``decoder.*`` as
in ``rtdetr_decoder.py`` (``decoder.decoder.layers.<i>.cross_attn.
sampling_offsets`` ...; ``nn.MultiheadAttention``'s ``in_proj_weight``,
``in_proj_bias``, ``out_proj``). Left out: the training-only
``decoder.denoising_class_embed``, and no RepVGG block is re-parameterised
(the published eval runs the two branches).

Precision: weights are fp32 and cast to the activation dtype at each layer
(``nn/common.py``); the boxes, their logits and the sampling locations stay
fp32, as do the attention weights' softmax and LayerNorm's statistics.
Where the published code computes the box head on all 8400 anchors and
then gathers the selected 300, this computes it on the 300 alone (the same
rows). Every shape is static: the top-k is ``ops/nms.py::topk_stable``.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, ContextManager, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prpe_tpu_torch.nn.common import BatchNorm, Conv2d, LayerNorm, Linear, fast_gelu
from prpe_tpu_torch.nn.resnet import ConvNormLayer, ResNetVD
from prpe_tpu_torch.ops.kernels.ms_deform_attn import ms_deform_attn
from prpe_tpu_torch.ops.nms import topk_stable

_BN_EPS = 1e-5


def _no_span(name: str) -> ContextManager:
    return contextlib.nullcontext()


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first, no dropout, no mask) under its
    parameter names, for a query equal to the key: q and k projected in one
    product, softmax attention through ``F.scaled_dot_product_attention``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def _init_extra(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.in_proj_weight.normal_(0.0, self.in_proj_weight.shape[1] ** -0.5, generator=gen)
            self.in_proj_bias.zero_()

    def forward(self, qk: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, t, d = v.shape
        w = self.in_proj_weight.to(v.dtype)
        bias = self.in_proj_bias.to(v.dtype)
        q, k = F.linear(qk, w[:2 * d], bias[:2 * d]).chunk(2, -1)
        v = F.linear(v, w[2 * d:], bias[2 * d:])
        split = lambda x: x.view(b, t, self.heads, -1).transpose(1, 2)  # noqa: E731
        o = F.scaled_dot_product_attention(split(q), split(k), split(v))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class MLP(nn.Module):
    """``num_layers`` linear layers with ReLU between them."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (num_layers - 1) + [cout]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


# ---- the hybrid encoder ------------------------------------------------------

def sincos_position_embedding(w: int, h: int, dim: int, temperature: float) -> torch.Tensor:
    """The published ``build_2d_sincos_position_embedding`` (1, w * h, dim),
    fp32, its ``meshgrid(..., indexing="ij")`` order kept."""
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                                    torch.arange(h, dtype=torch.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim)
    out_w = grid_w.flatten()[:, None] @ omega[None]
    out_h = grid_h.flatten()[:, None] @ omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class TransformerEncoderLayer(nn.Module):
    """Post-norm: ``x = LN(x + MHA(x + pos, x + pos, x))``, then
    ``x = LN(x + W2 GELU(W1 x))``."""

    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.linear1 = Linear(dim, ffn)
        self.linear2 = Linear(ffn, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x + pos, x))
        return self.norm2(x + self.linear2(fast_gelu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim, heads, ffn)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, pos)
        return x


class RepVggBlock(nn.Module):
    """``SiLU(BN(conv3x3 x) + BN(conv1x1 x))``, both branches run; the
    3x3 branch's BatchNorm, the add and the SiLU in one op."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = ConvNormLayer(ch, ch, 3, 1)
        self.conv2 = ConvNormLayer(ch, ch, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1.add_act(x, self.conv2(x), "silu")


class CSPRepLayer(nn.Module):
    """``RepVGG^3(conv1 x) + conv2 x``: the published ``conv3`` is the
    identity at RT-DETR-R50's expansion 1.0."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvNormLayer(cin, cout, 1, 1, "silu")
        self.conv2 = ConvNormLayer(cin, cout, 1, 1, "silu")
        self.bottlenecks = nn.Sequential(*[RepVggBlock(cout) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottlenecks(self.conv1(x)) + self.conv2(x)


class HybridEncoder(nn.Module):
    """Input projections, AIFI on the last level, CCFM: the three maps in,
    three ``hidden``-wide maps at strides 8, 16, 32 out."""

    def __init__(self, in_channels: Sequence[int], hidden: int, heads: int, ffn: int):
        super().__init__()
        self.hidden = hidden
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hidden, 1, bias=False), BatchNorm(hidden, _BN_EPS))
            for c in in_channels)
        self.encoder = nn.ModuleList([TransformerEncoder(hidden, heads, ffn, 1)])
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(ConvNormLayer(hidden, hidden, 1, 1, "silu")
                                           for _ in range(n - 1))
        self.fpn_blocks = nn.ModuleList(CSPRepLayer(2 * hidden, hidden) for _ in range(n - 1))
        self.downsample_convs = nn.ModuleList(ConvNormLayer(hidden, hidden, 3, 2, "silu")
                                              for _ in range(n - 1))
        self.pan_blocks = nn.ModuleList(CSPRepLayer(2 * hidden, hidden) for _ in range(n - 1))
        self._pos = {}

    def position(self, w: int, h: int, like: torch.Tensor) -> torch.Tensor:
        """The sin-cos table of a w x h map in ``like``'s dtype and device,
        made once."""
        key = (w, h, like.dtype, like.device)
        if key not in self._pos:
            self._pos[key] = sincos_position_embedding(
                w, h, self.hidden, 10000.0).to(like.device, like.dtype)
        return self._pos[key]

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        b, c, h, w = proj[-1].shape
        x = proj[-1].flatten(2).transpose(1, 2)
        x = self.encoder[0](x, self.position(w, h, x))
        proj[-1] = x.transpose(1, 2).reshape(b, c, h, w)
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

def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The published ``inverse_sigmoid``: clip to [0, 1], then
    log(max(x, eps) / max(1 - x, eps))."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable cross-attention: per head, ``points`` sampling
    offsets and weights a level from the query, locations ``b_xy + offset /
    points * b_wh * 0.5`` (fp32), the value bilinearly sampled there and
    summed with the softmaxed weights (``prpe::ms_deform_attn``)."""

    def __init__(self, dim: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        total = heads * levels * points
        self.sampling_offsets = Linear(dim, total * 2)
        self.attention_weights = Linear(dim, total)
        self.value_proj = Linear(dim, dim)
        self.output_proj = Linear(dim, dim)

    def forward(self, query: torch.Tensor, boxes: torch.Tensor, memory: torch.Tensor,
                shapes: Sequence[int]) -> torch.Tensor:
        b, lq, _ = query.shape
        h, l, p = self.heads, self.levels, self.points
        value = self.value_proj(memory).view(b, memory.shape[1], h, -1)
        offsets = self.sampling_offsets(query).view(b, lq, h, l, p, 2).float()
        weights = torch.softmax(self.attention_weights(query).view(b, lq, h, l * p).float(),
                                -1).view(b, lq, h, l, p)
        ref = boxes[:, :, None, None, None]
        locations = ref[..., :2] + offsets / p * ref[..., 2:] * 0.5
        return self.output_proj(ms_deform_attn(value, shapes, locations.contiguous(), weights))


class TransformerDecoderLayer(nn.Module):
    """Post-norm: self-attention over the queries (``q = k = t + pos``),
    deformable cross-attention of ``t + pos``, a ReLU FFN."""

    def __init__(self, dim: int, heads: int, ffn: int, levels: int, points: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.norm1 = LayerNorm(dim)
        self.cross_attn = MSDeformableAttention(dim, heads, levels, points)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Linear(dim, ffn)
        self.linear2 = Linear(ffn, dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, t: torch.Tensor, boxes: torch.Tensor, memory: torch.Tensor,
                shapes: Sequence[int], pos: torch.Tensor) -> torch.Tensor:
        t = self.norm1(t + self.self_attn(t + pos, t))
        t = self.norm2(t + self.cross_attn(t + pos, boxes, memory, shapes))
        return self.norm3(t + self.linear2(F.relu(self.linear1(t))))


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int, levels: int, points: int,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerDecoderLayer(dim, heads, ffn, levels, points)
                                    for _ in range(num_layers))


def make_anchors(shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05,
                 eps: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchors ((i + 0.5) / w, (j + 0.5) / h, grid_size * 2^l, same) over the
    levels' grids in logit space, fp32 (1, N, 4), +inf where a coordinate
    lies outside (eps, 1 - eps); and that validity (1, N, 1)."""
    anchors = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = (torch.stack([gx, gy], -1)[None] + 0.5) / torch.tensor([w, h], dtype=torch.float32)
        wh = torch.ones_like(xy) * grid_size * (2.0 ** lvl)
        anchors.append(torch.cat([xy, wh], -1).reshape(-1, h * w, 4))
    anchors = torch.cat(anchors, 1)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    return torch.where(valid, anchors, torch.inf), valid


class RTDETRTransformer(nn.Module):
    """The decoder side: input projections, query selection, the decoder
    layers and their heads."""

    def __init__(self, num_classes: int, hidden: int, num_queries: int, heads: int, ffn: int,
                 levels: int, points: int, num_layers: int, feat_channels: Sequence[int],
                 feat_strides: Sequence[int], image_size: int):
        super().__init__()
        self.num_queries = num_queries
        self.input_proj = nn.ModuleList(
            nn.Sequential(OrderedDict([("conv", Conv2d(c, hidden, 1, bias=False)),
                                       ("norm", BatchNorm(hidden, _BN_EPS))]))
            for c in feat_channels)
        self.decoder = TransformerDecoder(hidden, heads, ffn, levels, points, num_layers)
        self.query_pos_head = MLP(4, 2 * hidden, hidden, 2)
        self.enc_output = nn.Sequential(Linear(hidden, hidden), LayerNorm(hidden))
        self.enc_score_head = Linear(hidden, num_classes)
        self.enc_bbox_head = MLP(hidden, hidden, 4, 3)
        self.dec_score_head = nn.ModuleList(Linear(hidden, num_classes)
                                            for _ in range(num_layers))
        self.dec_bbox_head = nn.ModuleList(MLP(hidden, hidden, 4, 3) for _ in range(num_layers))
        self.grid = [(image_size // s, image_size // s) for s in feat_strides]
        self.shapes = [n for hw in self.grid for n in hw]
        self._anchors = {}

    def anchors(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        if device not in self._anchors:
            self._anchors[device] = tuple(t.to(device) for t in make_anchors(self.grid))
        return self._anchors[device]

    def select(self, feats: List[torch.Tensor]):
        """-> the memory (B, N, hidden), the top-``num_queries`` anchors
        (B, Q), their queries (B, Q, hidden) and box logits (B, Q, 4), fp32."""
        memory = torch.cat([p(f).flatten(2).transpose(1, 2)
                            for p, f in zip(self.input_proj, feats)], 1)
        anchors, valid = self.anchors(memory.device)
        out_memory = self.enc_output(valid.to(memory.dtype) * memory)
        scores = self.enc_score_head(out_memory).amax(-1)
        _, idx = topk_stable(scores, self.num_queries)
        rows = idx[..., None].expand(-1, -1, out_memory.shape[-1])
        target = torch.gather(out_memory, 1, rows)
        ref_unact = self.enc_bbox_head(target).float() + anchors[0][idx]
        return memory, idx, target, ref_unact

    def forward(self, memory: torch.Tensor, target: torch.Tensor, ref_unact: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder layers from the selected queries -> the last layer's
        class logits (B, Q, classes) and sigmoid cxcywh boxes (B, Q, 4),
        fp32."""
        boxes = torch.sigmoid(ref_unact)
        t = target
        last = len(self.decoder.layers) - 1
        for i, layer in enumerate(self.decoder.layers):
            pos = self.query_pos_head(boxes.to(t.dtype))
            t = layer(t, boxes, memory, self.shapes, pos)
            boxes = torch.sigmoid(self.dec_bbox_head[i](t).float() + inverse_sigmoid(boxes))
            if i == last:
                return self.dec_score_head[i](t).float(), boxes
        raise ValueError("RT-DETR needs at least one decoder layer")


class RTDETROutput(NamedTuple):
    logits: torch.Tensor  # (B, Q, classes) fp32, the last decoder layer's
    boxes: torch.Tensor  # (B, Q, 4) fp32 sigmoid cxcywh, over the image size
    selected: torch.Tensor  # (B, Q) int64: the anchor each query started from


class RTDETR(nn.Module):
    """RT-DETR-R50 at the published widths by default
    (``rtdetr_r50vd_6x_coco.yml``): NHWC (B, S, S, 3) in [0, 1] ->
    :class:`RTDETROutput`. ``span(name)`` opens a context around each part
    (``rtdetr.backbone``, ``rtdetr.encoder``, ``rtdetr.select``,
    ``rtdetr.decoder``); the cascade passes its traced call's."""

    def __init__(self, num_classes: int = 80, hidden: int = 256, num_queries: int = 300,
                 heads: int = 8, ffn: int = 1024, levels: int = 3, points: int = 4,
                 num_decoder_layers: int = 6, image_size: int = 640,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetVD(dtype=dtype)
        strides = (8, 16, 32)
        self.encoder = HybridEncoder(ResNetVD.out_channels, hidden, heads, ffn)
        self.decoder = RTDETRTransformer(num_classes, hidden, num_queries, heads, ffn, levels,
                                         points, num_decoder_layers, [hidden] * levels,
                                         strides, image_size)

    def forward(self, x: torch.Tensor, span: Callable[[str], ContextManager] = _no_span
                ) -> RTDETROutput:
        with span("rtdetr.backbone"):
            feats = self.backbone(x)
        with span("rtdetr.encoder"):
            feats = self.encoder(feats)
        with span("rtdetr.select"):
            memory, idx, target, ref_unact = self.decoder.select(feats)
        with span("rtdetr.decoder"):
            logits, boxes = self.decoder(memory, target, ref_unact)
        return RTDETROutput(logits, boxes, idx)
