"""Shared building blocks (NCHW inside, fp32 parameters, compute in the
activation dtype). ``model.train()`` puts every ``BatchNorm`` on batch
statistics and every ``Dropout`` on, as ``train=True`` does through a
whole JAX model.

Counterpart of ``prpe_tpu/nn/common.py``. Parameters stay fp32 and each
layer casts them to the dtype of its input, as flax's ``dtype=`` argument
does, so one model serves both the fp32 path and the bf16 path. Module and
parameter names mirror the flax trees, which keeps the weight bridge
(``models/porting.py``) a rename plus layout transposes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from prpe_tpu_torch.ops.kernels.bn_act import bn_act, bn_act_plain
from prpe_tpu_torch.parallel.collectives import all_reduce_


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: exact erf in fp32, tanh-approximate in bf16 (the JAX package's
    choice: the tanh error is below bf16's own rounding step)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose fp32 parameters are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` whose fp32 parameters are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and normalisation (float64 stays
    float64); the result is cast back to the input dtype (flax
    ``LayerNorm(dtype=...)`` semantics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(acc), self.normalized_shape, self.weight.to(acc),
                         self.bias.to(acc), self.eps)
        return y.to(x.dtype)


class _BatchStatsNorm(torch.autograd.Function):
    """flax ``BatchNorm`` on batch statistics: mean and the fast variance
    E[x^2] - E[x]^2 (clamped at 0) reduced in fp32 (float64 stays float64)
    over every axis but ``dim``; ``(x - mean) * (rsqrt(var + eps) * weight)
    + bias`` in that precision, cast to the input dtype. Only x and the per-channel statistics are kept
    for the backward, which is the analytic one of that expression.

    With a process ``group`` (the mesh's data axis) the statistics are those
    of the global batch, as under GSPMD: the forward all-reduces the
    per-channel sums of x and x^2 with the element count, the backward the
    sums of dy and dy * x_hat (SyncBatchNorm)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dim: int, eps: float, group=None):
        dims = [d for d in range(x.dim()) if d != dim]
        shape = [1] * x.dim()
        shape[dim] = -1
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        if group is None:
            count = None
            mean = xf.mean(dims)
            var_raw = (xf * xf).mean(dims) - mean * mean
        else:
            c = x.shape[dim]
            sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                              xf.new_full((1,), x.numel() // c)])
            all_reduce_(sums, group)
            count = sums[-1]
            mean = sums[:c] / count
            var_raw = sums[c:2 * c] / count - mean * mean
        del xf
        var = var_raw.clamp(min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd if weight is None else rstd * weight.to(acc)
        y = (x.to(acc) - mean.view(shape)) * mul.view(shape)
        if bias is not None:
            y = y + bias.to(acc).view(shape)
        ctx.save_for_backward(x, weight, mean, rstd, var_raw > 0)
        ctx.dim, ctx.has_bias, ctx.group, ctx.count = dim, bias is not None, group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd, var_live = ctx.saved_tensors
        dim = ctx.dim
        dims = [d for d in range(x.dim()) if d != dim]
        shape = [1] * x.dim()
        shape[dim] = -1
        g = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * rstd.view(shape)
        dweight = dbias = None
        if weight is not None and ctx.needs_input_grad[1]:
            dweight = (g * xhat).sum(dims)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = g.sum(dims)
        dx = None
        if ctx.needs_input_grad[0]:
            dxhat = g if weight is None else g * weight.to(mean.dtype).view(shape)
            if ctx.group is None:
                dxhat_mean = dxhat.mean(dims)
                dxhat_xhat_mean = (dxhat * xhat).mean(dims)
            else:
                c = mean.shape[0]
                sums = all_reduce_(torch.cat([dxhat.sum(dims), (dxhat * xhat).sum(dims)]),
                                   ctx.group)
                dxhat_mean, dxhat_xhat_mean = sums[:c] / ctx.count, sums[c:] / ctx.count
            # a clamped variance is a constant: no gradient through it
            var_term = dxhat_xhat_mean * var_live
            dx = (dxhat - dxhat_mean.view(shape) - xhat * var_term.view(shape))
            dx = (dx * rstd.view(shape)).to(x.dtype)
        return dx, dweight, dbias, None, None, None


class _Derived:
    """A tuple of tensors derived from ``sources`` (tensors or None) for an
    activation dtype, computed again only when that dtype or a source has
    changed. A source is seen as changed when its version counter moved (an
    in-place write: ``load_state_dict``, an optimizer step, a train-mode
    statistics update) or its storage is another one (``.to()``, a swapped
    ``.data``, a new parameter). The old sources are held so that no new
    storage can take an old one's address. Inference tensors keep no
    version counter: from them the tensors are computed on every call."""

    def __init__(self):
        self.entry = None  # (key, value, the sources held)

    def get(self, sources: Sequence[Optional[torch.Tensor]], dtype: torch.dtype,
            compute: Callable[[], Tuple[torch.Tensor, ...]]) -> Tuple[torch.Tensor, ...]:
        try:
            key = [dtype]
            for t in sources:
                if t is not None:
                    key += (t.data_ptr(), t._version)
        except RuntimeError:  # an inference tensor
            return compute()
        entry = self.entry
        if entry is None or entry[0] != key:
            entry = self.entry = (key, compute(), [t.detach() for t in sources if t is not None])
        return entry[1]


class BatchNorm(nn.Module):
    """BatchNorm as the JAX package runs it (flax ``nn.BatchNorm``).

    In eval mode, folded into a per-channel scale and bias: computed in fp32
    from the running statistics, then applied as ``x * scale + bias`` in the
    activation dtype, exactly as ``prpe_tpu.nn.common.inference_bn`` does.
    Where no gradient is recorded (``torch.no_grad``,
    ``torch.inference_mode``) the scale and bias are computed once and kept
    until the statistics or parameters change (``_Derived``), and the
    BatchNorm and the activation ``act`` run as one ``prpe::bn_act``
    (``ops/kernels/bn_act.py``; the CUDA kernel, with the same roundings,
    which takes bf16 and fp32 activations in NCHW order or channels-last
    and raises for any other CUDA tensor).

    In train mode, normalised with the batch's statistics (``_BatchStatsNorm``)
    and the running statistics moved as flax moves them:
    ``running = momentum * running + (1 - momentum) * batch``, with the
    **biased** batch variance and flax's ``momentum`` (0.97 in ``ConvBN``,
    0.9 elsewhere). ``freeze_stats`` holds the running statistics, so that
    a recomputed forward (gradient checkpointing) moves them once only.
    ``dim`` is the channel axis. ``sync_group`` (the mesh's data axis, set
    by ``set_sync_group``) makes the batch statistics those of the global
    batch, so the running statistics come out equal on every rank.

    ``act`` is the activation that follows: None, ``"silu"`` (``F.silu``),
    ``"relu"`` (``F.relu``) or a ``PReLU`` over the same channels.
    ``residual``, where given, is added between the normalisation and
    ``act`` (a residual block's shortcut), in the same op where no gradient
    is recorded; it has ``x``'s dtype, sizes and strides.
    """

    def __init__(self, channels: int, eps: float, affine: bool = True, dim: int = 1,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.dim = dim
        self.momentum = momentum
        self.freeze_stats = False
        self.sync_group = None
        if affine:
            self.weight = nn.Parameter(torch.empty(channels))
            self.bias = nn.Parameter(torch.empty(channels))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))
        self._folded = _Derived()

    def folded(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval scale and bias in ``dtype``, computed in fp32."""
        scale = torch.rsqrt(self.running_var.float() + self.eps)
        if self.weight is not None:
            scale = scale * self.weight.float()
        bias = -self.running_mean.float() * scale
        if self.bias is not None:
            bias = bias + self.bias.float()
        return scale.to(dtype), bias.to(dtype)

    def forward(self, x: torch.Tensor, act: Union[None, str, "PReLU"] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            y, mean, var = _BatchStatsNorm.apply(x, self.weight, self.bias, self.dim, self.eps,
                                                 self.sync_group)
            if not self.freeze_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
            if residual is not None:
                y = y + residual
            if act == "silu":
                return F.silu(y)
            if act == "relu":
                return F.relu(y)
            return y if act is None else act(y)
        prelu = isinstance(act, PReLU)
        kind = "prelu" if prelu else act or "none"
        if torch.is_grad_enabled():
            # the fused op's plain version, which records the gradient
            scale, bias = self.folded(x.dtype)
            alpha = act.alpha.to(x.dtype) if prelu else None
            return bn_act_plain(x, scale, bias, alpha, kind, self.dim, residual)
        sources = (self.running_mean, self.running_var, self.weight, self.bias)
        scale, bias = self._folded.get(sources, x.dtype, lambda: self.folded(x.dtype))
        return bn_act(x, scale, bias, act.alpha_in(x.dtype) if prelu else None, kind, self.dim,
                      residual)


class PReLU(nn.Module):
    """Per-channel parametric ReLU over the channel axis 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self._cast = _Derived()

    def alpha_in(self, dtype: torch.dtype) -> torch.Tensor:
        """``alpha`` cast to ``dtype``, kept until it changes (``_Derived``);
        for use where no gradient is recorded."""
        return self._cast.get((self.alpha,), dtype, lambda: (self.alpha.to(dtype),))[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha * x)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    1 - ``rate`` and scale the kept ones by 1 / (1 - ``rate``); the identity
    in eval mode. The mask is drawn from ``generator``, which the caller
    sets (the train step does): a train-mode forward without one raises.

    ``rows`` (start, total), when set, says that this input holds rows
    start ... of a global batch of ``total``: the mask is drawn for the
    whole global batch and this block of it kept, so that every data rank
    draws what one process would (``set_dropout_rows``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.rows = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a torch.Generator: set .generator")
        keep = 1.0 - self.rate
        if self.rows is None:
            mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        else:
            start, total = self.rows
            mask = (torch.rand((total, *x.shape[1:]), generator=self.generator,
                               device=x.device) < keep)[start:start + x.shape[0]]
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_sync_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` on the statistics of ``group``'s
    global batch (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group


def set_dropout_rows(model: nn.Module, rows) -> None:
    """Every ``Dropout`` of ``model`` draws for rows ``(start, total)`` of a
    global batch (None: for its input alone)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rows = rows


class ConvBN(nn.Module):
    """Bias-free conv + BatchNorm (eps 1e-3, flax momentum 0.97) + optional
    SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1, p: int = 0,
                 groups: int = 1, act: bool = True, eps: float = 1e-3):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, s, p, groups=groups, bias=False)
        self.bn = BatchNorm(cout, eps, momentum=0.97)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), "silu" if self.act else None)


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour x``scale`` upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def _linear_resize_matrix(in_size: int, out_size: int, align_corners: bool,
                          dtype: torch.dtype, device) -> torch.Tensor:
    """(out, in) row-stochastic bilinear interpolation matrix, with the JAX
    package's source-coordinate clamp (``F.interpolate`` clamps differently)."""
    if out_size == 1:
        src = torch.zeros(1, device=device)
    elif align_corners:
        src = torch.arange(out_size, dtype=torch.float32, device=device) * (
            (in_size - 1) / (out_size - 1))
    else:
        scale = in_size / out_size
        src = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
               * scale - 0.5).clamp(0.0, in_size - 1)
    lo = src.floor().long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    frac = src - lo.float()
    rows = torch.arange(out_size, device=device)
    m = torch.zeros(out_size, in_size, device=device)
    m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    m.index_put_((rows, hi), frac, accumulate=True)
    return m.to(dtype)


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize NCHW -> (B, C, H', W') as two interpolation matmuls."""
    _, _, h, w = x.shape
    mh = _linear_resize_matrix(h, out_hw[0], align_corners, x.dtype, x.device)
    mw = _linear_resize_matrix(w, out_hw[1], align_corners, x.dtype, x.device)
    return torch.einsum("oh,bchw,pw->bcop", mh, x, mw)


class AdaptiveAvgPool(nn.Module):
    """Global average pool of an NCHW tensor to (B, C, 1, 1)
    (``torch.nn.AdaptiveAvgPool2d((1, 1))``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


def max_pool(x: torch.Tensor, window: int, strides: int = 1, padding: int = 0) -> torch.Tensor:
    """Max pool NCHW; the padding acts as -inf, as in the JAX package."""
    return F.max_pool2d(x, window, strides, padding)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer of ``model`` from ``generator``.

    Lecun-normal conv/linear weights and zero biases, identity BatchNorm and
    LayerNorm, PReLU slope 0.25; a module with ``_init_extra(generator)``
    then sets its own special values (positional tables, head biases).
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
    for m in model.modules():
        if hasattr(m, "_init_extra"):
            m._init_extra(generator)


def materialize(model: nn.Module, device: torch.device, seed: int = 0) -> nn.Module:
    """Allocate a module built on the meta device on ``device`` and fill it
    from a ``torch.Generator`` on that device seeded with ``seed``. On the
    meta device itself it stays shapes only, with nothing to fill."""
    if device.type == "meta":
        return model.eval()
    model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model.eval()


def build_on(device: torch.device, factory, seed: int = 0) -> nn.Module:
    """``factory()`` constructed without allocating, then materialized."""
    with torch.device("meta"):
        model = factory()
    return materialize(model, device, seed)
