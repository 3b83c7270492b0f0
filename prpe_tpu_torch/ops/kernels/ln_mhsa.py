"""Fused pre-LN attention half-block: the CUDA kernel ``csrc/ln_mhsa.cu`` and
its plain version.

Counterpart of ``prpe_tpu/ops/pallas/attention_kernel.py::fused_ln_mhsa``
(``_ln_mhsa_kernel``): ``x + proj(MHSA(qkv(LN(x))))`` for x of shape
(B, T, C). The weights are the port's ``Linear`` weights, (out, in); as in
the JAX package they are cast to ``x.dtype`` here, outside the kernel, while
the LayerNorm parameters and the biases stay fp32. CPU tensors take
:func:`ln_mhsa_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.ops.kernels.attention import MAX_T, mhsa_packed_plain

_SYMBOL = {torch.float32: "prpe_ln_mhsa_f32", torch.bfloat16: "prpe_ln_mhsa_bf16"}


def ln_mhsa_plain(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch half-block with the numerics of the Pallas body (not of
    its XLA oracle, which rounds the logits and each product before the
    bias): two-pass fp32 LayerNorm statistics, fp32 scale and shift, rounded
    to the input dtype; each projection accumulates in fp32 over operands in
    the input dtype, adds its fp32 bias in fp32 and rounds once; the
    attention of :func:`mhsa_packed_plain`; ``x + round(y)`` in the input
    dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(dt)

    def dense(inp, w, b):
        return (inp.float() @ w.to(dt).float().T + b.float()).to(dt)

    o = mhsa_packed_plain(dense(xn, wq, bq), dense(xn, wk, bk), dense(xn, wv, bv), heads)
    return x + dense(o, wo, bo)


def fused_ln_mhsa(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHSA(qkv(LN(x))))``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Inference only (no gradient)."""
    args = (ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)
    if x.device.type == "cpu":
        return ln_mhsa_plain(x, *args, heads=heads, eps=eps)
    if x.device.type != "cuda" or any(a.device != x.device for a in args):
        raise ValueError(f"fused_ln_mhsa: x on {x.device}, parameters on "
                         f"{sorted({str(a.device) for a in args})}")
    if x.dtype not in _SYMBOL:
        raise ValueError(f"fused_ln_mhsa: dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_ln_mhsa: x must be a contiguous (B, T, C) tensor, got {x.shape}")
    b, t, c = x.shape
    for name, a in zip(("ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"), args):
        want = (c, c) if name.startswith("w") else (c,)
        if tuple(a.shape) != want:
            raise ValueError(f"fused_ln_mhsa: {name} has shape {tuple(a.shape)}, expected {want}")
    if heads <= 0 or c % heads:
        raise ValueError(f"fused_ln_mhsa: C = {c} is not a multiple of heads = {heads}")
    d = c // heads
    if d not in (16, 32, 64, 128):
        raise ValueError(f"fused_ln_mhsa: head dim {d} not in (16, 32, 64, 128)")
    if t > MAX_T:
        raise ValueError(f"fused_ln_mhsa: T = {t} > {MAX_T}")
    wq, wk, wv, wo = (w.to(x.dtype).contiguous() for w in (wq, wk, wv, wo))
    ln_w, ln_b, bq, bk, bv, bo = (p.float().contiguous() for p in (ln_w, ln_b, bq, bk, bv, bo))
    ptrs = (x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)
    if any(p.data_ptr() % 16 for p in ptrs):
        raise ValueError("fused_ln_mhsa: every operand must start on a 16-byte boundary")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ws = torch.empty(4 * b * t * c, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load("ln_mhsa"), _SYMBOL[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(p.data_ptr() for p in ptrs), out.data_ptr(), ws.data_ptr(),
                 b, t, c, heads, float(eps), float(d ** -0.5), stream)
    _build.check(err, "fused_ln_mhsa launch")
    _build.launches["ln_mhsa"] += 1
    return out
