"""The reference's precision, and the control's one step below it.

:func:`exact_fp32` holds the reference to float32 products, TF32 off in
cuDNN and cuBLAS, whatever the program's process has set; the program's
own settings are left to it outside. The cascade computes in bfloat16, so its control is the reference with every
convolution, linear layer and attention product fed through float8 (e4m3)
with one scale per tensor, the recipe a later change would be tempted by,
and every module's output rounded through it as the program rounds each to
bfloat16. :func:`to_fp8` switches a reference model to it; nothing else
changes.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Float32 products without TF32 inside; the flags as they were after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a per-tensor scale (amax / 448);
    the gradient passes straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / E4M3_MAX
    q = ((x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


def lowp(x: torch.Tensor, module) -> torch.Tensor:
    """``x`` through float8 when ``module`` was switched by :func:`to_fp8`."""
    return fp8(x) if getattr(module, "fp8", False) else x


def _quantize_input(module, args):
    return (fp8(args[0]),) + tuple(args[1:])


def _quantize_output(module, args, out):
    if isinstance(out, torch.Tensor):
        return fp8(out)
    if isinstance(out, (tuple, list)):
        return type(out)(fp8(o) if isinstance(o, torch.Tensor) else o for o in out)
    return out


@torch.no_grad()
def to_fp8(model: torch.nn.Module) -> torch.nn.Module:
    """Round ``model``'s convolution and linear weights through float8 in
    place, quantise their inputs and every module's output at every forward
    (the program holds each in bfloat16), and flag every module so that its
    attention products (:func:`lowp`) go through float8 too."""
    for m in model.modules():
        m.fp8 = True
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.weight.copy_(fp8(m.weight))
            m.register_forward_pre_hook(_quantize_input)
        m.register_forward_hook(_quantize_output)
    return model
