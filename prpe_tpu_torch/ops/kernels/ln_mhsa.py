"""Fused pre-LN attention half-block: the CUDA kernel ``csrc/ln_mhsa.cu`` and
its plain version, and two of its stages alone.

Counterpart of ``prpe_tpu/ops/pallas/attention_kernel.py::fused_ln_mhsa``
(``_ln_mhsa_kernel``): ``x + proj(MHSA(qkv(LN(x))))`` for x of shape
(B, T, C). The weights are the port's ``Linear`` weights, (out, in); as in
the JAX package they are cast to ``x.dtype`` here, outside the kernel, while
the LayerNorm parameters and the biases stay fp32. CPU tensors take the
plain versions; CUDA tensors launch the kernel or raise. The half-block's
launch is the custom op ``prpe::ln_mhsa``, so ``torch.export`` keeps it as
one node.

:func:`layernorm` and :func:`linear` run the half-block's LayerNorm and its
GEMM (bias, optional residual) as launches of their own, so that each stage
can be timed; :func:`fused_ln_mhsa` does not call them.
"""

from __future__ import annotations

from typing import Optional

import torch

from prpe_tpu_torch.ops.kernels._build import FLOAT, INT, PTR, Library
from prpe_tpu_torch.ops.kernels.attention import MAX_T, mhsa_packed_plain

# the arguments of ``prpe_<stage>_<dtype>``; a launch counts in its stage's route
_ARGS = {"ln_mhsa": [PTR] * 13 + [INT] * 4 + [FLOAT, FLOAT, PTR],
         "layernorm": [PTR] * 4 + [INT, INT, FLOAT, PTR],
         "linear": [PTR] * 5 + [INT] * 3 + [PTR]}
LIBRARY = Library("ln_mhsa", {f"prpe_{stage}_{dt}": args for stage, args in _ARGS.items()
                              for dt in ("f32", "bf16")}, routes=tuple(_ARGS))
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the LayerNorm kernel holds a row in registers: at most 16 16-byte vectors a
# lane of a warp, 2048 fp32 or 4096 bf16 values
_LN_MAX_BYTES = 32 * 16 * 16


def layernorm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis with the Pallas body's numerics:
    two-pass fp32 statistics (mean, then the mean of squared deviations), eps
    inside the square root, fp32 scale and shift, rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``round(x @ w^T + b)`` with the Pallas body's ``dense`` numerics:
    operands in x's dtype (w, an (out, in) weight, cast to it), fp32
    accumulation, the fp32 bias added in fp32, one rounding; then
    ``residual + y`` in x's dtype when a residual is given."""
    dt = x.dtype
    y = (x.float() @ w.to(dt).float().T + b.float()).to(dt)
    return y if residual is None else residual + y


def ln_mhsa_plain(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch half-block with the numerics of the Pallas body (not of
    its XLA oracle, which rounds the logits and each product before the
    bias): :func:`layernorm_plain`, three :func:`linear_plain` projections,
    :func:`mhsa_packed_plain`, and the output projection with ``x`` as its
    residual."""
    xn = layernorm_plain(x, ln_w, ln_b, eps)
    o = mhsa_packed_plain(linear_plain(xn, wq, bq), linear_plain(xn, wk, bk),
                          linear_plain(xn, wv, bv), heads)
    return linear_plain(o, wo, bo, residual=x)


def _check_cuda(name: str, x: torch.Tensor, others, dtypes) -> None:
    if x.device.type != "cuda" or any(a.device != x.device for a in others):
        raise ValueError(f"{name}: x on {x.device}, other operands on "
                         f"{sorted({str(a.device) for a in others})}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype} not in {sorted(map(str, dtypes))}")


def _check_row_width(name: str, x: torch.Tensor, cols: int) -> None:
    """A row of the LayerNorm kernel: whole 16-byte vectors that fit its
    registers."""
    row_bytes = cols * x.element_size()
    if row_bytes % 16 or row_bytes > _LN_MAX_BYTES:
        raise ValueError(f"{name}: C = {cols} {x.dtype} values must be a multiple of 16 bytes "
                         f"and at most {_LN_MAX_BYTES // x.element_size()}")


def _check_aligned(name: str, tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every operand must start on a 16-byte boundary")


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """The half-block's LayerNorm stage over the last axis: the CUDA kernel
    (fp32 or bf16) for CUDA tensors, :func:`layernorm_plain` for CPU
    tensors."""
    if x.device.type == "cpu":
        return layernorm_plain(x, w, b, eps)
    _check_cuda("layernorm", x, (w, b), tuple(_SUFFIX))
    cols = x.shape[-1]
    if not x.is_contiguous() or tuple(w.shape) != (cols,) or tuple(b.shape) != (cols,):
        raise ValueError(f"layernorm: x {tuple(x.shape)} must be contiguous, w and b ({cols},)")
    _check_row_width("layernorm", x, cols)
    w, b = w.float().contiguous(), b.float().contiguous()
    _check_aligned("layernorm", (x, w, b))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    LIBRARY.launch(f"prpe_layernorm_{_SUFFIX[x.dtype]}", ("layernorm",), x, x.data_ptr(),
                   w.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // cols, cols, float(eps))
    return y


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The half-block's GEMM stage, ``round(x @ w^T + b)`` (``+ residual``
    after the rounding): the CUDA kernel (fp32 or bf16) for CUDA tensors,
    :func:`linear_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return linear_plain(x, w, b, residual)
    others = (w, b) if residual is None else (w, b, residual)
    _check_cuda("linear", x, others, tuple(_SUFFIX))
    k = x.shape[-1]
    n = w.shape[0]
    if not x.is_contiguous() or w.dim() != 2 or w.shape[1] != k or tuple(b.shape) != (n,):
        raise ValueError(f"linear: x {tuple(x.shape)} contiguous, w (n, {k}) and b (n,) expected, "
                         f"got w {tuple(w.shape)}, b {tuple(b.shape)}")
    if n % 8 or k % 8 or k == 0:
        raise ValueError(f"linear: in = {k} and out = {n} must be positive multiples of 8")
    out_shape = (*x.shape[:-1], n)
    if residual is not None and (tuple(residual.shape) != out_shape
                                 or residual.dtype != x.dtype or not residual.is_contiguous()):
        raise ValueError(f"linear: residual must be a contiguous {out_shape} {x.dtype} tensor")
    w, b = w.to(x.dtype).contiguous(), b.float().contiguous()
    _check_aligned("linear", (x, w, b) if residual is None else (x, w, b, residual))
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    LIBRARY.launch(f"prpe_linear_{_SUFFIX[x.dtype]}", ("linear",), x, x.data_ptr(), w.data_ptr(),
                   b.data_ptr(), None if residual is None else residual.data_ptr(),
                   out.data_ptr(), x.numel() // k, n, k)
    return out


@torch.library.custom_op("prpe::ln_mhsa", mutates_args=(), device_types="cpu")
def _ln_mhsa_op(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, wq: torch.Tensor,
                bq: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, heads: int,
                eps: float) -> torch.Tensor:
    return ln_mhsa_plain(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads, eps=eps)


@_ln_mhsa_op.register_kernel("cuda")
def _(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
    b, t, c = x.shape
    ptrs = (x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_aligned("fused_ln_mhsa", ptrs)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ws = torch.empty(4 * b * t * c, dtype=x.dtype, device=x.device)
    LIBRARY.launch(f"prpe_ln_mhsa_{_SUFFIX[x.dtype]}", ("ln_mhsa",), x,
                   *(p.data_ptr() for p in ptrs), out.data_ptr(), ws.data_ptr(),
                   b, t, c, heads, float(eps), float((c // heads) ** -0.5))
    return out


@_ln_mhsa_op.register_fake
def _(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
    return torch.empty_like(x)


def fused_ln_mhsa(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHSA(qkv(LN(x))))``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Inference only (no gradient). The launch
    is the custom op ``prpe::ln_mhsa`` (see ``attention.py``), whose CPU
    implementation is the plain version."""
    args = (ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)
    if x.device.type != "cpu":
        _check_cuda("fused_ln_mhsa", x, args, tuple(_SUFFIX))
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(
                f"fused_ln_mhsa: x must be a contiguous (B, T, C) tensor, got {x.shape}")
        b, t, c = x.shape
        for name, a in zip(("ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"), args):
            want = (c, c) if name.startswith("w") else (c,)
            if tuple(a.shape) != want:
                raise ValueError(
                    f"fused_ln_mhsa: {name} has shape {tuple(a.shape)}, expected {want}")
        if heads <= 0 or c % heads:
            raise ValueError(f"fused_ln_mhsa: C = {c} is not a multiple of heads = {heads}")
        if c // heads not in (16, 32, 64, 128):
            raise ValueError(f"fused_ln_mhsa: head dim {c // heads} not in (16, 32, 64, 128)")
        if t > MAX_T:
            raise ValueError(f"fused_ln_mhsa: T = {t} > {MAX_T}")
        _check_row_width("fused_ln_mhsa", x, c)
        wq, wk, wv, wo = (w.to(x.dtype).contiguous() for w in (wq, wk, wv, wo))
        ln_w, ln_b, bq, bk, bv, bo = (p.float().contiguous() for p in (ln_w, ln_b, bq, bk, bv, bo))
    return _ln_mhsa_op(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, float(eps))
