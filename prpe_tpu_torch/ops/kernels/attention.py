"""Multi-head self-attention: the CUDA kernels of ``csrc/mhsa.cu`` and their
plain versions, over two layouts.

- :func:`mhsa_packed`: q/k/v and the output in the natural (B, T, H*D)
  layout. Counterpart of ``prpe_tpu/ops/pallas/attention_kernel.py::
  _mhsa_kernel_packed`` (``_pallas_forward(variant="packed")``).
- :func:`mhsa_bhtd`: (B, H, T, D) tensors. Counterpart of the three Pallas
  kernels that ``_pallas_forward`` runs on that layout (``_mhsa_kernel_batched``,
  ``_mhsa_kernel`` and ``_mhsa_kernel_bh``): one function on one layout,
  which one CUDA kernel serves (see ``csrc/mhsa.cu``).

Each launch is the custom op ``prpe::mhsa_packed`` / ``prpe::mhsa_bhtd``
(a fake implementation gives its output's shape), so ``torch.export``
keeps the kernel as one node of the exported graph. The op's CPU
implementation is the plain version; its CUDA implementation launches the
kernel. The wrappers check shapes, dtypes and devices before the op, and
refuse a tensor that is on neither: CPU tensors take the plain versions,
CUDA tensors launch the kernel or raise.

Both ops are differentiable: the forward is the kernel (or the plain
version on the CPU) and the backward is :func:`mhsa_backward`, the JAX
package's recompute (``attention_kernel.py::_bwd``) in PyTorch ops.
"""

from __future__ import annotations

import torch

from prpe_tpu_torch.ops.kernels._build import FLOAT, INT, PTR, Library

# a launch counts in the route of its layout: "mhsa" packed, "mhsa_bhtd"
LIBRARY = Library("mhsa", {f"prpe_mhsa_{layout}_{dt}": [PTR] * 4 + [INT] * 4 + [FLOAT, PTR]
                           for layout in ("packed", "bhtd") for dt in ("f32", "bf16")},
                  routes=("mhsa", "mhsa_bhtd"))
# longest sequence the kernel takes: the JAX package's MAX_PALLAS_T
MAX_T = 1024
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def mhsa_bhtd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MHSA over (B, H, T, D) with the kernel's numerics: fp32
    logits scaled after the dot product, fp32 softmax, P rounded to the input
    dtype, fp32 accumulation of P V, output in the input dtype."""
    d = q.shape[-1]
    s = q.float() @ k.float().transpose(-1, -2) * (d ** -0.5)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return (p @ v.float()).to(q.dtype)


def mhsa_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """:func:`mhsa_bhtd_plain` over packed (B, T, H*D) tensors."""
    b, t, c = q.shape
    split = lambda x: x.reshape(b, t, heads, c // heads).transpose(1, 2)  # noqa: E731
    return mhsa_bhtd_plain(split(q), split(k), split(v)).transpose(1, 2).reshape(b, t, c)


def _check(name: str, q, k, v, t: int, d: int) -> None:
    """The kernel's conditions on q/k/v that a fake tensor can show too."""
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q/k/v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _SUFFIX or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if t > MAX_T:
        raise ValueError(f"{name}: T = {t} > {MAX_T}")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head dim {d} not in (16, 32, 64, 128)")


def _launch(name: str, layout: str, q, k, v, b: int, t: int, heads: int, d: int) -> torch.Tensor:
    """Launch ``prpe_mhsa_<layout>_<dtype>`` on checked q/k/v, counted in
    route ``name``."""
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on 16-byte boundaries")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    LIBRARY.launch(f"prpe_mhsa_{layout}_{_SUFFIX[q.dtype]}", (name,), q, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, heads, d, float(d ** -0.5))
    return o


@torch.library.custom_op("prpe::mhsa_packed", mutates_args=(), device_types="cpu")
def _mhsa_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    return mhsa_packed_plain(q, k, v, heads)


@_mhsa_packed_op.register_kernel("cuda")
def _(q, k, v, heads):
    b, t, c = q.shape
    return _launch("mhsa", "packed", q, k, v, b, t, heads, c // heads)


@torch.library.custom_op("prpe::mhsa_bhtd", mutates_args=(), device_types="cpu")
def _mhsa_bhtd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mhsa_bhtd_plain(q, k, v)


@_mhsa_bhtd_op.register_kernel("cuda")
def _(q, k, v):
    b, h, t, d = q.shape
    return _launch("mhsa_bhtd", "bhtd", q, k, v, b, t, h, d)


@_mhsa_packed_op.register_fake
def _(q, k, v, heads):
    return torch.empty_like(q)


@_mhsa_bhtd_op.register_fake
def _(q, k, v):
    return torch.empty_like(q)


def mhsa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor):
    """The attention backward of ``attention_kernel.py::_bwd``, recomputed
    from q/k/v over (B, T, H, D) tensors (any strides), with its roundings:
    the logits come out in the input dtype and are scaled after that
    rounding; the softmax runs in fp32 and P is rounded to the input dtype
    for dV = P^T g; dP = g V^T is rounded to the input dtype, then taken to
    fp32; dS = P (dP - sum(dP P)) in fp32, scaled, then rounded; dQ and dK
    in the input dtype. Returns (dq, dk, dv) in the same layout."""
    d = q.shape[-1]
    scale = d ** -0.5
    g = g.to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s.float(), dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq, dk, dv


def _save_qkv(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])


def _packed_backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    b, t, c = q.shape
    heads = ctx.heads
    split = lambda x: x.view(b, t, heads, c // heads)  # noqa: E731
    grads = mhsa_backward(split(q), split(k), split(v), split(grad.contiguous()))
    return (*(x.reshape(b, t, c) for x in grads), None)


def _save_packed(ctx, inputs, output):
    _save_qkv(ctx, inputs, output)
    ctx.heads = inputs[3]


def _bhtd_backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    bthd = lambda x: x.transpose(1, 2)  # noqa: E731  (B, H, T, D) <-> (B, T, H, D)
    grads = mhsa_backward(bthd(q), bthd(k), bthd(v), bthd(grad))
    return tuple(bthd(x).contiguous() for x in grads)


# the kernels stay the forward; the backward is the JAX package's einsum
# recompute (a product outside any Pallas kernel), on either device
_mhsa_packed_op.register_autograd(_packed_backward, setup_context=_save_packed)
_mhsa_bhtd_op.register_autograd(_bhtd_backward, setup_context=_save_qkv)


def mhsa_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(Q K^T d^-1/2) V over (B, T, H*D) tensors, per head: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type != "cpu":
        if q.dim() != 3 or not (q.shape == k.shape == v.shape):
            raise ValueError(f"mhsa_packed: shapes {q.shape}, {k.shape}, {v.shape}")
        b, t, c = q.shape
        if heads <= 0 or c % heads:
            raise ValueError(f"mhsa_packed: C = {c} is not a multiple of heads = {heads}")
        _check("mhsa_packed", q, k, v, t, c // heads)
    return _mhsa_packed_op(q, k, v, heads)


def mhsa_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T d^-1/2) V over (B, H, T, D) tensors: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if q.device.type != "cpu":
        if q.dim() != 4 or not (q.shape == k.shape == v.shape):
            raise ValueError(f"mhsa_bhtd: shapes {q.shape}, {k.shape}, {v.shape}")
        _check("mhsa_bhtd", q, k, v, q.shape[2], q.shape[3])
    return _mhsa_bhtd_op(q, k, v)
