"""Packed multi-head self-attention: the CUDA kernel ``csrc/mhsa.cu`` and its
plain version.

Counterpart of ``prpe_tpu/ops/pallas/attention_kernel.py::_mhsa_kernel_packed``
(``_pallas_forward(variant="packed")``). q/k/v and the output stay in the
natural (B, T, H*D) layout. CPU tensors take :func:`mhsa_packed_plain`; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from prpe_tpu_torch.ops.kernels import _build

# longest sequence the kernel takes: the JAX package's MAX_PALLAS_T
MAX_T = 1024
_DTYPES = {torch.float32: "prpe_mhsa_packed_f32", torch.bfloat16: "prpe_mhsa_packed_bf16"}


def mhsa_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch packed MHSA with the kernel's numerics: fp32 logits
    scaled after the dot product, fp32 softmax, P rounded to the input dtype,
    fp32 accumulation of P V, output in the input dtype."""
    b, t, c = q.shape
    d = c // heads
    split = lambda x: x.reshape(b, t, heads, d).transpose(1, 2).float()  # noqa: E731
    s = split(q) @ split(k).transpose(-1, -2) * (d ** -0.5)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    o = p @ split(v)
    return o.transpose(1, 2).reshape(b, t, c).to(q.dtype)


def mhsa_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(Q K^T d^-1/2) V over (B, T, H*D) tensors, per head: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return mhsa_packed_plain(q, k, v, heads)
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError(f"mhsa_packed: q/k/v on {q.device}, {k.device}, {v.device}")
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"mhsa_packed: shapes {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mhsa_packed: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mhsa_packed: q, k and v must be contiguous")
    b, t, c = q.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"mhsa_packed: C = {c} is not a multiple of heads = {heads}")
    d = c // heads
    if t > MAX_T:
        raise ValueError(f"mhsa_packed: T = {t} > {MAX_T}")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"mhsa_packed: head dim {d} not in (16, 32, 64, 128)")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("mhsa_packed: q, k and v must start on 16-byte boundaries")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    fn = getattr(_build.load("mhsa"), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, t, heads, d, float(d ** -0.5), stream)
    _build.check(err, "mhsa_packed launch")
    _build.launches["mhsa"] += 1
    return o
