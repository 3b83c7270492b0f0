"""The plain MHSA versions (the CPU side of ``csrc/mhsa.cu``) against the JAX
package's Pallas kernels in interpret mode: packed, and the three kernels
over (B, H, T, D)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops.pallas.attention_kernel import _pallas_forward
from prpe_tpu_torch.ops.kernels.attention import (
    mhsa_bhtd, mhsa_bhtd_plain, mhsa_packed, mhsa_packed_plain,
)
from torch_one_thread import torch_on_one_thread  # noqa: F401

B, T, H, D = 2, 24, 2, 16


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_packed_mhsa_matches_pallas(dtype, tol):
    """fp32: both accumulate in fp32 (1e-5); bf16: P and the output are
    rounded to bf16 on both sides, one bf16 step of unit-scale outputs."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (B, T, H * D)).astype(np.float32) for _ in range(3))
    jd = getattr(jnp, dtype)
    want = _pallas_forward(*(jnp.asarray(a, jd).reshape(B, T, H, D) for a in (q, k, v)),
                           interpret=True, variant="packed")
    want = np.asarray(want, np.float32).reshape(B, T, H * D)
    td = getattr(torch, dtype)
    got = mhsa_packed(*(torch.from_numpy(a).to(td) for a in (q, k, v)), H)
    assert got.dtype == td and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_mhsa_cpu_path_is_plain():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 10, 32)).astype(np.float32)) for _ in range(3))
    assert torch.equal(mhsa_packed(q, k, v, 4), mhsa_packed_plain(q, k, v, 4))


@pytest.mark.parametrize("variant", ["batched", "unrolled", "bh"])
@pytest.mark.parametrize("shape", [(2, 24, 2, 16), (1, 65, 3, 32)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_bhtd_mhsa_matches_pallas(variant, shape, dtype, tol):
    """The (B, H, T, D) plain version against each Pallas kernel on that
    layout, fed (B, T, H, D) as ``_pallas_forward`` takes it; tolerances as
    for the packed kernel."""
    b, t, h, d = shape
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    want = _pallas_forward(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                           interpret=True, variant=variant)
    td = getattr(torch, dtype)
    got = mhsa_bhtd(*(torch.from_numpy(a).to(td).transpose(1, 2).contiguous() for a in (q, k, v)))
    assert got.dtype == td and got.shape == (b, h, t, d)
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_bhtd_cpu_path_is_plain_and_packed_agrees():
    """On the CPU the wrapper is the plain version, and the two layouts
    compute the same function."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 10, 16)).astype(np.float32))
               for _ in range(3))
    got = mhsa_bhtd(q, k, v)
    assert torch.equal(got, mhsa_bhtd_plain(q, k, v))
    pack = lambda x: x.transpose(1, 2).reshape(2, 10, 48)  # noqa: E731
    assert torch.equal(pack(got), mhsa_packed_plain(pack(q), pack(k), pack(v), 3))


@pytest.mark.parametrize("fn", ["mhsa_packed", "mhsa_bhtd"])
def test_wrappers_refuse_other_devices(fn):
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches its kernel or raises."""
    from prpe_tpu_torch.ops.kernels import attention

    shape = (2, 10, 32) if fn == "mhsa_packed" else (2, 2, 10, 16)
    q = torch.empty(shape, device="meta")
    args = (q, q, q, 2) if fn == "mhsa_packed" else (q, q, q)
    with pytest.raises(ValueError, match="meta"):
        getattr(attention, fn)(*args)
