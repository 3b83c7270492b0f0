"""The plain packed MHSA (the CPU side of ``csrc/mhsa.cu``) against the JAX
package's packed Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops.pallas.attention_kernel import _pallas_forward
from prpe_tpu_torch.ops.kernels.attention import mhsa_packed, mhsa_packed_plain

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
