"""The plain fused LN -> MHSA half-block (the CPU side of ``csrc/ln_mhsa.cu``)
against the JAX package's ``fused_ln_mhsa`` Pallas kernel in interpret mode.

The plain version follows the Pallas body, not its XLA oracle
``_ln_mhsa_reference``: in bf16 the oracle rounds the logits and each
projection before its bias, and differs from the body by a bf16 step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops.pallas.attention_kernel import fused_ln_mhsa as jfused_ln_mhsa
from prpe_tpu_torch.ops.kernels.ln_mhsa import fused_ln_mhsa, ln_mhsa_plain


def half_block_inputs(b, t, c, seed):
    """x, then (ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo) with JAX's
    (in, out) kernels, all fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, t, c)).astype(np.float32)
    params = [rng.normal(1, 0.1, (c,)), rng.normal(0, 0.1, (c,))]
    for _ in range(4):
        params += [rng.normal(0, c ** -0.5, (c, c)), rng.normal(0, 0.02, (c,))]
    return x, [p.astype(np.float32) for p in params]


def port_params(params):
    """JAX (in, out) kernels -> the port's (out, in) Linear weights."""
    return [torch.from_numpy(np.ascontiguousarray(p.T if p.ndim == 2 else p)) for p in params]


@pytest.mark.parametrize("b,t,c,heads", [(2, 24, 64, 4), (3, 10, 32, 2)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_plain_ln_mhsa_matches_pallas(b, t, c, heads, dtype, tol):
    """Tolerances are the JAX package's own for this kernel
    (tests/test_pallas_attention.py)."""
    x, params = half_block_inputs(b, t, c, seed=b)
    want = jfused_ln_mhsa(jnp.asarray(x, getattr(jnp, dtype)), *params, heads=heads,
                          interpret=True)
    td = getattr(torch, dtype)
    got = ln_mhsa_plain(torch.from_numpy(x).to(td), *port_params(params), heads=heads)
    assert got.dtype == td and got.shape == (b, t, c)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_cpu_path_is_plain():
    x, params = half_block_inputs(2, 12, 32, seed=7)
    xt, pt = torch.from_numpy(x).bfloat16(), port_params(params)
    assert torch.equal(fused_ln_mhsa(xt, *pt, heads=2), ln_mhsa_plain(xt, *pt, heads=2))


def test_wrapper_refuses_other_devices():
    """A tensor that is not on the CPU never takes the plain version."""
    x, params = half_block_inputs(1, 4, 32, seed=8)
    meta = [torch.empty(p.shape, device="meta") for p in port_params(params)]
    with pytest.raises(ValueError, match="meta"):
        fused_ln_mhsa(torch.empty(x.shape, device="meta"), *meta, heads=2)
