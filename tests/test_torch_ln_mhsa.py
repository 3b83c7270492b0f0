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
from prpe_tpu_torch.ops.kernels.attention import mhsa_packed_plain
from prpe_tpu_torch.ops.kernels.ln_mhsa import (
    fused_ln_mhsa, layernorm, layernorm_plain, linear, linear_plain, ln_mhsa_plain,
)


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


@pytest.mark.parametrize("b,t,c,heads", [(2, 24, 64, 4), (3, 10, 32, 2), (1, 192, 768, 12)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_plain_ln_mhsa_matches_pallas(b, t, c, heads, dtype, tol):
    """Tolerances are the JAX package's own for this kernel
    (tests/test_pallas_attention.py); the last shape is ViT-B's width."""
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


def _old_ln_mhsa_plain(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps=1e-12):
    """The plain half-block as one function, before its stages were split
    out: the composition must keep every rounding of it."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stages_compose_to_ln_mhsa_plain(dtype):
    """layernorm_plain -> three linear_plain -> mhsa_packed_plain ->
    linear_plain with the residual is ln_mhsa_plain, bit for bit, and equal
    to the one-function version it replaced."""
    x, params = half_block_inputs(2, 24, 64, seed=11)
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td)
    lw, lb, wq, bq, wk, bk, wv, bv, wo, bo = port_params(params)
    xn = layernorm_plain(xt, lw, lb)
    o = mhsa_packed_plain(linear_plain(xn, wq, bq), linear_plain(xn, wk, bk),
                          linear_plain(xn, wv, bv), 4)
    staged = linear_plain(o, wo, bo, residual=xt)
    want = ln_mhsa_plain(xt, *port_params(params), heads=4)
    assert staged.dtype == td
    assert torch.equal(staged, want)
    assert torch.equal(want, _old_ln_mhsa_plain(xt, *port_params(params), heads=4))


@pytest.mark.parametrize("dtype,with_residual", [
    pytest.param("bfloat16", False, id="False"), pytest.param("bfloat16", True, id="True"),
    pytest.param("float32", False, id="float32-False"),
    pytest.param("float32", True, id="float32-True")])
def test_linear_plain_matches_pallas_dense(dtype, with_residual):
    """linear_plain against the Pallas body's ``dense`` (``dot_general`` with
    ``preferred_element_type=float32``, plus the fp32 bias, rounded once),
    then ``x + y`` as the body adds its residual, in ``dtype`` through
    jax.numpy. The two fp32 sums run in different orders, so a bf16 result
    may sit one bf16 step (2**-8 relative) away, an fp32 one a few fp32 ulps
    (1e-5 on these unit-scale sums of 64 products)."""
    import jax

    rng = np.random.default_rng(12)
    m, k, n = 40, 64, 96
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, k ** -0.5, (k, n)).astype(np.float32)  # JAX (in, out)
    b = rng.normal(0, 0.02, (n,)).astype(np.float32)
    res = rng.normal(0, 1, (m, n)).astype(np.float32)
    jdt, td = getattr(jnp, dtype), getattr(torch, dtype)
    y = jax.lax.dot_general(jnp.asarray(a, jdt), jnp.asarray(w, jdt), (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    want = (y + jnp.asarray(b)).astype(jdt)
    if with_residual:
        want = jnp.asarray(res, jdt) + want
    got = linear_plain(torch.from_numpy(a).to(td), torch.from_numpy(w.T.copy()),
                       torch.from_numpy(b),
                       torch.from_numpy(res).to(td) if with_residual else None)
    assert got.dtype == td and got.shape == (m, n)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
        assert np.mean(got == want) > 0.95
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage_wrappers_cpu_path_is_plain(dtype):
    x, params = half_block_inputs(2, 12, 32, seed=13)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    lw, lb, wq, bq = port_params(params)[:4]
    assert torch.equal(layernorm(xt, lw, lb), layernorm_plain(xt, lw, lb))
    assert torch.equal(linear(xt, wq, bq), linear_plain(xt, wq, bq))
    assert torch.equal(linear(xt, wq, bq, residual=xt), linear_plain(xt, wq, bq, residual=xt))


@pytest.mark.parametrize("stage", ["layernorm", "linear"])
def test_stage_wrappers_refuse_other_devices(stage):
    """A tensor that is not on the CPU never takes a plain version."""
    x = torch.empty(1, 4, 32, device="meta")
    w, b = torch.empty(32, 32, device="meta"), torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        if stage == "layernorm":
            layernorm(x, b, b)
        else:
            linear(x, w, b)
