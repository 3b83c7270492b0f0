"""The training-mode pieces of the port's modules on the CPU: BatchNorm on
batch statistics against ``flax.linen.BatchNorm``, dropout, the trunk's
recomputation, the attention ops' backward against ``jax.vjp`` of the JAX
package's ``mhsa_attention``, and a ``pallas_lnfused`` training forward.

Tolerances are stated at each test.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.nn.vit import ViTPose as JViTPose
from prpe_tpu.ops.pallas.attention_kernel import mhsa_attention
from prpe_tpu_torch.nn import vit as pvit
from prpe_tpu_torch.nn.common import BatchNorm, Dropout
from prpe_tpu_torch.nn.resnet import ResNetTrunk
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.ops.kernels.attention import mhsa_backward, mhsa_bhtd, mhsa_packed
from test_torch_models import port_module, random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


# ----------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,momentum", [((4, 6, 6, 16), 0.97), ((3, 2, 2, 8), 0.9),
                                            ((16, 12), 0.9)])
def test_batchnorm_train_matches_flax(dtype, shape, momentum):
    """Output within 1e-5 (fp32) or one bf16 step (8e-3) of its magnitude;
    the new running mean and variance (fp32 either way) within 1e-6; in
    fp32 also the gradients of x, scale and bias within 1e-5."""
    rng = np.random.default_rng(len(shape) + int(momentum * 100))
    # a large mean against the spread: the fast variance's cancellation
    x = (rng.normal(size=shape) * 2.0 + 3.0).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(1, 0.1, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3, dtype=jdt)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    xj = jnp.asarray(x, jdt)
    y, new = bn.apply(v, xj, mutable=["batch_stats"])

    pb = BatchNorm(c, 1e-3, momentum=momentum, dim=x.ndim - 1)
    with torch.no_grad():
        for name, val in (("weight", scale), ("bias", bias), ("running_mean", mean0),
                          ("running_var", var0)):
            getattr(pb, name).copy_(torch.from_numpy(val))
    pb.train()
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    yt = pb(xt)
    assert yt.dtype == tdt
    assert max_rel(yt.detach().float(), np.asarray(y, np.float32)) <= (
        1e-5 if dtype == "float32" else 8e-3)
    np.testing.assert_allclose(pb.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb.running_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    if dtype == "float32":
        gy = rng.normal(size=shape).astype(np.float32)
        grads = torch.autograd.grad(yt, [xt, pb.weight, pb.bias], torch.from_numpy(gy))

        def f(x, s, b):
            out, _ = bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": v["batch_stats"]},
                              x, mutable=["batch_stats"])
            return (out * gy).sum()

        jgrads = jax.grad(f, argnums=(0, 1, 2))(xj, jnp.asarray(scale), jnp.asarray(bias))
        for g, w in zip(grads, jgrads):
            assert max_rel(g, w) <= 1e-5


def test_batchnorm_eval_mode_is_the_folded_one():
    pb = BatchNorm(8, 1e-5)
    with torch.no_grad():
        pb.weight.fill_(2.0)
        pb.bias.fill_(0.5)
        pb.running_mean.fill_(1.0)
        pb.running_var.fill_(4.0)
    pb.eval()
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    want = (x - 1.0) * (2.0 / np.sqrt(4.0 + 1e-5)) + 0.5
    torch.testing.assert_close(pb(x), want, rtol=1e-6, atol=1e-6)
    assert float(pb.running_mean[0]) == 1.0  # eval moves nothing


# ------------------------------------------------------------------- Dropout

def test_dropout_share_and_scale():
    """The share dropped within 0.01 of the rate over 200 000 elements; the
    kept ones scaled by exactly 1 / (1 - rate); identity in eval mode."""
    d = Dropout(0.4)
    x = torch.full((200_000,), 3.0)
    d.train()
    with pytest.raises(RuntimeError, match="torch.Generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.4) < 0.01
    assert torch.all((y == 0) | (y == torch.tensor(3.0) / 0.6))
    # the same seed draws the same mask
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    d.eval()
    assert d(x) is x
    d.train()
    d.rate = 1.0
    assert torch.count_nonzero(d(x)) == 0


# ----------------------------------------------------- trunk recomputation

def test_trunk_remat_moves_running_stats_once():
    """With ``remat`` the trunk recomputes each block on the backward; the
    running statistics, the output and the gradients equal those of a run
    without it (to 1e-6), so the recomputation moved nothing twice."""
    torch.manual_seed(0)
    plain = ResNetTrunk((1, 1, 1, 1), remat=False)
    with torch.no_grad():
        for name, b in plain.named_buffers():
            b.copy_(torch.rand_like(b) + 0.5 if name.endswith("var") else torch.randn_like(b) * 0.1)
        for p in plain.parameters():
            p.normal_(0, 0.1)
    remat = ResNetTrunk((1, 1, 1, 1), remat=True)
    remat.load_state_dict(plain.state_dict())
    start = plain.layer4_0.bn3.running_var.clone()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for m in (plain, remat):
        m.train()
        y = m(x)
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y.square().sum(), list(m.parameters())))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for g1, g0 in zip(grads[1], grads[0]):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)
    for (name, b1), (_, b0) in zip(remat.named_buffers(), plain.named_buffers()):
        torch.testing.assert_close(b1, b0, rtol=0, atol=1e-6, msg=name)
    # and the statistics did move
    assert not torch.equal(remat.layer4_0.bn3.running_var, start)


# ---------------------------------------------------------- attention grads

B, T, H, D = 2, 24, 4, 16


def qkvg(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.0, (B, T, H, D)).astype(np.float32) for _ in range(4)]


def jax_grads(arrays, dtype):
    q, k, v, g = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: mhsa_attention(q, k, v), q, k, v)
    return out, vjp(g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "bhtd"])
def test_attention_backward_matches_jax_vjp(dtype, layout):
    """The plain forward plus the registered backward against ``jax.vjp``
    of ``mhsa_attention`` (its ``_bwd``): fp32 within 1e-5 of the largest
    gradient; bf16, where both sides take the same roundings, within two
    bf16 steps (1.6e-2)."""
    arrays = qkvg(dtype)
    want_out, want = jax_grads(arrays, dtype)
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in arrays)
    if layout == "packed":
        ins = [x.reshape(B, T, H * D).requires_grad_() for x in (q, k, v)]
        out = mhsa_packed(*ins, H)
        grads = torch.autograd.grad(out, ins, g.reshape(B, T, H * D))
        grads = [x.reshape(B, T, H, D) for x in grads]
        out = out.reshape(B, T, H, D)
    else:
        ins = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
        out = mhsa_bhtd(*ins)
        grads = torch.autograd.grad(out, ins, g.transpose(1, 2))
        grads = [x.transpose(1, 2) for x in grads]
        out = out.transpose(1, 2)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    assert max_rel(out.detach().float(), np.asarray(want_out, np.float32)) <= max(tol, 1e-5)
    for got, w in zip(grads, want):
        assert got.dtype == tdt
        w = np.asarray(w, np.float32)
        err = float(np.abs(got.float().numpy() - w).max())
        assert err <= tol * float(np.abs(w).max()), err


class _AttentionF64(torch.autograd.Function):
    """A float64 attention forward with ``mhsa_backward`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    @staticmethod
    def backward(ctx, g):
        return mhsa_backward(*ctx.saved_tensors, g)


def test_attention_backward_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the backward against finite
    differences of a float64 forward (its softmax is fp32, as in ``_bwd``,
    so within gradcheck's default atol 1e-5 / rtol 1e-3)."""
    gen = torch.Generator().manual_seed(3)
    ins = [torch.randn(1, 6, 2, 8, dtype=torch.float64, generator=gen).requires_grad_()
           for _ in range(3)]
    assert torch.autograd.gradcheck(_AttentionF64.apply, ins)


# ---------------------------------------------- pallas_lnfused in training

def test_lnfused_training_forward_takes_the_module_path(monkeypatch):
    """Under ``pallas_lnfused`` a training forward never calls the fused
    half-block (K4, inference only, as in the JAX package), matches the JAX
    package's training forward (within 1e-4) and has a backward; an eval
    forward still calls it."""
    pose = dict(image_size=(64, 48), hidden=32, layers=2, heads=2)
    x = np.random.default_rng(12).normal(size=(2, 64, 48, 3)).astype(np.float32)
    jm = JViTPose(**pose)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=2)
    monkeypatch.setenv("PRPE_ATTN_MODE", "pallas_lnfused")
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    pm = port_module(lambda: ViTPose(**pose), v)
    calls = {"fused": 0, "bhtd": 0}
    fused, bhtd = pvit.fused_ln_mhsa, pvit.mhsa_bhtd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pvit, "fused_ln_mhsa", count("fused", fused))
    monkeypatch.setattr(pvit, "mhsa_bhtd", count("bhtd", bhtd))
    pm.train()
    got = pm(torch.from_numpy(x))
    assert calls == {"fused": 0, "bhtd": pose["layers"]}
    assert max_rel(got.detach(), np.asarray(want)) <= 1e-4
    grads = torch.autograd.grad(got.square().sum(), list(pm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    pm.eval()
    with torch.no_grad():
        pm(torch.from_numpy(x))
    assert calls["fused"] == pose["layers"]
