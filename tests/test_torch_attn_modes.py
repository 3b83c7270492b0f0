"""``PRPE_ATTN_MODE`` in the port's ViT against the JAX package on the CPU.

The JAX package reads the variable while it traces, so each case builds a
fresh jitted apply after setting it. Both sides get the same weights (a
numpy-filled JAX variable tree carried over by ``from_jax_variables``, strict
load) and the same numpy inputs. On the CPU the JAX package's Pallas modes
fall back to its einsum path and XLA oracle, and the port's wrappers take
their plain versions, so fp32 outputs agree to summation order in every
mode. Which kernel each mode routes to is checked separately, by counting
the calls of the port's wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.nn.vit import MHSA as JMHSA
from prpe_tpu.nn.vit import ViTBlock as JViTBlock
from prpe_tpu.nn.vit import ViTPose as JViTPose
from prpe_tpu_torch.nn import vit as pvit
from prpe_tpu_torch.nn.vit import MHSA, ViTBlock, ViTPose
from test_torch_models import assert_rel, port_module, random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401

# tools/bench_attention.py's seven modes, the legacy alias and an unknown
# pallas_* suffix (None: PRPE_ATTN_MODE unset)
MODES = ["einsum", "einsum_bf16sm", "pallas", "pallas_unrolled", "pallas_bh",
         "pallas_packed", "pallas_lnfused"]
CASES = [(m, None) for m in MODES] + [(None, "1"), ("pallas_x", None), (None, None)]
CASE_IDS = [m or f"unset-fused{f}" for m, f in CASES]

ROUTE = {  # mode -> the port function its attention goes through
    "einsum": "einsum_attention", "einsum_bf16sm": "einsum_attention",
    "pallas": "mhsa_bhtd", "pallas_unrolled": "mhsa_bhtd", "pallas_bh": "mhsa_bhtd",
    "pallas_x": "mhsa_bhtd", "pallas_packed": "mhsa_packed", "pallas_lnfused": "fused_ln_mhsa",
}

FP32_TOL = 1e-4  # relative to the largest output magnitude, as in test_torch_models
# bf16, einsum modes: both sides run the same roundings; they differ where a
# sum lands on a rounding boundary (matmul order, the bias add fused or not),
# one bf16 step of the LayerNorm-scale activations, carried through 2 layers
BF16_TOL = 3e-2

BLOCK = dict(hidden=64, heads=4)
POSE = dict(image_size=(64, 48), hidden=64, layers=2, heads=4)


def set_mode(monkeypatch, mode, fused):
    for name, value in (("PRPE_ATTN_MODE", mode), ("PRPE_FUSED_ATTENTION", fused)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


@pytest.fixture(scope="module")
def block_pair():
    x = np.random.default_rng(11).normal(size=(2, 24, BLOCK["hidden"])).astype(np.float32)
    jm = JViTBlock(**BLOCK)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    return jm, v, x, port_module(lambda: ViTBlock(**BLOCK), v)


@pytest.fixture(scope="module")
def pose_pair():
    x = np.random.default_rng(12).normal(size=(2, 64, 48, 3)).astype(np.float32)
    jm = JViTPose(**POSE)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=2)
    return jm, v, x, port_module(lambda: ViTPose(**POSE), v)


def run_pair(pair, dtype="float32"):
    """(port output, JAX output) as fp32 numpy, under the current env."""
    jm, v, x, pm = pair
    jm = jm.clone(dtype=getattr(jnp, dtype))
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x, jm.dtype))
    td = getattr(torch, dtype)
    if isinstance(pm, ViTPose):
        pm.dtype = td
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(td))
    if isinstance(pm, ViTPose):
        pm.dtype = torch.float32
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("mode,fused", CASES, ids=CASE_IDS)
def test_vit_block_matches_jax(block_pair, monkeypatch, mode, fused):
    set_mode(monkeypatch, mode, fused)
    assert_rel(*run_pair(block_pair), FP32_TOL)


@pytest.mark.parametrize("mode,fused", CASES, ids=CASE_IDS)
def test_vitpose_matches_jax(pose_pair, monkeypatch, mode, fused):
    set_mode(monkeypatch, mode, fused)
    got, want = run_pair(pose_pair)
    assert got.shape == (2, 17, 16, 12)
    assert_rel(got, want, FP32_TOL)


@pytest.mark.parametrize("mode", ["einsum", "einsum_bf16sm"])
@pytest.mark.parametrize("which", ["block", "pose"])
def test_einsum_modes_bf16_match_jax(block_pair, pose_pair, monkeypatch, mode, which):
    set_mode(monkeypatch, mode, None)
    assert_rel(*run_pair(block_pair if which == "block" else pose_pair, "bfloat16"), BF16_TOL)


@pytest.mark.parametrize("which", ["block", "pose"])
@pytest.mark.parametrize("mode,fused", CASES, ids=CASE_IDS)
def test_mode_routes_to_its_kernel(block_pair, pose_pair, monkeypatch, mode, fused, which):
    """Each mode calls exactly its wrapper, once per block, with contiguous
    tensors (the CUDA kernels refuse others). The ViTPose crops are an NHWC
    view of channels-first memory, as the cascade's crops are, which makes
    the first block's input a transposed view."""
    set_mode(monkeypatch, mode, fused)
    calls = {name: 0 for name in set(ROUTE.values())}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(pvit, name), **kw):
            calls[_name] += 1
            assert all(a.is_contiguous() for a in args if isinstance(a, torch.Tensor)), _name
            return _fn(*args, **kw)
        monkeypatch.setattr(pvit, name, counted)
    _, _, x, pm = block_pair if which == "block" else pose_pair
    if which == "pose":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        pm(torch.from_numpy(x) if which == "block" else torch.from_numpy(x).permute(0, 2, 3, 1))
    want_route = ROUTE.get(pvit.attn_mode(), "einsum_attention")
    assert pvit.attn_mode() == (mode or ("pallas_unrolled" if fused else "pallas_packed"))
    layers = 1 if which == "block" else POSE["layers"]
    assert calls == {name: layers * int(name == want_route) for name in calls}


@pytest.mark.parametrize("mode", ["einsum", "einsum_bf16sm"])
def test_einsum_modes_bf16_roundings(monkeypatch, mode):
    """The einsum path's bf16 roundings, op for op: with permutation
    matrices for the q/k/v/proj weights (exact in bf16) the MHSA output is
    the attention alone. Against JAX run op by op (each op rounds to bf16;
    a jitted XLA CPU program elides some of those roundings), at most 1 % of
    the elements may differ, by one bf16 step (the exp and matmul
    implementations differ). Keeping the logits in fp32, or an fp32 softmax
    in ``einsum_bf16sm``, changes about a third of them."""
    set_mode(monkeypatch, mode, None)
    c, heads = 64, 4
    x = np.random.default_rng(13).normal(0, 3, (2, 40, c)).astype(np.float32)
    eye = np.eye(c, dtype=np.float32)
    kernels = {"q": eye, "k": eye[np.random.default_rng(1).permutation(c)],
               "v": eye[np.random.default_rng(2).permutation(c)], "proj": eye}
    variables = {"params": {n: {"kernel": w, "bias": np.zeros(c, np.float32)}
                            for n, w in kernels.items()}}
    want = np.asarray(JMHSA(hidden=c, heads=heads, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    pm = port_module(lambda: MHSA(c, heads), variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).bfloat16()).float().numpy()
    assert (got != want).mean() <= 0.01
    assert_rel(got, want, 2 ** -8)


@pytest.mark.parametrize("layout", ["nhwc", "channels_first_view"])
def test_vit_token_stream_is_contiguous(pose_pair, layout):
    """Every block gets a contiguous (B, T, C) input whatever the crops'
    memory layout: a transposed view would carry its layout through every
    residual add (a copy before each LayerNorm and GEMM on the card)."""
    _, _, x, pm = pose_pair
    if layout == "nhwc":
        crops = torch.from_numpy(x)
    else:
        crops = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    seen = []
    hooks = [getattr(pm.backbone, f"block{i}").register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous())) for i in range(POSE["layers"])]
    try:
        with torch.no_grad():
            pm(crops)
    finally:
        for h in hooks:
            h.remove()
    assert seen == [True] * POSE["layers"]
