"""The multi-scale deformable attention kernel (``csrc/ms_deform_attn.cu``)
against its plain version on the card, at the benchmark cell's shapes
(B 128 frames, Lq 300 queries, S 8400 positions over the 80^2, 40^2 and
20^2 levels, H 8 heads of D 32, L 3 levels, P 4 points), in bf16 and fp32,
with sampling locations inside and outside the maps; its launch count in
RT-DETR (one a decoder layer); and the tensors it refuses. Needs the card:
every test is marked ``cuda`` and skips where no GPU is present. On the
card, without JAX:

    python -m pytest tests/test_torch_msda_cuda.py -m cuda --noconftest -q

Tolerances, each against the plain version computed in fp32 on the same
inputs (``want``) and the sum of the magnitudes it adds up (``mag``: the
plain version on ``|value|``; bilinear and attention weights are not
negative):

- fp32: ``|got - want| <= 2^-12 * mag``. The kernel sums the 4 corners, 3
  levels and 4 points in another order than ``grid_sample`` and the
  stacked sum (about 48 roundings of 2^-24 each), and ``grid_sample`` may
  contract its source coordinate ``(g + 1) * size - 1`` into one FMA,
  which moves a corner weight by up to an ulp of the coordinate (2^-17 at
  80 cells) times the difference of two values.
- bf16: the same plus ``2^-8 * |want|``: the kernel accumulates in fp32 and
  rounds once, to bf16 (half an ulp, 2^-9 relative; 2^-8 leaves room for
  the fp32 slack above crossing a rounding boundary). The plain version in
  bf16 rounds after each level's ``grid_sample`` and the weighting, so it
  is held to the fp32 result, not to the bf16 plain one.
"""

import pytest
import torch

from prpe_tpu_torch.nn.common import materialize
from prpe_tpu_torch.nn.rtdetr import RTDETR
from prpe_tpu_torch.ops.kernels import launches
from prpe_tpu_torch.ops.kernels.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain

pytestmark = pytest.mark.cuda

SHAPES = [80, 80, 40, 40, 20, 20]
B, LQ, H, D, L, P = 128, 300, 8, 32, 3, 4
S = 80 * 80 + 40 * 40 + 20 * 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def inputs(device, dtype, seed, batch=B):
    """Value N(0, 1); locations U(-0.1, 1.1), so that some points and corners
    fall outside the maps; softmaxed weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    value = torch.randn(batch, S, H, D, generator=gen, device=device).to(dtype)
    loc = torch.rand(batch, LQ, H, L, P, 2, generator=gen, device=device) * 1.2 - 0.1
    w = torch.softmax(torch.randn(batch, LQ, H, L * P, generator=gen, device=device), -1)
    return value, loc, w.view(batch, LQ, H, L, P)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_kernel_matches_plain_at_the_cell_shapes(cuda, dtype):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    value, loc, w = inputs(cuda, dt, 1)
    before = launches["msda"]
    with torch.inference_mode():
        got = ms_deform_attn(value, SHAPES, loc, w)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(value.float(), SHAPES, loc, w)
        mag = ms_deform_attn_plain(value.float().abs(), SHAPES, loc, w)
    assert launches["msda"] == before + 1
    assert got.dtype == dt and got.shape == (B, LQ, H * D)
    bound = 2.0**-12 * mag + (2.0**-8 * want.abs() if dt == torch.bfloat16 else 0.0)
    err = (got.float() - want).abs()
    assert bool((err <= bound).all()), float((err / bound.clamp(min=1e-30)).max())
    # points outside every map add nothing: the whole sum is 0
    value, loc, w = inputs(cuda, dt, 2, batch=2)
    loc[:, :, 0] = torch.tensor([-0.6, 1.7], device=cuda)
    with torch.inference_mode():
        out = ms_deform_attn(value, SHAPES, loc, w)
    assert bool((out[:, :, :D] == 0).all())


def test_one_launch_a_decoder_layer(cuda):
    """RT-DETR-R50 at the published widths, bf16, 2 frames of 640^2: one
    kernel launch in each of the 6 decoder layers."""
    with torch.device("meta"):
        model = RTDETR(dtype=torch.bfloat16)
    materialize(model, cuda, 0)
    x = torch.rand(2, 640, 640, 3, device=cuda)
    before = launches["msda"]
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert launches["msda"] - before == 6
    assert out.logits.shape == (2, 300, 80) and bool(out.boxes.isfinite().all())


def test_what_the_kernel_does_not_take_raises(cuda):
    """fp16 values, a strided value, heads of 512 bytes, bf16 locations,
    shapes that miss positions: ``ValueError`` before a launch; a call that
    would record a gradient: ``RuntimeError``."""
    value, loc, w = inputs(cuda, torch.bfloat16, 3, batch=1)
    before = launches["msda"]
    wide = torch.zeros(1, S, 2, 4 * D, device=cuda)  # 128 fp32 channels
    two = (loc[:, :, :2].contiguous(), w[:, :, :2].contiguous())
    bad = [(value.half(), SHAPES, loc, w), (value.transpose(2, 3), SHAPES, loc, w),
           (wide, SHAPES, *two), (value, SHAPES, loc.bfloat16(), w),
           (value, [80, 80, 40, 40, 20, 19], loc, w)]
    for args in bad:
        with pytest.raises(ValueError):
            ms_deform_attn(*args)
    assert launches["msda"] == before
    with pytest.raises(RuntimeError):
        ms_deform_attn(value.requires_grad_(), SHAPES, loc, w)
