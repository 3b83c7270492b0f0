"""The fused eval BatchNorm kernel (``csrc/bn_act.cu``) against its plain
version on the card, bit for bit: every finite bf16 value through each
activation (none, SiLU, PReLU, ReLU), fp32 values over many magnitudes,
every layout route of the kernel (16-byte vectors in one channel, across
channels, one element at a time), and every BatchNorm of the benchmark
cells' models at their real shapes and layouts (both YOLOv11-n at 128
frames of 640^2, IR-50 at 256 faces, RT-DETR's ResNet-50-vd at 128 frames
of 640^2), in bf16 and fp32. The plain version on the card is ATen's own
kernels, which the port ran before the fused op. Needs the card: every test
is marked ``cuda`` and skips where no GPU is present. On the card, without
JAX (this file imports torch and the port only):

    python -m pytest tests/test_torch_bn_act_cuda.py -m cuda --noconftest -q

Tolerance: equality of bits (NaN where the plain version gives NaN).
"""

import pytest
import torch

from prpe_tpu_torch.nn.common import BatchNorm, PReLU, init_weights
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.resnet import ResNetVD
from prpe_tpu_torch.nn.yolo import YOLO
from prpe_tpu_torch.ops.kernels import launches
from prpe_tpu_torch.ops.kernels.bn_act import bn_act, bn_act_plain

pytestmark = pytest.mark.cuda

ACTS = ("none", "silu", "prelu", "relu")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def same_bits(got, want):
    """Equal dtype, strides, NaN positions and every other value's bits."""
    if got.dtype != want.dtype or got.stride() != want.stride():
        return False
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        return False
    return torch.equal(got[~nan], want[~nan])


def constants(c, dtype, gen, device):
    """Per-channel scale, bias and slope in ``dtype``: signs, tiny and large
    magnitudes, zero."""
    mag = torch.exp2(torch.randint(-12, 8, (c,), generator=gen, device=device).float())
    scale = torch.randn(c, generator=gen, device=device) * mag
    scale[0] = 0.0
    bias = torch.randn(c, generator=gen, device=device) * mag.flip(0)
    alpha = torch.randn(c, generator=gen, device=device) * 0.3
    return scale.to(dtype), bias.to(dtype), alpha.to(dtype)


def layouts(x, c):
    """``x`` (N, C, H, W) in each layout the kernel routes differently."""
    cl = x.contiguous(memory_format=torch.channels_last)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    off = flat[1:].view(x.shape)  # off a 16-byte boundary: one element at a time
    off.copy_(x)
    return {"nchw": x.contiguous(), "channels_last": cl, "offset": off,
            "rows": x.permute(0, 2, 3, 1).reshape(-1, c)}


def check(x, scale, bias, alpha, act, dim=1):
    before = launches["bn_act"]
    got = bn_act(x, scale, bias, alpha if act == "prelu" else None, act, dim)
    want = bn_act_plain(x, scale, bias, alpha if act == "prelu" else None, act, dim)
    torch.cuda.synchronize()
    assert launches["bn_act"] == before + 1, "the kernel did not launch"
    return same_bits(got, want)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c, hw", [(24, (16, 16)), (32, (7, 7)), (24, (3, 3)), (32, (2, 2))])
def test_every_finite_bf16_value(cuda, act, c, hw):
    """All 65536 bf16 bit patterns but the NaNs, in each layout: NCHW planes
    of 256 (vectors in one channel), 49 and 9 (vectors over two channels)
    and 4 elements (one element at a time); channels-last with C = 32
    (constants in registers) and 24 (from shared memory)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32, device=cuda).to(torch.int16)
    values = bits.view(torch.bfloat16)
    values = values[~values.isnan()]
    per = c * hw[0] * hw[1]
    n = -(-values.numel() // per)
    x = values.repeat(2)[:n * per].reshape(n, c, *hw)
    scale, bias, alpha = constants(c, torch.bfloat16, gen, cuda)
    for name, xl in layouts(x, c).items():
        assert check(xl, scale, bias, alpha, act), name


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c, hw", [(16, (12, 20)), (6, (12, 20)), (12, (7, 7))])
def test_fp32_over_many_magnitudes(cuda, act, c, hw):
    """fp32 inputs from 2^-30 to 2^30 with both signs, zeros and infinities;
    C = 6 is not a multiple of the 4-wide vector, so channels-last there
    takes one element at a time; 7x7 NCHW planes take vectors over two
    channels, and channels-last with C = 12 reads the constants from
    shared memory."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(64, c, *hw, generator=gen, device=cuda)
    x = x * torch.exp2(torch.randint(-30, 30, x.shape, generator=gen, device=cuda).float())
    x.view(-1)[:8] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 1e-45, -1e-45,
                                   3e38, -3e38], device=cuda)
    scale, bias, alpha = constants(c, torch.float32, gen, cuda)
    for name, xl in layouts(x, c).items():
        assert check(xl, scale, bias, alpha, act), name


def test_other_dtypes_layouts_and_constants_raise(cuda):
    """A CUDA tensor the kernel does not take raises, through the wrapper
    and through the op itself, and launches nothing: float64, a layout
    other than NCHW-dense or channels-last, constants of another dtype or
    length."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 8, 4, 6, generator=gen, device=cuda)
    scale, bias, alpha = constants(8, torch.float32, gen, cuda)
    before = launches["bn_act"]
    for xl, s, b, a in ((x.double(), scale.double(), bias.double(), alpha.double()),
                        (x.transpose(2, 3), scale, bias, alpha),
                        (x, scale.bfloat16(), bias, alpha),
                        (x, scale, bias[:7], alpha)):
        with pytest.raises(ValueError):
            bn_act(xl, s, b, a, "prelu", 1)
        with pytest.raises(ValueError):
            torch.ops.prpe.bn_act(xl, s, b, a, "prelu", 1)
    assert launches["bn_act"] == before


def test_a_negative_channel_axis(cuda):
    """(N, C) with the channel axis given as -1 launches as axis 1 does."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(64, 24, generator=gen, device=cuda).bfloat16()
    scale, bias, alpha = constants(24, torch.bfloat16, gen, cuda)
    assert check(x, scale, bias, alpha, "silu", dim=-1)


def _randomize(module, gen):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.3, 2.0, generator=gen)
                if m.weight is not None:
                    m.weight.uniform_(0.15, 1.0, generator=gen)
                    m.bias.normal_(0.0, 0.3, generator=gen)
            elif isinstance(m, PReLU):
                m.alpha.uniform_(0.0, 0.4, generator=gen)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", ["yolo", "irnet", "resnet50vd"])
def test_every_batchnorm_of_the_cell(cuda, model, dtype):
    """Each BatchNorm of a YOLOv11-n at 128 frames of 640^2, of IR-50 at 256
    faces of 112^2 or of ResNet-50-vd at 128 frames of 640^2 (55, 35 of
    them with the ReLU), on the activations it gets there (cuDNN's layouts
    included): the fused op's output equals the plain version on the same
    input, and every one launched the kernel."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(4)
    with torch.device(cuda):
        net = {"yolo": lambda: YOLO(nc=1, dtype=dt),
               "irnet": lambda: IRNet(num_layers=50, dtype=dt),
               "resnet50vd": lambda: ResNetVD(dtype=dt)}[model]()
    init_weights(net, gen)
    _randomize(net, gen)
    net.eval()
    shape = (256, 112, 112, 3) if model == "irnet" else (128, 640, 640, 3)
    x = torch.rand(shape, generator=gen, device=cuda)
    sites = []

    def hook(bn, args, out):
        x, act = args[0], (args[1] if len(args) > 1 else None)
        scale, bias = bn.folded(x.dtype)
        alpha = act.alpha.to(x.dtype) if isinstance(act, PReLU) else None
        kind = "prelu" if alpha is not None else (act or "none")
        want = bn_act_plain(x, scale, bias, alpha, kind, bn.dim)
        cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        sites.append((tuple(x.shape), "channels_last" if cl else "nchw", kind,
                      same_bits(out, want)))

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, BatchNorm)]
    try:
        before = launches["bn_act"]
        with torch.inference_mode():
            net(x)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    bad = [s for s in sites if not s[3]]
    assert not bad, bad
    assert len(sites) == len(handles) == {"yolo": 81, "irnet": 78, "resnet50vd": 55}[model]
    if model == "resnet50vd":
        assert sum(s[2] == "relu" for s in sites) == 35
    assert launches["bn_act"] - before == len(sites)
