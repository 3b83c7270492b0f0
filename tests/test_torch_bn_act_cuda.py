"""The fused eval BatchNorm kernel (``csrc/bn_act.cu``) against its plain
version on the card, bit for bit: every finite bf16 value through each
activation (none, SiLU, PReLU, ReLU), and with a residual operand through
ReLU and SiLU, fp32 values over many magnitudes, every layout route of the
kernel (16-byte vectors in one channel, across channels, one element at a
time), and every BatchNorm of the benchmark cells' models at their real
shapes and layouts (both YOLOv11-n at 128 frames of 640^2, IR-50 at 256
faces, RT-DETR's ResNet-50-vd and hybrid encoder at 128 frames of 640^2,
whose 28 residual sites add the shortcut or the other branch in the op), in
bf16 and fp32; the residual launches a cascade call counts (28 with
RT-DETR, 0 with the YOLO person detector). The plain version on the card
is ATen's own kernels, which the port ran before the fused op. Needs the
card: every test is marked ``cuda`` and skips where no GPU is present. On
the card, without JAX (this file imports torch and the port only):

    python -m pytest tests/test_torch_bn_act_cuda.py -m cuda --noconftest -q

Tolerance: equality of bits (NaN where the plain version gives NaN).
"""

import pytest
import torch

from prpe_tpu_torch.nn.common import BatchNorm, PReLU, init_weights
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.resnet import ResNetVD
from prpe_tpu_torch.nn.rtdetr import RTDETR
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


def check(x, scale, bias, alpha, act, dim=1, residual=None):
    before = launches["bn_act"], launches["bn_act_residual"]
    got = bn_act(x, scale, bias, alpha if act == "prelu" else None, act, dim, residual)
    want = bn_act_plain(x, scale, bias, alpha if act == "prelu" else None, act, dim, residual)
    torch.cuda.synchronize()
    assert launches["bn_act"] == before[0] + 1, "the kernel did not launch"
    assert launches["bn_act_residual"] == before[1] + (residual is not None)
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


@pytest.mark.parametrize("act", ("relu", "silu"))
@pytest.mark.parametrize("c, hw", [(24, (16, 16)), (32, (7, 7)), (24, (3, 3)), (32, (2, 2))])
def test_every_finite_bf16_value_with_a_residual(cuda, act, c, hw):
    """All finite bf16 values as ``x``, in each layout as above, with two
    residuals each: the same values in another order (sums over every
    magnitude, to infinity and NaN) and the negated BatchNorm output plus a
    term 2^-12 of another value (sums at and near zero). Also an aligned
    ``x`` with a residual off a 16-byte boundary, which takes one element
    at a time."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32, device=cuda).to(torch.int16)
    values = bits.view(torch.bfloat16)
    values = values[~values.isnan()]
    per = c * hw[0] * hw[1]
    n = -(-values.numel() // per)
    x = values.repeat(2)[:n * per].reshape(n, c, *hw)
    scale, bias, alpha = constants(c, torch.bfloat16, gen, cuda)
    flat = x.reshape(-1)
    shuffled = flat[torch.randperm(flat.numel(), generator=gen, device=cuda)].view(x.shape)
    near = -bn_act_plain(x, scale, bias, None, "none", 1) + shuffled * 2.0 ** -12
    for r in (shuffled, near):
        xs, rs = layouts(x, c), layouts(r, c)
        for name in xs:
            assert check(xs[name], scale, bias, alpha, act, residual=rs[name]), name
        assert check(xs["nchw"], scale, bias, alpha, act, residual=rs["offset"]), "mixed"


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
    # with a residual: the same values in another order
    r = x.reshape(-1)[torch.randperm(x.numel(), generator=gen, device=cuda)].view(x.shape)
    for (name, xl), rl in zip(layouts(x, c).items(), layouts(r, c).values()):
        assert check(xl, scale, bias, alpha, act, residual=rl), f"{name} residual"


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


def test_a_residual_the_kernel_cannot_read_raises(cuda):
    """A residual of another dtype, shape, layout or device than ``x``
    raises through the wrapper and the op, and launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, 8, 4, 6, generator=gen, device=cuda).bfloat16()
    scale, bias, _ = constants(8, torch.bfloat16, gen, cuda)
    before = launches["bn_act"], launches["bn_act_residual"]
    for r in (x.float(), x[:, :, :3], x.contiguous(memory_format=torch.channels_last), x.cpu()):
        with pytest.raises(ValueError):
            bn_act(x, scale, bias, None, "relu", 1, r)
        with pytest.raises(ValueError):
            torch.ops.prpe.bn_act(x, scale, bias, None, "relu", 1, r)
    assert (launches["bn_act"], launches["bn_act_residual"]) == before


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


def _checked_sites(net, run):
    """``run()`` under ``inference_mode`` with every BatchNorm of ``net``
    hooked: per forward, its input's shape and layout, the activation,
    whether it added a residual, and whether its output equals the plain
    version on the same operands. Also the launches of both counters."""
    sites = []

    def hook(bn, args, out):
        x, act = args[0], (args[1] if len(args) > 1 else None)
        residual = args[2] if len(args) > 2 else None
        scale, bias = bn.folded(x.dtype)
        alpha = act.alpha.to(x.dtype) if isinstance(act, PReLU) else None
        kind = "prelu" if alpha is not None else (act or "none")
        want = bn_act_plain(x, scale, bias, alpha, kind, bn.dim, residual)
        cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        sites.append((tuple(x.shape), "channels_last" if cl else "nchw", kind,
                      residual is not None, same_bits(out, want)))

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, BatchNorm)]
    try:
        before = launches["bn_act"], launches["bn_act_residual"]
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return sites, (launches["bn_act"] - before[0], launches["bn_act_residual"] - before[1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", ["yolo", "irnet", "resnet50vd"])
def test_every_batchnorm_of_the_cell(cuda, model, dtype):
    """Each BatchNorm of a YOLOv11-n at 128 frames of 640^2, of IR-50 at 256
    faces of 112^2 or of ResNet-50-vd at 128 frames of 640^2 (55, 51 of
    them with the ReLU, 16 of those adding the shortcut), on the
    activations it gets there (cuDNN's layouts included): the fused op's
    output equals the plain version on the same input, and every one
    launched the kernel."""
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
    sites, (fused, residual) = _checked_sites(net, lambda: net(x))
    bad = [s for s in sites if not s[4]]
    assert not bad, bad
    assert len(sites) == {"yolo": 81, "irnet": 78, "resnet50vd": 55}[model]
    if model == "resnet50vd":
        assert sum(s[2] == "relu" for s in sites) == 51
    assert sum(s[3] for s in sites) == residual == (16 if model == "resnet50vd" else 0)
    assert fused == len(sites)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_residual_site_of_rtdetr(cuda, dtype):
    """RT-DETR-R50's backbone and hybrid encoder at 128 frames of 640^2:
    its 28 BatchNorms that add a residual (16 bottlenecks with the shortcut
    and ReLU, 12 RepVGG blocks with the other branch and SiLU), and every
    other BatchNorm there, equal the plain version on the activations they
    get, each one launch."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(8)
    with torch.device(cuda):
        net = RTDETR(dtype=dt)
    init_weights(net, gen)
    _randomize(net, gen)
    net.eval()
    x = torch.rand(128, 640, 640, 3, generator=gen, device=cuda)
    sites, (fused, residual) = _checked_sites(net, lambda: net.encoder(net.backbone(x)))
    bad = [s for s in sites if not s[4]]
    assert not bad, bad
    with_residual = [s for s in sites if s[3]]
    assert len(with_residual) == residual == 28
    assert sorted({s[2] for s in with_residual}) == ["relu", "silu"]
    assert sum(s[2] == "silu" for s in with_residual) == 12
    assert all(s[1] == "channels_last" for s in with_residual)
    assert fused == len(sites)


@pytest.mark.parametrize("person_detector, want", [("rtdetr", 28), ("yolo", 0)])
def test_the_residual_counter_of_a_cascade_call(cuda, person_detector, want):
    """``bn_act_residual_launches`` in a traced cascade call: 28 with
    RT-DETR-R50 as the person detector, 0 with the YOLOv11-n (its path has
    no residual site); ``bn_act_launches`` counts every BatchNorm."""
    from torch.profiler import ProfilerActivity, profile

    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
    from prpe_tpu_torch.utils import profiling

    model = CascadeModel(DetectionConfig(), PoseConfig(), dtype=torch.bfloat16, device=cuda,
                         seed=0, person_detector=person_detector)
    cfg = CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3, conf_threshold=0.0)
    gen = torch.Generator(device=cuda).manual_seed(9)
    gallery = torch.nn.functional.normalize(torch.randn(32, 512, generator=gen, device=cuda),
                                            dim=-1)
    images = torch.rand(2, 640, 640, 3, generator=gen, device=cuda).to(torch.bfloat16)
    run = build_cascade_runner(model, cfg, pose_capacity=2, device=cuda)
    run(images, gallery)
    with profile(activities=[ProfilerActivity.CPU]):
        run(images, gallery)
    torch.cuda.synchronize()
    got = profiling.counters()[-1]
    assert got["bn_act_residual_launches"] == want
    assert got["bn_act_launches"] == sum(isinstance(m, BatchNorm) for m in model.modules())
