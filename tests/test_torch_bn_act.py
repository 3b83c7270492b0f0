"""Eval BatchNorm with its activation in one op (``nn/common.py::BatchNorm``,
``ops/kernels/bn_act.py``) on the CPU, held bit for bit against the eval
expression the port ran before it: the constants folded in fp32 on every
call, ``x * scale + bias`` in the activation dtype, then the activation as a
separate op. Also: the cached constants follow every change of the
statistics and parameters, train mode and grad-enabled eval are the old
code, and a warm eval ``ConvBN`` issues one op for its BatchNorm and SiLU.
With a residual operand: the op against the parent's BatchNorm, separate
add and activation, ResNet-50-vd's bottlenecks and RT-DETR's RepVGG blocks
against their parent forwards and their grad-enabled eval, the refusals of
a residual the kernel cannot read at ``x``'s offsets, and the export.
The CUDA kernel itself is checked on the card
(``tests/test_torch_bn_act_cuda.py``).

Tolerance: equality (the same roundings in the same order)."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from prpe_tpu_torch.nn.common import BatchNorm, ConvBN, PReLU, _BatchStatsNorm, init_weights
from prpe_tpu_torch.nn.irnet import BasicBlockIR, IRNet
from prpe_tpu_torch.nn.resnet import BottleNeckD, ConvNormLayer, ResNetVD, ShortcutD
from prpe_tpu_torch.nn.rtdetr import RepVggBlock
from prpe_tpu_torch.nn.yolo import YOLO
from prpe_tpu_torch.ops.kernels import bn_act as bn_act_mod
from prpe_tpu_torch.ops.kernels.bn_act import bn_act, bn_act_plain, geometry
from torch_one_thread import torch_on_one_thread  # noqa: F401

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
ACTS = ("none", "silu", "prelu", "relu")
LAYOUTS = ("nchw", "channels_last", "rows")
C = 24


def parent_eval(bn, x, act=None):
    """The eval BatchNorm and activation as the port ran them before the
    fused op, op for op."""
    scale = torch.rsqrt(bn.running_var.float() + bn.eps)
    if bn.weight is not None:
        scale = scale * bn.weight.float()
    bias = -bn.running_mean.float() * scale
    if bn.bias is not None:
        bias = bias + bn.bias.float()
    shape = [1] * x.dim()
    shape[bn.dim] = -1
    y = x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if isinstance(act, PReLU):
        alpha = act.alpha.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(y >= 0, y, alpha * y)
    return y


def parent_add_act(y, residual, act):
    """The parent's add of a residual to a BatchNorm's output and the
    activation after it, as separate ops (``F.relu(out + shortcut)``,
    ``F.silu(a + b)``)."""
    y = y + residual
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if isinstance(act, PReLU):
        alpha = act.alpha.to(y.dtype).view(1, -1, *([1] * (y.dim() - 2)))
        return torch.where(y >= 0, y, alpha * y)
    return y


def randomize(module, gen):
    """Every BatchNorm's statistics and affine parameters and every PReLU's
    slope drawn away from their identity values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.7, generator=gen)
                m.running_var.uniform_(0.2, 3.0, generator=gen)
                if m.weight is not None:
                    m.weight.uniform_(0.3, 1.7, generator=gen)
                    m.bias.normal_(0.0, 0.5, generator=gen)
            elif isinstance(m, PReLU):
                m.alpha.uniform_(-0.2, 0.6, generator=gen)
    return module


def make_input(layout, dtype, gen, n=3, c=C, hw=(5, 7)):
    if layout == "rows":
        x = torch.randn(n, c, generator=gen) * 3
    else:
        x = torch.randn(n, c, *hw, generator=gen) * 3
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
    return x.to(dtype)


def act_arg(act, c=C, gen=None):
    if act == "prelu":
        p = PReLU(c)
        with torch.no_grad():
            p.alpha.uniform_(-0.2, 0.6, generator=gen)
        return p
    return None if act == "none" else act


def same(a, b):
    """Equal bits, shape and strides."""
    return a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_eval_path_and_plain_version_match_the_parent(dtype, act, layout, affine):
    gen = torch.Generator().manual_seed(len(dtype) * 31 + len(act) * 7 + len(layout) + affine)
    bn = randomize(BatchNorm(C, 1e-3, affine=affine), gen).eval()
    a = act_arg(act, gen=gen)
    x = make_input(layout, DTYPES[dtype], gen)
    want = parent_eval(bn, x, a)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            for _ in range(2):  # the cold call computes the constants, the warm one reads them
                assert same(bn(x, a), want)
    scale, bias = bn.folded(x.dtype)
    alpha = a.alpha.to(x.dtype) if act == "prelu" else None
    assert same(bn_act_plain(x, scale, bias, alpha, act, 1), want)
    assert same(torch.ops.prpe.bn_act(x, scale, bias, alpha, act, 1), want)


def _conv_bn(act, gen):
    m = ConvBN(5, C, 3, p=1, act=act)
    init_weights(m, gen)
    return randomize(m, gen).eval()


def _conv_norm_relu(gen):
    m = ConvNormLayer(5, C, 3, 1, "relu")
    init_weights(m, gen)
    return randomize(m, gen).eval()


def _ir_block(gen):
    m = BasicBlockIR(16, C, 2)
    init_weights(m, gen)
    return randomize(m, gen).eval()


def _parent_ir_block(m, x):
    r = m.conv1(parent_eval(m.bn0, x))
    r = m.conv2(parent_eval(m.bn1, r, m.prelu))
    return parent_eval(m.bn2, r) + parent_eval(m.shortcut_bn, m.shortcut_conv(x))


def _built(module, gen):
    init_weights(module, gen)
    return randomize(module, gen).eval()


def _parent_conv_norm(m, x, act=None):
    return parent_eval(m.norm, m.conv(x), act)


def _parent_bottleneck(m, x):
    """``BottleNeckD.forward`` as the parent ran it: ``relu(branch2c(...) +
    shortcut)``, the shortcut's pool and conv as before."""
    out = _parent_conv_norm(m.branch2a, x, "relu")
    out = _parent_conv_norm(m.branch2c, _parent_conv_norm(m.branch2b, out, "relu"))
    if m.shortcut:
        short = x
    elif isinstance(m.short, ShortcutD):
        short = _parent_conv_norm(m.short.conv, F.avg_pool2d(x, 2, 2, 0, ceil_mode=True))
    else:
        short = _parent_conv_norm(m.short, x)
    return F.relu(out + short)


def _parent_rep_vgg(m, x):
    return F.silu(_parent_conv_norm(m.conv1, x) + _parent_conv_norm(m.conv2, x))


# the residual blocks: ResNet-50-vd's bottleneck with the identity, a 1x1
# ConvNormLayer and the vd shortcut (pool, then 1x1), and RT-DETR's RepVGG
# block: (build, input channels)
RESIDUAL_BLOCKS = {
    "bottleneck_identity": (lambda g: _built(BottleNeckD(C, C // 4, 1, True), g), C),
    "bottleneck_conv": (lambda g: _built(BottleNeckD(5, C // 4, 1, False), g), 5),
    "bottleneck_pool": (lambda g: _built(BottleNeckD(5, C // 4, 2, False), g), 5),
    "rep_vgg": (lambda g: _built(RepVggBlock(C), g), C),
}

SITES = {
    # ConvBN with SiLU and without (YOLO), BatchNorm -> PReLU and the
    # standalone ones (IR-Net's blocks)
    "conv_bn_silu": (lambda g: _conv_bn(True, g), 5,
                     lambda m, x: parent_eval(m.bn, m.conv(x), "silu")),
    "conv_bn": (lambda g: _conv_bn(False, g), 5, lambda m, x: parent_eval(m.bn, m.conv(x))),
    "ir_block": (_ir_block, 16, _parent_ir_block),
    # ResNet-50-vd's ConvNormLayer with its ReLU (RT-DETR's backbone)
    "conv_norm_relu": (_conv_norm_relu, 5, lambda m, x: parent_eval(m.norm, m.conv(x), "relu")),
    # BatchNorm, residual add and activation in one op (RT-DETR)
    **{name: (build, cin, _parent_rep_vgg if name == "rep_vgg" else _parent_bottleneck)
       for name, (build, cin) in RESIDUAL_BLOCKS.items()},
}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("site", sorted(SITES))
def test_sites_match_the_parent(site, dtype, layout):
    gen = torch.Generator().manual_seed(11)
    build, cin, parent = SITES[site]
    m = build(gen)
    x = make_input(layout, DTYPES[dtype], gen, n=2, c=cin, hw=(8, 6))
    with torch.no_grad():
        want = parent(m, x)
    with torch.inference_mode():
        assert same(m(x), want)
        assert same(m(x), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_whole_models_match_grad_enabled_eval(dtype):
    """IR-18 (input BatchNorm -> PReLU, every block, the output BatchNorm and
    the 2-D affine-free one), YOLOv11-n and ResNet-50-vd (BatchNorm -> ReLU),
    each at a small size: the inference-mode forward equals the
    grad-enabled eval forward, which still runs the parent's expression."""
    gen = torch.Generator().manual_seed(5)
    irnet = IRNet(num_layers=18, input_size=32, embedding_size=16, dtype=DTYPES[dtype])
    yolo = YOLO(nc=2, dtype=DTYPES[dtype])
    resnet = ResNetVD(dtype=DTYPES[dtype])
    for m in (irnet, yolo, resnet):
        init_weights(m, gen)
        randomize(m, gen).eval()
    faces = torch.rand(2, 32, 32, 3, generator=gen)
    frames = torch.rand(1, 64, 64, 3, generator=gen)
    for model, x in ((irnet, faces), (yolo, frames), (resnet, frames)):
        want = model(x)
        with torch.inference_mode():
            got = model(x)
        assert len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_a_residual_matches_the_parents_separate_add(dtype, act, layout):
    """``act(bn(x) + residual)`` in one op (the plain version, the op, the
    eval BatchNorm under ``no_grad`` and ``inference_mode``, cold and warm,
    and grad-enabled eval) equals the parent's BatchNorm, add and activation
    as separate ops, with the residual on either side of the add."""
    gen = torch.Generator().manual_seed(len(dtype) * 13 + len(act) * 5 + len(layout))
    bn = randomize(BatchNorm(C, 1e-3), gen).eval()
    a = act_arg(act, gen=gen)
    x = make_input(layout, DTYPES[dtype], gen)
    r = make_input(layout, DTYPES[dtype], gen)
    want = parent_add_act(parent_eval(bn, x), r, a)
    assert same(parent_add_act(r, parent_eval(bn, x), a), want)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            for _ in range(2):
                assert same(bn(x, a, r), want)
    assert same(bn(x, a, r), want)  # grad-enabled eval: the plain version
    scale, bias = bn.folded(x.dtype)
    alpha = a.alpha.to(x.dtype) if act == "prelu" else None
    assert same(bn_act_plain(x, scale, bias, alpha, act, 1, r), want)
    assert same(torch.ops.prpe.bn_act(x, scale, bias, alpha, act, 1, r), want)
    assert same(bn_act(x, scale, bias, alpha, act, 1, residual=r), want)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("block", sorted(RESIDUAL_BLOCKS))
def test_residual_blocks_under_no_grad_equal_grad_enabled_eval(block, dtype):
    """``BottleNeckD`` (each shortcut kind) and ``RepVggBlock``: the no-grad
    forward, whose last BatchNorm adds the residual in the fused op, equals
    the grad-enabled eval forward, which records the gradient through plain
    ops, and that one still reaches the block's input."""
    gen = torch.Generator().manual_seed(12)
    build, cin = RESIDUAL_BLOCKS[block]
    m = build(gen).to(DTYPES[dtype])
    x = make_input("channels_last", DTYPES[dtype], gen, n=2, c=cin, hw=(8, 6))
    with torch.no_grad():
        got = m(x)
    want = m(x.requires_grad_())
    assert same(got, want)
    (grad,) = torch.autograd.grad(want.float().sum(), x)
    assert bool(grad.abs().sum() > 0)


def test_the_constants_are_kept_until_a_source_changes():
    gen = torch.Generator().manual_seed(2)
    bn = randomize(BatchNorm(C, 1e-5), gen).eval()
    x = make_input("nchw", torch.bfloat16, gen)
    with torch.inference_mode():
        bn(x)
        first = bn._folded.entry[1]
        bn(x)
        assert bn._folded.entry[1] is first
        bn(x.float())  # another activation dtype
        assert bn._folded.entry[1][0].dtype == torch.float32


def _check(bn, x, act=None):
    with torch.inference_mode():
        got = bn(x, act)
    assert same(got, parent_eval(bn, x, act))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cache_follows_load_state_dict(dtype):
    gen = torch.Generator().manual_seed(3)
    bn = randomize(BatchNorm(C, 1e-3), gen).eval()
    x = make_input("channels_last", DTYPES[dtype], gen)
    _check(bn, x, "silu")
    other = randomize(BatchNorm(C, 1e-3), gen)
    bn.load_state_dict(other.state_dict())
    _check(bn, x, "silu")


def test_cache_follows_an_optimizer_step():
    gen = torch.Generator().manual_seed(4)
    bn = randomize(BatchNorm(C, 1e-5), gen).eval()
    prelu = act_arg("prelu", gen=gen)
    x = make_input("nchw", torch.bfloat16, gen)
    _check(bn, x, prelu)
    params = [bn.weight, bn.bias, prelu.alpha]
    opt = torch.optim.SGD(params, lr=0.5)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    _check(bn, x, prelu)


def test_cache_follows_a_train_mode_forward():
    gen = torch.Generator().manual_seed(5)
    bn = randomize(BatchNorm(C, 1e-3, momentum=0.5), gen)
    x = make_input("nchw", torch.float32, gen)
    _check(bn.eval(), x)
    before = bn.running_var.clone()
    bn.train()(x * 4 + 1)
    assert not torch.equal(bn.running_var, before)
    _check(bn.eval(), x)


def test_cache_follows_to_dtype_and_swapped_data():
    gen = torch.Generator().manual_seed(6)
    bn = randomize(BatchNorm(C, 1e-5), gen).eval()
    x = make_input("nchw", torch.bfloat16, gen)
    _check(bn, x)
    bn.to(torch.bfloat16)  # rounds the statistics and parameters
    _check(bn, x)
    bn.to(torch.float32)
    _check(bn, x)
    bn.running_mean.data = torch.randn(C, generator=gen)
    _check(bn, x)
    with torch.no_grad():
        bn.weight[0] = 5.0  # a write through an index is a write too
    _check(bn, x)


def test_inference_tensors_compute_the_constants_each_call():
    """Statistics made inside ``torch.inference_mode`` keep no version
    counter: the constants are computed on every call, not kept."""
    gen = torch.Generator().manual_seed(7)
    with torch.inference_mode():
        bn = randomize(BatchNorm(C, 1e-5), gen).eval()
        x = make_input("nchw", torch.bfloat16, gen)
        assert same(bn(x), parent_eval(bn, x))
        assert bn._folded.entry is None


def test_train_mode_and_grad_enabled_eval_are_unchanged():
    """Outputs and gradients of ``ConvBN`` in train mode and in
    grad-enabled eval equal the parent's composition of the same ops."""
    gen = torch.Generator().manual_seed(8)
    m = _conv_bn(True, gen)
    x = make_input("channels_last", torch.float32, gen, n=4, c=5).requires_grad_()
    params = [x, m.conv.weight, m.bn.weight, m.bn.bias]
    g = torch.randn(4, C, 5, 7, generator=gen)

    def run(fn):
        y = fn()
        return (y, *torch.autograd.grad(y, params, g))

    for train in (True, False):
        m.train(train)
        state = {k: v.clone() for k, v in m.state_dict().items()}
        got = run(lambda: m(x))
        m.load_state_dict(state)  # train mode moved the statistics: start again
        if train:
            want = run(lambda: F.silu(_BatchStatsNorm.apply(
                m.conv(x), m.bn.weight, m.bn.bias, 1, m.bn.eps, None)[0]))
        else:
            want = run(lambda: parent_eval(m.bn, m.conv(x), "silu"))
        assert all(same(a, b) for a, b in zip(got, want)), train


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with torch.inference_mode(), _Ops() as ops:
        fn()
    return ops.names


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_a_warm_conv_bn_issues_one_op_for_its_batchnorm_and_silu(dtype):
    gen = torch.Generator().manual_seed(9)
    m = _conv_bn(True, gen)
    x = make_input("channels_last", DTYPES[dtype], gen, c=5)
    cold = _ops(lambda: m(x))
    warm = _ops(lambda: m(x))
    conv = [i for i, name in enumerate(warm) if name.startswith("aten.conv")]
    assert len(conv) == 1 and warm[conv[0] + 1:] == ["prpe.bn_act"]
    assert len(cold) > len(warm)
    # BatchNorm -> PReLU: one op too, the slope's cast kept with the constants
    block = _ir_block(gen)
    r = make_input("channels_last", DTYPES[dtype], gen, c=C)
    _ops(lambda: block.bn1(r, block.prelu))
    assert _ops(lambda: block.bn1(r, block.prelu)) == ["prpe.bn_act"]


def test_geometry_reads_the_dense_layouts():
    x = torch.zeros(2, 8, 3, 5)
    assert geometry(x, 1) == (2, 8, 15)
    assert geometry(x.contiguous(memory_format=torch.channels_last), 1) == (30, 8, 1)
    assert geometry(torch.zeros(4, 16), 1) == (4, 16, 1)
    assert geometry(torch.zeros(4, 16, 3), 2) == (64, 3, 1)
    assert geometry(x.permute(0, 1, 3, 2), 1) is None
    assert geometry(x[:, :, :, ::2], 1) is None


def test_geometry_counts_a_negative_axis_from_the_end():
    x = torch.zeros(2, 8, 3, 5)
    assert geometry(torch.zeros(4, 16), -1) == geometry(torch.zeros(4, 16), 1)
    assert geometry(x, -3) == geometry(x, 1)
    assert geometry(x, -1) == (48, 5, 1)
    assert geometry(x.contiguous(memory_format=torch.channels_last), -3) == (30, 8, 1)


def test_the_kernel_takes_bf16_and_fp32_dense_tensors_only():
    """The CUDA registration's conditions (``_check``, device-independent):
    a tensor it does not take raises instead of taking another route."""
    x = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16)
    s = torch.ones(8, dtype=torch.bfloat16)
    assert bn_act_mod._check(x, s, s, None, 1) == (2, 8, 16)
    xf, sf = x.float().contiguous(memory_format=torch.channels_last), s.float()
    assert bn_act_mod._check(xf, sf, sf, sf, 1) == (32, 8, 1)
    for bad, t in ((x.double(), s.double()), (x.transpose(2, 3), s),
                   (torch.zeros(1, bn_act_mod.MAX_CHANNELS + 1), torch.ones(1))):
        with pytest.raises(ValueError):
            bn_act_mod._check(bad, t, t, None, 1)


@pytest.mark.parametrize("fault", ["dtype", "shape", "strides", "device"])
def test_the_residual_must_match_the_input(fault):
    """The kernel reads the residual at ``x``'s offsets: another dtype,
    shape, layout or device raises. Strides of axes of length 1 do not
    matter (no offset depends on them)."""
    x = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16)
    s = torch.ones(8, dtype=torch.bfloat16)
    bad = {"dtype": x.float(), "shape": x[:, :, :3], "device": x.to("meta"),
           "strides": x.contiguous(memory_format=torch.channels_last)}[fault]
    with pytest.raises(ValueError):
        bn_act_mod._check(x, s, s, None, 1, bad)
    assert bn_act_mod._check(x, s, s, None, 1, x.clone()) == (2, 8, 16)
    one = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    other = torch.zeros(128, dtype=torch.bfloat16).as_strided(one.shape, (7, 16, 4, 1))
    assert bn_act_mod._check(one, s, s, None, 1, other) == (1, 8, 16)


@pytest.mark.parametrize("fault", ["dtype", "length", "strided", "device"])
@pytest.mark.parametrize("which", ["scale", "bias", "alpha"])
def test_the_constants_must_match_the_input(which, fault):
    """``scale``, ``bias`` and ``alpha`` are contiguous (C,) tensors of the
    input's dtype on its device, or the kernel would read other bytes."""
    x = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16)
    good = torch.ones(8, dtype=torch.bfloat16)
    bad = {"dtype": good.float(), "length": good[:7], "strided": torch.ones(16, dtype=x.dtype)[::2],
           "device": good.to("meta")}[fault]
    args = {"scale": good, "bias": good, "alpha": good}
    args[which] = bad
    with pytest.raises(ValueError):
        bn_act_mod._check(x, args["scale"], args["bias"], args["alpha"], 1)


def test_act_and_alpha_must_agree():
    x = torch.zeros(2, 4)
    s = torch.ones(4)
    with pytest.raises(ValueError):
        bn_act(x, s, s, None, "prelu", 1)
    with pytest.raises(ValueError):
        bn_act(x, s, s, s, "silu", 1)
    with pytest.raises(ValueError):
        bn_act(x, s, s, s, "relu", 1)
    with pytest.raises(ValueError):
        bn_act(x, s, s, None, "gelu", 1)


def test_export_keeps_the_op_as_one_node():
    """Exported under ``torch.no_grad`` (fake parameters: the constants are
    computed in the graph), an eval ``ConvBN`` holds ``prpe::bn_act``."""
    gen = torch.Generator().manual_seed(10)
    m = _conv_bn(True, gen)
    x = make_input("nchw", torch.float32, gen, c=5)
    with torch.no_grad():
        program = torch.export.export(m, (x,))
        got = program.module()(x)
    nodes = [n for n in program.graph.nodes if "bn_act" in str(n.target)]
    assert len(nodes) == 1
    with torch.inference_mode():
        assert torch.equal(got, m(x))


@pytest.mark.parametrize("block", ["bottleneck_identity", "rep_vgg"])
def test_export_keeps_the_op_with_a_residual_as_one_node(block):
    """Exported under ``torch.no_grad``, a bottleneck holds three
    ``prpe::bn_act`` nodes and a RepVGG block two, one of them with the
    residual as an operand, whose output is the block's: no separate
    activation is left."""
    gen = torch.Generator().manual_seed(13)
    build, cin = RESIDUAL_BLOCKS[block]
    m = build(gen)
    x = make_input("nchw", torch.float32, gen, n=2, c=cin, hw=(8, 6))
    with torch.no_grad():
        program = torch.export.export(m, (x,))
        got = program.module()(x)
    nodes = [n for n in program.graph.nodes if "bn_act" in str(n.target)]
    assert len(nodes) == {"bottleneck_identity": 3, "rep_vgg": 2}[block]
    with_residual = [n for n in nodes if len(n.args) > 6 and n.args[6] is not None]
    assert len(with_residual) == 1
    assert program.graph.output_node().args[0][0] is with_residual[0]
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not any(t.startswith(("aten.relu", "aten.silu")) for t in targets), targets
    with torch.inference_mode():
        assert torch.equal(got, m(x))
