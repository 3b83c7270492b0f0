"""The port's converters from the reference's torch checkpoints
(``prpe_tpu_torch/models/porting.py``) against the JAX package's.

Each synthetic reference state dict (the torch transcriptions of the
reference modules in ``tests/test_porting*.py``, randomly initialised, with
random BatchNorm statistics) goes through both routes: the JAX package's
``port_*`` followed by ``from_jax_variables``, and the port's own
converter. The two state dicts must be equal, key for key and bit for bit.
Where it is cheap, the port model loaded with the converted weights is
also held against the torch transcription's forward (fp32, stated
tolerances).
"""

import numpy as np
import pytest
import torch

from prpe_tpu.models import porting as jporting
from prpe_tpu_torch.core.config import (
    AdaFaceConfig, CombinedModelConfig, DetectionConfig, PoseConfig,
)
from prpe_tpu_torch.models import porting
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.nn.adapters import AdaFaceAdapter
from prpe_tpu_torch.nn.common import build_on
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.resnet import ResNetTrunk
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.nn.yolo import YOLO
from test_porting import _TorchResNet50Trunk
from test_porting_yolo_irnet import (
    TIRNet, TYolo, _randomize_bn, _seq_adapter, _TCombined, _TTrunk,
)
from torch_one_thread import torch_on_one_thread  # noqa: F401

CPU = torch.device("cpu")
FWD_TOL = 1e-4  # fp32 torch on both sides, relative to the output's largest magnitude


def assert_same(got, want):
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def assert_close_rel(got, want, tol=FWD_TOL):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _eval(module, seed):
    torch.manual_seed(seed)
    m = module() if callable(module) and not isinstance(module, torch.nn.Module) else module
    m.eval()
    _randomize_bn(m, None)
    return m


def _vitpose_torch(layers=2, size=(64, 48)):
    from transformers import VitPoseConfig, VitPoseForPoseEstimation
    from transformers.models.vitpose_backbone import VitPoseBackboneConfig

    bc = VitPoseBackboneConfig(num_hidden_layers=layers, hidden_size=32, num_attention_heads=2,
                               intermediate_size=128, image_size=list(size), num_channels=3)
    tm = VitPoseForPoseEstimation(VitPoseConfig(backbone_config=bc))
    tm.eval()
    with torch.no_grad():
        tm.backbone.embeddings.position_embeddings.normal_(0, 0.02)
    return tm


def test_port_resnet50_full_depth():
    torch.manual_seed(0)
    sd = _TorchResNet50Trunk().state_dict()
    assert_same(porting.port_resnet50(sd), porting.from_jax_variables(jporting.port_resnet50(sd)))


def test_port_resnet_trunk_forward():
    """A (1, 1, 1, 1) trunk: converted weights reproduce the torchvision-style
    forward (NCHW there, NHWC here)."""
    tm = _eval(lambda: _TTrunk((1, 1, 1, 1)), 1)
    sd = tm.state_dict()
    got_sd = porting.port_resnet50(sd, (1, 1, 1, 1))
    assert_same(got_sd, porting.from_jax_variables(jporting.port_resnet50(sd, (1, 1, 1, 1))))
    pm = build_on(CPU, lambda: ResNetTrunk((1, 1, 1, 1)))
    pm.load_state_dict(got_sd, strict=True)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert_close_rel(pm(x.permute(0, 2, 3, 1)), tm(x).permute(0, 2, 3, 1))


def test_port_vitpose():
    """HF ViTPose (2 layers, width 32): the converted state dict, then the
    heatmaps against HF's."""
    tm = _vitpose_torch()
    sd = tm.state_dict()
    got_sd = porting.port_vitpose(sd)
    assert_same(got_sd, porting.from_jax_variables(jporting.port_vitpose(sd)))
    pm = build_on(CPU, lambda: ViTPose(image_size=(64, 48), hidden=32, layers=2, heads=2,
                                       num_keypoints=tm.config.num_labels))
    pm.load_state_dict(got_sd, strict=True)
    x = torch.randn(2, 3, 64, 48, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert_close_rel(pm(x.permute(0, 2, 3, 1)), tm(pixel_values=x).heatmaps)


@pytest.mark.parametrize("layers,mode,skip", [(18, "ir", False), (18, "ir_se", False),
                                              (50, "ir", False), (18, "ir", True)])
def test_port_irnet(layers, mode, skip):
    tm = _eval(lambda: TIRNet(num_layers=layers, se=mode == "ir_se"), 4)
    sd = tm.state_dict()
    got = porting.port_irnet(sd, layers, mode, skip_input_layer=skip)
    assert_same(got, porting.from_jax_variables(
        jporting.port_irnet(sd, layers, mode, skip_input_layer=skip)))
    assert ("input_conv.weight" in got) != skip


def test_port_irnet_se_forward():
    """IR-SE-18 at 112^2: embedding and norm against the torch transcription."""
    tm = _eval(lambda: TIRNet(num_layers=18, se=True), 5)
    pm = build_on(CPU, lambda: IRNet(18, mode="ir_se"))
    pm.load_state_dict(porting.port_irnet(tm.state_dict(), 18, "ir_se"), strict=True)
    x = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        (emb, norm), (w_emb, w_norm) = pm(x.permute(0, 2, 3, 1)), tm(x)
    assert_close_rel(emb, w_emb)
    assert_close_rel(norm, w_norm)


def test_port_yolo():
    """yolopt YOLOv11-n with 80 classes: converted weights, then the raw
    per-level maps against the transcription's at 64^2."""
    tm = _eval(lambda: TYolo(nc=80), 7)
    sd = tm.state_dict()
    got_sd = porting.port_yolo(sd, "n")
    assert_same(got_sd, porting.from_jax_variables(jporting.port_yolo(sd, "n")))
    pm = build_on(CPU, lambda: YOLO(nc=80, variant="n"))
    pm.load_state_dict(got_sd, strict=True)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        for g, w in zip(pm(x.permute(0, 2, 3, 1)), tm(x)):
            assert_close_rel(g, w.permute(0, 2, 3, 1))


@pytest.mark.parametrize("flavor,act,out_ch", [("yolo", "silu", 3), ("simple", "prelu", 64),
                                               ("simple", "gelu", 3)])
def test_port_adapter(flavor, act, out_ch):
    holder = torch.nn.Module()
    holder.adapter = _seq_adapter(out_ch, (8, 8), act, out_ch)
    _eval(holder, 9)
    sd = holder.state_dict()
    prelu = act == "prelu"
    assert_same(porting.port_adapter(sd, "adapter", flavor, prelu),
                porting.from_jax_variables(jporting.port_adapter(sd, "adapter", flavor, prelu)))


def test_port_adaface_adapter_forward():
    """The PReLU adapter, resize included (torch ``Upsample(align_corners=
    True)`` against the port's interpolation matrices)."""
    holder = torch.nn.Module()
    holder.adapter = _seq_adapter(64, (12, 12), "prelu", 64)
    _eval(holder, 10)
    pm = build_on(CPU, lambda: AdaFaceAdapter((12, 12)))
    pm.load_state_dict(porting.port_adapter(holder.state_dict(), "adapter", "simple", True),
                       strict=True)
    f = torch.randn(2, 2048, 3, 2, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        assert_close_rel(pm(f.permute(0, 2, 3, 1)), holder.adapter(f).permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def reference_combined():
    """The reference graft's transcription (trunk (1, 1, 1, 1), detection
    adapters at 64^2, IR-18 with 40 classes, a 2-layer ViT at 64x48)."""
    tm = _eval(_TCombined, 12)
    with torch.no_grad():
        tm.vit_pose.vit_pose.backbone.embeddings.position_embeddings.normal_(0, 0.02)
    return tm


def test_port_combined(reference_combined):
    """The whole graft: every component, ``face_kernel`` and the margin
    buffers, equal on both routes, loaded strictly into the port model."""
    sd = reference_combined.state_dict()
    kw = dict(num_layers=18, backbone_stages=(1, 1, 1, 1))
    got = porting.port_combined(sd, **kw)
    assert_same(got, porting.from_jax_variables(jporting.port_combined(sd, **kw)))
    assert torch.equal(got["face_kernel"], sd["ada_face.head.kernel"])
    assert got["margin_mean"].shape == () and float(got["margin_mean"]) == 20.0
    assert float(got["margin_std"]) == 100.0
    cfg = CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=DetectionConfig(adapter_size=(64, 64)),
        face=AdaFaceConfig(arch="ir_18", num_classes=40),
        pose=PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                        vit_layers=2, vit_heads=2))
    pm = CombinedModel(cfg, device="cpu")
    pm.load_state_dict(got, strict=True)
    x = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(13)) * 0.5
    with torch.no_grad():
        feats = reference_combined.backbone(x)
        want_emb, _ = reference_combined.ada_face(feats)
        want_hm = reference_combined.vit_pose(feats)
        x_nhwc = x.permute(0, 2, 3, 1)
        assert_close_rel(pm.embed_face(x_nhwc)[0], want_emb)
        assert_close_rel(pm.pose(x_nhwc), want_hm)


def test_merge_variables():
    base = {"a": torch.zeros(2, 2), "b": torch.zeros(3)}
    merged = porting.merge_variables(base, {"a": torch.ones(2, 2)})
    assert torch.equal(merged["a"], torch.ones(2, 2)) and torch.equal(merged["b"], torch.zeros(3))
    with pytest.raises(ValueError, match="shape mismatch at a"):
        porting.merge_variables(base, {"a": torch.ones(3, 3)})


def test_numpy_state_dict_takes_bf16():
    sd = {"w": torch.ones(2, dtype=torch.bfloat16), "n": torch.tensor([3])}
    out = porting.to_numpy_state_dict(sd)
    assert out["w"].dtype == np.float32 and out["n"].tolist() == [3]
