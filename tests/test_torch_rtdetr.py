"""RT-DETR (``nn/rtdetr.py``, ``nn/resnet.py::ResNetVD``) and the cascade
with it as the person detector, against the plain fp32 reference
(``tools/reference_rtdetr.py``) on the CPU: seeded random weights at tiny
widths (the backbone at its published ResNet-50-vd widths, hidden 32, 2
heads, 3 classes, 24 queries, 2 decoder layers) on 96^2 frames. The
deformable attention's plain version is held against the published
``grid_sample`` formulation and against a loop that spells out the CUDA
kernel's arithmetic (``csrc/ms_deform_attn.cu``), points outside the maps
included; the kernel itself is checked on the card
(``tests/test_torch_msda_cuda.py``).

Tolerances: the port and the reference run the same fp32 mathematics in
another order (a fused q|k projection, the box head on the selected rows
alone, LayerNorm and SDPA kernels), so values agree to a few fp32 ulps of
their scale: 1e-4 relative to each tensor's largest magnitude. The top-k
picks are equal: both take a stable sort of the same scores.
"""

import pytest
import torch

from benchmark import weights_rtdetr as wr
from benchmark.reference import cascade as rc
from benchmark.reference import cascade_rtdetr as rcr
from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig, RTDETRConfig
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
from prpe_tpu_torch.nn.common import materialize
from prpe_tpu_torch.nn.rtdetr import RTDETR
from prpe_tpu_torch.ops.kernels.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
from prpe_tpu_torch.tools import reference_rtdetr as R
from torch_one_thread import torch_on_one_thread  # noqa: F401

TINY = dict(num_classes=3, hidden=32, num_queries=24, heads=2, ffn=64, levels=3, points=2,
            num_decoder_layers=2)
SIZE = 96
TOL = 1e-4


def close(got, want, tol=TOL):
    scale = float(want.abs().max().clamp(min=1e-6))
    return float((got - want).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def pair():
    """The port's tiny RT-DETR with seeded weights (statistics and affines
    drawn away from identity) and the reference holding the same state."""
    kw = dict(TINY)
    layers = kw.pop("num_decoder_layers")
    with torch.device("meta"):
        prog = RTDETR(num_decoder_layers=layers, image_size=SIZE, **kw)
    materialize(prog, torch.device("cpu"), 0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in prog.state_dict().items():
            if k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
            elif k.endswith(("running_mean", "bias")):
                v.normal_(0.0, 0.1, generator=gen)
            elif k.endswith("norm.weight") or ".1.weight" in k and v.dim() == 1:
                v.uniform_(0.5, 1.5, generator=gen)
    ref = R.RTDETR(num_classes=TINY["num_classes"], dim=TINY["hidden"],
                   num_queries=TINY["num_queries"], heads=TINY["heads"], ffn=TINY["ffn"],
                   levels=TINY["levels"], points=TINY["points"], num_layers=layers).eval()
    missing, unexpected = ref.load_state_dict(prog.state_dict(), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    x = torch.rand(2, SIZE, SIZE, 3, generator=gen)
    return prog, ref, x


def test_backbone_c3_to_c5(pair):
    prog, ref, x = pair
    with torch.inference_mode():
        got = prog.backbone(x)
        want = ref.backbone(x.permute(0, 3, 1, 2))
    assert [g.shape[1] for g in got] == [512, 1024, 2048]
    assert all(close(g, w) for g, w in zip(got, want))


def test_encoder_memory_and_selection(pair):
    prog, ref, x = pair
    with torch.inference_mode():
        feats = prog.encoder(prog.backbone(x))
        memory, idx, _, ref_unact = prog.decoder.select(feats)
        want_feats = ref.encoder(ref.backbone(x.permute(0, 3, 1, 2)))
        want_memory, shapes = ref.decoder.encoder_input(want_feats)
        _, logits, coords = ref.decoder.encoder_heads(want_memory, shapes)
    assert all(close(g, w) for g, w in zip(feats, want_feats))
    assert memory.shape == (2, (SIZE // 8) ** 2 + (SIZE // 16) ** 2 + (SIZE // 32) ** 2, 32)
    assert close(memory, want_memory)
    want_idx = R.top_queries(logits, TINY["num_queries"])
    assert torch.equal(idx, want_idx)
    assert close(ref_unact, coords.gather(1, want_idx[..., None].expand(-1, -1, 4)))


def test_decoder_logits_and_boxes(pair):
    prog, ref, x = pair
    with torch.inference_mode():
        got = prog(x)
        logits, boxes, idx = R.detect(ref, x.permute(0, 3, 1, 2))
    assert torch.equal(got.selected, idx)
    assert close(got.logits, logits) and close(got.boxes, boxes)


def _loop_msda(value, shapes, loc, w):
    """The CUDA kernel's arithmetic spelled out for one (b, q, h) at a time:
    grid_sample's source coordinate, the floor corner and its three
    neighbours with bilinear weights, corners off the map skipped."""
    b, _, heads, d = value.shape
    _, lq, _, levels, points, _ = loc.shape
    out = torch.zeros(b, lq, heads, d, dtype=torch.float64)
    starts = [0]
    for l in range(levels):
        starts.append(starts[-1] + shapes[2 * l] * shapes[2 * l + 1])
    v64, loc32 = value.double(), loc.float()
    for bi in range(b):
        for q in range(lq):
            for h in range(heads):
                for l in range(levels):
                    hh, ww = shapes[2 * l], shapes[2 * l + 1]
                    for p in range(points):
                        gx, gy = 2 * loc32[bi, q, h, l, p] - 1
                        sx = float(((gx + 1) * ww - 1) / 2)
                        sy = float(((gy + 1) * hh - 1) / 2)
                        x0, y0 = int(torch.tensor(sx).floor()), int(torch.tensor(sy).floor())
                        tx, ty = sx - x0, sy - y0
                        corners = ((x0, y0, (1 - tx) * (1 - ty)), (x0 + 1, y0, tx * (1 - ty)),
                                   (x0, y0 + 1, (1 - tx) * ty), (x0 + 1, y0 + 1, tx * ty))
                        for xc, yc, cw in corners:
                            if 0 <= xc < ww and 0 <= yc < hh:
                                out[bi, q, h] += (float(w[bi, q, h, l, p]) * cw
                                                  * v64[bi, starts[l] + yc * ww + xc, h])
    return out.reshape(b, lq, heads * d)


def test_plain_msda_is_the_published_grid_sample_and_the_kernels_arithmetic():
    gen = torch.Generator().manual_seed(3)
    shapes = [6, 5, 3, 3, 2, 1]
    s = 6 * 5 + 3 * 3 + 2 * 1
    value = torch.randn(2, s, 2, 4, generator=gen)
    loc = torch.rand(2, 5, 2, 3, 2, 2, generator=gen) * 1.6 - 0.3  # some off every map
    loc[0, 0, 0, 0, 0] = torch.tensor([-0.9, 1.8])
    w = torch.softmax(torch.randn(2, 5, 2, 6, generator=gen), -1).view(2, 5, 2, 3, 2)
    got = ms_deform_attn_plain(value, shapes, loc, w)
    want = R.deformable_attention_core_func(value, [(6, 5), (3, 3), (2, 1)], loc, w)
    assert torch.equal(got, want)
    assert torch.allclose(got.double(), _loop_msda(value, shapes, loc, w), atol=1e-6)
    with torch.inference_mode():
        assert torch.equal(ms_deform_attn(value, shapes, loc, w), got)
    # the op is inference only
    with pytest.raises(RuntimeError):
        ms_deform_attn(value.requires_grad_(), shapes, loc, w)


def _cascade_cfg():
    return {
        "rtdetr": {**TINY, "person_label": 0}, "yolo": {"width": [3, 16, 32, 64, 128, 256],
                                                     "depth": [1] * 6, "csp": [False, True]},
        "irnet": {"layers": 18}, "init": {"bn_weight": [0.15, 0.25], "head_gain": 6.0,
                                          "rtdetr_score_gain": 1.0, "rtdetr_score_bias": 1.0,
                                          "rtdetr_box_gain": 4.0,
                                          "rtdetr_backbone_bn_bias": [0.2, 0.4],
                                          "rtdetr_residual_bn_weight": [0.02, 0.05]},
        "pose": {"input_size": [64, 48], "num_keypoints": 17, "hidden": 32, "layers": 1,
                 "heads": 2, "mlp_ratio": 4, "patch_size": 16, "decoder_scale_factor": 4},
        "cascade": {"max_persons": 4, "max_faces": 4, "match_threshold": 0.9,
                    "conf_threshold": 0.25, "iou_threshold": 0.65, "pre_nms_top_k": 64},
    }


@pytest.fixture(scope="module")
def cascade():
    """The cascade with the tiny RT-DETR as its person detector, its runner,
    uint8 frames, a gallery holding the embeddings of every face the
    program detects (so that the faces in slots match and the gate lets
    persons through), and the reference cascade's answers on the same
    weights (``benchmark/reference/cascade_rtdetr.py``)."""
    cfg = _cascade_cfg()
    model = CascadeModel(DetectionConfig(pre_nms_top_k=64, image_size=SIZE),
                         PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                                    vit_layers=1, vit_heads=2),
                         irnet_layers=18, device="cpu", person_detector="rtdetr",
                         rtdetr=RTDETRConfig(**TINY))
    w = wr.make_weights(rcr.meta_models(cfg), 11, torch.device("cpu"), cfg["init"])
    # the last box head's w and h logits raised by 3, so that persons are
    # wide enough for faces' centres to fall inside them at this size
    w["person_rtdetr"]["decoder.dec_bbox_head.1.layers.2.bias"] = torch.tensor([0.0, 0, 3, 3])
    model.load_state_dict(wr.program_state_dict(model.state_dict().keys(), w))
    models = rcr.build_models(cfg, w, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    frames = (torch.rand(2, SIZE, SIZE, 3, generator=gen) * 255).round().to(torch.uint8)
    c = cfg["cascade"]
    run = build_cascade_runner(model, CascadeConfig(**{k: c[k] for k in (
        "max_persons", "max_faces", "match_threshold", "conf_threshold")}, face_capacity=4),
        pose_capacity=2, device="cpu")
    first = run(frames, torch.zeros(4, 512))
    gallery = rc.embed(models["irnet"], frames.float() / 255.0, first.faces.boxes.reshape(-1, 4),
                       torch.arange(8) // c["max_faces"], 8)
    ref = rcr.ReferenceCascade(cfg, models).run(frames, gallery, 2, 4)
    return run, frames, gallery, ref


def test_runner_end_to_end(cascade):
    """``build_cascade_runner`` with ``person_detector="rtdetr"`` against the
    reference cascade: persons, the query each served person came from,
    faces, the gate, the pose slots and their keypoints."""
    run, frames, gallery, ref = cascade
    res = run(frames, gallery)
    assert type(res).__name__ == "RTDETRCascadeResult"
    assert torch.equal(res.persons.valid, ref["person_valid"]) and bool(ref["person_valid"].any())
    assert torch.equal(res.person_anchor_idx, ref["person_anchor_idx"])
    assert torch.equal(res.person_query_idx[res.persons.valid],
                       ref["person_query_idx"][ref["person_valid"]])
    assert close(res.persons.scores, ref["person_scores"])
    assert close(res.persons.boxes, ref["person_boxes"])
    assert torch.equal(res.faces.valid, ref["face_valid"])
    assert torch.equal(res.face_identity.long(), ref["face_identity"])
    assert torch.equal(res.person_gated, ref["person_gated"]) and bool(res.person_gated.any())
    assert torch.equal(res.pose_valid, ref["pose_valid"]) and bool(res.pose_valid.any())
    assert torch.equal(res.pose_image_idx, ref["pose_image_idx"])
    assert close(res.pose_boxes, ref["pose_boxes"])
    v = res.pose_valid
    assert close(res.pose_keypoints[v], ref["pose_keypoints"][v], 1e-3)


def test_traced_call_keeps_the_detectors_spans_and_msda_launches(cascade, monkeypatch):
    """Under ``torch.profiler`` the call keeps ``cascade.person_rtdetr`` in
    ``cascade.detect`` with its four parts inside, and ``msda_launches``
    counts one launch a decoder layer (here the op's CPU implementation
    counts a launch, as the card's wrapper does)."""
    from torch.profiler import ProfilerActivity, profile

    from prpe_tpu_torch.ops.kernels import ms_deform_attn as msda_mod
    from prpe_tpu_torch.ops.kernels._build import launches
    from prpe_tpu_torch.utils import profiling

    plain = msda_mod.ms_deform_attn_plain

    def counting_plain(*args):
        launches["msda"] += 1
        return plain(*args)

    monkeypatch.setattr(msda_mod, "ms_deform_attn_plain", counting_plain)
    run, frames, gallery, _ = cascade
    with profile(activities=[ProfilerActivity.CPU]):
        run(frames, gallery)
    parents = {r["name"]: r["parent"] for r in profiling.spans()}
    assert parents["cascade.person_rtdetr"] == "cascade.detect"
    assert "cascade.person_yolo" not in parents
    for part in ("backbone", "encoder", "select", "decoder"):
        assert parents[f"rtdetr.{part}"] == "cascade.person_rtdetr"
    assert profiling.counters()[-1]["msda_launches"] == TINY["num_decoder_layers"]


def test_traced_call_counts_the_residual_batchnorms(cascade, monkeypatch):
    """``bn_act_residual_launches``: 28 fused BatchNorms a call add a
    residual, the last of each of ResNet-50-vd's 16 bottlenecks and one in
    each of the neck's 12 RepVGG blocks (widths do not change the count);
    each also counts in ``bn_act_launches``. Here the op's CPU
    implementation counts launches, as the card's wrapper does."""
    from torch.profiler import ProfilerActivity, profile

    from prpe_tpu_torch.ops.kernels import bn_act as bn_act_mod
    from prpe_tpu_torch.ops.kernels._build import launches
    from prpe_tpu_torch.utils import profiling

    plain = bn_act_mod.bn_act_plain

    def counting_plain(*args):
        launches["bn_act"] += 1
        if args[6] is not None:
            launches["bn_act_residual"] += 1
        return plain(*args)

    monkeypatch.setattr(bn_act_mod, "bn_act_plain", counting_plain)
    monkeypatch.setitem(launches, "bn_act", 0)
    monkeypatch.setitem(launches, "bn_act_residual", 0)
    run, frames, gallery, _ = cascade
    with profile(activities=[ProfilerActivity.CPU]):
        run(frames, gallery)
    got = profiling.counters()[-1]
    assert got["bn_act_residual_launches"] == launches["bn_act_residual"] == 28
    assert got["bn_act_launches"] == launches["bn_act"] > 28
