"""The cascade runner's spans and counters (``utils/profiling.py``) on the
small cascade of ``tests/test_torch_cascade.py``, on the CPU: tracing
follows ``torch.profiler`` alone, a traced call keeps nine nested spans on
the exported trace's clock and the counters of its own masks, and tracing
changes no output."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
from prpe_tpu_torch.ops.roi import crop_and_resize_batch
from prpe_tpu_torch.utils import profiling
from test_torch_cascade import CFG, POSE, POSE_CAPACITY

PARENTS = {
    "cascade.call": None, "cascade.upload": "cascade.call", "cascade.detect": "cascade.call",
    "cascade.person_yolo": "cascade.detect", "cascade.face_yolo": "cascade.detect",
    "cascade.face": "cascade.call", "cascade.irnet": "cascade.face",
    "cascade.pose": "cascade.call", "cascade.vitpose": "cascade.pose",
}
# inputs and configurations that only change what the counters count
CASES = {
    "float": dict(),
    "uint8": dict(uint8=True),
    "flip": dict(pose_flip_test=True),
    "ungated": dict(gate_pose=False),
    "one_face_slot": dict(face_capacity=1),
}


@pytest.fixture(scope="module")
def cascade():
    """The port's small cascade (seeded weights), two images and a gallery
    holding the embeddings of each image's best face plus two random rows."""
    torch.manual_seed(0)
    model = CascadeModel(DetectionConfig(pre_nms_top_k=64), PoseConfig(**POSE), irnet_layers=18,
                         device="cpu", seed=0)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(size=(2, 128, 128, 3)).astype(np.float32))
    first = build_cascade_runner(model, CascadeConfig(**CFG), pose_capacity=POSE_CAPACITY,
                                 device="cpu")(images, torch.zeros(4, 512))
    with torch.no_grad():
        crops = crop_and_resize_batch(images, first.faces.boxes[:, 0], torch.arange(2),
                                      (112, 112))
        emb, _ = model.irnet(((crops - 0.5) / 0.5).flip(-1))
    rand = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(2, 512))).float(),
                                         dim=-1)
    return model, images, torch.cat([emb, rand])


def _runner_and_inputs(cascade, case):
    model, images, gallery = cascade
    opts = dict(CASES[case])
    if opts.pop("uint8", False):
        images = (images * 255).round().to(torch.uint8)
    run = build_cascade_runner(model, CascadeConfig(**CFG, **opts),
                               pose_capacity=POSE_CAPACITY, device="cpu")
    return run, images, gallery


def _traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args)


def test_tracing_is_the_profiler_flag(monkeypatch):
    """On exactly while a ``torch.profiler`` records: the flag torch sets."""
    assert not profiling.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
    assert not profiling.tracing()
    with torch.autograd.profiler.profile():
        assert profiling.tracing()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert profiling.tracing()


def test_untraced_call_keeps_nothing(cascade):
    run, images, gallery = _runner_and_inputs(cascade, "float")
    _traced(run, images, gallery)
    before = (profiling.spans(), profiling.counters(), len(profiling._ring))
    assert before[0] and before[1]
    run(images, gallery)
    assert (profiling.spans(), profiling.counters(), len(profiling._ring)) == before
    assert profiling.call("cascade.call", 2, torch.device("cpu")) is profiling._OFF


def test_traced_call_spans_share_the_trace_clock(cascade, tmp_path):
    """One traced call after a warm-up: nine nested spans of one call id,
    each starting within 1 ms of its profiler range (a ``perf_counter`` or
    ``monotonic`` clock would be off by years), in the ranges' order;
    ``trace`` writes both files."""
    run, images, gallery = _runner_and_inputs(cascade, "float")
    with profiling.trace(str(tmp_path)):
        run(images, gallery)
        run(images, gallery)
    records = profiling.spans()
    assert len({r["call"] for r in records}) == 2
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written["spans"] == records and written["counters"] == profiling.counters()
    assert written["ring_calls"] == profiling.RING_CALLS >= 1024

    last = [r for r in records if r["call"] == records[-1]["call"]]
    assert sorted(r["name"] for r in last) == sorted(PARENTS)
    by_name = {r["name"]: r for r in last}
    for r in last:
        assert r["parent"] == PARENTS[r["name"]]
        assert r["host_start_ns"] <= r["host_end_ns"]
        assert r["device_ms"] == pytest.approx((r["host_end_ns"] - r["host_start_ns"]) / 1e6)
        if r["parent"] is not None:
            p = by_name[r["parent"]]
            assert p["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] <= p["host_end_ns"]

    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("name") in PARENTS),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [r["name"] for r in records]
    for e, r in list(zip(ranges, records))[len(records) - len(last):]:
        assert abs(base + e["ts"] * 1000 - r["host_start_ns"]) < 1e6, r["name"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_are_the_results_own_masks(cascade, case):
    run, images, gallery = _runner_and_inputs(cascade, case)
    res = _traced(run, images, gallery)
    got = profiling.counters()[-1]
    b, kf = res.faces.valid.shape
    face_slots = min(CASES[case].get("face_capacity") or 2 * b, b * kf)
    assert got == {
        "call": got["call"], "frames": b,
        "persons": int(res.persons.valid.sum()), "faces": int(res.faces.valid.sum()),
        "face_slots": face_slots,
        "face_slots_used": min(int(res.faces.valid.sum()), face_slots),
        "matched_faces": int((res.face_identity >= 0).sum()),
        "gated_persons": int(res.person_gated.sum()),
        "pose_slots": POSE_CAPACITY, "pose_slots_used": int(res.pose_valid.sum()),
        "face_budget_saturated": int(res.face_budget_saturated),
        "k1_launches": 0, "k2_launches": 0, "bn_act_launches": 0,
        "bn_act_residual_launches": 0, "msda_launches": 0,
    }
    assert got["matched_faces"] > 0 and got["pose_slots_used"] > 0


def test_launch_counters_are_the_calls_own(cascade, monkeypatch):
    """``k1_launches`` is the call's own share of ``_build.launches``: here
    a stand-in NMS counts a launch each, as the card's wrapper does."""
    from prpe_tpu_torch.infer import cascade as cascade_mod
    from prpe_tpu_torch.ops.kernels._build import launches

    nms = cascade_mod.non_max_suppression

    def counting_nms(*args, **kwargs):
        launches["nms"] += 1
        return nms(*args, **kwargs)

    monkeypatch.setattr(cascade_mod, "non_max_suppression", counting_nms)
    monkeypatch.setitem(launches, "nms", 100)
    run, images, gallery = _runner_and_inputs(cascade, "float")
    run(images, gallery)
    _traced(run, images, gallery)
    got = profiling.counters()[-1]
    assert (got["k1_launches"], got["k2_launches"], launches["nms"]) == (2, 0, 104)


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_are_bit_identical_with_tracing(cascade, case):
    run, images, gallery = _runner_and_inputs(cascade, case)
    plain = run(images, gallery)
    traced = _traced(run, images, gallery)
    for name, a, b in zip(plain._fields, plain, traced):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), name


def test_bn_act_launches_count_every_batchnorm(cascade, monkeypatch):
    """``bn_act_launches``: one fused BatchNorm a call for each BatchNorm of
    the detectors, IR-Net and ViTPose, each run once a call, and none of
    them adds a residual (``bn_act_residual_launches`` 0: the YOLO cascade
    has no such site); here the op's CPU implementation counts a launch, as
    the card's wrapper does."""
    from prpe_tpu_torch.nn.common import BatchNorm
    from prpe_tpu_torch.ops.kernels import bn_act as bn_act_mod
    from prpe_tpu_torch.ops.kernels._build import launches

    plain = bn_act_mod.bn_act_plain

    def counting_plain(*args):
        launches["bn_act"] += 1
        if args[6] is not None:
            launches["bn_act_residual"] += 1
        return plain(*args)

    monkeypatch.setattr(bn_act_mod, "bn_act_plain", counting_plain)
    monkeypatch.setitem(launches, "bn_act", 0)
    monkeypatch.setitem(launches, "bn_act_residual", 0)
    run, images, gallery = _runner_and_inputs(cascade, "float")
    _traced(run, images, gallery)
    model = cascade[0]
    want = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert want > 0
    assert profiling.counters()[-1]["bn_act_launches"] == launches["bn_act"] == want
    assert profiling.counters()[-1]["bn_act_residual_launches"] == launches["bn_act_residual"] == 0
