"""The port's measuring tools (``prpe_tpu_torch/tools/``) on the CPU at tiny
sizes: each prints the JSON lines of the repository script it follows,
with its metric names and keys; the profilers aggregate a trace, a CPU one
and a hand-made one with the card's event kinds; ``reference_nets`` holds
the reference transcriptions of ``tests/test_porting_yolo_irnet.py``, and
the benchmark's frozen copy of ``reference_rtdetr`` equals it.
"""

import json

import numpy as np
import pytest
import torch

from prpe_tpu_torch.tools import (
    bench_attention, bench_cascade, bench_io, bench_train, bench_vit_ln, dump_trace_ops,
    profile_cascade, profile_train, reference_nets, reference_rtdetr,
)
from torch_one_thread import torch_on_one_thread  # noqa: F401


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_cascade_dry_run(capsys, tmp_path):
    assert bench_cascade.main(["--dry-run"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    # the keys and metric of bench.py's line
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "face_gated_pose_cascade_640_throughput"
    assert rec["unit"] == "images/sec" and rec["value"] > 0
    assert rec["vs_baseline"] is None and "vs_baseline is null" in out.err
    baseline = tmp_path / "reference.json"
    baseline.write_text(json.dumps({"cascade_composite_img_per_sec": 2.0}))
    assert bench_cascade.main(["--dry-run", "--baseline", str(baseline)]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 2.0, abs=5e-3)


def test_bench_cascade_counts_its_calls():
    result = bench_cascade.run(bench_cascade.parse_args(["--dry-run"]))
    assert result["calls"] == 5 and result["batch"] == 2 and result["device"] == "cpu"


def test_bench_train_dry_run(capsys):
    assert bench_train.main(["--dry-run"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in recs] == [f"train_step_{t}" for t in bench_train.TASKS] + [
        "train_steps_bs32_640_harmonic_summary"]
    for r in recs[:4]:
        assert list(r) == ["metric", "value", "unit", "device_ms_per_step", "batch",
                           "image_size"]
        assert r["unit"] == "images/sec" and r["value"] > 0 and r["batch"] == 2
    assert list(recs[4]) == ["metric", "value", "unit"]
    assert recs[4]["value"] == pytest.approx(np.mean([r["value"] for r in recs[:4]]), abs=0.1)


def test_bench_train_refuses_a_window_with_other_updates(monkeypatch):
    """A pose step that updates twice breaks the one-window-one-task
    attribution, as a trace with extra ``jit__step`` events breaks the JAX
    script's."""
    from prpe_tpu_torch.train import steps

    real = steps.make_train_step

    def make(model, task, tx, cfg, **kw):
        step = real(model, task, tx, cfg, **kw)
        if task != "pose_estimation":
            return step

        def twice(state, batch, generator=None):
            state, _ = step(state, batch, generator)
            return step(state, batch, generator)

        return twice

    monkeypatch.setattr(steps, "make_train_step", make)
    with pytest.raises(RuntimeError, match="attribution would be wrong"):
        bench_train.run(bench_train.parse_args(["--dry-run"]))


@pytest.mark.parametrize("mode,metric", [("cascade", "cascade_640_from_disk"),
                                         ("train", "detection_train_from_disk"),
                                         ("png", "png_decode_pipeline_640")])
def test_bench_io_modes(capsys, tmp_path, mode, metric):
    argv = ["--mode", mode, "--dry-run", "--data-dir", str(tmp_path)]
    assert bench_io.main(argv) == 0
    rec, = json_lines(capsys.readouterr().out)
    assert rec["metric"] == metric and rec["unit"] == "images/sec" and rec["value"] > 0
    if mode == "cascade":
        assert set(rec["legs"]) == {"host_gather_img_s", "host_to_card_copy_mb_s",
                                    "device_exec_img_s"}
        assert rec["images_on_disk"] == 4 and rec["cascade_calls"] == 7
    elif mode == "train":
        assert rec["train_steps"] == 3
    else:
        assert rec["workers"] == 2
    # the data stays for the next run
    assert bench_io.main(argv) == 0
    assert "packing" not in capsys.readouterr().err


def test_profile_cascade_and_dump(capsys):
    assert profile_cascade.main(["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "-- by module --" in out
    prof = json.loads(out.strip().splitlines()[-1])
    assert prof["tool"] == "profile_cascade" and prof["kernel_ms_per_call"] > 0
    assert {"person_yolo", "face_yolo", "irnet", "vitpose"} <= set(prof["by_module"])
    assert 0 < prof["busy_share"] <= 1.0 and prof["launches"] > 0
    # the profiler's rows and the trace's modules count the same work
    assert sum(prof["by_module"].values()) == pytest.approx(prof["kernel_ms"], rel=0.05)
    assert dump_trace_ops.main([prof["trace"], "--top", "5"]) == 0
    dump = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dump["device"] == "cpu" and dump["trace"] == prof["trace"]
    assert dump["total_ms"] == pytest.approx(sum(prof["by_module"].values()), rel=1e-6)


def test_profile_train_dry_run(capsys):
    assert profile_train.main(["--dry-run", "pose_estimation"]) == 0
    prof = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pose = prof["tasks"]["pose_estimation"]
    assert list(prof["tasks"]) == ["pose_estimation"]
    assert {"backbone", "vit_pose_adapter", "vit_pose"} <= set(pose["by_module"])
    assert pose["kernel_ms_per_step"] > 0 and "train_pose_estimation" in pose["trace"]
    with pytest.raises(SystemExit):
        profile_train.parse_args(["32", "640", "no_such_task"])


def test_trace_summary_of_card_events(tmp_path):
    """The card's event kinds: kernels attributed through their launch's
    correlation id to the innermost module range around the launch; the
    busy share over the window range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": dump_trace_ops.WINDOW, "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "module::outer", "ts": 10, "dur": 50,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "module::inner", "ts": 20, "dur": 10,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 25, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 1,
         "tid": 2, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 30, "dur": 20, "tid": 7,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 50, "dur": 10, "tid": 7,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 80, "dur": 10, "tid": 7,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "module::outer", "ts": 30, "dur": 30,
         "tid": 7},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = dump_trace_ops.trace_summary(path, iters=2)
    assert s["device"] == "cuda" and s["launches"] == 1.5
    assert s["ops"] == {"k_a": [15.0, 2], "k_b": [5.0, 1]}
    assert s["by_module"] == {"inner": 0.01, "outer": 0.005, dump_trace_ops.OUTSIDE: 0.005}
    assert s["busy_share"] == pytest.approx(0.4) and s["window_ms"] == pytest.approx(0.05)


def test_profile_top_leaves_out_the_runners_spans():
    """The spans a runner opens while the profiler records are ranges, not
    work: on the card the profiler puts them on the device's timeline too,
    where their whole length would count as kernel time. A span around a
    sleep shows it on the CPU, where its self time is the sleep."""
    import time

    from prpe_tpu_torch.utils import profiling

    def call():
        with profiling.call("cascade.call", 1, torch.device("cpu")) as tr:
            with tr.span("cascade.detect"):
                time.sleep(0.05)
                torch.ones(32, 32) @ torch.ones(32, 32)

    p = dump_trace_ops.profile_top(call)
    assert not any(r[2].startswith("cascade.") for r in p["top"])
    assert 0 < p["kernel_ms"] < 25


def test_bench_attention_and_vit_ln_dry_run(capsys):
    assert bench_attention.main(["--dry-run", "pallas_packed", "einsum"]) == 0
    out = capsys.readouterr().out
    r = json.loads(out.strip().splitlines()[-1])
    assert list(r["modes"]) == ["pallas_packed", "einsum", "sdpa"]
    assert all(row["vitpose_fwd_ms"] > 0 for row in r["modes"].values())
    assert out.count("MODE ") == 3
    assert bench_vit_ln.main(["--dry-run", "pallas_lnfused"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(r["modes"]) == ["pallas_lnfused", "library"]
    assert set(r["layernorm"]) == {"model_layernorm_ms", "k4_layernorm_stage_ms",
                                   "library_layer_norm_ms"}


def test_sdpa_row_restores_the_module():
    from prpe_tpu_torch.nn import vit

    before = vit.einsum_attention
    with bench_attention.attn_mode("sdpa"):
        assert vit.einsum_attention is not before and vit.attn_mode() == "einsum"
    assert vit.einsum_attention is before


@pytest.mark.parametrize("make", [lambda m: m.TYolo(nc=80), lambda m: m.TYolo(nc=1),
                                  lambda m: m.TIRNet(num_layers=18),
                                  lambda m: m.TIRNet(num_layers=50),
                                  lambda m: m.TIRNet(num_layers=18, se=True)],
                         ids=["yolo_nc80", "yolo_nc1", "ir18", "ir50", "ir_se18"])
def test_reference_nets_match_the_test_transcriptions(make):
    """``tools/reference_nets.py`` against ``tests/test_porting_yolo_irnet.py``
    on the same state dict: the same keys and outputs bit for bit."""
    ref_module = pytest.importorskip("test_porting_yolo_irnet")
    torch.manual_seed(0)
    want = make(ref_module).eval()
    got = make(reference_nets).eval()
    sd = want.state_dict()
    assert list(got.state_dict()) == list(sd)
    got.load_state_dict(sd)
    x = torch.randn(2, 3, 112, 112) if isinstance(want, ref_module.TIRNet) else \
        torch.randn(1, 3, 128, 128)
    with torch.no_grad():
        w, g = want(x), got(x)
    for a, b in zip(w, g):
        assert torch.equal(a, b)


def test_benchmark_copy_of_reference_rtdetr_matches():
    """``benchmark/reference/rtdetr.py`` against ``tools/reference_rtdetr.py``
    on one state dict at tiny widths (the backbone at its published ones):
    the same keys, and the same logits, boxes and anchors bit for bit."""
    from benchmark.reference import rtdetr as frozen

    kw = dict(num_classes=3, dim=32, num_queries=16, heads=2, ffn=64, levels=3, points=2,
              num_layers=2)
    torch.manual_seed(0)
    want = reference_rtdetr.RTDETR(**kw).eval()
    with torch.no_grad():
        for m in want.modules():
            if isinstance(m, reference_rtdetr.Attention):
                torch.nn.init.normal_(m.in_proj_weight, 0.0, 0.2)
                torch.nn.init.normal_(m.in_proj_bias, 0.0, 0.1)
    got = frozen.RTDETR(**kw).eval()
    sd = want.state_dict()
    assert list(got.state_dict()) == list(sd)
    got.load_state_dict(sd)
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        for a, b in zip(reference_rtdetr.detect(want, x), frozen.detect(got, x)):
            assert torch.equal(a, b)


def test_pose_gap_grad_check_on_the_cpu(monkeypatch, capsys):
    """The gradient check at a tiny size: float64 against fp32 and bf16, with
    and without the attention op; fp32 agrees to rounding either way."""
    from prpe_tpu_torch.core import config
    from prpe_tpu_torch.data import synthetic
    from prpe_tpu_torch.tools import pose_gap

    full, pose_batch = config.CombinedModelConfig, synthetic.pose_batch
    monkeypatch.setattr(config, "CombinedModelConfig", lambda: full(
        backbone_stages=(1, 1, 1, 1), detection=config.DetectionConfig(adapter_size=(64, 64)),
        face=config.AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=config.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                               vit_layers=1, vit_heads=2)))
    monkeypatch.setattr(synthetic, "pose_batch", lambda rng, b, size, n: pose_batch(rng, b, 64, n))
    assert pose_gap.main(["grad", "--device", "cpu", "--batch", "2"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    runs = r["runs"]
    assert set(runs) == {"float64_einsum", "float32_pallas_packed", "float32_einsum",
                         "bfloat16_pallas_packed", "bfloat16_einsum"}
    for name in ("float32_pallas_packed", "float32_einsum"):
        assert runs[name]["median_rel_err"] < 1e-3 and runs[name]["max_err_over_branch_max"] < 1e-3
        assert runs[name]["loss"] == pytest.approx(runs["float64_einsum"]["loss"], rel=1e-5)


def test_pose_gap_train_patches_and_restores(monkeypatch):
    from prpe_tpu_torch.cli import build_model
    from prpe_tpu_torch.cli import train as train_cli
    from prpe_tpu_torch.nn import common
    from prpe_tpu_torch.tools import pose_gap

    plain_cls, plain_init = build_model.CombinedModel, common.init_weights
    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        seen["init"] = common.init_weights
        seen["model"] = build_model.CombinedModel(model_config_tiny(), torch.float32,
                                                  device="cpu")
        return 0

    monkeypatch.setattr(train_cli, "main", fake_main)
    assert pose_gap.main(["train", "--init", "trunc", "--init-seed", "3", "--",
                          "--epochs", "1"]) == 0
    assert seen["argv"] == ["--epochs", "1"] and seen["init"] is not plain_init
    assert build_model.CombinedModel is plain_cls and common.init_weights is plain_init
    # flax's lecun normal: truncated at two standard deviations of the
    # pre-scaling normal, variance 1 / fan_in
    w = seen["model"].vit_pose.backbone.block0.fc1.weight.detach()
    std = 1.0 / np.sqrt(w.shape[1])
    assert float(w.abs().max()) <= 2.0 * std / pose_gap._TRUNC_STD
    assert float(w.std()) == pytest.approx(std, rel=0.05)
    other = build_model.CombinedModel(model_config_tiny(), torch.float32, device="cpu", seed=3)
    assert not torch.equal(other.vit_pose.backbone.block0.fc1.weight, w)  # the plain draw


def model_config_tiny():
    from prpe_tpu_torch.core import config

    return config.CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=config.DetectionConfig(adapter_size=(32, 32)),
        face=config.AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=config.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                               vit_layers=1, vit_heads=2))
