"""The trace reduction, the tail statistic, the roofline and the FLOP count
on hand-made inputs."""

import statistics

import pytest
import torch

from benchmark import stats, trace
from benchmark.reference import flops


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_union_counts_overlapping_streams_once():
    assert trace.union([(0, 10), (5, 12), (20, 25), (25, 30)]) == [(0, 12), (20, 30)]
    events = [
        _ev(trace.WINDOW, "user_annotation", 0, 100),
        _ev("k1", "kernel", 10, 30, tid=7, correlation=1),
        _ev("nccl", "kernel", 20, 30, tid=8, correlation=2),  # another stream, overlapping
        _ev("copy", "gpu_memcpy", 70, 10, tid=7, correlation=3),
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(50e-6)  # [10, 50) and [70, 80): not 30 + 30 + 10
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["launches"] == 2


def test_kernels_belong_to_the_module_that_launched_them_and_gaps_to_the_host():
    events = [
        _ev(trace.WINDOW, "user_annotation", 0, 100),
        _ev("module::vitpose", "user_annotation", 5, 40),
        _ev("aten::mm", "cpu_op", 10, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 11, 2, correlation=1),
        _ev("aten::sort", "cpu_op", 50, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 52, 2, correlation=2),
        _ev("gemm", "kernel", 20, 10, tid=9, correlation=1),
        _ev("sort", "kernel", 85, 5, tid=9, correlation=2),
    ]
    s = trace.summarize(events)
    assert s["module_s"] == pytest.approx({"vitpose": 10e-6, trace.OUTSIDE: 5e-6})
    # idle [0, 20): the window's start; [30, 85): inside aten::sort? it starts at 50,
    # so the gap's start (30) lies in module::vitpose; [90, 100): after everything
    assert s["idle_s"]["module::vitpose"] == pytest.approx(55e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["gemm", pytest.approx(10e-6)]


def test_p95_and_its_sample_count():
    values = list(range(1, 201))
    assert stats.percentile(values, 95) == statistics.quantiles(values, n=100,
                                                                method="inclusive")[94]
    assert stats.beyond(values, 95) == 10
    assert stats.percentile([3.0], 95) == 3.0


def test_mhsa_roofline_arithmetic():
    b, t, h, d = 128, 192, 12, 64
    fl = 4 * b * h * t * t * d
    by = 4 * b * t * h * d * 2
    assert flops.mhsa_least_s(b, t, h, d, "bfloat16") == max(fl / 989e12, by / 3.35e12)
    assert flops.vit_tokens({"patch_size": 16, "input_size": [256, 192]}) == 192


def test_flop_count_of_a_convolution_and_a_linear():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        lin = torch.nn.Linear(64, 32)
    assert flops.forward_flops(conv, (1, 3, 10, 10)) == 2 * 8 * 10 * 10 * 3 * 9
    assert flops.forward_flops(lin, (5, 64)) == 2 * 5 * 64 * 32


def test_cascade_flops_scale_with_the_slots():
    from conftest import TINY_CONFIG
    one = flops.cascade_flops(TINY_CONFIG, 1, 0, 0)
    assert flops.cascade_flops(TINY_CONFIG, 4, 0, 0) == pytest.approx(4 * one)
    assert flops.cascade_flops(TINY_CONFIG, 1, 2, 3) > one
