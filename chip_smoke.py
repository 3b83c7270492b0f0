"""Smoke run of the PyTorch/CUDA port (``prpe_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``prpe_tpu_torch/csrc/`` (into
``build/prpe_tpu_torch/``), then runs these phases and fails with a non-zero
exit on the first fault:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (NMS keep masks equal at K = 256 and 1024;
   packed and (B, H, T, D) MHSA within 2e-2 in bf16 and 1e-4 in fp32 on
   unit-scale outputs, both dtypes at B = 32 and 128; the fused LN -> MHSA
   half-block within 5e-2 in bf16 and 2e-4 in fp32), with its time, the
   plain version's time, the library call's time where there is one, the
   least time the card could take for the same work, and the host time of
   one wrapper call; then the half-block's stages alone (LayerNorm, one
   projection, the attention, the output projection with the residual) in
   bf16 and fp32 at B = 32 and 128, each beside its library call; then every
   kernel at odd shapes: NMS at K = 31, 32, 33, 64 and 1024 with every
   candidate valid, with none valid and with one image of none, at
   thresholds 0.0 and 0.65; the attention at T = 1, 192 (the longest
   sequence whose logits stay in registers) and 193 for every head dim; the
   half-block's stages alone in both dtypes (fp32 within 1e-4); the fused
   eval BatchNorm (bit for bit, each activation route, ResNet-50-vd's ReLU
   among them) and the deformable attention at the RT-DETR cell's shapes
   (bf16 and fp32, ``tests/test_torch_msda_cuda.py``'s tolerances);
2. reference: a tiny fp32 cascade on the card against the same cascade on
   the CPU (where the kernels' plain versions run);
3. attn_modes: for each ``PRPE_ATTN_MODE`` of ``tools/bench_attention.py``,
   a tiny fp32 ViTPose on the card against the CPU, then the full-width
   ViTPose-B bf16 forward at batch 128: ms per forward and the launches of
   each kernel in one forward;
4. cascade: the full-width bf16 cascade (two YOLOv11-n at 640^2, IR-50,
   ViTPose-B) with random seeded weights, in the default attention mode
   and under ``pallas_lnfused``: each once with every launch counter at zero
   to show the path went through its kernels, then images/s at batch 32
   and 128, and a profile of the kernels that take the card's time; then
   the cascade with RT-DETR-R50 as its person detector at batch 128
   (``cascade_rtdetr``): one call with the counters at zero (6
   deformable-attention launches, one ``bn_act`` a BatchNorm), images/s,
   peak memory and a profile;
5. cascade in fp32: the same cascade with ``dtype=torch.float32`` (the
   dtype the JAX package's CLI and ``bench.py`` serve in off the TPU) in the
   default mode and under ``pallas_lnfused``: launches checked, images/s at
   batch 32, and a profile of one call with the device ms of the attention
   kernels and of K4's LayerNorm, GEMM and attention stages;
6. combined_reference: a tiny fp32 combined model (``models/combined.py``)
   on the card against the same weights on the CPU, for each task, within
   1e-4 of each output's largest magnitude (at least 1); K2 launched once
   per ViT block of its ``pose``;
7. combined: the full-width combined model (ResNet-50 trunk, YOLOv11-n
   branches at 160^2, IR-50 with a 64-channel input and the 85 742-class
   AdaFace prototypes, ViTPose-B) at batch 16 of 640^2 images, bf16 and
   fp32: ms per forward and images/s for each task, the launches of each
   (K2 12 times in ``pose``, no kernel elsewhere), and a kernel profile of
   ``pose`` and of ``person_detection`` in each dtype;
8. infer_cli: ``cli/infer.py::run`` at its full preset on 4 frames of
   640^2 with 2 enrolled faces: its JSON schema, the NMS kernel launched
   twice and K2 12 times per call, the wall ms per call and a kernel
   profile of one call;
9. export: ``torch.export`` of ViTPose-B and of the combined model's pose
   path at batch 2 (``cli/export.py``): the program holds the node
   ``prpe::mhsa_packed``, launches K2 when run, and gives the eager
   outputs within 1e-5 of their largest magnitude;
10. mhsa_grad: forward plus backward of K2 and K3 at (32, 192, 12 x 64),
    bf16 and fp32: the kernel's forward with the registered torch backward
    against the plain forward with the same backward (dq, dk, dv within
    2e-2 in bf16, 1e-4 in fp32), timed beside SDPA's forward plus backward;
11. train_reference: one SGD step per task of the tiny fp32 combined model
    on the card against the CPU from the same weights and batch (loss and
    metrics within 1e-4, parameter changes and BatchNorm statistics within
    the bounds ``phase_train_reference`` states); K2 once per ViT block in
    the pose step, K1 once in each detection eval step;
12. train: the full-width combined model in bf16 with fp32 parameters,
    batch 32 at 640^2, branch scope, Adam at lr 1e-3 on synthetic batches
    (the JAX package's ``bench_train.py`` geometry): per task ms per step,
    images/s, peak memory, launches per step (K2 12 in a pose step), the
    losses, the trunk unmoved, one eval step (K1 once in a detection one),
    and a kernel profile of a pose and a person-detection step;
13. train_cli: ``cli/train.py::main`` on the card: the tiny preset for an
    epoch with checkpoints and a resume from ``latest`` for a second, then
    the full preset at batch 4 for an epoch without a combined checkpoint,
    its launches counted (K2 12 per pose step, K1 once per detection
    validation batch) and its files checked (the slim ``best_*`` of both
    detection tasks, from the mAP hook, and of face recognition);
14. train_data: ``cli/train.py::main`` from datasets on disk, written once
    by ``tools/make_dataset.py`` for phases 14, 15 and 17 (detection and
    pose 64 train and 32 val PNGs of 640^2, 16 identities x 20 face crops
    of 112^2), the full preset at
    batch 32 for an epoch, once inline and once with 2 decode workers:
    every metric finite, ``val/mAP50-95`` on both detection tasks,
    ``val/ver_acc``, ``val/kpt_AP``, the detection ``best_*`` checkpoints,
    K1 once per detection val batch and K2 12 per pose train step plus 24
    per pose val batch; ms per step from disk beside the ``train`` phase's,
    the loader's wait per step, the hooks' host seconds, the host decode
    images/s at 0 and 2 workers;
15. device_resident: ``cli/train.py --device-resident`` on the same
    datasets for 2 epochs, frozen and then ``--device-resident-refresh``:
    the staged MiB, ms a step per epoch beside ``train_data``'s from disk
    and ``train``'s on a reused batch, ``fresh_epochs`` / ``stale_epochs``,
    K1 and K2 per epoch as in ``train_data``;
16. parallel_reference: one SGD step per task of the tiny fp32 combined
    model on gloo ranks sharing the card (NCCL refuses two ranks on one
    GPU) at (dp, mp) = (2, 1), (1, 2) and (2, 2), against the
    single-process step on the card within ``train_reference``'s bounds;
    every rank of a mesh bit-equal (parameters, BatchNorm statistics,
    margin buffers), K2 once per ViT block in each rank's pose step;
17. parallel: ``cli/train.py`` at the full preset, bf16, global batch 32
    of 640^2, branch scope, 2 steps and one val batch a task, over NCCL at
    world 1 (``--coordinator``, a wiring check, not a multi-GPU number) and
    two gloo ranks at dp = 2 and at mp = 2 (``face_kernel`` split by class):
    ms a step per task, peak GiB a rank, a profile of rank 0's first pose
    step (the collectives' host and device ms), launches per rank (K1 2,
    K2 48), the ranks' replicated parameters bit-equal, one file a save
    with the full (512, 85742) ``face_kernel``;
18. yolo_reference: ``cli/train_yolo.py``'s train step twice (accumulation
    2, the EMA) and its eval step for YOLOv11-n at 64^2, batch 4, fp32, on
    the card against the CPU from the same weights and batches, within the
    bounds of ``tests/test_torch_train_yolo.py``; K1 once in the eval step;
19. train_yolo: ``cli/train_yolo.py::main`` at full width (YOLOv11-n, fp32,
    batch 32 of 640^2, accumulation 2) from 64 train and 32 val PNGs
    written by ``tools/make_dataset.py``, 11 epochs (the first with the
    mosaic), then ``--test`` on ``best`` (or, where matplotlib is missing,
    the ``evaluate`` it calls): ``step.csv``, ``best`` and ``last``, K1 once
    per val batch; ms per step from disk and the loader's wait with and
    without the mosaic, the mosaic dataset's host images/s at 0 and 2
    workers, the mAP hook's seconds, the peak memory;
20. eval_verification: ``cli/eval_verification.py::main`` with IR-50 over
    64 pairs of 112^2 PNG crops: finite metrics, images/s;
21. harness: the measuring tools of ``prpe_tpu_torch/tools/`` at full
    geometry, each through its ``main`` in this process with the launch
    counters at zero: ``bench_reference_torch`` (eager fp32 YOLOv11-n,
    IR-50, ViTPose-B at batch 128; its JSON is the baseline of)
    ``bench_cascade`` at batch 128 in the default mode and under
    ``pallas_lnfused`` (K1 2 and K2 or K4 12 a call, 21 calls),
    ``bench_train`` (5 steps a task after one, K2 12 a pose step),
    ``bench_io`` in ``cascade`` (256 packed scenes), ``train`` (128 packed
    detection samples) and ``png`` (64 PNGs, 2 workers) modes, one
    ``profile_cascade`` (batch 128), one ``profile_train`` (pose) and
    ``dump_trace_ops`` on its trace: every stdout JSON parses with the
    metric names of the repository's scripts;
22. numerics: ``tools/make_numerics_pose_ckpt.py`` trains ViTPose-B in
    fp32 for 1300 steps, to pck 0.8 (K2 forward and backward), then
    ``tools/check_cascade_numerics.py bf16`` holds the bf16 cascade against
    the fp32 one on trained weights (the repository's YOLOv11-n checkpoint
    in both detector slots, that pose checkpoint, 16 enrolled identities)
    over 100 scenes, with the same-crop leg over 128 crops under K2, K3 and
    K4: the report (not judged on its ``pass``) beside the JAX package's,
    non-vacuous, K1-K4 launched;
23. convergence: ``tools/run_convergence.py`` at the full preset, batch
    16 of 640^2, 256 train and 64 val samples a task, 8 epochs, a combined
    checkpoint every 4, killed 5 s after the first checkpoint and resumed
    (its datasets written during phase 22):
    the resumed process starts at the checkpoint, the merged histories
    hold every epoch once, detection ``val/mAP50`` and pose
    ``val/kpt_AP`` improve from the first 3 epochs to the last 3, K1 and
    K2 launched by the resumed process.

Phases 16 (its ranks), the odd shapes of 1, 2, 6, 11 and 18 run together
after the kernel rows: they time nothing. Every phase prints one JSON line
with the card's name and power limit. The
last two lines are the ``kernels`` summary and ``{"ok": true, ...}``. The
build fails the run if ``ptxas`` reports a spill in any kernel.

    python3 chip_smoke.py --kernels-only [--root DIR]

runs the serving-shape kernel rows only, importing ``prpe_tpu_torch`` from
the checkout at DIR (default: this one), so that two trees can be timed in
one call on one card; ``--compare`` runs those rows, the bf16 cascade at
batch 32 in the default mode and phase 5 (both modes), and no phase that
needs the stage entry points alone or the combined model.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: outside the tensor cores
NMS_OPS_PER_PAIR = 14  # 4 min/max, 2 sub, 2 clamp, mul, 2 add/sub, eps add, div, compare

# tools/bench_attention.py's modes, and the kernel counter each one moves
ATTN_MODES = {"einsum": None, "einsum_bf16sm": None, "pallas": "mhsa_bhtd",
              "pallas_unrolled": "mhsa_bhtd", "pallas_bh": "mhsa_bhtd",
              "pallas_packed": "mhsa", "pallas_lnfused": "ln_mhsa"}

CARD = ""
T0 = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(phase: str, **numbers) -> None:
    """One result line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **numbers, "t_s": time.perf_counter() - T0,
                      "card": CARD}), flush=True)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of one call (``tools/timing.py::time_ms``: CUDA
    events around each call, queued behind a sleep kernel)."""
    from prpe_tpu_torch.tools.timing import time_ms as timed

    return timed(fn, torch.device("cuda"), runs=runs, warmup=warmup)


def host_us(fn, calls: int = 20, rounds: int = 7) -> float:
    """Host time of one call (the wrapper's checks, allocations and
    launches): the median over ``rounds`` of the host clock around ``calls``
    calls queued without waiting for the card (the host is shared, so single
    rounds spread)."""
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_mode(mode: str):
    """``PRPE_ATTN_MODE=mode`` inside the block
    (``tools/bench_attention.py::attn_mode``)."""
    from prpe_tpu_torch.tools.bench_attention import attn_mode as mode_ctx

    return mode_ctx(mode)


def expected_launches(mode: str, layers: int, nms: int = 0):
    """Every counter, as a path of ``layers`` ViT blocks under ``mode`` (plus
    ``nms`` NMS launches) must leave it."""
    from prpe_tpu_torch.ops.kernels import launches

    want = dict.fromkeys(launches, 0)
    want["nms"] = nms
    if ATTN_MODES[mode]:
        want[ATTN_MODES[mode]] = layers
    return want


# no-grad eval BatchNorm forwards on non-empty tensors since the last
# reset_counts(), by device type (watch_batchnorms)
BN_EVALS: dict = {}


def watch_batchnorms() -> None:
    """Count every no-grad eval ``BatchNorm`` forward in ``BN_EVALS``:
    ``BatchNorm.forward`` wrapped once, one Python call a BatchNorm. Each
    such forward has to launch the fused kernel once (:func:`with_bn`), so
    one that took ATen's ops shows as a missing launch."""
    from prpe_tpu_torch.nn.common import BatchNorm

    forward = BatchNorm.forward
    if getattr(forward, "counted", False):
        return

    def counted(self, x, act=None, residual=None):
        if not (self.training or torch.is_grad_enabled()) and x.numel():
            BN_EVALS[x.device.type] = BN_EVALS.get(x.device.type, 0) + 1
        return forward(self, x, act, residual)

    counted.counted = True
    BatchNorm.forward = counted


def reset_counts() -> None:
    """Every kernel's launch counter and ``BN_EVALS`` at zero."""
    from prpe_tpu_torch.ops.kernels import reset_launches

    reset_launches()
    BN_EVALS.clear()


def with_bn(want: dict, n=None) -> dict:
    """``want`` with the fused eval BatchNorm's launches (``bn_act``) that
    the BatchNorm forwards since :func:`reset_counts` call for: one a
    no-grad eval forward on the card (``n``, where a spawned rank counted
    them). ``bn_act`` is left out where ``want`` has no such key and none
    ran, as the phases leave out zero counts."""
    n = BN_EVALS.get("cuda", 0) if n is None else n
    return {**want, "bn_act": n} if n or "bn_act" in want else dict(want)


def batchnorms(*models) -> int:
    """The ``BatchNorm`` modules of ``models``: the fused launches of one
    no-grad eval forward of each."""
    from prpe_tpu_torch.nn.common import BatchNorm

    return sum(isinstance(m, BatchNorm) for model in models for m in model.modules())


def residual_sites(*models) -> int:
    """The blocks of ``models`` whose last BatchNorm adds a residual
    (ResNet-50-vd's bottlenecks, RT-DETR's RepVGG blocks): the fused
    launches with a residual (``bn_act_residual``) of one no-grad eval
    forward of each."""
    from prpe_tpu_torch.nn.resnet import BottleNeckD
    from prpe_tpu_torch.nn.rtdetr import RepVggBlock

    return sum(isinstance(m, (BottleNeckD, RepVggBlock)) for model in models
               for m in model.modules())


# ---------------------------------------------------------------- kernels ---

def nms_inputs(b: int, k: int, gen: torch.Generator, device, valid_share: float = 0.7):
    """Boxes clustered around a few centres per image (real overlaps) and a
    validity mask: ``valid_share`` of the candidates valid, not a prefix (every
    candidate valid at 1.0, none at 0.0)."""
    u = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    centres = 50 + 500 * u(b, max(8, k // 32), 2)
    pick = (u(b, k) * centres.shape[1]).long()
    cxy = torch.gather(centres, 1, pick[..., None].expand(b, k, 2)) + 16 * (u(b, k, 2) - 0.5)
    wh = 20 + 60 * u(b, k, 2)
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1).contiguous()
    valid = u(b, k) < valid_share
    return boxes, valid


def phase_nms(gen, device, b: int, k: int, thr: float = 0.65):
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels.nms import nms_keep, nms_keep_plain

    boxes, valid = nms_inputs(b, k, gen, device)
    before = launches["nms"]
    keep = nms_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    if launches["nms"] != before + 1:
        fail("nms_keep did not count its launch")
    want = nms_keep_plain(boxes, valid, thr)
    mismatches = int((keep != want).sum())
    if mismatches:
        fail(f"nms_keep differs from its plain version in {mismatches} of {b * k} bits (K={k})")
    err = float((keep.float() - want.float()).abs().max())
    if not bool(keep.any()) or bool((keep == valid).all()):
        fail("nms_keep test data kept nothing or suppressed nothing")
    ms = time_ms(lambda: nms_keep(boxes, valid, thr))
    plain_ms = time_ms(lambda: nms_keep_plain(boxes, valid, thr), runs=5, warmup=1)
    idx = torch.arange(k, device=device)
    n_iter = torch.where(valid, idx + 1, 0).amax(1).double()
    ops = NMS_OPS_PER_PAIR * float((n_iter * (n_iter - 1) / 2).sum())
    bnd, by = bound_ms(b * k * (16 + 1 + 1), ops, PEAK_FLOPS[torch.float32])
    row = dict(name="nms_keep", B=b, K=k, max_abs_err=err, kept=int(keep.sum()),
               valid=int(valid.sum()), ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=None, host_us=host_us(lambda: nms_keep(boxes, valid, thr)))
    emit("kernel", **row)
    return row


# the fused eval BatchNorm's rows: the cells' largest sites (YOLO's first
# ConvBN, IR-50's input BatchNorm -> PReLU, its last block, ResNet-50-vd's
# third stem conv -> ReLU and its first stage's branch2c with the shortcut
# added before the ReLU) in the channels-last layout cuDNN gives them,
# NCHW sites (IR-50's 14x14 planes come so), fp32 once; a fifth item True
# adds a residual
BN_ACT_ROWS = ((torch.bfloat16, (128, 16, 320, 320), "silu", "channels_last"),
               (torch.bfloat16, (128, 64, 320, 320), "relu", "channels_last"),
               (torch.bfloat16, (128, 256, 160, 160), "relu", "channels_last", True),
               (torch.bfloat16, (256, 64, 112, 112), "prelu", "channels_last"),
               (torch.bfloat16, (256, 512, 7, 7), "none", "channels_last"),
               (torch.bfloat16, (128, 16, 320, 320), "silu", "nchw"),
               (torch.bfloat16, (256, 256, 14, 14), "prelu", "nchw"),
               (torch.float32, (128, 16, 320, 320), "silu", "channels_last"))


def parent_bn_eval(bn, x, act, residual=None):
    """Eval BatchNorm, a residual's add and the activation as the port ran
    them before the fused op: the constants folded on every call, then
    separate ops."""
    import torch.nn.functional as F

    scale = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    bias = -bn.running_mean.float() * scale + bn.bias.float()
    y = x * scale.to(x.dtype).view(1, -1, 1, 1) + bias.to(x.dtype).view(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    if act in ("silu", "relu"):
        return getattr(F, act)(y)
    return y if act is None else act(y)


def phase_bn_act(gen, device, dtype, shape, act: str, layout: str, residual: bool = False):
    """The fused eval BatchNorm kernel (``csrc/bn_act.cu``) at one of the
    cell's shapes, with a residual operand where ``residual``: bit-equal to
    its plain version, device ms against one read and one write of the
    tensor (and one read of the residual), and host us a call of the op, of
    its launch alone, of a warm ``BatchNorm`` forward (cached constants, one
    op) and of the parent's eval expression it replaces (ten ops, the
    residual's add and the activation's)."""
    from prpe_tpu_torch.nn.common import BatchNorm, PReLU
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels.bn_act import _launch, bn_act, bn_act_plain

    c = shape[1]
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    x = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(memory_format=fmt)
    r = (torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(memory_format=fmt)
         if residual else None)
    scale, bias, alpha = (torch.rand(c, generator=gen, device=device).to(dtype) for _ in range(3))
    alpha = alpha if act == "prelu" else None
    before = launches["bn_act"], launches["bn_act_residual"]
    y = bn_act(x, scale, bias, alpha, act, 1, r)
    torch.cuda.synchronize()
    if (launches["bn_act"], launches["bn_act_residual"]) != (before[0] + 1, before[1] + residual):
        fail("bn_act did not count its launch")
    want = bn_act_plain(x, scale, bias, alpha, act, 1, r)
    if not torch.equal(y, want) or y.stride() != want.stride():
        fail(f"bn_act differs from its plain version at {shape} {layout} {act} "
             f"residual {residual}")
    ms = time_ms(lambda: bn_act(x, scale, bias, alpha, act, 1, r))
    plain_ms = time_ms(lambda: bn_act_plain(x, scale, bias, alpha, act, 1, r), runs=5, warmup=1)
    nbytes = (3 if residual else 2) * x.numel() * x.element_size()
    bnd, by = bound_ms(nbytes, 0.0, PEAK_FLOPS[torch.float32])
    # host us a call: a small tensor of the same channels, so the card keeps up
    small = x[:1, :, :4, :4].contiguous(memory_format=fmt)
    small_r = r[:1, :, :4, :4].contiguous(memory_format=fmt) if residual else None
    bn = BatchNorm(c, 1e-3).to(device).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    module_act = {"none": None, "silu": "silu", "relu": "relu",
                  "prelu": PReLU(c).to(device)}[act]
    if act == "prelu":
        with torch.no_grad():
            module_act.alpha.fill_(0.25)
    with torch.inference_mode():
        host = {"host_us": host_us(lambda: bn_act(small, scale, bias, alpha, act, 1, small_r)),
                # the launch alone, without the custom op's dispatch
                "host_us_launch": host_us(
                    lambda: _launch(small, scale, bias, alpha, act, 1, small_r)),
                "host_us_module": host_us(lambda: bn(small, module_act, small_r)),
                "host_us_parent": host_us(
                    lambda: parent_bn_eval(bn, small, module_act, small_r))}
    row = dict(name="bn_act", shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               act=act, layout=layout, residual=residual,
               max_abs_err=float((y.float() - want.float()).abs().max()),
               ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None,
               tb_per_s=nbytes / ms / 1e9, **host)
    emit("kernel", **row)
    return row


# RT-DETR-R50's levels at 640^2: strides 8, 16 and 32
MSDA_LEVELS = (80, 80, 40, 40, 20, 20)


def phase_msda(gen, device, dtype, b: int = 128, lq: int = 300, h: int = 8, d: int = 32,
               points: int = 4):
    """The deformable-attention kernel (``csrc/ms_deform_attn.cu``) at the
    cell ``cascade_rtdetr.b128``'s shapes against its plain version on the
    same card inputs, locations inside and outside the maps, with the
    tolerances of ``tests/test_torch_msda_cuda.py`` (against the plain
    version in fp32: 2^-12 of the magnitudes it sums, and in bf16 2^-8 of
    the result more); device ms against the least time of
    ``benchmark/reference/flops_rtdetr.py``'s bytes and operations."""
    from benchmark.reference.flops_rtdetr import msda_bytes, msda_ops
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain

    shapes, levels = list(MSDA_LEVELS), len(MSDA_LEVELS) // 2
    s = sum(shapes[2 * l] * shapes[2 * l + 1] for l in range(levels))
    value = torch.randn(b, s, h, d, generator=gen, device=device).to(dtype)
    loc = torch.rand(b, lq, h, levels, points, 2, generator=gen, device=device) * 1.2 - 0.1
    w = torch.softmax(torch.randn(b, lq, h, levels * points, generator=gen, device=device),
                      -1).view(b, lq, h, levels, points)
    kernel = lambda: ms_deform_attn(value, shapes, loc, w)  # noqa: E731
    with torch.inference_mode():
        before = launches["msda"]
        got = kernel()
        torch.cuda.synchronize()
        if launches["msda"] != before + 1:
            fail("ms_deform_attn did not count its launch")
        want = ms_deform_attn_plain(value.float(), shapes, loc, w)
        tol = 2.0**-12 * ms_deform_attn_plain(value.float().abs(), shapes, loc, w)
        if dtype == torch.bfloat16:
            tol += 2.0**-8 * want.abs()
        err = (got.float() - want).abs()
        worst = float((err / tol.clamp(min=1e-30)).max())
        if not worst <= 1.0:
            fail(f"ms_deform_attn {dtype} exceeds its tolerance {worst:.3g} times")
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: ms_deform_attn_plain(value, shapes, loc, w), runs=5, warmup=1)
        bnd, by = bound_ms(msda_bytes(b, lq, s, h, d, levels, points, value.element_size()),
                           msda_ops(b, lq, s, h, d, levels, points), PEAK_FLOPS[dtype])
        row = dict(name="ms_deform_attn", dtype=str(dtype).replace("torch.", ""), B=b, Lq=lq,
                   S=s, H=h, D=d, L=levels, P=points, max_abs_err=float(err.max()),
                   tolerance_used=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   library_ms=None, host_us=host_us(kernel))
    emit("kernel", **row)
    return row


def phase_mhsa(gen, device, dtype, layout: str, b: int = 32, t: int = 192, h: int = 12,
               d: int = 64):
    """The attention kernel over one layout: ``packed`` (B, T, H*D), K2 of
    the default mode, or ``bhtd`` (B, H, T, D), K3 of the ``pallas``,
    ``pallas_unrolled`` and ``pallas_bh`` modes. SDPA takes the same
    tensors, as (B, H, T, D) views."""
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels import attention as attn

    if layout == "packed":
        name, counter, shape = "mhsa_packed", "mhsa", (b, t, h * d)
        kernel = lambda q, k, v: attn.mhsa_packed(q, k, v, h)  # noqa: E731
        plain = lambda q, k, v: attn.mhsa_packed_plain(q, k, v, h)  # noqa: E731
        heads = lambda x: x.view(b, t, h, d).transpose(1, 2)  # noqa: E731
    else:
        name, counter, shape = "mhsa_bhtd", "mhsa_bhtd", (b, h, t, d)
        kernel, plain, heads = attn.mhsa_bhtd, attn.mhsa_bhtd_plain, (lambda x: x)
    q, k, v = (torch.randn(*shape, generator=gen, device=device).to(dtype) for _ in range(3))
    before = launches[counter]
    o = kernel(q, k, v)
    torch.cuda.synchronize()
    if launches[counter] != before + 1:
        fail(f"{name} did not count its launch")
    err = float((o.float() - plain(q, k, v).float()).abs().max())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if not err <= tol:
        fail(f"{name} {dtype} max abs err {err} > {tol}")
    ms = time_ms(lambda: kernel(q, k, v))
    plain_ms = time_ms(lambda: plain(q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
    bnd, by = bound_ms(4 * q.numel() * q.element_size(), 4 * b * h * t * t * d, PEAK_FLOPS[dtype])
    row = dict(name=name, dtype=str(dtype).replace("torch.", ""), B=b, T=t, H=h, D=d,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=library_ms, host_us=host_us(lambda: kernel(q, k, v)))
    emit("kernel", **row)
    return row


def ln_mhsa_inputs(b: int, t: int, c: int, dtype, gen, device):
    """x ~ N(0, 1) in ``dtype``; fp32 LayerNorm scale ~ N(1, 0.1) and shift ~
    N(0, 0.1); four (out, in) fp32 weights ~ N(0, 1/C) with biases ~
    N(0, 0.02) (the JAX package's own test of this kernel)."""
    def n(*shape, mean=0.0, std=1.0):
        return mean + std * torch.randn(*shape, generator=gen, device=device)

    x = n(b, t, c).to(dtype)
    params = [n(c, mean=1.0, std=0.1), n(c, std=0.1)]
    for _ in range(4):
        params += [n(c, c, std=c ** -0.5), n(c, std=0.02)]
    return x, params


def phase_ln_mhsa(gen, device, dtype, b: int, t: int = 192, c: int = 768, h: int = 12):
    """The fused half-block of ``pallas_lnfused`` at ViT-B width. No single
    PyTorch call computes it; ``composed_library_ms`` times the library
    composition of the same function (layer_norm, three linears, SDPA, a
    linear and the residual add, parameters in ``dtype``)."""
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels.ln_mhsa import fused_ln_mhsa, ln_mhsa_plain

    x, params = ln_mhsa_inputs(b, t, c, dtype, gen, device)
    before = launches["ln_mhsa"]
    o = fused_ln_mhsa(x, *params, heads=h)
    torch.cuda.synchronize()
    if launches["ln_mhsa"] != before + 1:
        fail("fused_ln_mhsa did not count its launch")
    err = float((o.float() - ln_mhsa_plain(x, *params, heads=h).float()).abs().max())
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    if not err <= tol:
        fail(f"fused_ln_mhsa {dtype} B={b} max abs err {err} > {tol}")
    ms = time_ms(lambda: fused_ln_mhsa(x, *params, heads=h), runs=10)
    plain_ms = time_ms(lambda: ln_mhsa_plain(x, *params, heads=h), runs=10)
    lw, lb, wq, bq, wk, bk, wv, bv, wo, bo = (p.to(dtype) for p in params)
    heads = lambda y: y.view(b, t, h, c // h).transpose(1, 2)  # noqa: E731

    def composed():
        xn = F.layer_norm(x, (c,), lw, lb, 1e-12)
        o = F.scaled_dot_product_attention(heads(F.linear(xn, wq, bq)), heads(F.linear(xn, wk, bk)),
                                           heads(F.linear(xn, wv, bv)))
        return x + F.linear(o.transpose(1, 2).reshape(b, t, c), wo, bo)

    composed_ms = time_ms(composed, runs=10)
    es = x.element_size()
    nbytes = 2 * x.numel() * es + 4 * c * c * es + 6 * c * 4
    ops = b * (4 * 2 * t * c * c + 4 * h * t * t * (c // h))
    bnd, by = bound_ms(nbytes, ops, PEAK_FLOPS[dtype])
    row = dict(name="ln_mhsa", dtype=str(dtype).replace("torch.", ""), B=b, T=t, C=c, H=h,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=None, composed_library_ms=composed_ms,
               host_us=host_us(lambda: fused_ln_mhsa(x, *params, heads=h)))
    emit("kernel", **row)
    return row


def phase_ln_stages(gen, device, dtype, b: int, t: int = 192, c: int = 768, h: int = 12):
    """The half-block's stages alone in ``dtype``, each checked against its
    plain version and timed beside one library call: the LayerNorm
    (``F.layer_norm``), one q/k/v projection (``F.linear``), the attention
    (SDPA) and the output projection with the residual (``F.linear`` and the
    add). Parameters in ``dtype`` for the library, as in ``composed``; the
    kernels take the weights in ``dtype`` too, so no cast is timed. fp32
    library calls run in fp32 (TF32 is off)."""
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels import attention as attn
    from prpe_tpu_torch.ops.kernels import ln_mhsa as lm

    dt = dtype
    x, params = ln_mhsa_inputs(b, t, c, dt, gen, device)
    lw, lb, wq, bq, wk, bk, wv, bv, wo, bo = params
    wq, wk, wv, wo = (w.to(dt) for w in (wq, wk, wv, wo))
    lib = [p.to(dt) for p in (lw, lb, bq, bo)]
    xn = lm.layernorm(x, lw, lb)
    q, k, v = lm.linear(xn, wq, bq), lm.linear(xn, wk, bk), lm.linear(xn, wv, bv)
    o = attn.mhsa_packed(q, k, v, h)
    heads = lambda y: y.view(b, t, h, c // h).transpose(1, 2)  # noqa: E731
    m, es = b * t, x.element_size()
    gemm_bytes = (2 * m * c + c * c) * es + c * 4
    tol, attn_tol = (5e-2, 2e-2) if dt == torch.bfloat16 else (1e-4, 1e-4)
    stages = {
        "layernorm": (lambda: lm.layernorm(x, lw, lb), lambda: lm.layernorm_plain(x, lw, lb),
                      lambda: F.layer_norm(x, (c,), lib[0], lib[1], 1e-12),
                      2 * m * c * es + 2 * c * 4, 8 * m * c, "layernorm", tol),
        "q_projection": (lambda: lm.linear(xn, wq, bq), lambda: lm.linear_plain(xn, wq, bq),
                         lambda: F.linear(xn, wq, lib[2]), gemm_bytes, 2 * m * c * c,
                         "linear", tol),
        "attention": (lambda: attn.mhsa_packed(q, k, v, h),
                      lambda: attn.mhsa_packed_plain(q, k, v, h),
                      lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)),
                      4 * m * c * es, 4 * b * h * t * t * (c // h), "mhsa", attn_tol),
        "out_projection": (lambda: lm.linear(o, wo, bo, residual=x),
                           lambda: lm.linear_plain(o, wo, bo, residual=x),
                           lambda: x + F.linear(o, wo, lib[3]), gemm_bytes + m * c * es,
                           2 * m * c * c, "linear", tol),
    }
    rows = {}
    name_dt = str(dt).replace("torch.", "")
    for name, (kernel, plain, library, nbytes, ops, counter, tol) in stages.items():
        before = launches[counter]
        got = kernel()
        torch.cuda.synchronize()
        if launches[counter] != before + 1:
            fail(f"{name} stage did not count its launch")
        err = float((got.float() - plain().float()).abs().max())
        if not err <= tol:
            fail(f"{name} stage {name_dt} B={b} max abs err {err} > {tol}")
        bnd, by = bound_ms(nbytes, ops, PEAK_FLOPS[dt])
        rows[name] = dict(max_abs_err=err, ms=time_ms(kernel), library_ms=time_ms(library),
                          bound_ms=bnd, bound_by=by)
    emit("ln_mhsa_stages", dtype=name_dt, B=b, T=t, C=c, H=h, stages=rows,
         ms_sum=rows["layernorm"]["ms"] + 3 * rows["q_projection"]["ms"]
         + rows["attention"]["ms"] + rows["out_projection"]["ms"])
    return rows


def phase_odd_shapes(gen, device) -> None:
    """Kernels against their plain versions away from the serving shapes:
    NMS at K not a multiple of 32 and at the word edges K = 31, 32, 33, 64
    and the largest K = 1024 with every candidate valid, with none valid and
    with one image of a batch none valid, at thresholds 0.0 and 0.65; T not
    a multiple of the 64-key tile, every head dim, the longest sequence, and
    T = 1, 192 and 193 (both attention kernels hold the logits of up to 192
    keys in registers and take longer rows in more passes) for every head
    dim; for the half-block and its stages alone, B*T rows and C columns
    that are not multiples of the GEMM tiles. Correctness only."""
    from prpe_tpu_torch.ops.kernels.attention import (
        mhsa_bhtd, mhsa_bhtd_plain, mhsa_packed, mhsa_packed_plain,
    )
    from prpe_tpu_torch.ops.kernels.ln_mhsa import (
        fused_ln_mhsa, layernorm, layernorm_plain, linear, linear_plain, ln_mhsa_plain,
    )
    from prpe_tpu_torch.ops.kernels.nms import nms_keep, nms_keep_plain

    checked = []
    # K at the 32-candidate word edges and the largest K, every candidate
    # valid; no candidate valid; one image of a batch with none valid
    nms_cases = [(3, 1, 0.7, 0.5), (5, 300, 0.7, 0.5), (2, 777, 0.7, 0.5)]
    nms_cases += [(b, k, share, thr) for b, k, share in (
        (3, 31, 1.0), (3, 32, 1.0), (3, 33, 1.0), (2, 64, 1.0), (2, 1024, 1.0), (3, 256, 0.0))
        for thr in (0.0, 0.65)]
    for b, k, share, thr in nms_cases:
        boxes, valid = nms_inputs(b, k, gen, device, share)
        if not torch.equal(nms_keep(boxes, valid, thr), nms_keep_plain(boxes, valid, thr)):
            fail(f"nms_keep differs from its plain version at B={b}, K={k}, "
                 f"valid share {share}, threshold {thr}")
        checked.append(f"nms B={b} K={k} valid={share} thr={thr}")
    boxes, valid = nms_inputs(4, 256, gen, device)
    valid[2] = False
    for thr in (0.0, 0.65):
        if not torch.equal(nms_keep(boxes, valid, thr), nms_keep_plain(boxes, valid, thr)):
            fail(f"nms_keep differs from its plain version with one image of none valid, "
                 f"threshold {thr}")
        checked.append(f"nms B=4 K=256 image 2 none valid thr={thr}")
    straddle = [(2, t, 2, d) for d in (16, 32, 64, 128) for t in (1, 192, 193)]
    for b, t, h, d in ((2, 24, 2, 16), (3, 200, 4, 32), (2, 65, 3, 64), (1, 1024, 2, 128),
                       *straddle):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v = (torch.randn(b, t, h * d, generator=gen, device=device).to(dtype)
                       for _ in range(3))
            err = float((mhsa_packed(q, k, v, h).float() - mhsa_packed_plain(q, k, v, h).float())
                        .abs().max())
            if not err <= tol:
                fail(f"mhsa_packed {dtype} at B={b} T={t} H={h} D={d}: max abs err {err} > {tol}")
            checked.append(f"mhsa {str(dtype)[6:]} B={b} T={t} H={h} D={d} err={err:.3g}")
            q, k, v = (x.view(b, t, h, d).transpose(1, 2).contiguous() for x in (q, k, v))
            err = float((mhsa_bhtd(q, k, v).float() - mhsa_bhtd_plain(q, k, v).float())
                        .abs().max())
            if not err <= tol:
                fail(f"mhsa_bhtd {dtype} at B={b} T={t} H={h} D={d}: max abs err {err} > {tol}")
            checked.append(f"mhsa_bhtd {str(dtype)[6:]} B={b} T={t} H={h} D={d} err={err:.3g}")
    for b, t, c, h in ((2, 24, 32, 2), (3, 10, 64, 4), (2, 65, 64, 1), (1, 200, 96, 3),
                       (3, 77, 256, 2)):
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
            x, params = ln_mhsa_inputs(b, t, c, dtype, gen, device)
            err = float((fused_ln_mhsa(x, *params, heads=h).float()
                         - ln_mhsa_plain(x, *params, heads=h).float()).abs().max())
            if not err <= tol:
                fail(f"fused_ln_mhsa {dtype} at B={b} T={t} C={c} H={h}: max abs err {err} > {tol}")
            checked.append(f"ln_mhsa {str(dtype)[6:]} B={b} T={t} C={c} H={h} err={err:.3g}")
    for b, t, k, n in ((3, 77, 32, 96), (1, 200, 96, 256), (2, 65, 256, 40)):
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            x, params = ln_mhsa_inputs(b, t, k, dtype, gen, device)
            w = torch.randn(n, k, generator=gen, device=device) * k ** -0.5
            bias = 0.02 * torch.randn(n, generator=gen, device=device)
            res = torch.randn(b, t, n, generator=gen, device=device).to(dtype)
            got = {"layernorm": (layernorm(x, *params[:2]), layernorm_plain(x, *params[:2])),
                   "linear": (linear(x, w, bias), linear_plain(x, w, bias)),
                   "linear+residual": (linear(x, w, bias, res), linear_plain(x, w, bias, res))}
            dt = str(dtype)[6:]
            for name, (a, want) in got.items():
                err = float((a.float() - want.float()).abs().max())
                if not err <= tol:
                    fail(f"{name} {dt} at B={b} T={t} in={k} out={n}: max abs err {err} > {tol}")
                checked.append(f"{name} {dt} B={b} T={t} in={k} out={n} err={err:.3g}")
    emit("odd_shapes", checked=checked)


# ---------------------------------------------------------------- cascade ---

def check_result(res, b: int, kp: int, kf: int, g: int, k: int) -> None:
    shapes = {
        "persons.boxes": (res.persons.boxes, (b, kp, 4)),
        "faces.boxes": (res.faces.boxes, (b, kf, 4)),
        "face_identity": (res.face_identity, (b, kf)),
        "face_similarity": (res.face_similarity, (b, kf)),
        "person_gated": (res.person_gated, (b, kp)),
        "face_budget_saturated": (res.face_budget_saturated, ()),
        "pose_image_idx": (res.pose_image_idx, (g,)),
        "pose_boxes": (res.pose_boxes, (g, 4)),
        "pose_keypoints": (res.pose_keypoints, (g, k, 2)),
        "pose_scores": (res.pose_scores, (g, k)),
        "pose_valid": (res.pose_valid, (g,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            fail(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            fail(f"{name} has non-finite values")


def phase_reference(device) -> None:
    """A tiny fp32 cascade on the card (kernels) against the same weights and
    images on the CPU (plain versions)."""
    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

    det = DetectionConfig(pre_nms_top_k=64)
    pose = PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=64,
                      vit_layers=2, vit_heads=4)
    cfg = CascadeConfig(max_persons=4, max_faces=4, match_threshold=0.3, conf_threshold=0.0,
                        gate_pose=False)
    cpu = CascadeModel(det, pose, irnet_layers=18, device="cpu", seed=1)
    gpu = CascadeModel(det, pose, irnet_layers=18, device=device)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    images = torch.rand(2, 128, 128, 3, generator=gen)
    gallery = torch.nn.functional.normalize(torch.randn(4, 512, generator=gen), dim=-1)
    want = build_cascade_runner(cpu, cfg, pose_capacity=3, device="cpu")(images, gallery)
    got = build_cascade_runner(gpu, cfg, pose_capacity=3, device=device)(images, gallery)
    got = type(got)(*(type(x)(*(t.cpu() for t in x)) if isinstance(x, tuple) else x.cpu()
                      for x in got))
    errs = {}
    for name, tol in (("persons.boxes", 1e-2), ("persons.scores", 1e-4), ("faces.boxes", 1e-2),
                      ("faces.scores", 1e-4), ("face_similarity", 1e-4),
                      ("pose_keypoints", 1e-2), ("pose_scores", 1e-4)):
        a, b = got, want
        for part in name.split("."):
            a, b = getattr(a, part), getattr(b, part)
        errs[name] = float((a.float() - b.float()).abs().max())
        if not errs[name] <= tol:
            fail(f"reference: {name} differs by {errs[name]} > {tol} between card and CPU")
    for name in ("face_identity", "person_gated", "pose_valid", "pose_image_idx"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"reference: {name} differs between card and CPU")
    emit("reference", **{f"max_abs_err.{k}": v for k, v in errs.items()})


def phase_attn_modes(device, batch: int = 128):
    """Each attention mode of the ViT: (a) a tiny fp32 ViTPose (2 layers,
    hidden 64, 4 heads, 64x48) on the card against the same weights on the
    CPU, heatmaps within 1e-4 of their largest magnitude (at least 1);
    (b) the full-width ViTPose-B bf16 forward at ``batch`` crops of 256x192:
    the launches of one forward, every counter at zero before it, and the
    ms per forward. Returns the launches per mode."""
    from prpe_tpu_torch.nn.common import build_on
    from prpe_tpu_torch.nn.vit import ViTPose
    from prpe_tpu_torch.ops.kernels import launches

    tiny_kw = dict(image_size=(64, 48), hidden=64, layers=2, heads=4)
    tiny_cpu = build_on(torch.device("cpu"), lambda: ViTPose(**tiny_kw), seed=5)
    tiny_gpu = build_on(device, lambda: ViTPose(**tiny_kw))
    tiny_gpu.load_state_dict(tiny_cpu.state_dict())
    crops = torch.randn(3, 3, 64, 48, generator=torch.Generator().manual_seed(6))
    crops = crops.permute(0, 2, 3, 1)
    full = build_on(device, lambda: ViTPose(dtype=torch.bfloat16), seed=7)
    # crops as the cascade makes them: an NHWC view of channels-first memory
    x = torch.rand(batch, 3, 256, 192, generator=torch.Generator(device=device).manual_seed(8),
                   device=device).permute(0, 2, 3, 1)
    counts, ms, errs = {}, {}, {}
    for mode in ATTN_MODES:
        with attn_mode(mode), torch.inference_mode():
            want = tiny_cpu(crops)
            got = tiny_gpu(crops.to(device)).cpu()
            errs[mode] = float((got - want).abs().max())
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            if not errs[mode] <= tol:
                fail(f"attn_modes: {mode} tiny ViTPose differs by {errs[mode]} > {tol} "
                     "between card and CPU")
            reset_counts()
            hm = full(x)
            torch.cuda.synchronize()
            counts[mode] = dict(launches)
            expected = with_bn(expected_launches(mode, 12))
            if counts[mode] != expected:
                fail(f"attn_modes: {mode} launched {counts[mode]}, expected {expected}")
            if hm.shape != (batch, 17, 64, 48) or not bool(torch.isfinite(hm).all()):
                fail(f"attn_modes: {mode} heatmaps of shape {tuple(hm.shape)} or not finite")
            ms[mode] = time_ms(lambda: full(x), runs=5, warmup=2)
    emit("attn_modes", model=f"ViTPose-B bf16 b{batch} 256x192", ms_per_forward=ms,
         launches_per_forward=counts, tiny_fp32_max_abs_err=errs)
    return counts


def phase_cascade(device, modes=("pallas_packed", "pallas_lnfused"), pose=None,
                  irnet_layers: int = 50, size: int = 640, batches=((32, 20), (128, 8)),
                  dtype=torch.bfloat16):
    """The full-width cascade in ``dtype`` unless a smaller ``pose`` / ``size``
    is given, once per attention mode, each mode also profiled. Returns the
    launches of one call per mode."""
    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
    from prpe_tpu_torch.ops.kernels import launches

    pose = pose or PoseConfig()
    t0 = time.perf_counter()
    model = CascadeModel(DetectionConfig(), pose, irnet_layers=irnet_layers,
                         dtype=dtype, device=device, seed=0)
    cfg = CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3, conf_threshold=0.0)
    gen = torch.Generator(device=device).manual_seed(1)
    gallery = torch.nn.functional.normalize(
        torch.randn(32, 512, generator=gen, device=device), dim=-1)
    images = {b: torch.rand(b, size, size, 3, generator=gen, device=device).to(dtype)
              for b, _ in batches}
    init_s = time.perf_counter() - t0
    dt = str(dtype).replace("torch.", "")

    counts = {}
    for mode in modes:
        rates = {}
        with attn_mode(mode):
            for batch, iters in batches:
                run = build_cascade_runner(model, cfg, pose_capacity=batch, device=device)
                if batch == batches[0][0]:
                    # the main path, once, with every counter at zero
                    reset_counts()
                    res = run(images[batch], gallery)
                    torch.cuda.synchronize()
                    counts[mode] = dict(launches)
                    want = expected_launches(mode, pose.vit_layers, nms=2)
                    want["bn_act"] = batchnorms(model)
                    if counts[mode] != want:
                        fail(f"main path under {mode} ({dt}) launched {counts[mode]}, "
                             f"expected {want}")
                    check_result(res, batch, cfg.max_persons, cfg.max_faces, batch,
                                 pose.num_keypoints)
                    profile = profile_top(lambda: run(images[batch], gallery))
                for _ in range(2):
                    run(images[batch], gallery)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(iters):
                    out = run(images[batch], gallery)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                check_result(out, batch, cfg.max_persons, cfg.max_faces, batch, pose.num_keypoints)
                rates[batch] = batch * iters / wall
        emit("cascade", metric=f"face_gated_pose_cascade_{size}_throughput", unit="images/sec",
             dtype=dt, attn_mode=mode, images_per_s={f"b{b}": r for b, r in rates.items()},
             launches_per_call=counts[mode], init_s=init_s,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        # busy share: kernel time of one profiled call over one timed call's wall time
        b0 = batches[0][0]
        wall_ms = 1e3 * b0 / rates[b0]
        emit(f"profile_b{b0}" + ("" if dtype == torch.bfloat16 else f"_{dt}"),
             attn_mode=mode, wall_ms_per_call=wall_ms,
             device_busy_share=profile.get("kernel_ms", 0.0) / wall_ms,
             attention_kernel_ms=profile["attention_ms"], ln_mhsa_stage_ms=profile["ln_mhsa"],
             top_device_ms=profile)
    return counts


def phase_cascade_rtdetr(device, batch: int = 128, iters: int = 8, size: int = 640, pose=None,
                         irnet_layers: int = 50, rtdetr=None):
    """The cascade with RT-DETR-R50 as its person detector, the model of the
    cell ``cascade_rtdetr.b128`` (bf16, random seeded weights, unless a
    smaller ``pose`` / ``rtdetr`` / ``size`` is given): one call with every
    counter at zero (one deformable-attention launch a decoder layer, one
    ``bn_act`` a BatchNorm, 28 of them ``bn_act_residual``, K1 on the
    faces alone, K2 once a ViT block),
    then images/s and peak memory at ``batch`` and a profile of one call.
    Returns the launches of that call."""
    from prpe_tpu_torch.core.config import (CascadeConfig, DetectionConfig, PoseConfig,
                                            RTDETRConfig)
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
    from prpe_tpu_torch.ops.kernels import launches

    pose, rtdetr = pose or PoseConfig(), rtdetr or RTDETRConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = CascadeModel(DetectionConfig(image_size=size), pose, irnet_layers=irnet_layers,
                         dtype=torch.bfloat16, device=device, seed=0, person_detector="rtdetr",
                         rtdetr=rtdetr)
    cfg = CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3, conf_threshold=0.0)
    gen = torch.Generator(device=device).manual_seed(1)
    gallery = torch.nn.functional.normalize(
        torch.randn(32, 512, generator=gen, device=device), dim=-1)
    images = torch.rand(batch, size, size, 3, generator=gen, device=device).to(torch.bfloat16)
    run = build_cascade_runner(model, cfg, pose_capacity=batch, device=device)
    init_s = time.perf_counter() - t0
    reset_counts()
    res = run(images, gallery)
    torch.cuda.synchronize()
    counts = dict(launches)
    want = expected_launches("pallas_packed", pose.vit_layers, nms=1)
    want.update(bn_act=batchnorms(model), bn_act_residual=residual_sites(model),
                msda=rtdetr.num_decoder_layers)
    if counts != want:
        fail(f"the RT-DETR cascade launched {counts}, expected {want}")
    check_result(res, batch, cfg.max_persons, cfg.max_faces, batch, pose.num_keypoints)
    if tuple(res.person_query_idx.shape) != (batch, cfg.max_persons):
        fail(f"person_query_idx has shape {tuple(res.person_query_idx.shape)}")
    profile = profile_top(lambda: run(images, gallery))
    for _ in range(2):
        run(images, gallery)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        out = run(images, gallery)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check_result(out, batch, cfg.max_persons, cfg.max_faces, batch, pose.num_keypoints)
    wall_ms = 1e3 * wall / iters
    emit("cascade_rtdetr", metric=f"rtdetr_cascade_{size}_throughput", unit="images/sec",
         dtype="bfloat16", images_per_s=batch * iters / wall, wall_ms_per_call=wall_ms,
         launches_per_call=counts, init_s=init_s,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         device_busy_share=profile.get("kernel_ms", 0.0) / wall_ms, top_device_ms=profile)
    return counts


def profile_top(fn, top: int = 12):
    """Device time per kernel over one call (``tools/dump_trace_ops.py``)."""
    from prpe_tpu_torch.tools.dump_trace_ops import profile_top as aggregate

    return aggregate(fn, top=top)


# --------------------------------------------------------------- combined ---

def tiny_combined_config():
    """A (1, 1, 1, 1) trunk, detection adapters at 32^2, IR-18 on 32^2 with
    10 classes, a 1-layer ViT of width 32 at 64x48 (the CPU tests' size)."""
    from prpe_tpu_torch.core.config import (
        AdaFaceConfig, CombinedModelConfig, DetectionConfig, PoseConfig,
    )

    return CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=DetectionConfig(adapter_size=(32, 32)),
        face=AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                        vit_layers=1, vit_heads=2))


def combined_tasks(model, x, labels):
    """name -> call of each entry point of the combined model: the four
    tasks of ``forward`` and the face logits (no EMA update)."""
    from prpe_tpu_torch.core.config import TASKS

    calls = {task: (lambda task=task: model(x, task)) for task in TASKS}
    calls["face_logits"] = lambda: model(x, "face_recognition", labels, train=False)
    return calls


def flat(out):
    """A task's output as a list of tensors."""
    return list(out) if isinstance(out, (list, tuple)) else [out]


def phase_combined_reference(device) -> None:
    """The tiny fp32 combined model on the card (kernels) against the same
    weights and images on the CPU (plain versions), every task; K2 once in
    ``pose`` (one ViT block), and the fused eval BatchNorm once a no-grad
    eval BatchNorm forward (:func:`with_bn`), no other kernel of ours."""
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches

    cfg = tiny_combined_config()
    cpu = CombinedModel(cfg, device="cpu", seed=2)
    gpu = CombinedModel(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(2, 64, 64, 3, generator=gen)
    labels = torch.tensor([1, 7])
    errs, counts = {}, {}
    want_calls = combined_tasks(cpu, x, labels)
    with torch.inference_mode():
        for name, fn in combined_tasks(gpu, x.to(device), labels.to(device)).items():
            reset_counts()
            got = flat(fn())
            torch.cuda.synchronize()
            counts[name] = {k: v for k, v in launches.items() if v}
            want = with_bn({"mhsa": cfg.pose.vit_layers} if name == "pose_estimation" else {})
            if counts[name] != want:
                fail(f"combined_reference: {name} launched {counts[name]}, expected {want}")
            err = 0.0
            for g, w in zip(got, flat(want_calls[name]()), strict=True):
                tol = 1e-4 * max(1.0, float(w.abs().max()))
                e = float((g.cpu().float() - w.float()).abs().max())
                if not e <= tol:
                    fail(f"combined_reference: {name} differs by {e} > {tol} between card and CPU")
                err = max(err, e)
            errs[name] = err
    emit("combined_reference", max_abs_err=errs, launches=counts)


def phase_combined(device, batch: int = 16, size: int = 640, runs: int = 10) -> dict:
    """The full-width combined model (``CombinedModelConfig()``) in bf16 and
    fp32 at ``batch`` images of ``size``^2: per task, ms per forward (CUDA
    events, calls queued back to back) and images/s, the launches of one
    forward with every counter at zero before it; a kernel profile of the
    fp32 ``pose``. Returns K2's launches per ``pose`` call per dtype."""
    from prpe_tpu_torch.core.config import CombinedModelConfig
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches

    cfg = CombinedModelConfig()
    k2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        model = CombinedModel(cfg, dtype, device=device, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=device).manual_seed(10)
        x = torch.rand(batch, size, size, 3, generator=gen, device=device)
        labels = torch.randint(0, cfg.face.num_classes, (batch,), generator=gen, device=device)
        rows = {}
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            for name, fn in combined_tasks(model, x, labels).items():
                reset_counts()
                out = flat(fn())
                torch.cuda.synchronize()
                counts = {k: v for k, v in launches.items() if v}
                want = with_bn({"mhsa": cfg.pose.vit_layers} if name == "pose_estimation" else {})
                if counts != want:
                    fail(f"combined {dt}: {name} launched {counts}, expected {want}")
                if not all(bool(torch.isfinite(t).all()) for t in out):
                    fail(f"combined {dt}: {name} has non-finite outputs")
                ms = time_ms(fn, runs=runs, warmup=2)
                rows[name] = dict(ms_per_forward=ms, images_per_s=batch * 1e3 / ms,
                                  launches=counts, shapes=[list(t.shape) for t in out])
            k2[dt] = rows["pose_estimation"]["launches"]["mhsa"]
            if rows["pose_estimation"]["shapes"] != [[batch, 17, 64, 48]]:
                fail(f"combined {dt}: heatmaps of shape {rows['pose_estimation']['shapes']}")
            profiles = {task: profile_top(lambda task=task: model(x, task), top=16)
                        for task in ("pose_estimation", "person_detection")}
        emit("combined", dtype=dt, batch=batch, image_size=size, tasks=rows, init_s=init_s,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             k2_launches_per_pose=k2[dt], profiles=profiles)
        del model
        torch.cuda.empty_cache()
    return k2


def check_infer_json(results, n: int) -> None:
    """The keys of ``cli/infer.py``'s JSON (the JAX package's CLI's)."""
    if len(results) != n:
        fail(f"infer_cli: {len(results)} results for {n} frames")
    for r in results:
        if set(r) != {"image", "persons", "faces", "poses"}:
            fail(f"infer_cli: result keys {sorted(r)}")
        for key, fields in (("persons", {"box", "score", "gated"}),
                            ("faces", {"box", "score", "identity", "similarity"}),
                            ("poses", {"box", "keypoints", "scores"})):
            for item in r[key]:
                if set(item) != fields:
                    fail(f"infer_cli: {key} entry keys {sorted(item)}")
                if key == "poses" and len(item["keypoints"]) != 17:
                    fail("infer_cli: a pose without 17 keypoints")


def phase_infer_cli(device, frames: int = 4, faces: int = 2, calls: int = 5) -> dict:
    """``cli/infer.py::run`` (the CLI's path on arrays) at the full preset,
    fp32 as the CLI serves: 4 uint8 frames of 640^2 and 2 enrolled uint8
    faces of 112^2 from a seed; the launches of one call with every counter
    at zero before it, the JSON schema, and the wall ms per call."""
    import numpy as np

    from prpe_tpu_torch.cli import infer
    from prpe_tpu_torch.ops.kernels import launches

    model = infer.build_model("full", device=device)
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (frames, 640, 640, 3), dtype=np.uint8)
    enroll = rng.integers(0, 256, (faces, 112, 112, 3), dtype=np.uint8)
    reset_counts()
    results = infer.run(model, images, enroll, threshold=0.4)
    torch.cuda.synchronize()
    counts = dict(launches)
    want = expected_launches("pallas_packed", model.pose_cfg.vit_layers, nms=2)
    want["bn_act"] = batchnorms(model, model.irnet)  # IR-Net embeds the enrolled faces too
    if counts != want:
        fail(f"infer_cli launched {counts}, expected {want}")
    check_infer_json(results, frames)
    json.dumps(results)
    t = time.perf_counter()
    for _ in range(calls):
        infer.run(model, images, enroll, threshold=0.4)
    wall_ms = (time.perf_counter() - t) / calls * 1e3
    profile = profile_top(lambda: infer.run(model, images, enroll, threshold=0.4))
    emit("infer_cli", frames=frames, enrolled=faces, launches_per_call=counts,
         wall_ms_per_call=wall_ms, device_busy_share=profile["kernel_ms"] / wall_ms,
         persons=sum(len(r["persons"]) for r in results),
         faces=sum(len(r["faces"]) for r in results), poses=sum(len(r["poses"]) for r in results),
         profile=profile)
    return counts


def phase_export(device, batch: int = 2) -> dict:
    """``torch.export`` (``cli/export.py``) of ViTPose-B and of the combined
    model's pose path at full width, fp32: the graph holds
    ``prpe::mhsa_packed``, running the program launches K2 once per ViT
    block, and its heatmaps equal the eager ones within 1e-5 of their
    largest magnitude."""
    from prpe_tpu_torch.cli import export
    from prpe_tpu_torch.ops.kernels import launches

    rows = {}
    for name in ("vitpose", "combined_pose"):
        model, x = export.build_program(name, batch, 640, "full", device)
        x = torch.rand(x.shape, generator=torch.Generator(device=device).manual_seed(12),
                       device=device)
        t0 = time.perf_counter()
        program = export.export_program(model, x)
        export_s = time.perf_counter() - t0
        nodes = [str(n.target) for n in program.graph.nodes if "prpe" in str(n.target)]
        if nodes.count("prpe.mhsa_packed.default") != 12:
            fail(f"export: {name} graph holds {nodes}, expected 12 prpe::mhsa_packed nodes")
        with torch.inference_mode():
            want = model(x)
            reset_counts()
            got = program.module()(x)
            torch.cuda.synchronize()
        counts = {k: v for k, v in launches.items() if v}
        want_counts = with_bn({"mhsa": 12})
        if counts != want_counts:
            fail(f"export: the {name} program launched {counts}, expected {want_counts}")
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        if not err <= tol:
            fail(f"export: {name} program differs from eager by {err} > {tol}")
        rows[name] = dict(max_abs_err=err, launches=counts, prpe_nodes=len(nodes),
                          export_s=export_s, heatmaps=list(got.shape))
        del program, model
    emit("export", batch=batch, programs=rows)
    return rows


# --------------------------------------------------------------- training ---

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_mhsa_grad(gen, device, dtype, layout: str, b: int = 32, t: int = 192, h: int = 12,
                    d: int = 64) -> dict:
    """Forward plus backward of one attention op: the kernel's forward with
    the registered backward (``attention.py::mhsa_backward``, the JAX
    package's ``_bwd`` in torch ops) against the plain forward with the
    same backward, on the same tensors; ``library_ms`` is SDPA's forward
    plus backward. The bound counts the forward's two products and the
    backward's five (it recomputes the logits, as ``_bwd`` does)."""
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels import attention as attn

    if layout == "packed":
        name, counter, shape = "mhsa_packed", "mhsa", (b, t, h * d)
        kernel = lambda q, k, v: attn.mhsa_packed(q, k, v, h)  # noqa: E731
        plain = lambda q, k, v: attn.mhsa_packed_plain(q, k, v, h)  # noqa: E731
        bthd = lambda x: x.view(b, t, h, d)  # noqa: E731
        back = lambda x: x.reshape(b, t, h * d)  # noqa: E731
        heads = lambda x: x.view(b, t, h, d).transpose(1, 2)  # noqa: E731
    else:
        name, counter, shape = "mhsa_bhtd", "mhsa_bhtd", (b, h, t, d)
        kernel, plain = attn.mhsa_bhtd, attn.mhsa_bhtd_plain
        bthd = lambda x: x.transpose(1, 2)  # noqa: E731
        back = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
        heads = lambda x: x  # noqa: E731
    q, k, v, g = (torch.randn(*shape, generator=gen, device=device).to(dtype) for _ in range(4))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]

    def kernel_fwd_bwd():
        out = kernel(*ins)
        return out, torch.autograd.grad(out, ins, g)

    def plain_fwd_bwd():
        out = plain(q, k, v)
        grads = attn.mhsa_backward(bthd(q), bthd(k), bthd(v), bthd(g))
        return out, [back(x) for x in grads]

    lib_ins = [heads(x).detach().clone().requires_grad_() for x in (q, k, v)]

    def library_fwd_bwd():
        out = F.scaled_dot_product_attention(*lib_ins)
        return torch.autograd.grad(out, lib_ins, heads(g))

    before = launches[counter]
    out, grads = kernel_fwd_bwd()
    _sync(device)
    if launches[counter] != before + 1:
        fail(f"{name} forward + backward launched {launches[counter] - before} kernels, not 1")
    want_out, want = plain_fwd_bwd()
    errs = {"out": float((out.detach().float() - want_out.float()).abs().max())}
    for key, got, w in zip(("dq", "dk", "dv"), grads, want):
        errs[key] = float((got.float() - w.float()).abs().max())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if not max(errs.values()) <= tol or not all(bool(torch.isfinite(x).all()) for x in grads):
        fail(f"{name} grad {dtype}: max abs errs {errs} > {tol}")
    ms = time_ms(kernel_fwd_bwd, runs=10)
    plain_ms = time_ms(plain_fwd_bwd, runs=10)
    library_ms = time_ms(library_fwd_bwd, runs=10)
    bnd, by = bound_ms(11 * q.numel() * q.element_size(), 14 * b * h * t * t * d,
                       PEAK_FLOPS[dtype])
    row = dict(name=f"{name}_grad", dtype=str(dtype).replace("torch.", ""), B=b, T=t, H=h, D=d,
               max_abs_err=max(errs.values()), max_abs_err_by_output=errs, ms=ms,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=library_ms,
               host_us=host_us(kernel_fwd_bwd, calls=5, rounds=3))
    emit("mhsa_grad", **row)
    return row


TRAIN_OPTIM = dict(optimizer="sgd", learning_rate=0.1, weight_decay=5e-4)


def train_batches(cfg, batch: int, size: int, seed: int = 0, num_classes=None) -> dict:
    """One synthetic batch per task (``data/synthetic.py``, numpy seed)."""
    import numpy as np

    from prpe_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    return {"person_detection": synthetic.detection_batch(rng, batch, size, cfg.detection.max_gt),
            "face_detection": synthetic.detection_batch(rng, batch, size, cfg.detection.max_gt),
            "face_recognition": synthetic.face_batch(rng, batch, size,
                                                     num_classes or cfg.face.num_classes),
            "pose_estimation": synthetic.pose_batch(rng, batch, size, cfg.pose.max_instances)}


def one_train_step(model, task: str, cfg, optim_kw: dict, batch: dict):
    """A fresh optimizer for ``task`` (branch scope) and one step: -> the
    step's metrics as floats."""
    from prpe_tpu_torch.core.config import OptimConfig
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_train_step, trainable_params

    tx = build_optimizer(OptimConfig(**optim_kw))
    state = create_train_state(model, {task: tx}, {task: trainable_params(model, task)})
    step = make_train_step(model, task, tx, cfg)
    _, metrics = step(state, batch, torch.Generator(device=next(model.parameters()).device))
    return {k: float(v) for k, v in metrics.items()}


def phase_train_reference(device) -> dict:
    """One SGD step per task of the tiny fp32 combined model on the card
    against the same step on the CPU, from the same weights and batch
    (dropout off: the two devices draw different masks). Loss and metrics
    within 1e-4 of their magnitude (at least 1), ``grad_norm`` within 5e-3;
    each updated parameter's
    change within 1e-1 of the largest CPU change of that tensor plus 1e-4 of
    the task's largest (the tiny model's BatchNorms reduce over few
    elements, so its fp32 gradients carry rounding of that size, as
    ``tests/test_torch_train.py`` sets out); the running statistics within
    1e-3. K2 launched once per ViT block in the pose step; K1 once in each
    detection eval step. Returns the launch counts."""
    from prpe_tpu_torch.core.config import TASKS
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.train.steps import make_eval_step, trainable_mask

    cfg = tiny_combined_config()
    batches = train_batches(cfg, 8, 64, seed=3)
    rows, counts = {}, {}
    for task in TASKS:
        # the weights drawn once on the CPU: a generator draws differently
        # on the card
        models = {"cpu": CombinedModel(cfg, device="cpu", seed=2),
                  "card": CombinedModel(cfg, device=device)}
        models["card"].load_state_dict(models["cpu"].state_dict())
        for m in models.values():
            m.ada_face.dropout.rate = 0.0
        start = {k: t.clone() for k, t in models["cpu"].state_dict().items()}
        reset_counts()
        got = one_train_step(models["card"], task, cfg, TRAIN_OPTIM, batches[task])
        _sync(device)
        counts[task] = {"train": {k: v for k, v in launches.items() if v}}
        want_counts = with_bn({"mhsa": cfg.pose.vit_layers} if task == "pose_estimation" else {})
        want = one_train_step(models["cpu"], task, cfg, TRAIN_OPTIM, batches[task])
        if counts[task]["train"] != want_counts:
            fail(f"train_reference: {task} step launched {counts[task]['train']}, "
                 f"expected {want_counts}")
        metric_err = max(abs(got[k] - w) / max(1.0, abs(w)) for k, w in want.items()
                         if k != "grad_norm")
        norm_err = abs(got["grad_norm"] - want["grad_norm"]) / max(1.0, abs(want["grad_norm"]))
        if not (metric_err <= 1e-4 and norm_err <= 5e-3):
            fail(f"train_reference: {task} metrics {got} against the CPU's {want}")
        mask = trainable_mask(models["cpu"], task)
        gsd = {k: t.cpu() for k, t in models["card"].state_dict().items()}
        wsd = models["cpu"].state_dict()
        task_scale = max(float((wsd[k] - start[k]).abs().max()) for k in mask if mask[k])
        param_err = stat_err = 0.0
        for k, w in wsd.items():
            if k in mask and not mask[k]:
                if not torch.equal(gsd[k], start[k]):
                    fail(f"train_reference: {task} moved the frozen {k}")
                continue
            if k in mask:
                scale = float((w - start[k]).abs().max())
                e = float(((gsd[k] - start[k]) - (w - start[k])).abs().max())
                bound = 1e-1 * scale + 1e-4 * task_scale
                if not e <= bound:
                    fail(f"train_reference: {task} {k} moved {e} off the CPU's change {scale}")
                param_err = max(param_err, e / bound)
            else:
                e = float((gsd[k].float() - w.float()).abs().max()) / max(
                    1.0, float(w.float().abs().max()))
                if not e <= 1e-3:
                    fail(f"train_reference: {task} statistic {k} off by {e}")
                stat_err = max(stat_err, e)
        reset_counts()
        make_eval_step(models["card"], task, cfg)(batches[task])
        _sync(device)
        counts[task]["eval"] = {k: v for k, v in launches.items() if v}
        want_eval = with_bn({"nms": 1} if "detection" in task else
                            {"mhsa": 2 * cfg.pose.vit_layers} if task == "pose_estimation" else {})
        if counts[task]["eval"] != want_eval:
            fail(f"train_reference: {task} eval step launched {counts[task]['eval']}, "
                 f"expected {want_eval}")
        rows[task] = dict(loss=got["loss"], loss_cpu=want["loss"], max_metric_rel_err=metric_err,
                          grad_norm_rel_err=norm_err,
                          max_param_change_share_of_bound=param_err, task_max_change=task_scale,
                          max_stat_rel_err=stat_err, launches=counts[task])
    emit("train_reference", batch=8, image_size=64, tasks=rows)
    return counts


def phase_train(device, cfg=None, dtype=torch.bfloat16, batch: int = 32, size: int = 640,
                warmup: int = 2, steps: int = 5) -> dict:
    """The ``bench_train.py`` geometry: ``CombinedModelConfig()`` at full
    width, bf16 compute with fp32 parameters, ``batch`` images of
    ``size``^2, branch scope, Adam at lr 1e-3 constant, one synthetic batch
    per task (detection 16 boxes at most, face labels from 1000 classes,
    pose 8 instances; numpy seed 0) already on the card. Per task:
    ``warmup`` steps, then ``steps`` timed (CUDA events, the steps queued
    back to back) with every launch counter at zero before them; finite
    losses, the trunk unmoved, the peak memory; one eval step with its
    launches; a kernel profile of one pose and one person-detection step.
    A batch the card cannot hold is halved, and the row says so. Returns
    the launches per train step and per eval step."""
    import dataclasses

    from prpe_tpu_torch.core.config import TASKS, CombinedModelConfig, OptimConfig
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import (
        make_eval_step, make_train_step, to_device, trainable_params,
    )

    cfg = cfg or dataclasses.replace(
        CombinedModelConfig(), detection=dataclasses.replace(CombinedModelConfig().detection,
                                                             max_gt=16))
    t0 = time.perf_counter()
    model = CombinedModel(cfg, dtype, device=device, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    optim = OptimConfig(optimizer="adam", learning_rate=1e-3)
    txs = {task: build_optimizer(optim) for task in TASKS}
    state = create_train_state(model, txs, {t: trainable_params(model, t) for t in TASKS})
    gen = torch.Generator(device=device).manual_seed(0)
    trunk = {k: p.detach().clone() for k, p in model.named_parameters()
             if k.startswith("backbone")}
    per_step, per_eval, rows, profiles, step_ms = {}, {}, {}, {}, {}
    host_batches = train_batches(cfg, batch, size, 0, min(1000, cfg.face.num_classes))
    for task in TASKS:
        step = make_train_step(model, task, txs[task], cfg)
        b = batch
        while True:
            try:
                data = to_device({k: v[:b] for k, v in host_batches[task].items()}, device)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                losses = []
                for _ in range(warmup):
                    state, m = step(state, data, gen)
                    losses.append(m)
                _sync(device)
                break
            except torch.cuda.OutOfMemoryError:
                if b == 1:
                    raise
                data = None
                torch.cuda.empty_cache()
                b //= 2
        reset_counts()
        holder = {"state": state}

        def one():
            holder["state"], m = step(holder["state"], data, gen)
            losses.append(m)

        ms = time_ms(one, runs=steps, warmup=0)
        _sync(device)
        step_ms[task] = ms
        state = holder["state"]
        counts = {k: v for k, v in launches.items() if v}
        per_step[task] = {k: v / steps for k, v in counts.items()}
        want = with_bn({"mhsa": cfg.pose.vit_layers * steps} if task == "pose_estimation" else {})
        if counts != want:
            fail(f"train: {task} launched {counts} in {steps} steps, expected {want}")
        host = [{k: float(v) for k, v in m.items()} for m in losses]
        if not all(v == v and abs(v) != float("inf") for m in host for v in m.values()):
            fail(f"train: {task} has non-finite metrics {host[-1]}")
        for k, p in model.named_parameters():
            if k in trunk and not torch.equal(p, trunk[k]):
                fail(f"train: the frozen trunk's {k} moved in {task}")
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0
        reset_counts()
        metrics, _ = make_eval_step(model, task, cfg)(data)
        _sync(device)
        per_eval[task] = {k: v for k, v in launches.items() if v}
        want_eval = with_bn({"nms": 1} if "detection" in task else
                            {"mhsa": 2 * cfg.pose.vit_layers} if task == "pose_estimation" else {})
        if per_eval[task] != want_eval:
            fail(f"train: {task} eval step launched {per_eval[task]}, expected {want_eval}")
        rows[task] = dict(batch=b, batch_note=None if b == batch else f"batch {batch} did not fit",
                          ms_per_step=ms, images_per_s=b * 1e3 / ms,
                          peak_mem_gib=peak, launches_per_step=per_step[task],
                          eval_launches=per_eval[task], losses=[m["loss"] for m in host],
                          last_metrics=host[-1],
                          eval_metrics={k: float(v) for k, v in metrics.items()})
        if task in ("pose_estimation", "person_detection") and device.type == "cuda":
            profiles[task] = profile_top(lambda: step(state, data, gen), top=16)
        del data
    emit("train", dtype=str(dtype).replace("torch.", ""), image_size=size, init_s=init_s,
         optimizer="adam lr 1e-3 constant, branch scope", tasks=rows, profiles=profiles)
    del model, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"step": per_step, "eval": per_eval, "ms": step_ms}


def phase_train_cli(device, full_batch: int = 4,
                    full=("--preset", "full", "--image-size", "640"), layers: int = 12) -> dict:
    """``cli/train.py::main`` on the card, writing into a temporary
    directory that is deleted afterwards: the tiny preset for 1 epoch with
    its checkpoints, then ``--resume-checkpoint latest`` for a second; then
    the full preset (fresh weights, no component files) at batch
    ``full_batch`` for 1 epoch with ``--save-every 2`` (no combined
    checkpoint; the slim ``best_*`` of each task whose monitor has a value
    is: both detection tasks' from the mAP hook, face recognition's), with
    every launch counter at zero before it. Returns that run's launches."""
    import json as json_
    import shutil
    import tempfile

    from prpe_tpu_torch.cli import train as cli
    from prpe_tpu_torch.ops.kernels import launches

    tmp = tempfile.mkdtemp(prefix="prpe_train_cli_")
    try:
        def args(name, *extra):
            missing = os.path.join(tmp, "no_dataset")
            return ["--device", str(device), "--person-data-dir", missing, "--face-data-dir",
                    missing, "--face-rec-data-dir", missing, "--pose-data-dir", missing,
                    "--component-dir", missing, "--checkpoint-dir", os.path.join(tmp, name, "ck"),
                    "--log-dir", os.path.join(tmp, name, "log"), *extra]

        tiny = ["--preset", "tiny", "--image-size", "64", "--batch-size", "4"]
        t0 = time.perf_counter()
        if cli.main(args("tiny", *tiny, "--epochs", "1")) != 0:
            fail("train_cli: the tiny run did not return 0")
        if cli.main(args("tiny", *tiny, "--epochs", "2", "--resume-checkpoint", "latest")) != 0:
            fail("train_cli: the resumed tiny run did not return 0")
        tiny_s = time.perf_counter() - t0
        meta = json_.loads(open(os.path.join(tmp, "tiny", "ck", "meta.json")).read())
        epochs = [(c["epoch"], c["last_task"]) for c in meta["checkpoints"]]
        # the newest 3 (TrainConfig.keep_checkpoints) are all of epoch 1
        if [e for e, _ in epochs] != [1, 1, 1] or epochs[-1][1] != "pose_estimation":
            fail(f"train_cli: the resumed run wrote checkpoints {epochs}")

        reset_counts()
        t0 = time.perf_counter()
        if cli.main(args("full", *full, "--batch-size", str(full_batch), "--epochs", "1",
                         "--save-every", "2")) != 0:
            fail("train_cli: the full run did not return 0")
        _sync(device)
        full_s = time.perf_counter() - t0
        counts = {k: v for k, v in launches.items() if v}
        # 8 synthetic train batches a task; 2 validation batches a detection
        # task (K1 once each); pose has no validation loader
        want = with_bn({"mhsa": 8 * layers, "nms": 2 * 2})
        if counts != want:
            fail(f"train_cli: the full run launched {counts}, expected {want}")
        written = sorted(os.listdir(os.path.join(tmp, "full", "ck")))
        # pose has no validation loader on synthetic data, so no monitor
        want_written = ["best_face_detection.pt", "best_face_recognition.pt",
                        "best_person_detection.pt", "meta.json"]
        if written != want_written:
            fail(f"train_cli: the full run wrote {written}, expected {want_written}")
        history = {}
        for task in ("person_detection", "face_detection", "face_recognition", "pose_estimation"):
            with open(os.path.join(tmp, "full", "log", f"{task}_history.csv")) as f:
                head, row = f.read().splitlines()[:2]
            history[task] = dict(zip(head.split(","), (float(x) for x in row.split(","))))
            if not all(v == v for v in history[task].values()):
                fail(f"train_cli: {task} logged non-finite metrics {history[task]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_cli", tiny_two_runs_s=tiny_s, tiny_checkpoints=epochs, full_batch=full_batch,
         full_run_s=full_s, full_launches=counts, full_written=written,
         full_history={t: {k: h[k] for k in h if k in ("train/loss", "val/loss", "val_acc",
                                                       "val/mAP50-95")}
                       for t, h in history.items()})
    return counts


TASK_METRIC = {"person_detection": "val/mAP50-95", "face_detection": "val/mAP50-95",
               "face_recognition": "val/ver_acc", "pose_estimation": "val/kpt_AP"}


def decode_rate(tmp: str, batch: int, size: int, workers: int) -> dict:
    """Host images/s of each task's train loader alone (decode, resize,
    flip, collate; no card), over one batch of ``loader.host``, with the
    native library already built."""
    from prpe_tpu_torch import native
    from prpe_tpu_torch.core.config import DetectionConfig
    from prpe_tpu_torch.data import detection, faces, pipeline, pose

    native.get_lib()
    max_gt = DetectionConfig().max_gt
    datasets = {
        "person_detection": detection.YoloTxtDataset(os.path.join(tmp, "person"), "train", size,
                                                     max_gt, augment=True),
        "face_detection": detection.YoloTxtDataset(os.path.join(tmp, "face"), "train", size,
                                                   max_gt, augment=True),
        "face_recognition": faces.IdentityFolderDataset(os.path.join(tmp, "faces"), "train",
                                                        augment=True),
        "pose_estimation": pose.CocoKeypointDataset(os.path.join(tmp, "pose"), "train",
                                                    image_size=size, augment=True)}
    rates = {}
    for task, ds in datasets.items():
        loader = pipeline.make_epoch_loader(ds, batch, max_samples=batch, num_workers=workers,
                                            prefetch=0)
        try:
            t0 = time.perf_counter()
            n = sum(len(b["image"]) for b in loader.host(0))
            rates[task] = n / (time.perf_counter() - t0)
        finally:
            loader.close()
    return rates


def make_png_datasets(root: str, n_train: int = 64, n_val: int = 32, size: int = 640,
                      identities: int = 16, per_identity: int = 20) -> float:
    """The four layouts of ``tools/make_dataset.py`` under ``root`` (detection
    and pose ``n_train`` + ``n_val`` PNGs of ``size``^2 each, ``identities``
    x ``per_identity`` face crops of 112^2); returns the seconds taken."""
    from prpe_tpu_torch.tools.make_dataset import make_dataset

    t0 = time.perf_counter()
    make_dataset(root, n_train, n_val, det_size=size, pose_size=size, face_size=112,
                 identities=identities, per_identity=per_identity)
    return time.perf_counter() - t0


def data_argv(root: str, run_dir: str, device, size: int, batch: int, *extra) -> list:
    """``cli/train.py`` flags for the datasets under ``root``, writing into
    ``run_dir`` (``device`` None: the CLI's default)."""
    dev = [] if device is None else ["--device", str(device)]
    return [*dev, "--image-size", str(size), "--batch-size", str(batch),
            "--person-data-dir", os.path.join(root, "person"),
            "--face-data-dir", os.path.join(root, "face"),
            "--face-rec-data-dir", os.path.join(root, "faces"),
            "--pose-data-dir", os.path.join(root, "pose"),
            "--component-dir", os.path.join(root, "no_components"),
            "--checkpoint-dir", os.path.join(run_dir, "ck"),
            "--log-dir", os.path.join(run_dir, "log"), *extra]


def history(run_dir: str, task: str) -> list:
    """The rows of a run's ``<task>_history.csv`` as dicts of floats."""
    import csv

    with open(os.path.join(run_dir, "log", f"{task}_history.csv")) as f:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]


def phase_train_data(device, n_train: int = 64, n_val: int = 32, size: int = 640,
                     batch: int = 32, identities: int = 16, per_identity: int = 20,
                     full=("--preset", "full"), layers: int = 12, workers=(0, 2),
                     train_ms=None, root=None) -> dict:
    """``cli/train.py::main`` from datasets on disk: the four layouts written
    by ``tools/make_dataset.py`` into a temporary directory (detection and
    pose ``n_train`` + ``n_val`` PNGs of ``size``^2 each; ``identities`` x
    ``per_identity`` face crops of 112^2, of which the reader's 10 % split
    must fill one val batch), then one epoch at ``batch`` per run, once for
    each decode-worker count in ``workers`` (after the first, one train
    step a task), every launch counter at zero before each run. Fails on a non-finite metric, a missing ``val/mAP50-95``
    (both detection tasks), ``val/ver_acc`` or ``val/kpt_AP``, a missing
    detection ``best_*`` checkpoint, or launches other than K1 once per
    detection val batch and K2 ``layers`` per pose train step plus
    2 ``layers`` per pose val batch. Prints per task the ms per train step
    from disk (beside ``train_ms``, the ``train`` phase's on a reused device
    batch), the loader's wait per step, the seconds each eval hook takes on
    the host, the metrics, and the host decode images/s of each worker
    count. ``root``: datasets already written there (else they are written
    into a temporary directory, deleted afterwards). Returns the first
    run's launches and ms a step per task."""
    import csv
    import shutil
    import tempfile

    from prpe_tpu_torch.cli import train as cli
    from prpe_tpu_torch.ops.kernels import launches

    tmp = tempfile.mkdtemp(prefix="prpe_train_data_")
    runs, first_counts, first_ms = {}, None, None
    try:
        dataset_s = None
        if root is None:
            dataset_s = make_png_datasets(tmp, n_train, n_val, size, identities, per_identity)
            root = tmp
        decode = {w: decode_rate(root, batch, size, w) for w in workers}
        build = cli.build_task_loaders
        for w in workers:
            captured, hook_s = {}, {}

            def timed(task, hook):
                def run(outputs):
                    t = time.perf_counter()
                    try:
                        return hook(outputs)
                    finally:
                        hook_s[task] = hook_s.get(task, 0.0) + time.perf_counter() - t
                return run

            def capture(args, cfg, device=None, **kw):
                loaders = build(args, cfg, device, **kw)
                for task, tl in loaders.items():
                    if "eval_hook" in tl:
                        tl["eval_hook"] = timed(task, tl["eval_hook"])
                captured.update(loaders)
                return loaders

            name = f"workers{w}"
            # the runs after the first: one step a task
            argv = data_argv(root, os.path.join(tmp, name), device, size, batch, *full,
                             "--epochs", "1", "--num-workers", str(w), "--save-every", "2",
                             *(() if w == workers[0] else ("--max-train-samples", str(batch))))
            cli.build_task_loaders = capture
            try:
                reset_counts()
                t0 = time.perf_counter()
                if cli.main(argv) != 0:
                    fail(f"train_data: the run at {w} workers did not return 0")
                _sync(device)
                run_s = time.perf_counter() - t0
            finally:
                cli.build_task_loaders = build
            counts = {k: v for k, v in launches.items() if v}
            if set(captured) != set(TASK_METRIC) or not all(
                    hasattr(captured[t]["train"], "host") for t in TASK_METRIC):
                fail(f"train_data: not every task read its dataset ({sorted(captured)})")
            val_batches = {t: captured[t]["val"].steps_per_epoch for t in TASK_METRIC}
            pose_steps = captured["pose_estimation"]["train"].steps_per_epoch
            want = with_bn({
                "nms": val_batches["person_detection"] + val_batches["face_detection"],
                "mhsa": layers * pose_steps + 2 * layers * val_batches["pose_estimation"]})
            if counts != want or min(val_batches.values()) < 1:
                fail(f"train_data: {w} workers launched {counts}, expected {want} "
                     f"(val batches {val_batches}, pose steps {pose_steps})")
            written = sorted(os.listdir(os.path.join(tmp, name, "ck")))
            rows = {}
            for task, metric in TASK_METRIC.items():
                with open(os.path.join(tmp, name, "log", f"{task}_history.csv")) as f:
                    hist = {k: float(v) for k, v in next(csv.DictReader(f)).items()}
                if metric not in hist or not all(v == v and abs(v) != float("inf")
                                                 for v in hist.values()):
                    fail(f"train_data: {task} at {w} workers logged {hist}")
                if "detection" in task and f"best_{task}.pt" not in written:
                    fail(f"train_data: no best_{task}.pt at {w} workers ({written})")
                stats = captured[task]["train"].stats
                rows[task] = dict(
                    train_steps=stats["batches"],
                    ms_per_step=batch * 1e3 / hist["train/images_per_sec"],
                    train_phase_ms_per_step=(train_ms or {}).get(task),
                    loader_wait_ms_per_step=stats["wait_s"] * 1e3 / max(stats["batches"], 1),
                    val_batches=val_batches[task], hook_s=hook_s.get(task),
                    metrics={k: hist[k] for k in hist if k in (
                        "train/loss", "val/loss", "val/mAP50", "val/mAP50-95", "val/ver_acc",
                        "val/kpt_AP", "val_acc")})
            runs[name] = dict(run_s=run_s, launches=counts, written=written, tasks=rows)
            first_counts = first_counts or counts
            first_ms = first_ms or {t: r["ms_per_step"] for t, r in rows.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_data", image_size=size, batch=batch, train_images=n_train, val_images=n_val,
         face_crops=identities * per_identity, dataset_s=dataset_s,
         decode_images_per_s={f"workers{w}": r for w, r in decode.items()}, runs=runs)
    return {"launches": first_counts, "ms": first_ms}


# ------------------------------------------------------------- parallel ---

# ranks of one process group share the one card under gloo: NCCL refuses
# two ranks on one GPU
COLLECTIVE_KEYS = ("nccl", "gloo", "all_reduce", "allreduce", "all_gather", "allgather",
                   "broadcast", "c10d::")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(fn, world: int, *args):
    """``fn(rank, world, *args, queue)`` started in ``world`` spawned
    processes, each to put ``(rank, result)`` on ``queue``."""
    import torch.multiprocessing as mp

    q = mp.get_context("spawn").Queue()
    return world, q, mp.spawn(fn, args=(world, *args, q), nprocs=world, join=False)


def spawn_ranks(fn, world: int, *args) -> list:
    return collect_ranks(*start_ranks(fn, world, *args))


def collect_ranks(world: int, q, procs, timeout_s: float = 900.0) -> list:
    """The results of ``start_ranks``' processes in rank order, after every
    process has exited. A rank that fails fails the phase with its
    traceback."""
    import queue as queue_

    results, deadline = {}, time.time() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, out = q.get(timeout=1.0)
                results[rank] = out
            except queue_.Empty:
                procs.join(timeout=0.0)  # raises with a failed rank's traceback
                if time.time() > deadline:
                    raise TimeoutError(f"{world} ranks gave {len(results)} results")
        while not procs.join():
            pass
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    return [results[r] for r in range(world)]


def count_on_cpu() -> None:
    """For a rehearsal on the CPU: each custom op's CPU kernel (its plain
    version) counts a launch, as its CUDA kernel does on the card."""
    from prpe_tpu_torch.ops.kernels import _build, attention, bn_act, ms_deform_attn, nms

    def counting(op, plain, key):
        def fn(*args):
            _build.launches[key] += 1
            return plain(*args)
        torch.library.register_kernel(op, "cpu", fn)

    counting("prpe::mhsa_packed", attention.mhsa_packed_plain, "mhsa")
    counting("prpe::mhsa_bhtd", attention.mhsa_bhtd_plain, "mhsa_bhtd")
    counting("prpe::nms_keep", nms.nms_keep_plain, "nms")
    counting("prpe::ms_deform_attn", ms_deform_attn.ms_deform_attn_plain, "msda")

    def bn_act_counting(*args):
        _build.launches["bn_act"] += 1
        if len(args) > 6 and args[6] is not None:  # a residual: that route's counter too
            _build.launches["bn_act_residual"] += 1
        return bn_act.bn_act_plain(*args)

    torch.library.register_kernel("prpe::bn_act", "cpu", bn_act_counting)


def _rank_device(device_str: str) -> torch.device:
    """A spawned rank's device: the card (fp32 without TF32, as the parent
    runs it), or the CPU in a rehearsal."""
    torch.set_num_threads(2)
    device = torch.device(device_str)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        count_on_cpu()
    watch_batchnorms()
    return device


def state_digest(state_dict, skip=()) -> str:
    import hashlib

    digest = hashlib.sha256()
    for k in sorted(state_dict):
        if k in skip:
            continue
        digest.update(k.encode())
        t = state_dict[k].detach().cpu().contiguous()
        digest.update(t.view(torch.uint8).numpy().tobytes() if t.dim() else
                      t.reshape(1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def step_errors(start, got, want, mask, got_metrics, want_metrics):
    """(metric error, grad-norm error, worst parameter change over its bound,
    worst statistic error) of a step against a reference step from the
    same ``start``, with ``phase_train_reference``'s bounds: metrics 1e-4,
    ``grad_norm`` 5e-3 of their magnitude (at least 1), each trained
    parameter's change within 1e-1 of the reference change's largest entry
    plus 1e-4 of the task's largest, statistics 1e-3; a frozen parameter
    unmoved."""
    metric_err = max(abs(got_metrics[k] - w) / max(1.0, abs(w)) for k, w in want_metrics.items()
                     if k != "grad_norm")
    norm_err = abs(got_metrics["grad_norm"] - want_metrics["grad_norm"]) / max(
        1.0, abs(want_metrics["grad_norm"]))
    task_scale = max(float((want[k] - start[k]).abs().max()) for k in mask if mask[k])
    param_share = stat_err = 0.0
    for k, w in want.items():
        if k in mask and not mask[k]:
            if not torch.equal(got[k], start[k]):
                param_share = float("inf")
            continue
        if k in mask:
            scale = float((w - start[k]).abs().max())
            e = float(((got[k] - start[k]) - (w - start[k])).abs().max())
            param_share = max(param_share, e / (1e-1 * scale + 1e-4 * task_scale))
        else:
            stat_err = max(stat_err, float((got[k].float() - w.float()).abs().max()) / max(
                1.0, float(w.float().abs().max())))
    return metric_err, norm_err, param_share, stat_err


def _reference_rank(rank: int, world: int, init_dir: str, schedule, device_str: str, payload,
                    queue) -> None:
    """One process of ``phase_parallel_reference``: in each round of
    ``schedule`` (meshes as (shape, the processes that form it)), one step
    per task of the tiny model as its rank of its mesh, held against the
    single-process step on the card; the process group is left between
    rounds, the model kept."""
    device = _rank_device(device_str)
    from prpe_tpu_torch.core.config import MeshConfig, OptimConfig
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.parallel import distributed, mesh as mesh_lib
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_train_step, trainable_mask, trainable_params

    cfg = tiny_combined_config()
    start = {k: t.to(device) for k, t in payload["state_dict"].items()}
    refs = {task: (m, {k: t.to(device) for k, t in sd.items()})
            for task, (m, sd) in payload["refs"].items()}
    model = CombinedModel(cfg, device=device)
    model.ada_face.dropout.rate = 0.0
    out = {}
    for r, meshes in enumerate(schedule):
        mine = [(i, shape, procs) for i, (shape, procs) in enumerate(meshes) if rank in procs]
        if not mine:
            continue
        i, shape, procs = mine[0]
        distributed.initialize(f"file://{init_dir}/init{r}_{i}", len(procs), procs.index(rank),
                               backend="gloo", device=device)
        mesh = mesh_lib.build_mesh(MeshConfig(data_parallel=shape[0], model_parallel=shape[1]),
                                   device=device)
        rows = {}
        for task, batch in payload["batches"].items():
            # the full classifier back before the weights, then this rank's block
            model.face_kernel.data = torch.empty_like(start["face_kernel"])
            model.load_state_dict(start)
            mesh_lib.shard_params(model, mesh)
            tx = build_optimizer(OptimConfig(**TRAIN_OPTIM),
                                 lambda u: mesh_lib.global_norm(u, mesh))
            state = create_train_state(model, {task: tx}, {task: trainable_params(model, task)})
            step = make_train_step(model, task, tx, cfg)
            reset_counts()
            _, metrics = step(state, mesh_lib.shard_batch(batch, mesh),
                              torch.Generator(device=device))
            _sync(device)
            counts = {k: v for k, v in launches.items() if v}
            bn_evals = BN_EVALS.get(device.type, 0)
            got = {k: t.detach() for k, t in
                   mesh_lib.gather_params(model.state_dict(), mesh).items()}
            want_metrics, want = refs[task]
            errs = step_errors(start, got, want, trainable_mask(model, task),
                               {k: float(v) for k, v in metrics.items()}, want_metrics)
            rows[task] = dict(launches=counts, bn_evals=bn_evals, digest=state_digest(got),
                              errors=dict(zip(("metric", "grad_norm", "param_share", "stat"),
                                              errs)),
                              loss=float(metrics["loss"]))
        out[f"dp{shape[0]}_mp{shape[1]}"] = dict(coords=(mesh.data_rank, mesh.model_rank),
                                                 group_rank=procs.index(rank), tasks=rows)
        distributed.shutdown()
    out["done"] = time.perf_counter()  # one clock for every process of the host
    queue.put((rank, out))


def phase_parallel_reference(device, schedule=((((2, 1), (0, 1)), ((1, 2), (2, 3))),
                                               (((2, 2), (0, 1, 2, 3)),)), meanwhile=()):
    """The tiny fp32 combined model, one SGD step per task (branch scope,
    dropout off) at (dp, mp) = (2, 1), (1, 2) and (2, 2): four spawned
    processes share the card under gloo, as two meshes of two and then one
    of four (``schedule``), each rank with its rows of the batch of 8 and its
    block of the classes. Against the single-process step on the card from
    the same weights and batch, within ``phase_train_reference``'s bounds;
    every rank of a mesh ends with bit-equal parameters, BatchNorm
    statistics and margin buffers (``face_kernel`` gathered); K2 launched
    once per ViT block in each rank's pose step, nothing else. The calls in
    ``meanwhile`` (phases that time nothing) run in this process while the
    ranks do. Returns the launches per rank of each mesh."""
    import tempfile

    from prpe_tpu_torch.core.config import TASKS
    from prpe_tpu_torch.models.combined import CombinedModel

    cfg = tiny_combined_config()
    batches = train_batches(cfg, 8, 64, seed=3)
    start_model = CombinedModel(cfg, device="cpu", seed=2)
    start = {k: t.clone() for k, t in start_model.state_dict().items()}
    refs = {}
    for task in TASKS:
        model = CombinedModel(cfg, device=device)
        model.load_state_dict(start)
        model.ada_face.dropout.rate = 0.0
        metrics = one_train_step(model, task, cfg, TRAIN_OPTIM, batches[task])
        refs[task] = (metrics, {k: t.detach().cpu() for k, t in model.state_dict().items()})
        del model
    payload = {"state_dict": start, "batches": batches, "refs": refs}
    processes = 1 + max(p for meshes in schedule for _, procs in meshes for p in procs)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        started = start_ranks(_reference_rank, processes, d, schedule, str(device), payload)
        for call in meanwhile:
            call()
        meanwhile_s = time.perf_counter() - t0
        results = collect_ranks(*started)
    run_s = time.perf_counter() - t0
    ranks_s = max(r["done"] for r in results) - t0
    rows, counts = {}, {}
    for name in sorted({n for r in results for n in r if n != "done"}):
        ranks = sorted((r[name] for r in results if name in r), key=lambda x: x["group_rank"])
        for task in TASKS:
            per_rank = [r["tasks"][task] for r in ranks]
            want_launches = {"mhsa": cfg.pose.vit_layers} if task == "pose_estimation" else {}
            wants = [with_bn(want_launches, r["bn_evals"]) for r in per_rank]
            if [r["launches"] for r in per_rank] != wants:
                fail(f"parallel_reference: {name} {task} launched "
                     f"{[r['launches'] for r in per_rank]}, expected {wants}")
            if len({r["digest"] for r in per_rank}) != 1:
                fail(f"parallel_reference: {name} {task}: the ranks' parameters, statistics "
                     "or margin buffers differ")
            e = per_rank[0]["errors"]
            if not (e["metric"] <= 1e-4 and e["grad_norm"] <= 5e-3 and e["param_share"] <= 1.0
                    and e["stat"] <= 1e-3):
                fail(f"parallel_reference: {name} {task} off the single-process step: {e}")
        counts[name] = [{t: r["tasks"][t]["launches"] for t in TASKS} for r in ranks]
        rows[name] = dict(ranks=len(ranks), coords=[r["coords"] for r in ranks],
                          errors={t: ranks[0]["tasks"][t]["errors"] for t in TASKS},
                          losses={t: ranks[0]["tasks"][t]["loss"] for t in TASKS},
                          single_losses={t: refs[t][0]["loss"] for t in TASKS},
                          launches_per_rank=counts[name], ranks_equal=True)
    if sorted(rows) != ["dp1_mp2", "dp2_mp1", "dp2_mp2"]:
        fail(f"parallel_reference: ran the meshes {sorted(rows)}")
    emit("parallel_reference", backend="gloo", batch=8, image_size=64, processes=processes,
         run_s=run_s, ranks_s=ranks_s, meanwhile_s=meanwhile_s, meshes=rows)
    return counts


def _cli_rank(rank: int, world: int, runs, device_str: str, profile_task: str, gate,
              queue) -> None:
    """One spawned process of ``phase_parallel``: ready on the card (CUDA
    context, cuDNN and cuBLAS started), it waits for ``gate``, then runs
    ``_cli_runs``."""
    device = _rank_device(device_str)
    if device.type == "cuda":
        x = torch.ones(2, 8, 16, 16, device=device, requires_grad=True)
        w = torch.ones(8, 8, 3, 3, device=device)
        (torch.nn.functional.conv2d(x, w).sum() + (x.flatten(1) @ x.flatten(1).T).sum()).backward()
        _sync(device)
    gate.wait()
    queue.put((rank, _cli_runs(rank, runs, device, profile_task)))


def _cli_runs(rank: int, runs, device, profile_task: str) -> dict:
    """For each of ``runs`` (name, number of processes, gloo rendezvous or
    None, argv) that this process takes part in, ``cli/train.py::main`` as
    its ``rank``, with the run's launches, peak memory, the steps' times, a
    profile of rank 0's first ``profile_task`` step, the seconds until
    training starts and in checkpoint writes, and a digest of the
    replicated parameters and buffers at the end of training. Where the run
    names a gloo rendezvous, this process joins it first and leaves it
    after: ranks that share the one card need gloo (NCCL refuses two ranks
    on one GPU), and the CLI keeps its caller's process group; otherwise
    the CLI joins the rendezvous of its argv."""
    cuda = device.type == "cuda"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from prpe_tpu_torch.cli import train as cli
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.parallel import distributed, mesh as mesh_lib
    from prpe_tpu_torch.train import checkpoint, round_robin

    out = {}
    make_step, train = round_robin.make_train_step, round_robin.RoundRobinTrainer.train

    def make(model, task, *a, **k):
        step = make_step(model, task, *a, **k)
        times = out["step_ms"].setdefault(task, [])

        def timed(state, batch, gen=None):
            if task == profile_task and rank == 0 and not times:
                return profiled(state, batch, gen)
            _sync(device)
            t0 = time.perf_counter()
            result = step(state, batch, gen)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            return result

        def profiled(state, batch, gen):
            _sync(device)
            t0 = time.perf_counter()
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=activities) as prof:
                result = step(state, batch, gen)
                _sync(device)
            wall = (time.perf_counter() - t0) * 1e3
            coll, kernel_ms, memcpy_ms = [], 0.0, 0.0
            for e in prof.key_averages():
                key = e.key.lower()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                    kernel_ms += e.self_device_time_total / 1e3
                    if "memcpy" in key:
                        memcpy_ms += e.self_device_time_total / 1e3
                if any(c in key for c in COLLECTIVE_KEYS):
                    coll.append([e.key[:60], e.count, e.cpu_time_total / 1e3,
                                 e.device_time_total / 1e3])
            out["profile"] = dict(step_wall_ms=wall, device_ms=kernel_ms, memcpy_device_ms=memcpy_ms,
                                  collective_device_ms=sum(
                                      r[3] for r in coll if r[0].lower().startswith("nccl")),
                                  collectives=sorted(coll, key=lambda r: -r[2])[:8])
            times.append(None)  # the profiled step: not timed
            return result
        return timed

    def train_and_digest(self, *a, **k):
        out["setup_s"] = time.perf_counter() - out["t0"]
        result = train(self, *a, **k)
        skip = ([n for n, s in mesh_lib.make_param_shardings(self.mesh, self.model).items()
                 if s.axis is not None] if self.mesh is not None else [])
        out["digest"] = state_digest(self.model.state_dict(), skip)
        return result

    def timed_save(self, *a, **k):
        t = time.perf_counter()
        try:
            return save_slot(self, *a, **k)
        finally:
            out["save_s"] += time.perf_counter() - t

    save_slot = checkpoint.CheckpointManager._save_slot
    round_robin.make_train_step = make
    round_robin.RoundRobinTrainer.train = train_and_digest
    checkpoint.CheckpointManager._save_slot = timed_save
    results = {}
    try:
        for name, processes, gloo, argv in runs:
            if rank >= processes:
                continue
            out.clear()
            t0 = time.perf_counter()
            out.update(profile=None, step_ms={}, t0=t0, save_s=0.0)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            if gloo:
                distributed.initialize(gloo, processes, rank, backend="gloo", device=device)
            try:
                code = cli.main([*argv, "--process-id", str(rank)])
            finally:
                if gloo:
                    distributed.shutdown()
            _sync(device)
            out.pop("t0")
            results[name] = dict(out, code=code, run_s=time.perf_counter() - t0,
                                 launches={k: v for k, v in launches.items() if v},
                                 bn_evals=BN_EVALS.get(device.type, 0),
                                 peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                                           if cuda else 0.0))
    finally:
        round_robin.make_train_step, round_robin.RoundRobinTrainer.train = make_step, train
        checkpoint.CheckpointManager._save_slot = save_slot
    return results


def phase_parallel(device, root: str, size: int = 640, batch: int = 32, layers: int = 12,
                   full=("--preset", "full", "--dtype", "bfloat16"), train_ms=None,
                   classes=None,
                   runs=(("nccl_world1", 1, "nccl", ("--data-parallel", "1")),
                         ("gloo_dp2", 2, "gloo", ("--data-parallel", "2")),
                         ("gloo_mp2", 2, "gloo", ("--data-parallel", "1", "--model-parallel",
                                                  "2", "--save-every", "1")))) -> dict:
    """``cli/train.py`` at ``full`` over the datasets under ``root`` (64
    train and 32 val images a task: 2 steps and one val batch at the global
    batch of 32, ``--trainable branch``, one epoch), each ``runs`` entry
    (name, processes, backend, mesh flags) once: NCCL at world 1 in this
    process (a wiring check of the collectives, not a multi-GPU number),
    then the gloo runs in turn in the same spawned processes, which start
    on the card meanwhile and wait for it: two gloo ranks on the one card
    at dp = 2, and at mp = 2 (``face_kernel`` shards of (512, 42871)) with
    a combined checkpoint after every task.
    Per run: ms a step per task from rank 0's history beside the ``train``
    phase's, peak GiB per rank, launches per rank (K1 once per detection val
    batch, K2 ``layers`` per pose train step and 2 ``layers`` per pose val
    batch, on every rank), the collectives in a profile of rank 0's first
    pose step, the replicated parameters and buffers bit-equal on every rank,
    and the checkpoints: one file a save, the full (512, 85742)
    ``face_kernel`` in each. Returns the launches per rank of each run."""
    import shutil
    import tempfile

    from prpe_tpu_torch.core.config import TASKS, AdaFaceConfig

    classes = classes or AdaFaceConfig().num_classes
    out, counts = {}, {}
    tmp = tempfile.mkdtemp(prefix="prpe_parallel_")
    try:
        specs = []
        for name, world, backend, mesh_flags in runs:
            # gloo: every rank on the one card; NCCL: the CLI's cuda:LOCAL_RANK
            flag = ("cpu" if device.type == "cpu" else "cuda:0" if backend == "gloo" else None)
            address = f"127.0.0.1:{free_port()}"
            specs.append((name, world, f"tcp://{address}" if backend == "gloo" else None,
                          data_argv(root, os.path.join(tmp, name), flag, size, batch, *full,
                                    "--epochs", "1", "--save-every", "2",
                                    "--max-train-samples", "64", "--trainable", "branch",
                                    *mesh_flags, "--coordinator", address,
                                    "--num-processes", str(world))))
        # NCCL in this process, warm on the card; the gloo runs in turn in
        # the same spawned processes, which start meanwhile and wait for it
        import torch.multiprocessing as mp

        t0 = time.perf_counter()
        gate = mp.get_context("spawn").Event()
        gloo_specs = [spec for spec in specs if spec[2]]
        started = start_ranks(_cli_rank, max(w for _, w, _, _ in gloo_specs), gloo_specs,
                              str(device), "pose_estimation", gate)
        try:
            here = _cli_runs(0, [spec for spec in specs if not spec[2]], device,
                             "pose_estimation")
        except BaseException:
            for proc in started[2].processes:
                proc.terminate()
            raise
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the card's memory to the ranks
        gate.set()
        processes = collect_ranks(*started)
        phase_s = time.perf_counter() - t0
        for name, world, backend, mesh_flags in runs:
            run_dir = os.path.join(tmp, name)
            ranks = [here[name]] if name in here else [p[name] for p in processes[:world]]
            run_s = ranks[0]["run_s"]  # the other ranks may have waited for it to start
            if any(r["code"] != 0 for r in ranks):
                fail(f"parallel: {name} returned {[r['code'] for r in ranks]}")
            want = [with_bn({"nms": 2, "mhsa": 2 * layers + 2 * layers}, r["bn_evals"])
                    for r in ranks]
            if [r["launches"] for r in ranks] != want:
                fail(f"parallel: {name} launched {[r['launches'] for r in ranks]}, "
                     f"expected {want}")
            if len({r["digest"] for r in ranks}) != 1:
                fail(f"parallel: {name}: the ranks' replicated parameters or buffers differ")
            rows = {}
            for task in TASKS:
                hist = history(run_dir, task)
                if len(hist) != 1 or not all(v == v and abs(v) != float("inf")
                                             for v in hist[0].values()):
                    fail(f"parallel: {name} {task} logged {hist}")
                # the steps on the card, each between two synchronisations,
                # without the loader's wait; the first warms up (and, for
                # pose, is the profiled one)
                step_ms = ranks[0]["step_ms"][task]
                rows[task] = dict(step_ms_rank0=step_ms, ms_per_step=step_ms[-1],
                                  train_phase_ms_per_step=(train_ms or {}).get(task),
                                  epoch_ms_per_step=batch * 1e3 / hist[0]["train/images_per_sec"],
                                  loss=hist[0]["train/loss"], val_loss=hist[0].get("val/loss"))
            ck = os.path.join(run_dir, "ck")
            written = sorted(os.listdir(ck))
            if any(".tmp" in f for f in written):
                fail(f"parallel: {name} left {written}")
            meta = json.loads(open(os.path.join(ck, "meta.json")).read())
            epochs = sorted(f for f in written if f.startswith("epoch"))
            kept = [c["name"] + ".pt" for c in meta["checkpoints"]]
            if epochs != sorted(kept):
                fail(f"parallel: {name} wrote {epochs}, its meta lists {kept}")
            files = [os.path.join(ck, f) for f in written if f.endswith(".pt")]
            for f in files:
                kernel = torch.load(f, map_location="cpu", mmap=True,
                                    weights_only=True)["model"]["face_kernel"]
                if tuple(kernel.shape) != (512, classes):
                    fail(f"parallel: {name} {os.path.basename(f)} holds face_kernel "
                         f"{tuple(kernel.shape)}")
            counts[name] = [r["launches"] for r in ranks]
            out[name] = dict(ranks=world, backend=backend, mesh=list(mesh_flags), run_s=run_s,
                             setup_s_rank0=ranks[0]["setup_s"],
                             save_s_per_rank=[r["save_s"] for r in ranks], tasks=rows, peak_gib_per_rank=[r["peak_gib"] for r in ranks],
                             launches_per_rank=counts[name], ranks_equal=True,
                             checkpoints=written, kept=len(meta["checkpoints"]),
                             pose_step_profile_rank0=ranks[0]["profile"])
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("parallel", batch=batch, image_size=size, phase_s=phase_s, note="nccl_world1 is one "
         "process on one card: a wiring check of the collectives, not a multi-GPU number",
         runs=out)
    return counts


def phase_device_resident(device, root: str, size: int = 640, batch: int = 32,
                          layers: int = 12, full=("--preset", "full"), epochs: int = 2,
                          train_ms=None, disk_ms=None) -> dict:
    """``cli/train.py --device-resident`` over the datasets under ``root``
    for ``epochs`` epochs, frozen and then with ``--device-resident-refresh``
    (one process): the staged MiB, ms a step per task and epoch from the
    history beside ``train_data``'s steps from disk (``disk_ms``) and
    ``train``'s on a reused batch (``train_ms``), the loaders'
    ``fresh_epochs`` / ``stale_epochs``, K1 once per detection val batch and
    K2 ``layers`` per pose train step plus 2 ``layers`` per pose val batch
    in every epoch. Returns the frozen run's launches."""
    import shutil
    import tempfile

    from prpe_tpu_torch.cli import train as cli
    from prpe_tpu_torch.core.config import TASKS
    from prpe_tpu_torch.ops.kernels import launches

    build = cli.build_task_loaders
    out, first = {}, None
    tmp = tempfile.mkdtemp(prefix="prpe_device_resident_")
    try:
        for name, flags in (("frozen", ("--device-resident",)),
                            ("refresh", ("--device-resident", "--device-resident-refresh"))):
            captured = {}

            def capture(args, cfg, device=None, **kw):
                captured.update(build(args, cfg, device, **kw))
                return captured

            run_dir = os.path.join(tmp, name)
            cli.build_task_loaders = capture
            try:
                reset_counts()
                t0 = time.perf_counter()
                if cli.main(data_argv(root, run_dir, device, size, batch, *full, "--epochs",
                                      str(epochs), "--save-every", str(epochs + 1),
                                      *flags)) != 0:
                    fail(f"device_resident: the {name} run did not return 0")
                _sync(device)
                run_s = time.perf_counter() - t0
            finally:
                cli.build_task_loaders = build
            counts = {k: v for k, v in launches.items() if v}
            val = {t: captured[t]["val"].steps_per_epoch for t in TASKS}
            pose_steps = captured["pose_estimation"]["train"].steps_per_epoch
            want = with_bn({"nms": epochs * (val["person_detection"] + val["face_detection"]),
                            "mhsa": epochs * layers * (pose_steps + 2 * val["pose_estimation"])})
            if counts != want:
                fail(f"device_resident: {name} launched {counts}, expected {want}")
            rows, staged = {}, 0
            for task in TASKS:
                tl = captured[task]
                if not all(hasattr(tl[s], "total_bytes") for s in ("train", "val")):
                    fail(f"device_resident: {name} {task} was not staged")
                staged += tl["train"].total_bytes + tl["val"].total_bytes
                hist = history(run_dir, task)
                if len(hist) != epochs or not all(v == v and abs(v) != float("inf")
                                                  for h in hist for v in h.values()):
                    fail(f"device_resident: {name} {task} logged {hist}")
                stats = tl["train"].stats
                rows[task] = dict(
                    ms_per_step=[batch * 1e3 / h["train/images_per_sec"] for h in hist],
                    disk_ms_per_step=(disk_ms or {}).get(task),
                    train_phase_ms_per_step=(train_ms or {}).get(task),
                    fresh_epochs=stats["fresh_epochs"], stale_epochs=stats["stale_epochs"])
            if name == "frozen" and any(r["stale_epochs"] for r in rows.values()):
                fail(f"device_resident: the frozen run counted stale epochs {rows}")
            if name == "refresh" and any(r["fresh_epochs"] + r["stale_epochs"] != epochs
                                         for r in rows.values()):
                fail(f"device_resident: the refresh run counted {rows}")
            out[name] = dict(run_s=run_s, staged_mib=staged / 2 ** 20, launches=counts,
                             tasks=rows)
            first = first or counts
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("device_resident", batch=batch, image_size=size, epochs=epochs, runs=out)
    return first


# ------------------------------------------------------- the YOLO trainer ---

YOLO_OPTIM = dict(optimizer="sgd", learning_rate=0.1, weight_decay=5e-4, schedule="linear",
                  min_lr=1e-4, warmup_steps=100, total_steps=200, accumulate=2)


def yolo_batches(n: int, batch: int, size: int, seed: int) -> list:
    """Synthetic detection batches (``data/synthetic.py``, numpy seed) with
    uint8 images, the loaders' dtype."""
    import numpy as np

    from prpe_tpu_torch.core.config import DetectionConfig
    from prpe_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = synthetic.detection_batch(rng, batch, size, DetectionConfig().max_gt)
        b["image"] = np.round(b["image"] * 255).astype(np.uint8)
        out.append(b)
    return out


def matched_share(boxes_a, boxes_b, thr: float = 0.99) -> float:
    """Share of ``boxes_a`` (N, 4) xyxy with a partner in ``boxes_b`` of IoU
    at least ``thr``, pairing the best overlaps first (the greedy matcher of
    ``tools/check_cascade_numerics.py:133``)."""
    from prpe_tpu_torch.eval.map import box_iou_matrix

    if len(boxes_a) == 0:
        return 1.0
    iou = box_iou_matrix(boxes_a, boxes_b)
    used, n = set(), 0
    for i in iou.max(axis=1).argsort()[::-1] if iou.size else []:
        for j in iou[i].argsort()[::-1]:
            if iou[i, j] < thr:
                break
            if j not in used:
                used.add(j)
                n += 1
                break
    return n / len(boxes_a)


def phase_yolo_reference(device, size: int = 64, batch: int = 4) -> dict:
    """``cli/train_yolo.py``'s ``train_step`` twice (accumulation 2: the
    first call holds the update back; the update count and the EMA advance
    on both) and its ``eval_step`` on the EMA with the live statistics, for
    YOLOv11-n at ``size``^2, batch ``batch``, fp32, on the card against the
    CPU from the same weights (drawn on the CPU) and batches. The bounds of
    ``tests/test_torch_train_yolo.py``: losses within 1e-4 of their
    magnitude (at least 1), running statistics within 1e-3, each parameter's
    and EMA entry's change within 5e-2 of the CPU's largest change of that
    tensor plus 1e-4 of the model's plus two fp32 ulps of the tensor's
    largest entry; every CPU detection matched by a card detection at IoU
    0.99, scores within 1e-4. The train steps launch no kernel; the eval
    step launches K1 once. Returns the card's launches."""
    import numpy as np

    from prpe_tpu_torch.cli import train_yolo
    from prpe_tpu_torch.core.config import DetectionConfig, OptimConfig
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.train.optim import build_optimizer

    cpu = torch.device("cpu")
    det = DetectionConfig(num_classes=1, image_size=size)
    # the weights drawn once on the CPU: a generator draws differently on the card
    models = {where: train_yolo.build_model(1, "n", dev)
              for where, dev in (("cpu", cpu), ("card", device))}
    models["card"].load_state_dict(models["cpu"].state_dict())
    start = {k: t.clone() for k, t in models["cpu"].state_dict().items()}
    names = [n for n, _ in models["cpu"].named_parameters()]
    steps, eval_batch = yolo_batches(2, batch, size, seed=5), yolo_batches(1, batch, size, 6)[0]
    out, counts, wants = {}, {}, {}
    for where, model in models.items():
        tx = build_optimizer(OptimConfig(**YOLO_OPTIM))
        state = train_yolo.create_state(model, tx)
        reset_counts()
        metrics = [{k: float(v) for k, v in train_yolo.train_step(model, tx, state, b, det)
                    .items()} for b in steps]
        _sync(device)
        counts[where] = {"train": {k: v for k, v in launches.items() if v}}
        wants[where] = {"train": with_bn({})}
        reset_counts()
        dets = train_yolo.eval_step(model, state.ema_params, eval_batch, det)
        _sync(device)
        counts[where]["eval"] = {k: v for k, v in launches.items() if v}
        wants[where]["eval"] = with_bn({"nms": 1})
        out[where] = dict(metrics=metrics, count=state.updates_count,
                          sd={k: t.cpu() for k, t in model.state_dict().items()},
                          ema={k: t.cpu() for k, t in state.ema_params.items()},
                          dets=[t.cpu().numpy() for t in dets])
    got, want = out["card"], out["cpu"]
    if counts["card"] != wants["card"]:
        fail(f"yolo_reference: the card launched {counts['card']}, expected {wants['card']}")
    if not got["count"] == want["count"] == 2:
        fail(f"yolo_reference: update counts {got['count']}, {want['count']}")
    metric_err = max(abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                     for g, w in zip(got["metrics"], want["metrics"]) for k in w)
    if not metric_err <= 1e-4:
        fail(f"yolo_reference: losses {got['metrics']} against the CPU's {want['metrics']}")
    stat_err = max(float((got["sd"][k] - want["sd"][k]).abs().max())
                   / max(1.0, float(want["sd"][k].abs().max()))
                   for k in want["sd"] if k not in names)
    if not stat_err <= 1e-3:
        fail(f"yolo_reference: running statistics off by {stat_err}")
    eps = float(torch.finfo(torch.float32).eps)
    share = 0.0
    for key, tensors in (("sd", names), ("ema", names)):
        scale = max(float((want[key][n] - start[n]).abs().max()) for n in tensors)
        for n in tensors:
            dw, dg = want[key][n] - start[n], got[key][n] - start[n]
            bound = (5e-2 * float(dw.abs().max()) + 1e-4 * scale
                     + 2 * eps * float(start[n].abs().max()))
            e = float((dg - dw).abs().max())
            if not e <= bound:
                fail(f"yolo_reference: {key} {n} moved {e} off the CPU's change (bound {bound})")
            share = max(share, e / bound)
    gb, gs, _, gv = got["dets"]
    wb, ws, _, wv = want["dets"]
    if gv.sum(-1).tolist() != wv.sum(-1).tolist() or not wv.any():
        fail(f"yolo_reference: {gv.sum(-1)} valid detections against the CPU's {wv.sum(-1)}")
    matched = min(matched_share(wb[i][wv[i]], gb[i][gv[i]]) for i in range(len(wv)))
    score_err = float(np.abs(np.sort(gs[gv]) - np.sort(ws[wv])).max())
    if matched < 1.0 or score_err > 1e-4:
        fail(f"yolo_reference: {matched} of the CPU detections matched, scores off {score_err}")
    emit("yolo_reference", image_size=size, batch=batch, accumulate=2,
         losses=[m["loss"] for m in got["metrics"]],
         losses_cpu=[m["loss"] for m in want["metrics"]], max_loss_rel_err=metric_err,
         max_stat_rel_err=stat_err, max_change_share_of_bound=share,
         detections=int(gv.sum()), max_score_err=score_err, launches=counts["card"])
    return counts["card"]


def mosaic_rates(root: str, size: int, batch: int, workers=(0, 2)) -> dict:
    """Host images/s of ``YoloMosaicDataset`` alone (decode, mosaic, affine,
    MixUp, HSV, flip, collate; no card), over one batch of ``loader.host``,
    with the mosaic and without it, at each worker count; the native
    library already built."""
    from prpe_tpu_torch import native
    from prpe_tpu_torch.core.config import DetectionConfig
    from prpe_tpu_torch.data import pipeline
    from prpe_tpu_torch.data.detection import YoloMosaicDataset, YoloTxtDataset

    native.get_lib()
    rates = {}
    for mosaic in (1.0, 0.0):
        for w in workers:
            ds = YoloMosaicDataset(YoloTxtDataset(root, "train", size, DetectionConfig().max_gt),
                                   mosaic_prob=mosaic)
            loader = pipeline.make_epoch_loader(ds, batch, max_samples=batch, num_workers=w,
                                                prefetch=0)
            try:
                t0 = time.perf_counter()
                n = sum(len(b["image"]) for b in loader.host(0))
                rates[f"{'mosaic' if mosaic else 'plain'}_workers{w}"] = (
                    n / (time.perf_counter() - t0))
            finally:
                loader.close()
    return rates


def phase_train_yolo(device, n_train: int = 64, n_val: int = 32, size: int = 640,
                     batch: int = 32, epochs: int = 11) -> dict:
    """``cli/train_yolo.py::main`` end to end at full width: YOLOv11-n, fp32,
    ``batch`` images of ``size``^2 (accumulation round(64 / batch)), from a
    PNG dataset written by ``tools/make_dataset.py`` (``n_train`` train and
    ``n_val`` val images) into a temporary directory, for ``epochs`` epochs:
    epoch 0 with the mosaic, the last 10 without it. Then ``--test`` on
    ``best`` where matplotlib imports; where it does not (decided before the
    run), the same ``evaluate`` that ``--test`` calls on ``best``, and the
    line says the plots were not made. Every launch counter at zero before
    the training run and before the test. Fails unless each run returns 0,
    ``step.csv`` has a finite row per epoch, ``best`` and ``last`` exist,
    K1 ran once per val batch (``epochs`` x val batches, then val batches),
    and the test's metrics are finite. Prints ms a train step from disk and
    the loader's wait a step for the mosaic epoch and the others, the host
    images/s of the mosaic dataset alone (with and without the mosaic, at 0
    and 2 workers), the mAP hook's seconds a val pass, the peak memory and
    the launches. Returns the launches of both runs summed."""
    import csv
    import importlib.util
    import io
    import pathlib
    import shutil
    import tempfile

    from prpe_tpu_torch.cli import train_yolo
    from prpe_tpu_torch.eval import map as map_eval
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.tools.make_dataset import make_detection_split

    tmp = tempfile.mkdtemp(prefix="prpe_train_yolo_")
    real_build, real_val, real_hook = (train_yolo.build_loaders, train_yolo.val_outputs,
                                       map_eval.detection_eval_hook)
    try:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "det")
        make_detection_split(pathlib.Path(data), "train", n_train, size, seed=0)
        make_detection_split(pathlib.Path(data), "val", n_val, size, seed=1)
        dataset_s = time.perf_counter() - t0
        rates = mosaic_rates(data, size, batch)

        epoch_log, hook_s, captured = [], [], {}

        def build(args, det_cfg, dev):
            train_ds, train_loader, val_loader, steps = real_build(args, det_cfg, dev)

            def epoch_fn(epoch):
                epoch_log.append({"epoch": epoch, "t0": time.perf_counter(),
                                  "wait0": train_loader.stats["wait_s"],
                                  "batches0": train_loader.stats["batches"],
                                  "mosaic": getattr(train_ds, "mosaic_prob", None)})
                return train_loader(epoch)

            captured.update(train=train_loader, val=val_loader)
            return train_ds, epoch_fn, val_loader, steps

        def val(*a, **k):
            if epoch_log and "t1" not in epoch_log[-1]:
                e = epoch_log[-1]
                e.update(t1=time.perf_counter(),
                         wait=captured["train"].stats["wait_s"] - e["wait0"],
                         steps=captured["train"].stats["batches"] - e["batches0"])
            return real_val(*a, **k)

        def hook(image_size):
            inner = real_hook(image_size)

            def run(outputs):
                t = time.perf_counter()
                try:
                    return inner(outputs)
                finally:
                    hook_s.append(time.perf_counter() - t)
            return run

        out = os.path.join(tmp, "out")
        argv = ["--device", str(device), "--data-dir", data, "--input-size", str(size),
                "--batch-size", str(batch), "--epochs", str(epochs), "--output-dir", out]
        train_yolo.build_loaders, train_yolo.val_outputs = build, val
        map_eval.detection_eval_hook = hook
        stdout = io.StringIO()
        cuda = device.type == "cuda"
        try:
            reset_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                rc = train_yolo.main(argv)
            _sync(device)
            run_s = time.perf_counter() - t0
        finally:
            train_yolo.build_loaders, train_yolo.val_outputs = real_build, real_val
            map_eval.detection_eval_hook = real_hook
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
        train_counts = {k: v for k, v in launches.items() if v}
        if rc != 0:
            fail("train_yolo: the training run did not return 0")
        val_batches = captured["val"].steps_per_epoch
        want = with_bn({"nms": epochs * val_batches})
        if train_counts != want or val_batches < 1:
            fail(f"train_yolo: the training run launched {train_counts}, expected {want} "
                 f"(K1 {epochs} x {val_batches})")
        with open(os.path.join(out, "step.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != epochs or not all(float(v) == float(v) and abs(float(v)) != float("inf")
                                          for r in rows for v in r.values()):
            fail(f"train_yolo: step.csv holds {rows}")
        if not all(os.path.exists(os.path.join(out, f"{n}.pt")) for n in ("best", "last")):
            fail(f"train_yolo: no best.pt or last.pt in {sorted(os.listdir(out))}")
        want_mosaic = [1.0 if e < max(0, epochs - 10) else 0.0 for e in range(epochs)]
        if [e["mosaic"] for e in epoch_log] != want_mosaic:
            fail(f"train_yolo: mosaic by epoch {[e['mosaic'] for e in epoch_log]}")

        # --test on best: the CLI where matplotlib imports, else its evaluate
        plots = importlib.util.find_spec("matplotlib") is not None
        reset_counts()
        t0 = time.perf_counter()
        test_out = io.StringIO()
        if plots:
            with contextlib.redirect_stdout(test_out):
                rc = train_yolo.main(argv + ["--test", "--class-names", "person"])
            if rc != 0:
                fail("train_yolo: --test did not return 0")
            pngs = sorted(f for f in os.listdir(out) if f.endswith("_curve.png"))
            if len(pngs) != 4:
                fail(f"train_yolo: --test wrote {pngs}")
            table = test_out.getvalue().splitlines()[-5].split()
            test_metrics = dict(zip(("precision", "recall", "mAP50", "mAP50-95"),
                                    map(float, table)))
        else:
            from prpe_tpu_torch.core.config import DetectionConfig
            from prpe_tpu_torch.train.checkpoint import load_model

            args = train_yolo.parse_args(argv)
            det_cfg = DetectionConfig(num_classes=1, image_size=size)
            model = train_yolo.build_model(1, "n", device)
            model.load_state_dict(load_model(os.path.join(out, "best")))
            _, _, val_loader, _ = train_yolo.build_loaders(args, det_cfg, device)
            test_metrics, curves = train_yolo.evaluate(model, dict(model.named_parameters()),
                                                       val_loader, det_cfg, size)
            if curves is None:
                fail("train_yolo: the test evaluation had no curve data")
            pngs = "not made: matplotlib is not installed on this host"
        _sync(device)
        test_s = time.perf_counter() - t0
        test_counts = {k: v for k, v in launches.items() if v}
        want = with_bn({"nms": val_batches})
        if test_counts != want:
            fail(f"train_yolo: the test launched {test_counts}, expected {want}")
        if not all(v == v for v in test_metrics.values()):
            fail(f"train_yolo: test metrics {test_metrics}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def per_step(mosaic):
        epochs_ = [e for e in epoch_log if e["mosaic"] == mosaic]
        steps = sum(e["steps"] for e in epochs_)
        if not steps:
            return None
        return dict(epochs=len(epochs_), steps=steps,
                    ms_per_step=sum(e["t1"] - e["t0"] for e in epochs_) * 1e3 / steps,
                    loader_wait_ms_per_step=sum(e["wait"] for e in epochs_) * 1e3 / steps)

    emit("train_yolo", variant="n", image_size=size, batch=batch, accumulate=round(64 / batch),
         dtype="float32", train_images=n_train, val_images=n_val, epochs=epochs,
         dataset_s=dataset_s, startup_line=stdout.getvalue().splitlines()[0], run_s=run_s,
         mosaic_epochs=per_step(1.0), plain_epochs=per_step(0.0),
         epoch_ms_per_step=[(e["t1"] - e["t0"]) * 1e3 / e["steps"] for e in epoch_log],
         host_images_per_s=rates, map_hook_s_per_val_pass=hook_s,
         peak_mem_gib=peak, launches_train=train_counts, launches_test=test_counts,
         last_row={k: float(v) for k, v in rows[-1].items()}, test_s=test_s,
         test_metrics=test_metrics, plots=pngs)
    return {"nms": train_counts["nms"] + test_counts["nms"]}


def phase_eval_verification(device, pairs: int = 64, arch: str = "ir_50",
                            batch: int = 64, runs: int = 2) -> None:
    """``cli/eval_verification.py::main`` on the card: ``pairs`` pairs of
    112^2 face crops as PNG bytes (the port's writer; matched pairs near
    copies, numpy seed 0) in an npz in a temporary directory, ``arch``
    weights from seed 0, ``runs`` times. Fails unless it returns 0 and its
    metrics are finite. Prints images/s a run (decoding, the model's build
    and the padding included) and the metrics."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from prpe_tpu_torch.cli import eval_verification
    from prpe_tpu_torch.data.image import encode_png
    from prpe_tpu_torch.ops.kernels import launches

    rng = np.random.default_rng(0)
    imgs, issame = [], []
    for p in range(pairs):
        a = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
        b = (np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
             if p % 2 == 0 else rng.integers(0, 256, a.shape, dtype=np.uint8))
        imgs += [encode_png(a), encode_png(b)]
        issame.append(p % 2 == 0)
    tmp = tempfile.mkdtemp(prefix="prpe_eval_verification_")
    try:
        path = os.path.join(tmp, "pairs.npz")
        np.savez(path, jpegs=np.array(imgs, dtype=object), issame=np.asarray(issame))
        rates, metrics = [], None
        reset_counts()
        for _ in range(runs):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = eval_verification.main([path, "--device", str(device), "--arch", arch,
                                             "--batch-size", str(batch)])
            _sync(device)
            rates.append(2 * pairs / (time.perf_counter() - t0))
            if rc != 0:
                fail("eval_verification: the CLI did not return 0")
            metrics = json.loads(out.getvalue().splitlines()[-1])
            if not all(v == v and abs(v) != float("inf") for v in metrics.values()):
                fail(f"eval_verification: metrics {metrics}")
        counts = {k: v for k, v in launches.items() if v}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("eval_verification", arch=arch, pairs=pairs, batch=batch, images_per_s=rates,
         metrics=metrics, launches=counts)


# the fewest steps of tools/make_numerics_pose_ckpt.py found to reach pck 0.8
# on the card (1100: 0.708, 1200: 0.774, 1300: 0.928; its default, as the
# JAX script's, is 1500)
def run_tool(module: str, argv) -> tuple:
    """``prpe_tpu_torch.tools.<module>.main(argv)`` in this process, every
    launch counter at zero before it: -> (its stdout, the launches, s)."""
    import importlib
    import io

    from prpe_tpu_torch.ops.kernels import launches

    tool = importlib.import_module(f"prpe_tpu_torch.tools.{module}")
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tool.main(list(argv))
    torch.cuda.synchronize()
    counts = dict(launches)
    if rc != 0:
        fail(f"harness: {module} {' '.join(argv)} exited {rc}")
    return out.getvalue(), counts, time.perf_counter() - t0


def json_lines(module: str, text: str, n=None) -> list:
    """A tool's stdout as JSON: its ``n`` lines, each one object, or (``n``
    None) its last line after lines of text."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    try:
        records = [json.loads(ln) for ln in (lines if n else lines[-1:])]
    except (json.JSONDecodeError, IndexError) as e:
        fail(f"harness: {module} printed no parsable JSON line ({e}): {text[-500:]!r}")
    if n and len(records) != n:
        fail(f"harness: {module} printed {len(records)} JSON lines, expected {n}")
    return records


def profile_agrees(prof: dict) -> bool:
    """A profile's two aggregations (the profiler's kernel rows, the trace's
    kernels by module) give one device time, and the busy share is a share."""
    by_module = sum(prof["by_module"].values())
    return (abs(by_module - prof["kernel_ms"]) <= 0.02 * prof["kernel_ms"]
            and 0.0 < prof["busy_share"] <= 1.0)


def phase_harness(device, root: str) -> dict:
    """The measuring tools at full geometry, each through its ``main`` with
    the launch counters at zero before it: ``bench_reference_torch`` (its
    JSON the baseline of) ``bench_cascade`` at batch 128 in the default
    mode (K1 2 and K2 12 a call) and under ``pallas_lnfused`` (K1 2, K4
    12), ``bench_train`` for 5 steps a task (K2 12 a pose step, the warm-up
    included), ``bench_io`` in ``cascade`` mode on 256 packed scenes, in
    ``train`` mode on 128 packed detection samples for an epoch and in
    ``png`` mode on 64 PNGs with 2 workers, one ``profile_cascade`` (batch
    128, 5 calls) and one ``profile_train`` (pose, 2 steps): each tool's
    stdout JSON parses with its metric names and every counter moved as
    the calls it made require. Returns the launches of ``bench_cascade``
    per mode and of ``bench_train``."""
    import importlib.util

    rows, counts = {}, {}
    baseline = os.path.join(root, "reference.json")
    if importlib.util.find_spec("transformers") is None:
        # the tool names the missing package and exits; vs_baseline stays null
        try:
            run_tool("bench_reference_torch", ["--out", baseline])
            fail("harness: bench_reference_torch ran without transformers")
        except SystemExit as e:
            if "transformers" not in str(e):
                fail(f"harness: bench_reference_torch exited with {e}")
            rows["bench_reference_torch"] = dict(missing="transformers", message=str(e))
        baseline_args = []
    else:
        text, c, sec = run_tool("bench_reference_torch", ["--out", baseline])
        ref = json.loads(text)
        if not ref["cascade_composite_img_per_sec"] > 0:
            fail(f"harness: bench_reference_torch composite {ref}")
        rows["bench_reference_torch"] = dict(seconds=sec, **ref)
        baseline_args = ["--baseline", baseline]
    for mode, kernel in (("pallas_packed", "mhsa"), ("pallas_lnfused", "ln_mhsa")):
        with attn_mode(mode):
            text, c, sec = run_tool("bench_cascade", baseline_args)
        rec, = json_lines("bench_cascade", text, 1)
        if rec["metric"] != "face_gated_pose_cascade_640_throughput" or (
                rec["vs_baseline"] is None) != (not baseline_args):
            fail(f"harness: bench_cascade printed {rec}")
        calls = 21  # a warm-up and 20 timed, well inside PRPE_BENCH_DEADLINE_S
        want = with_bn(expected_launches(mode, 12 * calls, nms=2 * calls))
        if c != want:
            fail(f"harness: bench_cascade under {mode} launched {c}, expected {want}")
        counts[f"bench_cascade_{mode}"] = c
        rows[f"bench_cascade_{mode}"] = dict(seconds=sec, calls=calls, **rec)
    text, c, sec = run_tool("bench_train", ["--iters", "5"])
    recs = json_lines("bench_train", text, 5)
    names = [r["metric"] for r in recs]
    if names != [f"train_step_{t}" for t in ("person_detection", "face_detection",
                                             "face_recognition", "pose_estimation")] + [
            "train_steps_bs32_640_harmonic_summary"]:
        fail(f"harness: bench_train printed {names}")
    want = with_bn(expected_launches("pallas_packed", 12 * 6))  # a warm-up step, 5 timed
    if c != want:
        fail(f"harness: bench_train launched {c}, expected {want}")
    counts["bench_train"] = c
    rows["bench_train"] = dict(seconds=sec, lines=recs)
    data = os.path.join(root, "bench_io")
    for mode, argv in (("cascade", ["--images", "256"]),
                       ("train", ["--images", "128", "--epochs", "1"]),
                       ("png", ["--images", "64", "--workers", "2", "--batch", "16"])):
        text, c, sec = run_tool("bench_io", ["--mode", mode, "--data-dir", data, *argv])
        rec, = json_lines("bench_io", text, 1)
        calls = rec.get("cascade_calls", 0)
        want = with_bn(expected_launches("pallas_packed", 12 * calls, nms=2 * calls))
        if c != want or not rec["value"] > 0:
            fail(f"harness: bench_io {mode} printed {rec}, launched {c}, expected {want}")
        rows[f"bench_io_{mode}"] = dict(seconds=sec, **rec)
    text, c, sec = run_tool("profile_cascade", ["128", "--iters", "5"])
    prof, = json_lines("profile_cascade", text)
    want = with_bn(expected_launches("pallas_packed", 12 * 6, nms=2 * 6))
    if c != want or not profile_agrees(prof):
        fail(f"harness: profile_cascade launched {c}, kernel ms {prof['kernel_ms']} against "
             f"{prof['by_module']} by module")
    rows["profile_cascade"] = dict(seconds=sec, **{k: prof[k] for k in (
        "kernel_ms_per_call", "launches", "busy_share", "window_ms", "by_module",
        "attention_ms", "top")})
    text, c, sec = run_tool("profile_train", ["32", "640", "pose_estimation", "--iters", "2"])
    prof, = json_lines("profile_train", text)
    pose = prof["tasks"]["pose_estimation"]
    want = with_bn(expected_launches("pallas_packed", 12 * 3))
    if c != want or not profile_agrees(pose):
        fail(f"harness: profile_train launched {c}, kernel ms {pose['kernel_ms']} against "
             f"{pose['by_module']} by module")
    rows["profile_train"] = dict(seconds=sec, **{k: pose[k] for k in (
        "kernel_ms_per_step", "launches", "busy_share", "window_ms", "by_module", "top")})
    text, c, sec = run_tool("dump_trace_ops", ["--iters", "2", "--top", "10"])
    dump, = json_lines("dump_trace_ops", text)
    if dump["device"] != "cuda" or "train_pose_estimation" not in dump["trace"]:
        fail(f"harness: dump_trace_ops read {dump['trace']} ({dump['device']})")
    rows["dump_trace_ops"] = dict(seconds=sec, distinct_kernels=dump["distinct_kernels"])
    emit("harness", **rows)
    return counts


POSE_CKPT_STEPS = 1300
JAX_NUMERICS = "runs/r3_numerics/cascade_fp32_vs_bf16.json"
# the counts the JAX tool's verdict requires non-empty
NON_VACUOUS = ("person_detections_fp32", "face_pairs_clear_margin", "pose_pairs",
               "person_confident_fp32", "face_confident_fp32")


def phase_numerics(device, steps: int = POSE_CKPT_STEPS, scenes: int = 100,
                   pose_crops: int = 128, pose_cfg=None, irnet_layers: int = 50,
                   scene_size: int = 640, min_pairs: int = 50) -> dict:
    """``tools/make_numerics_pose_ckpt.py`` trains ViTPose-B in fp32 for
    ``steps`` (K2 forward and backward) into a temporary directory, then
    ``tools/check_cascade_numerics.py bf16`` holds the bf16 cascade against
    the fp32 one over ``scenes`` scenes with the trained detector
    (``runs/torch_numerics/detector_ckpt.npz``) in both detector slots and
    that pose checkpoint, its same-crop leg over ``pose_crops`` crops under
    the packed (K2), (B, H, T, D) (K3) and fused (K4) modes. Fails when the
    pose checkpoint's pck is under 0.8, when a count the JAX tool requires
    non-empty is 0, when a mode has fewer than ``min_pairs`` same-crop
    pairs, or when K1, K2, K3 or K4 did not launch; not on ``pass``: the
    verdict is the finding. Prints the report beside the JAX package's
    (``runs/r3_numerics``). Returns the launches (pose training, check)."""
    import io
    import shutil
    import tempfile

    from prpe_tpu_torch.core.config import PoseConfig
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.tools import check_cascade_numerics as cn
    from prpe_tpu_torch.tools import make_numerics_pose_ckpt as mp

    pose_cfg = pose_cfg or PoseConfig()
    tmp = tempfile.mkdtemp(prefix="prpe_numerics_")
    log = io.StringIO()
    try:
        pose_path = os.path.join(tmp, "pose_ckpt.pt")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            pck = mp.train_pose_ckpt(steps, 16, 1e-3, pose_path, device=device,
                                     pose_cfg=pose_cfg)
        _sync(device)
        pose_s = time.perf_counter() - t0
        pose_counts = {k: v for k, v in launches.items() if v}
        if pck < mp.MIN_PCK:
            fail(f"numerics: the pose checkpoint reached pck {pck:.3f} in {steps} steps, "
                 f"under {mp.MIN_PCK}")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            report = cn.check_bf16(scenes, 4, cn.DETECTOR_NPZ, cn.DETECTOR_NPZ, pose_path,
                                   pose_crops, out=os.path.join(tmp, "report.json"),
                                   device=device, scene_size=scene_size, pose_cfg=pose_cfg,
                                   irnet_layers=irnet_layers)
        _sync(device)
        check_s = time.perf_counter() - t0
        counts = {k: v for k, v in launches.items() if v}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    empty = [k for k in NON_VACUOUS if not report[k]]
    if empty:
        fail(f"numerics: the comparison is vacuous, {empty} = 0")
    few = {m: report[f"pose_same_crop_pairs_{m}"] for m in cn.SAME_CROP_MODES
           if report[f"pose_same_crop_pairs_{m}"] < min_pairs}
    if few:
        fail(f"numerics: fewer than {min_pairs} same-crop pairs: {few}")
    if not pose_counts.get("mhsa"):
        fail(f"numerics: the pose training launched {pose_counts}, no K2")
    missing = [k for k in ("nms", "mhsa", "mhsa_bhtd", "ln_mhsa") if not counts.get(k)]
    if missing:
        fail(f"numerics: the check launched {counts}, none of {missing}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), JAX_NUMERICS)) as f:
        jax_report = json.load(f)
    emit("numerics", pose_steps=steps, pose_pck=pck, pose_train_s=pose_s, check_s=check_s,
         verdict_pass=report["pass"], report=report, jax_r3=jax_report,
         launches_pose_training=pose_counts, launches_check=counts)
    return {"pose_training": pose_counts, "check": counts}


# a tools/run_convergence.py trainer process that writes its launch counts
# to the path in its first argument when it exits (not when it is killed)
COUNTING_TRAIN = """import json, sys
from prpe_tpu_torch.cli import train
from prpe_tpu_torch.ops.kernels import launches
path = sys.argv.pop(1)
try:
    rc = train.main(sys.argv[1:])
finally:
    with open(path, "w") as f:
        json.dump(dict(launches), f)
sys.exit(rc)
"""


def start_convergence_data(n_train: int = 256, n_val: int = 64, extra=()):
    """``tools/make_dataset.py`` (``n_train`` train, ``n_val`` val a task,
    ``extra`` flags) in a process of its own, writing while the phases
    before ``convergence`` run -> (temporary root, the process)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="prpe_convergence_")
    proc = subprocess.Popen([sys.executable, "-m", "prpe_tpu_torch.tools.make_dataset",
                             os.path.join(tmp, "data"), "--train", str(n_train), "--val",
                             str(n_val), *extra], stdout=subprocess.DEVNULL)
    return tmp, proc


def phase_convergence(device, prepared, n_train: int = 256, n_val: int = 64, epochs: int = 8,
                      save_every: int = 4, kill_delay: float = 5.0, batch: int = 16,
                      flags=("--preset", "full", "--image-size", "640")) -> dict:
    """``tools/run_convergence.py`` on the datasets that
    ``start_convergence_data`` writes (``prepared``; ``n_train`` train,
    ``n_val`` val a task): ``cli/train.py`` with ``flags`` at batch
    ``batch`` for ``epochs`` epochs, staged on the card, a combined
    checkpoint every ``save_every`` epochs, killed ``kill_delay`` s after
    its first checkpoint appears and resumed from ``latest``, all in that
    temporary directory, deleted afterwards. Fails unless the kill came
    and one resume finished, the resumed process started where the
    checkpoint left off, the merged histories hold every epoch once, both
    detection tasks' ``val/mAP50`` and pose's ``val/kpt_AP`` improved
    (mean of the last 3 epochs over the first 3), and the resumed process
    launched K1 and K2. Face recognition is reported, not judged. Returns
    the resumed process's launches."""
    import csv
    import io
    import shutil

    from prpe_tpu_torch.tools import run_convergence as rc

    if device.type == "cuda":  # the trainers are other processes: release the cache
        torch.cuda.empty_cache()
    tmp, proc = prepared
    log = io.StringIO()
    train_cmd = rc.train_cmd

    def counting_cmd(args, data, out, log_dir, resume):
        cmd = train_cmd(args, data, out, log_dir, resume)
        i = cmd.index("-m")
        return [cmd[0], "-c", COUNTING_TRAIN, os.path.join(log_dir, "launches.json"),
                *cmd[i + 2:]]

    try:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        if proc.wait() != 0:
            fail(f"convergence: make_dataset exited {proc.returncode}")
        data_wait_s = time.perf_counter() - t0
        rc.train_cmd = counting_cmd
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                rc.run(rc.parse_args([
                    "--device", str(device), *flags, "--epochs", str(epochs),
                    "--batch-size", str(batch), "--samples", str(n_train),
                    "--val-samples", str(n_val), "--save-every", str(save_every),
                    "--kill-delay", str(kill_delay), "--data", data, "--out", out]))
        finally:
            rc.train_cmd = train_cmd
        run_s = time.perf_counter() - t0
        with open(os.path.join(out, "resume.json")) as f:
            resume = json.load(f)
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
        curves = {}
        for task, col in (("person_detection", "val/mAP50"), ("face_detection", "val/mAP50"),
                          ("face_recognition", "val/acc"), ("pose_estimation", "val/kpt_AP")):
            with open(os.path.join(out, f"{task}_history.csv")) as f:
                curves[task] = [float(r[col]) for r in csv.DictReader(f)]
        phases = resume["phases"]
        counts = {}
        if len(phases) == 2 and os.path.exists(os.path.join(out, "phase2_resume",
                                                            "launches.json")):
            with open(os.path.join(out, "phase2_resume", "launches.json")) as f:
                counts = {k: v for k, v in json.load(f).items() if v}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not resume["killed"] or len(phases) != 2 or phases[1]["rc"] != 0:
        fail(f"convergence: expected one kill and one resume, got {phases}")
    if not resume["resumed_from_saved_epoch"]:
        fail(f"convergence: the resumed process did not start at the checkpoint: {phases}")
    if not resume["contiguous"] or not all(resume["contiguous"].values()):
        fail(f"convergence: the merged histories skip or repeat an epoch: "
             f"{resume['contiguous']}")
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    improved = {t: mean(c[-3:]) > mean(c[:3]) for t, c in curves.items()}
    judged = ("person_detection", "face_detection", "pose_estimation")
    if not all(improved[t] for t in judged):
        fail(f"convergence: no improvement from the first 3 epochs to the last 3: {curves}")
    if not counts.get("nms") or not counts.get("mhsa"):
        fail(f"convergence: the resumed process launched {counts}")
    emit("convergence", epochs=epochs, train_samples=n_train, val_samples=n_val, batch=batch,
         save_every=save_every, kill_delay_s=kill_delay,
         first_checkpoint_s=resume["first_checkpoint_s"],
         resumed_from=phases[1]["resumed_from"],
         first_epoch_after_resume=phases[1]["first_epoch_per_task"], data_wait_s=data_wait_s,
         run_s=run_s, curves=curves, improved=improved,
         summary={t: {k: v for k, v in s.items() if k != "curve"} for t, s in summary.items()},
         launches_resumed=counts)
    return counts


def report_build(logs) -> None:
    """Print each kernel's ``ptxas`` lines (entry, registers, spills, wgmma
    notes) and fail on a spill or a compiler error."""
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma")) \
                    or "error" in line.lower():
                print(f"nvcc {name}: {line.strip()}", flush=True)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                fail(f"ptxas reports a spill in csrc/{name}.cu: {line.strip()}")


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")


def suffixed(row, suffix: str) -> dict:
    """A row's measured keys under ``<key><suffix>``, for the kernels line."""
    return {f"{k}{suffix}": row[k] for k in ROW_KEYS}


def kernel_rows(gen, device):
    """The serving-shape kernel rows: K1 at K = 256 and 1024; K2 and K3 in
    bf16 and fp32 at B = 32 and 128; K4 in both dtypes at B = 32 and 128;
    the fused eval BatchNorm at ``BN_ACT_ROWS``; the deformable attention in
    bf16 and fp32 at 128 frames."""
    bf, f32 = torch.bfloat16, torch.float32
    nms_rows = [phase_nms(gen, device, 32, k) for k in (256, 1024)]
    # the pose stage runs at pose_capacity = batch
    shapes = [(bf, 32), (f32, 32), (bf, 128), (f32, 128)]
    mhsa_rows = [phase_mhsa(gen, device, dt, "packed", b) for dt, b in shapes]
    bhtd_rows = [phase_mhsa(gen, device, dt, "bhtd", b) for dt, b in shapes]
    ln_rows = [phase_ln_mhsa(gen, device, dt, b) for dt in (bf, f32) for b in (32, 128)]
    bn_rows = [phase_bn_act(gen, device, *spec) for spec in BN_ACT_ROWS]
    msda_rows = [phase_msda(gen, device, dt) for dt in (bf, f32)]
    return nms_rows, mhsa_rows, bhtd_rows, ln_rows, bn_rows, msda_rows


def main() -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the serving-shape kernel rows only")
    parser.add_argument("--compare", action="store_true",
                        help="run the serving-shape kernel rows and the fp32 cascade only")
    parser.add_argument("--root", help="import prpe_tpu_torch from the checkout at ROOT")
    args = parser.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one CUDA GPU")
    from prpe_tpu_torch.ops.kernels import build_all

    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(CARD, flush=True)  # name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # fp32 references stay fp32 on the card (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report_build(build_all())
    emit("build", seconds=time.perf_counter() - t0, root=os.path.abspath(args.root or "."))

    gen = torch.Generator(device=device).manual_seed(0)
    nms_rows, mhsa_rows, bhtd_rows, ln_rows, bn_rows, msda_rows = kernel_rows(gen, device)
    fp32_cascade = lambda: phase_cascade(  # noqa: E731
        device, batches=((32, 10),), dtype=torch.float32)
    if args.kernels_only:
        return 0
    if args.compare:
        phase_cascade(device, modes=("pallas_packed",), batches=((32, 20),))
        fp32_cascade()
        return 0
    watch_batchnorms()
    for dtype in (torch.bfloat16, torch.float32):
        for b in (32, 128):
            phase_ln_stages(gen, device, dtype, b)
    # the correctness checks, and the export whose time is the host's trace,
    # run while the parallel reference's ranks share the card
    parallel_ref_counts = phase_parallel_reference(device, meanwhile=(
        lambda: phase_odd_shapes(gen, device), lambda: phase_reference(device),
        lambda: phase_combined_reference(device), lambda: phase_train_reference(device),
        lambda: phase_yolo_reference(device), lambda: phase_export(device)))
    mode_counts = phase_attn_modes(device)
    counts = phase_cascade(device)
    counts_f32 = fp32_cascade()
    rtdetr_counts = phase_cascade_rtdetr(device)
    phase_combined(device)
    phase_infer_cli(device)
    grad_rows = {(dt, layout): phase_mhsa_grad(gen, device, dt, layout)
                 for dt in (torch.bfloat16, torch.float32) for layout in ("packed", "bhtd")}
    train_counts = phase_train(device)
    cli_counts = phase_train_cli(device)
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="prpe_png_datasets_")
    try:
        emit("png_datasets", seconds=make_png_datasets(root), train_images=64, val_images=32,
             face_crops=16 * 20)
        data = phase_train_data(device, train_ms=train_counts["ms"], root=root)
        data_counts = data["launches"]
        resident_counts = phase_device_resident(device, root, train_ms=train_counts["ms"],
                                                disk_ms=data["ms"])
        parallel_counts = phase_parallel(device, root, train_ms=train_counts["ms"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    yolo_counts = phase_train_yolo(device)
    phase_eval_verification(device)
    root = tempfile.mkdtemp(prefix="prpe_harness_")
    try:
        harness = phase_harness(device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bench = lambda kernel: dict(  # noqa: E731
        launches_bench_cascade=harness["bench_cascade_pallas_packed"][kernel],
        launches_bench_cascade_lnfused=harness["bench_cascade_pallas_lnfused"][kernel],
        launches_bench_train=harness["bench_train"][kernel])
    # the convergence datasets are written while the numerics phase runs
    prepared = start_convergence_data()
    try:
        numerics_counts = phase_numerics(device)
        convergence_counts = phase_convergence(device, prepared)
    finally:
        prepared[1].kill()
        prepared[1].wait()
        shutil.rmtree(prepared[0], ignore_errors=True)

    src, pallas = "prpe_tpu_torch/csrc/", "prpe_tpu/ops/pallas/"
    row = lambda r: {k: r[k] for k in ROW_KEYS}  # noqa: E731
    # rows at B = 32 in bf16 (the default cascade's dtype), then the same
    # kernel at B = 128 and in fp32 under suffixed keys
    attn_keys = lambda rows: {**row(rows[0]), **suffixed(rows[2], "_b128"),  # noqa: E731
                              **suffixed(rows[1], "_f32"), **suffixed(rows[3], "_b128_f32")}
    # the training path: launches per train step and per eval step at full
    # width, and over the full-preset train CLI run; the forward + backward
    # of the attention ops (kernel forward, torch backward) under _fwd_bwd
    bf, f32 = torch.bfloat16, torch.float32
    grad_keys = lambda layout: {**suffixed(grad_rows[(bf, layout)], "_fwd_bwd"),  # noqa: E731
                                **suffixed(grad_rows[(f32, layout)], "_fwd_bwd_f32")}
    kernels = [
        dict(name="nms_keep", route="cuda", source=src + "nms.cu",
             replaces=pallas + "nms_kernel.py:42", launches=counts["pallas_packed"]["nms"],
             launches_f32=counts_f32["pallas_packed"]["nms"],
             launches_detection_eval_step=train_counts["eval"]["person_detection"]["nms"],
             launches_train_cli=cli_counts["nms"], launches_train_data=data_counts["nms"],
             launches_train_yolo=yolo_counts["nms"],
             launches_device_resident=resident_counts["nms"],
             launches_parallel_per_rank={k: [r["nms"] for r in v]
                                         for k, v in parallel_counts.items()},
             launches_numerics=numerics_counts["check"]["nms"],
             launches_convergence_resumed=convergence_counts["nms"],
             **bench("nms"),
             **row(nms_rows[0]),
             **suffixed(nms_rows[1], "_k1024")),
        dict(name="mhsa_packed", route="cuda", source=src + "mhsa.cu",
             replaces=pallas + "attention_kernel.py:92",
             launches=counts["pallas_packed"]["mhsa"],
             launches_f32=counts_f32["pallas_packed"]["mhsa"],
             launches_pose_train_step=train_counts["step"]["pose_estimation"]["mhsa"],
             launches_train_cli=cli_counts["mhsa"], launches_train_data=data_counts["mhsa"],
             launches_device_resident=resident_counts["mhsa"],
             launches_parallel_per_rank={k: [r["mhsa"] for r in v]
                                         for k, v in parallel_counts.items()},
             launches_parallel_reference_pose_step_per_rank={
                 k: [r["pose_estimation"]["mhsa"] for r in v]
                 for k, v in parallel_ref_counts.items()},
             launches_numerics_pose_training=numerics_counts["pose_training"]["mhsa"],
             launches_numerics=numerics_counts["check"]["mhsa"],
             launches_convergence_resumed=convergence_counts["mhsa"],
             **bench("mhsa"),
             **attn_keys(mhsa_rows),
             **grad_keys("packed")),
    ]
    # one kernel serves the three (B, H, T, D) Pallas kernels; launches per
    # ViTPose-B forward under the mode that selects each
    for variant, mode, line in (("batched", "pallas", 57), ("unrolled", "pallas_unrolled", 42),
                                ("bh", "pallas_bh", 76)):
        kernels.append(dict(name=f"mhsa_bhtd[{variant}]", route="cuda", source=src + "mhsa.cu",
                            replaces=f"{pallas}attention_kernel.py:{line}", attn_mode=mode,
                            launches=mode_counts[mode]["mhsa_bhtd"],
                            launches_numerics=numerics_counts["check"]["mhsa_bhtd"],
                            **bench("mhsa_bhtd"),
                            **attn_keys(bhtd_rows),
                            **grad_keys("bhtd")))
    kernels.append(dict(name="ln_mhsa", route="cuda", source=src + "ln_mhsa.cu",
                        replaces=pallas + "attention_kernel.py:115", attn_mode="pallas_lnfused",
                        launches=counts["pallas_lnfused"]["ln_mhsa"],
                        launches_f32=counts_f32["pallas_lnfused"]["ln_mhsa"],
                        launches_numerics=numerics_counts["check"]["ln_mhsa"],
                        **bench("ln_mhsa"),
                        composed_library_ms=ln_rows[0]["composed_library_ms"],
                        composed_library_ms_b128=ln_rows[1]["composed_library_ms"],
                        composed_library_ms_f32=ln_rows[2]["composed_library_ms"],
                        composed_library_ms_b128_f32=ln_rows[3]["composed_library_ms"],
                        **row(ln_rows[0]), **suffixed(ln_rows[1], "_b128"),
                        **suffixed(ln_rows[2], "_f32"), **suffixed(ln_rows[3], "_b128_f32")))
    kernels.append(dict(name="bn_act", route="cuda", source=src + "bn_act.cu", replaces=None,
                        launches=counts["pallas_packed"]["bn_act"],
                        launches_f32=counts_f32["pallas_packed"]["bn_act"],
                        launches_rtdetr=rtdetr_counts["bn_act"],
                        launches_rtdetr_residual=rtdetr_counts["bn_act_residual"],
                        rows=bn_rows))
    kernels.append(dict(name="ms_deform_attn", route="cuda", source=src + "ms_deform_attn.cu",
                        replaces=None, launches=rtdetr_counts["msda"],
                        **row(msda_rows[0]), **suffixed(msda_rows[1], "_f32")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
