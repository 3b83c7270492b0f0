"""Smoke run of the PyTorch/CUDA port (``prpe_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``prpe_tpu_torch/csrc/`` (into
``build/prpe_tpu_torch/``), then runs these phases and fails with a non-zero
exit on the first fault:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (NMS keep masks equal; packed MHSA within
   2e-2 in bf16 and 1e-4 in fp32 on unit-scale outputs), with its time, the
   plain version's time, the library call's time where there is one, and
   the least time the card could take for the same work;
2. reference: a tiny fp32 cascade on the card against the same cascade on
   the CPU (where the kernels' plain versions run);
3. cascade: the full-width bf16 cascade (two YOLOv11-n at 640^2, IR-50,
   ViTPose-B) with random seeded weights, once with every launch counter at
   zero to show the path went through both kernels, then images/s at batch
   32 and 128 and the kernels that take the card's time.

Every phase prints one JSON line with the card's name and power limit. The
last two lines are the ``kernels`` summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: outside the tensor cores
NMS_OPS_PER_PAIR = 14  # 4 min/max, 2 sub, 2 clamp, mul, 2 add/sub, eps add, div, compare

CARD = ""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers, "card": CARD}), flush=True)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    ``runs`` back-to-back calls. The card first spins on a sleep kernel so
    the host can queue the calls ahead of it: launch latency on the host
    does not count unless the calls cannot be queued fast enough."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- kernels ---

def nms_inputs(b: int, k: int, gen: torch.Generator, device):
    """Boxes clustered around a few centres per image (real overlaps) and a
    validity mask that is not a prefix."""
    u = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    centres = 50 + 500 * u(b, max(8, k // 32), 2)
    pick = (u(b, k) * centres.shape[1]).long()
    cxy = torch.gather(centres, 1, pick[..., None].expand(b, k, 2)) + 16 * (u(b, k, 2) - 0.5)
    wh = 20 + 60 * u(b, k, 2)
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1).contiguous()
    valid = u(b, k) < 0.7
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
               library_ms=None)
    emit("kernel", **row)
    return row


def phase_mhsa(gen, device, dtype, b: int = 32, t: int = 192, h: int = 12, d: int = 64):
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.ops.kernels.attention import mhsa_packed, mhsa_packed_plain

    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=device).to(dtype) for _ in range(3))
    before = launches["mhsa"]
    o = mhsa_packed(q, k, v, h)
    torch.cuda.synchronize()
    if launches["mhsa"] != before + 1:
        fail("mhsa_packed did not count its launch")
    want = mhsa_packed_plain(q, k, v, h)
    err = float((o.float() - want.float()).abs().max())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if not err <= tol:
        fail(f"mhsa_packed {dtype} max abs err {err} > {tol}")
    ms = time_ms(lambda: mhsa_packed(q, k, v, h))
    plain_ms = time_ms(lambda: mhsa_packed_plain(q, k, v, h))
    heads = lambda x: x.view(b, t, h, d).transpose(1, 2)  # noqa: E731
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
    bnd, by = bound_ms(4 * q.numel() * q.element_size(), 4 * b * h * t * t * d, PEAK_FLOPS[dtype])
    row = dict(name="mhsa_packed", dtype=str(dtype).replace("torch.", ""), B=b, T=t, H=h, D=d,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=library_ms)
    emit("kernel", **row)
    return row


def phase_odd_shapes(gen, device) -> None:
    """Kernels against their plain versions away from the serving shapes:
    K not a multiple of 32, T not a multiple of the 64-key tile, every head
    dim, the longest sequence. Correctness only."""
    from prpe_tpu_torch.ops.kernels.attention import mhsa_packed, mhsa_packed_plain
    from prpe_tpu_torch.ops.kernels.nms import nms_keep, nms_keep_plain

    checked = []
    for b, k in ((3, 1), (5, 300), (2, 777)):
        boxes, valid = nms_inputs(b, k, gen, device)
        if not torch.equal(nms_keep(boxes, valid, 0.5), nms_keep_plain(boxes, valid, 0.5)):
            fail(f"nms_keep differs from its plain version at B={b}, K={k}")
        checked.append(f"nms B={b} K={k}")
    for b, t, h, d in ((2, 24, 2, 16), (3, 200, 4, 32), (2, 65, 3, 64), (1, 1024, 2, 128)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v = (torch.randn(b, t, h * d, generator=gen, device=device).to(dtype)
                       for _ in range(3))
            err = float((mhsa_packed(q, k, v, h).float() - mhsa_packed_plain(q, k, v, h).float())
                        .abs().max())
            if not err <= tol:
                fail(f"mhsa_packed {dtype} at B={b} T={t} H={h} D={d}: max abs err {err} > {tol}")
            checked.append(f"mhsa {str(dtype)[6:]} B={b} T={t} H={h} D={d} err={err:.3g}")
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


def phase_cascade(device, pose=None, irnet_layers: int = 50, size: int = 640,
                  batches=((32, 20), (128, 8))):
    """The full-width cascade unless a smaller ``pose`` / ``size`` is given."""
    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
    from prpe_tpu_torch.ops.kernels import launches, reset_launches

    pose = pose or PoseConfig()
    t0 = time.perf_counter()
    model = CascadeModel(DetectionConfig(), pose, irnet_layers=irnet_layers,
                         dtype=torch.bfloat16, device=device, seed=0)
    cfg = CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3, conf_threshold=0.0)
    gen = torch.Generator(device=device).manual_seed(1)
    gallery = torch.nn.functional.normalize(
        torch.randn(32, 512, generator=gen, device=device), dim=-1)
    init_s = time.perf_counter() - t0

    counts, rates = {}, {}
    for batch, iters in batches:
        images = torch.rand(batch, size, size, 3, generator=gen, device=device).to(torch.bfloat16)
        run = build_cascade_runner(model, cfg, pose_capacity=batch, device=device)
        if batch == batches[0][0]:
            # the main path, once, with every counter at zero
            reset_launches()
            res = run(images, gallery)
            torch.cuda.synchronize()
            counts = dict(launches)
            want = {"nms": 2, "mhsa": pose.vit_layers}
            if counts != want:
                fail(f"main path launched {counts}, expected {want}")
            check_result(res, batch, cfg.max_persons, cfg.max_faces, batch, pose.num_keypoints)
            profile = profile_top(lambda: run(images, gallery))
        for _ in range(2):
            run(images, gallery)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            out = run(images, gallery)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check_result(out, batch, cfg.max_persons, cfg.max_faces, batch, pose.num_keypoints)
        rates[batch] = batch * iters / dt
    emit("cascade", metric=f"face_gated_pose_cascade_{size}_throughput", unit="images/sec",
         images_per_s={f"b{b}": r for b, r in rates.items()}, launches_per_call=counts,
         init_s=init_s, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # busy share: kernel time of one profiled call over one timed call's wall time
    b0 = batches[0][0]
    wall_ms = 1e3 * b0 / rates[b0]
    emit(f"profile_b{b0}", wall_ms_per_call=wall_ms,
         device_busy_share=profile.get("kernel_ms", 0.0) / wall_ms, top_device_ms=profile)
    return counts


def profile_top(fn, top: int = 12):
    """Device time per kernel over one call, from torch.profiler: kernel
    events only (the aten ops that launch them would count the time twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key[:80]))
    rows.sort(reverse=True)
    return {"kernel_ms": sum(r[0] for r in rows), "launches": sum(r[1] for r in rows),
            "top": [list(r) for r in rows[:top]]}


def main() -> int:
    global CARD
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

    t0 = time.perf_counter()
    logs = build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"nvcc {name}: {line.strip()}", flush=True)
    emit("build", seconds=time.perf_counter() - t0)

    gen = torch.Generator(device=device).manual_seed(0)
    nms_rows = [phase_nms(gen, device, 32, k) for k in (256, 1024)]
    mhsa_rows = [phase_mhsa(gen, device, dt) for dt in (torch.bfloat16, torch.float32)]
    phase_odd_shapes(gen, device)
    phase_reference(device)
    counts = phase_cascade(device)

    kernels = [
        dict(name="nms_keep", route="cuda", source="prpe_tpu_torch/csrc/nms.cu",
             replaces="prpe_tpu/ops/pallas/nms_kernel.py:42", launches=counts["nms"],
             **{k: nms_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}),
        dict(name="mhsa_packed", route="cuda", source="prpe_tpu_torch/csrc/mhsa.cu",
             replaces="prpe_tpu/ops/pallas/attention_kernel.py:92", launches=counts["mhsa"],
             **{k: mhsa_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
