"""Drives ``prpe_tpu_torch``'s face-gated pose cascade:
``build_cascade_runner(...)``'s ``run(frames, gallery)``, closed loop, one
client.

Set-up draws the seeded weights, lets the reference calibrate their
BatchNorm statistics on the frames, builds the gallery from the reference's
embeddings of faces the cascade will gate on (that reference work is timed
as ``reference_s``, which the harness leaves out of ``setup_s``), builds the program's
``CascadeModel`` with those weights, puts a pool of uint8 frame batches in
pinned host memory (a user hands frames from the host, so each call uploads
them) and warms every pool batch once. A call ends when its answers are on
the host. The answers of every call are kept; after the window a sample
drawn from the seed is judged against the fp32 reference
(``reference/judge.py``).
"""

from __future__ import annotations

import gc
import os
import random
import statistics
import time
from typing import Dict, List

import torch

from benchmark import weights as wmod
from benchmark.reference import cascade as rc
from benchmark.reference.judge import counts, judge, numbers, spread
from benchmark.reference.precision import exact_fp32
from benchmark.stats import beyond, percentile

MODULES = ("person_yolo", "face_yolo", "irnet", "vitpose")


def smooth_frames(gen: torch.Generator, shape, octaves, device) -> torch.Tensor:
    """uint8 NHWC frames with structure at several scales, as camera frames
    have (white noise would make a crop shifted by a pixel another image):
    for each ``[cells, weight]`` of ``octaves`` a uniform grid of ``cells``
    squared values upsampled bilinearly to the frame, weighted and summed."""
    b, h, w, ch = shape
    x = torch.zeros(b, ch, h, w, device=device)
    for cells, weight in octaves:
        grid = torch.rand(b, ch, cells, cells, generator=gen, device=device)
        x += weight * torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear",
                                                      align_corners=False)
    x = x / sum(weight for _, weight in octaves)
    return (x * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _answers(res) -> Dict[str, torch.Tensor]:
    """A ``CascadeResult`` (or the reference's answers) on the host under
    the reference's field names."""
    if isinstance(res, dict):
        return {k: v.cpu() for k, v in res.items()}
    p, f = res.persons, res.faces
    fields = {
        "person_boxes": p.boxes, "person_scores": p.scores, "person_valid": p.valid,
        "face_boxes": f.boxes, "face_scores": f.scores, "face_valid": f.valid,
        "face_identity": res.face_identity, "face_similarity": res.face_similarity,
        "person_gated": res.person_gated, "pose_image_idx": res.pose_image_idx,
        "pose_boxes": res.pose_boxes, "pose_valid": res.pose_valid,
        "pose_keypoints": res.pose_keypoints, "pose_scores": res.pose_scores,
    }
    return {k: v.cpu() for k, v in fields.items()}


class Driver:
    """One cell of the cascade: ``setup``, ``call``, ``window``, ``check``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 dtype: torch.dtype, log):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.dtype = device, dtype
        self.log = log
        self.batch = traffic["batch"]
        c = cfg["cascade"]
        self.face_capacity = c["face_capacity_per_frame"] * self.batch
        self.pose_capacity = c["pose_capacity_per_frame"] * self.batch
        self.calls: List[dict] = []  # pool index and answers of each call
        self.latencies: List[float] = []

    # ---- set-up ------------------------------------------------------------
    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        y = cfg["yolo"]
        w = wmod.make_weights(rc.meta_models(cfg), self.seed, dev, cfg["init"]["bn_weight"],
                              cfg["init"]["head_gain"])
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        size = y["image_size"]
        shape = (self.traffic["pool_batches"], self.batch, size, size, 3)
        frames = torch.stack([smooth_frames(gen, shape[1:], self.traffic["octaves"], dev)
                              for _ in range(shape[0])])
        self._sync()
        t0 = time.perf_counter()
        with exact_fp32():
            self.gallery = self._calibrate_and_plant(w, frames, gen)
        self._sync()
        self.reference_s = time.perf_counter() - t0
        self.build(w)
        self.pool = torch.empty(shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        self.pool.copy_(frames)
        # the reference's weights wait on the host for the check
        self.weights = {m: {k: t.cpu() for k, t in sd.items()} for m, sd in w.items()}
        del w, frames
        self._free()
        if dev.type == "cuda":
            # the peak is the program's: warm-up and window, not the draws above
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(self.traffic["pool_batches"]):
            self.call(i, keep=False)

    def build(self, w) -> None:
        """The program's model with the weights ``w`` and its runner."""
        from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
        from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

        cfg, dev = self.cfg, self.device
        os.environ["PRPE_ATTN_MODE"] = cfg["attn_mode"]
        y, p, c = cfg["yolo"], cfg["pose"], cfg["cascade"]
        det = DetectionConfig(num_classes=y["num_classes"], variant=y["variant"],
                              image_size=y["image_size"], iou_threshold=c["iou_threshold"],
                              reg_max=y["reg_max"])
        pose = PoseConfig(input_size=tuple(p["input_size"]), heatmap_size=tuple(p["heatmap_size"]),
                          num_keypoints=p["num_keypoints"], vit_hidden=p["hidden"],
                          vit_layers=p["layers"], vit_heads=p["heads"],
                          vit_mlp_ratio=p["mlp_ratio"], patch_size=p["patch_size"],
                          decoder_scale_factor=p["decoder_scale_factor"])
        self.model = CascadeModel(det, pose, irnet_layers=cfg["irnet"]["layers"],
                                  dtype=self.dtype, device=dev, seed=self.seed % 2**63)
        self.model.load_state_dict(wmod.program_state_dict(self.model.state_dict().keys(), w))
        cascade_cfg = CascadeConfig(
            max_persons=c["max_persons"], max_faces=c["max_faces"],
            match_threshold=c["match_threshold"], conf_threshold=c["conf_threshold"],
            gate_pose=c["gate_pose"], pose_flip_test=c["pose_flip_test"],
            face_capacity=self.face_capacity, pre_nms_top_k=c["pre_nms_top_k"])
        self.runner = build_cascade_runner(self.model, cascade_cfg,
                                           pose_capacity=self.pose_capacity, device=dev)

    def _calibrate_and_plant(self, w, frames, gen) -> torch.Tensor:
        """BatchNorm statistics of ``w`` set from the reference run over the
        first ``calibration_frames`` frames (``reference/cascade.py::
        calibrate``); then the gallery: for every pool batch, the reference's
        embeddings of the ``planted_per_batch`` best faces that take a face
        slot and whose centre lies in a person box, as the reference
        detects them; random unit rows fill the rest."""
        t = self.traffic
        c = self.cfg["cascade"]
        names = ("person_yolo", "face_yolo", "irnet")
        models = rc.build_models(self.cfg, {m: w[m] for m in names}, self.device)
        calib = frames[0, :t["calibration_frames"]].float() / 255.0
        rc.calibrate(models, calib, self.cfg)
        for m in names:
            for k, v in models[m].state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    w[m][k] = v.clone()
        rows = []
        kf = c["max_faces"]
        for batch in frames:
            f = batch.float() / 255.0
            det = {}
            for name, kmax in (("person_yolo", c["max_persons"]), ("face_yolo", kf)):
                det[name] = rc.greedy_nms(*rc.candidates(models[name], f, 16), c["conf_threshold"],
                                          c["iou_threshold"], c["pre_nms_top_k"], kmax)
            p, fc = det["person_yolo"], det["face_yolo"]
            slots, slot_valid = rc.face_slots(fc["scores"], fc["valid"], self.face_capacity)
            boxes = fc["boxes"].reshape(-1, 4)[slots]
            img = slots // kf
            cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
            pb = p["boxes"][img]  # (F, Kp, 4)
            inside = ((cx[:, None] >= pb[..., 0]) & (cx[:, None] <= pb[..., 2])
                      & (cy[:, None] >= pb[..., 1]) & (cy[:, None] <= pb[..., 3])
                      & p["valid"][img]).any(-1) & slot_valid
            pick = inside.nonzero()[:t["planted_per_batch"], 0]
            rows.append(rc.embed(models["irnet"], f, boxes[pick], img[pick], 64))
        planted = torch.cat(rows)[:t["gallery"]]
        fill = torch.randn(t["gallery"] - planted.shape[0], planted.shape[1], generator=gen,
                           device=self.device)
        return torch.cat([planted, torch.nn.functional.normalize(fill, dim=-1)])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _free(self) -> None:
        gc.collect()
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- calls -------------------------------------------------------------
    def call(self, i: int, keep: bool = True) -> None:
        """One call on pool batch ``i`` mod the pool; its answers reach the host."""
        slot = i % self.traffic["pool_batches"]
        t0 = time.perf_counter()
        answers = _answers(self.runner(self.pool[slot], self.gallery))
        t1 = time.perf_counter()
        if keep:
            self.calls.append({"slot": slot, "answers": answers})
            self.latencies.append(t1 - t0)

    def window(self, seconds: float) -> Dict[str, float]:
        """Calls until ``seconds`` have passed: -> the end-to-end numbers."""
        from prpe_tpu_torch.ops.kernels._build import launches

        before = dict(launches)
        t_start = time.perf_counter()
        i = 0
        while True:
            self.call(i)
            i += 1
            if time.perf_counter() - t_start >= seconds:
                break
        wall = time.perf_counter() - t_start
        lat_ms = [x * 1e3 for x in self.latencies]
        p95 = percentile(lat_ms, 95)
        self.log(f"calls {len(lat_ms)}, call latency median {statistics.median(lat_ms)} ms, "
                 f"p95 {p95} ms over {len(lat_ms)} samples ({beyond(lat_ms, 95)} beyond it), "
                 f"window {wall} s; kernel launches a call "
                 f"{ {k: (launches[k] - before[k]) / len(lat_ms) for k in launches} }")
        return {"cascade_images_per_s": self.batch * len(lat_ms) / wall,
                "cascade_call_p95_ms": p95}

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The program's modules whose forwards the traced run annotates."""
        return {name: getattr(self.model, name) for name in MODULES}

    def units(self) -> Dict[str, float]:
        """What a traced call holds, for the per-layer readers."""
        return {"frames_per_call": float(self.batch), "pose_slots": float(self.pose_capacity),
                "face_slots": float(self.face_capacity)}

    # ---- the check ---------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.runner, self.model
        self._free()

    @exact_fp32()
    def check(self) -> Dict[str, float]:
        """The judge's numbers over a seeded sample of the window's calls."""
        n = min(self.traffic["check_calls"], len(self.calls))
        picks = random.Random(self.seed).sample(range(len(self.calls)), n)
        picks.sort(key=lambda i: (self.calls[i]["slot"], i))
        w = {m: {k: t.to(self.device) for k, t in sd.items()} for m, sd in self.weights.items()}
        models = rc.build_models(self.cfg, w, self.device)
        del w
        items = []
        cands = {}
        for i in picks:
            call = self.calls[i]
            frames = self.pool[call["slot"]].to(self.device)
            if call["slot"] not in cands:
                f = frames.float() / 255.0
                cands = {call["slot"]: {n: rc.candidates(models[n], f, 16)
                                        for n in ("person_yolo", "face_yolo")}}
            out = {k: v.to(self.device) for k, v in call["answers"].items()}
            items.append(judge(models, self.cfg, frames, self.gallery, out, self.face_capacity,
                               self.pose_capacity, cands=cands[call["slot"]]))
        self.log(f"judged calls {picks} of {len(self.calls)}: items {counts(items)}, "
                 f"percentiles 50/75/90/99 {spread(items)}")
        return numbers(items)


class Control(Driver):
    """The control: the reference in float8 (``reference/precision.py``) put
    in the program's place, on the same inputs and through the same check."""

    def build(self, w) -> None:
        clone = {m: {k: t.clone() for k, t in sd.items()} for m, sd in w.items()}
        self.model = rc.ReferenceCascade(self.cfg, rc.build_models(self.cfg, clone, self.device,
                                                                   low=True), low=True)
        self.runner = self._run

    @exact_fp32()
    def _run(self, frames, gallery):
        return self.model.run(frames.to(self.device), gallery, self.pose_capacity,
                              self.face_capacity)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return self.model.models


FAULTS = {"control": Control}
