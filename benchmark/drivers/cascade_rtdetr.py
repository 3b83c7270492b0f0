"""Drives ``prpe_tpu_torch``'s face-gated pose cascade with RT-DETR-R50 as its
person detector (``CascadeModel(..., person_detector="rtdetr")``):
``build_cascade_runner(...)``'s ``run(frames, gallery)``, closed loop, one
client, as ``cascade.py`` drives the YOLO cascade.

The port's RT-DETR is imported first of all, so that a tree without it
fails at once, before any weight is drawn. Set-up draws the seeded weights
(``weights_rtdetr.py``), lets the reference calibrate every BatchNorm's
statistics on the frames (``reference/cascade_rtdetr.py::calibrate``) and
builds the gallery from the reference's embeddings of faces whose centre
lies in a person the reference's RT-DETR serves (that reference work is
``reference_s``), builds the program with those weights, pins a pool of
uint8 frame batches and warms each once. After the window a sample of the
calls drawn from the seed is judged against the fp32 reference
(``reference/judge_rtdetr.py``).
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict

import torch

import prpe_tpu_torch.nn.rtdetr  # noqa: F401  (a tree without it fails here)
from benchmark import weights_rtdetr as wr
from benchmark.drivers.cascade import Driver as CascadeDriver
from benchmark.drivers.cascade import _answers as cascade_answers
from benchmark.drivers.cascade import smooth_frames
from benchmark.reference import cascade as rc
from benchmark.reference import cascade_rtdetr as rcr
from benchmark.reference import judge_rtdetr as jr
from benchmark.reference.precision import exact_fp32

MODULES = ("person_rtdetr", "face_yolo", "irnet", "vitpose")


def _answers(res) -> Dict[str, torch.Tensor]:
    """``cascade.py``'s answers and the persons' anchors and queries."""
    if isinstance(res, dict):
        return {k: v.cpu() for k, v in res.items()}
    out = cascade_answers(res)
    out["person_anchor_idx"] = res.person_anchor_idx.cpu()
    out["person_query_idx"] = res.person_query_idx.cpu()
    return out


class Driver(CascadeDriver):
    """One cell of the RT-DETR cascade: ``setup``, ``call``, ``window``,
    ``check``."""

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        w = wr.make_weights(rcr.meta_models(cfg), self.seed, dev, cfg["init"])
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        size = cfg["yolo"]["image_size"]
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
        self.weights = {m: {k: t.cpu() for k, t in sd.items()} for m, sd in w.items()}
        del w, frames
        self._free()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(self.traffic["pool_batches"]):
            self.call(i, keep=False)

    def build(self, w) -> None:
        from prpe_tpu_torch.core.config import (CascadeConfig, DetectionConfig, PoseConfig,
                                                RTDETRConfig)
        from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

        cfg, dev = self.cfg, self.device
        os.environ["PRPE_ATTN_MODE"] = cfg["attn_mode"]
        y, p, c, r = cfg["yolo"], cfg["pose"], cfg["cascade"], cfg["rtdetr"]
        det = DetectionConfig(num_classes=y["num_classes"], variant=y["variant"],
                              image_size=y["image_size"], iou_threshold=c["iou_threshold"],
                              reg_max=y["reg_max"])
        pose = PoseConfig(input_size=tuple(p["input_size"]), heatmap_size=tuple(p["heatmap_size"]),
                          num_keypoints=p["num_keypoints"], vit_hidden=p["hidden"],
                          vit_layers=p["layers"], vit_heads=p["heads"],
                          vit_mlp_ratio=p["mlp_ratio"], patch_size=p["patch_size"],
                          decoder_scale_factor=p["decoder_scale_factor"])
        rtdetr = RTDETRConfig(num_classes=r["num_classes"], person_label=r["person_label"],
                              hidden=r["hidden"], num_queries=r["num_queries"], heads=r["heads"],
                              ffn=r["ffn"], levels=r["levels"], points=r["points"],
                              num_decoder_layers=r["num_decoder_layers"])
        self.model = CascadeModel(det, pose, irnet_layers=cfg["irnet"]["layers"],
                                  dtype=self.dtype, device=dev, seed=self.seed % 2**63,
                                  person_detector="rtdetr", rtdetr=rtdetr)
        self.model.load_state_dict(wr.program_state_dict(self.model.state_dict().keys(), w))
        cascade_cfg = CascadeConfig(
            max_persons=c["max_persons"], max_faces=c["max_faces"],
            match_threshold=c["match_threshold"], conf_threshold=c["conf_threshold"],
            gate_pose=c["gate_pose"], pose_flip_test=c["pose_flip_test"],
            face_capacity=self.face_capacity, pre_nms_top_k=c["pre_nms_top_k"])
        self.runner = build_cascade_runner(self.model, cascade_cfg,
                                           pose_capacity=self.pose_capacity, device=dev)

    def _calibrate_and_plant(self, w, frames, gen) -> torch.Tensor:
        """BatchNorm statistics and RT-DETR's person bias from the reference
        over the first ``calibration_frames`` frames; then the gallery: per pool batch, the
        reference's embeddings of the ``planted_per_batch`` best faces that
        take a face slot and whose centre lies in a person the reference
        serves; random unit rows fill the rest."""
        t = self.traffic
        c = self.cfg["cascade"]
        names = ("person_rtdetr", "face_yolo", "irnet")
        models = rcr.build_models(self.cfg, {m: w[m] for m in names}, self.device)
        calib = frames[0, :t["calibration_frames"]].float() / 255.0
        rcr.calibrate(models, calib, self.cfg)
        bias = rcr.person_bias_key(self.cfg)
        for m in names:
            for k, v in models[m].state_dict().items():
                if k.endswith(("running_mean", "running_var")) or (m, k) == ("person_rtdetr", bias):
                    w[m][k] = v.clone()
        rows = []
        kf = c["max_faces"]
        for batch in frames:
            f = batch.float() / 255.0
            p = rcr.persons(self.cfg, *rcr.detect(models["person_rtdetr"], f, 16)[:2],
                            float(f.shape[2]))
            fc = rc.greedy_nms(*rc.candidates(models["face_yolo"], f, 16), c["conf_threshold"],
                               c["iou_threshold"], c["pre_nms_top_k"], kf)
            slots, slot_valid = rc.face_slots(fc["scores"], fc["valid"], self.face_capacity)
            boxes = fc["boxes"].reshape(-1, 4)[slots]
            img = slots // kf
            cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
            pb = p["boxes"][img]
            inside = ((cx[:, None] >= pb[..., 0]) & (cx[:, None] <= pb[..., 2])
                      & (cy[:, None] >= pb[..., 1]) & (cy[:, None] <= pb[..., 3])
                      & p["valid"][img]).any(-1) & slot_valid
            pick = inside.nonzero()[:t["planted_per_batch"], 0]
            rows.append(rc.embed(models["irnet"], f, boxes[pick], img[pick], 64))
        planted = torch.cat(rows)[:t["gallery"]]
        fill = torch.randn(t["gallery"] - planted.shape[0], planted.shape[1], generator=gen,
                           device=self.device)
        return torch.cat([planted, torch.nn.functional.normalize(fill, dim=-1)])

    def call(self, i: int, keep: bool = True) -> None:
        """One call on pool batch ``i`` mod the pool; its answers reach the host."""
        slot = i % self.traffic["pool_batches"]
        t0 = time.perf_counter()
        answers = _answers(self.runner(self.pool[slot], self.gallery))
        t1 = time.perf_counter()
        if keep:
            self.calls.append({"slot": slot, "answers": answers})
            self.latencies.append(t1 - t0)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self.model, name) for name in MODULES}

    @exact_fp32()
    def check(self) -> Dict[str, float]:
        """The judge's numbers over a seeded sample of the window's calls."""
        n = min(self.traffic["check_calls"], len(self.calls))
        picks = random.Random(self.seed).sample(range(len(self.calls)), n)
        picks.sort(key=lambda i: (self.calls[i]["slot"], i))
        w = {m: {k: t.to(self.device) for k, t in sd.items()} for m, sd in self.weights.items()}
        models = rcr.build_models(self.cfg, w, self.device)
        del w
        items = []
        cands = {}
        for i in picks:
            call = self.calls[i]
            frames = self.pool[call["slot"]].to(self.device)
            if call["slot"] not in cands:
                cands = {call["slot"]: rc.candidates(models["face_yolo"], frames.float() / 255.0,
                                                     16)}
            out = {k: v.to(self.device) for k, v in call["answers"].items()}
            items.append(jr.judge(models, self.cfg, frames, self.gallery, out, self.face_capacity,
                                  self.pose_capacity, face_cands=cands[call["slot"]]))
        self.log(f"judged calls {picks} of {len(self.calls)}: items {jr.counts(items)}, "
                 f"percentiles 50/75/90/99 {jr.spread(items)}")
        return jr.numbers(items)


class Control(Driver):
    """The control: the reference in float8 (``reference/precision.py``) put
    in the program's place, on the same inputs and through the same check."""

    def build(self, w) -> None:
        clone = {m: {k: t.clone() for k, t in sd.items()} for m, sd in w.items()}
        self.model = rcr.ReferenceCascade(self.cfg, rcr.build_models(self.cfg, clone,
                                                                     self.device, low=True),
                                          low=True)
        self.runner = self._run

    @exact_fp32()
    def _run(self, frames, gallery):
        return self.model.run(frames.to(self.device), gallery, self.pose_capacity,
                              self.face_capacity)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return self.model.models


FAULTS = {"control": Control}
