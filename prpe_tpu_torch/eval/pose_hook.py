"""Round-robin eval hook: pose predictions -> COCO keypoint AP
(``prpe_tpu/eval/pose_hook.py``, an own copy).

Bridges the pose eval step's (coords, scores) outputs back to
original-image coordinates through the letterbox metadata, accumulates
COCO-format predictions, and runs the OKS AP suite
(reference flow: training/lightning/pose_estimation/module.py:504-628;
evaluation itself in eval/keypoint_eval.py, since pycocotools is not a
dependency).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from prpe_tpu_torch.eval.keypoint_eval import evaluate_keypoints


def pose_eval_hook(image_size: int, keypoint_thresh: float = 0.3):
    def hook(outputs) -> Dict[str, float]:
        predictions: List[dict] = []
        annotations: List[dict] = []
        seen = set()
        for preds, batch in outputs:
            coords, scores = preds  # (B, K, 2) normalized, (B, K)
            coords = np.asarray(coords)
            scores = np.asarray(scores)
            bsz = coords.shape[0]
            image_ids = np.asarray(batch.get("image_id", np.arange(bsz)))
            scale = np.asarray(batch.get("scale", np.ones(bsz)))
            pad = np.asarray(batch.get("pad", np.zeros((bsz, 2))))
            boxes = np.asarray(batch["boxes"])  # (B, N, 4) letterboxed pixels
            kpts_gt = np.asarray(batch["keypoints"])  # (B, N, K, 3) normalized
            areas = np.asarray(batch["areas"])
            mask = np.asarray(batch["mask"])

            for b in range(bsz):
                img_id = int(image_ids[b])
                if img_id in seen:
                    continue
                seen.add(img_id)
                s, (t, l) = float(scale[b]), pad[b]
                inv = 1.0 / max(s, 1e-9)

                # prediction: normalized frame coords -> original pixels
                # (the reference maps via the first instance's box,
                # module.py:534-546; we map through the letterbox transform,
                # which is exact for the full-frame heatmap pipeline)
                px = (coords[b, :, 0] * image_size - l) * inv
                py = (coords[b, :, 1] * image_size - t) * inv
                kp = []
                for x, y, sc in zip(px, py, scores[b]):
                    v = 2 if sc > keypoint_thresh else 1
                    kp += [float(x), float(y), int(v)]
                predictions.append({
                    "image_id": img_id, "category_id": 1,
                    "keypoints": kp, "score": float(scores[b].mean()),
                })

                # ground truths back to original pixels
                for n in range(mask[b].sum()):
                    gk = kpts_gt[b, n]
                    gx = (gk[:, 0] * image_size - l) * inv
                    gy = (gk[:, 1] * image_size - t) * inv
                    gkp = []
                    for x, y, v in zip(gx, gy, gk[:, 2]):
                        gkp += [float(x), float(y), int(v)]
                    annotations.append({
                        "image_id": img_id,
                        "keypoints": gkp,
                        "area": float(areas[b, n]) * inv * inv,
                        "num_keypoints": int((gk[:, 2] > 0).sum()),
                        "iscrowd": 0,
                    })
        if not predictions:
            return {}
        return {f"kpt_{k}": v for k, v in
                evaluate_keypoints(predictions, annotations).items()}

    return hook
