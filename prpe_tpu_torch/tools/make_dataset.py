"""Write learnable synthetic datasets for all four round-robin tasks, as PNG
through the port's own writer (no PIL needed).

    python -m prpe_tpu_torch.tools.make_dataset OUT [--train N] [--val N]
        [--det-size 320] [--pose-size 640] [--face-size 112]
        [--identities 32] [--per-identity N] [--jpeg-quality Q]

The layouts the training CLI reads (the repository's
``tools/make_synthetic_multitask_data.py`` and
``tools/make_synthetic_yolo_dataset.py`` write the same, with PIL, faces and
pose as JPEG):

  OUT/person/, OUT/face/  YOLO-txt: images/{split}/*.png, labels/{split}/*.txt
                          (``cls cx cy w h`` normalised, one row a box)
  OUT/faces/imgs/<id>/    identity folders of 112^2 face crops
  OUT/pose/               images/{split}/*.png and
                          annotations/person_keypoints_{split}2017.json

The content draws from the same generators in the same order as those
tools, so it is learnable in the same way: bright rectangles on dark noise
(detection), a per-identity 4x4 colour-block signature with noise, shift
and brightness jitter (faces), one person box with 17 distinct-coloured
keypoint discs in a skeleton layout (pose, one person an image, since the
combined model predicts one skeleton a frame). Detection images of one
split seed are pixel-identical to the repository tool's.

``--jpeg-quality Q`` passes every face crop and pose image through
``data/image.py::jpeg_roundtrip`` before the PNG is written: the pixels
the repository tool's JPEGs (quality 92) decode to, within about a grey
level, for a host without PIL. Without it the PNGs are lossless, which is
a departure from the JAX side's data: JPEG's quantisation takes about a
quarter of the pose images' pixel noise away.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

import numpy as np

from prpe_tpu_torch.data.image import jpeg_roundtrip, save_png

# 17 maximally-distinct keypoint colours (hue wheel)
KP_COLORS = np.stack([
    np.array([np.cos(t), np.cos(t - 2.094), np.cos(t + 2.094)]) * 0.5 + 0.5
    for t in np.linspace(0, 2 * np.pi, 17, endpoint=False)
])

# rough upright skeleton in a unit box (x, y in [0, 1]), COCO keypoint order
SKELETON = np.array([
    [0.50, 0.10], [0.46, 0.08], [0.54, 0.08], [0.40, 0.10], [0.60, 0.10],
    [0.35, 0.25], [0.65, 0.25], [0.28, 0.42], [0.72, 0.42], [0.22, 0.58],
    [0.78, 0.58], [0.42, 0.55], [0.58, 0.55], [0.40, 0.75], [0.60, 0.75],
    [0.38, 0.95], [0.62, 0.95],
])


def _u8(img: np.ndarray, jpeg_quality: Optional[int] = None) -> np.ndarray:
    out = (img * 255).astype(np.uint8)
    return out if jpeg_quality is None else jpeg_roundtrip(out, jpeg_quality)


def make_detection_split(root: pathlib.Path, split: str, n: int, size: int, seed: int) -> None:
    """YOLO-txt split of ``n`` images: 1-4 bright rectangles each, class 0."""
    img_dir, lab_dir = root / "images" / split, root / "labels" / split
    img_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.uniform(0, 0.3, size=(size, size, 3))
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            w = rng.uniform(0.15, 0.4)
            h = rng.uniform(0.15, 0.4)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            color = rng.uniform(0.7, 1.0, size=3)
            x1, y1 = int((cx - w / 2) * size), int((cy - h / 2) * size)
            x2, y2 = int((cx + w / 2) * size), int((cy + h / 2) * size)
            img[y1:y2, x1:x2] = color
            rows.append(f"0 {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
        save_png(img_dir / f"{i:05d}.png", _u8(img))
        (lab_dir / f"{i:05d}.txt").write_text("\n".join(rows) + "\n")


def make_faces(root: pathlib.Path, n_ids: int, per_id: int, size: int = 112,
               seed: int = 0, jpeg_quality: Optional[int] = None) -> None:
    """``n_ids`` identity folders of ``per_id`` crops each."""
    rng = np.random.default_rng(seed)
    sigs = rng.random((n_ids, 4, 4, 3))  # per-identity block signature
    for c in range(n_ids):
        d = root / "imgs" / f"id{c:04d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_id):
            base = np.kron(sigs[c], np.ones((size // 4, size // 4, 1)))
            img = base + rng.normal(0, 0.08, base.shape)
            img = np.roll(img, rng.integers(-6, 7, 2), axis=(0, 1))
            img = np.clip(img * rng.uniform(0.8, 1.2), 0, 1)
            save_png(d / f"{i:03d}.png", _u8(img, jpeg_quality))


def make_pose_split(root: pathlib.Path, split: str, n: int, size: int, seed: int,
                    jpeg_quality: Optional[int] = None) -> None:
    """COCO-keypoints split of ``n`` images, one annotated person each."""
    img_dir, ann_dir = root / "images" / split, root / "annotations"
    img_dir.mkdir(parents=True, exist_ok=True)
    ann_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        img = rng.uniform(0, 0.25, (size, size, 3))
        bw = rng.uniform(0.25, 0.45) * size
        bh = rng.uniform(0.45, 0.7) * size
        x0 = rng.uniform(0, size - bw)
        y0 = rng.uniform(0, size - bh)
        img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] *= 0.5
        img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] += 0.35
        kps = []
        pts = SKELETON + rng.normal(0, 0.02, SKELETON.shape)
        for k in range(17):
            kx = x0 + pts[k, 0] * bw
            ky = y0 + pts[k, 1] * bh
            r = max(int(0.012 * size), 2)
            ys, xs = np.ogrid[-r:r + 1, -r:r + 1]
            disc = ys * ys + xs * xs <= r * r
            yy, xx = int(ky), int(kx)
            y1, y2 = max(yy - r, 0), min(yy + r + 1, size)
            x1, x2 = max(xx - r, 0), min(xx + r + 1, size)
            img[y1:y2, x1:x2][disc[: y2 - y1, : x2 - x1]] = KP_COLORS[k]
            kps += [float(kx), float(ky), 2]
        anns.append({"id": i + 1, "image_id": i, "category_id": 1, "keypoints": kps,
                     "num_keypoints": 17, "iscrowd": 0, "bbox": [x0, y0, bw, bh],
                     "area": float(bw * bh)})
        name = f"{i:06d}.png"
        save_png(img_dir / name, _u8(img, jpeg_quality))
        images.append({"id": i, "file_name": name, "width": size, "height": size})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person",
                            "keypoints": [f"k{j}" for j in range(17)], "skeleton": []}]}
    (ann_dir / f"person_keypoints_{split}2017.json").write_text(json.dumps(coco))


def make_dataset(out, n_train: int = 256, n_val: int = 64, *, det_size: int = 320,
                 pose_size: int = 640, face_size: int = 112, identities: int = 32,
                 per_identity: Optional[int] = None,
                 jpeg_quality: Optional[int] = None) -> pathlib.Path:
    """All four layouts under ``out``, with the repository tool's seeds
    (person 0/1, face 2/3, faces 0, pose 4/5); ``jpeg_quality`` takes the
    face crops and pose images through a JPEG round trip. Returns ``out``."""
    out = pathlib.Path(out)
    make_detection_split(out / "person", "train", n_train, det_size, seed=0)
    make_detection_split(out / "person", "val", n_val, det_size, seed=1)
    make_detection_split(out / "face", "train", n_train, det_size, seed=2)
    make_detection_split(out / "face", "val", n_val, det_size, seed=3)
    make_faces(out / "faces", identities,
               per_identity if per_identity is not None else max(n_train // 8, 10), face_size,
               jpeg_quality=jpeg_quality)
    make_pose_split(out / "pose", "train", n_train, pose_size, seed=4, jpeg_quality=jpeg_quality)
    make_pose_split(out / "pose", "val", n_val, pose_size, seed=5, jpeg_quality=jpeg_quality)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--train", type=int, default=256, help="train images per task")
    ap.add_argument("--val", type=int, default=64, help="val images per detection/pose task")
    ap.add_argument("--det-size", type=int, default=320)
    ap.add_argument("--pose-size", type=int, default=640)
    ap.add_argument("--face-size", type=int, default=112)
    ap.add_argument("--identities", type=int, default=32)
    ap.add_argument("--per-identity", type=int, default=None,
                    help="face crops per identity (default max(train / 8, 10))")
    ap.add_argument("--jpeg-quality", type=int, default=None,
                    help="face crops and pose images through a JPEG round trip at this quality "
                         "(the JAX tool writes 92)")
    a = ap.parse_args(argv)
    out = make_dataset(a.out, a.train, a.val, det_size=a.det_size, pose_size=a.pose_size,
                       face_size=a.face_size, identities=a.identities,
                       per_identity=a.per_identity, jpeg_quality=a.jpeg_quality)
    print(f"wrote person/, face/, faces/, pose/ under {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
