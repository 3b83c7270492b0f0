"""Identity-folder face-recognition dataset (MS1MV2-style layout;
``prpe_tpu/data/faces.py``, an own copy).

Re-derivation of the reference's ImageFolderDataset + datamodule
(reference: training/lightning/face_recognition/datamodule.py:34-246):
  * layout ``{root}/imgs/{identity}/{n}.jpg``; label = identity folder index
  * RGB -> BGR channel swap — AdaFace checkpoints were trained on BGR
    (reference: face_recognition/datamodule.py:103-104)
  * resize 112, normalize mean 0.5 / std 0.5
  * deterministic 90/10 train/val split, seed 42
    (reference: datamodule.py:195-199)
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Tuple

import numpy as np

from prpe_tpu_torch import native
from prpe_tpu_torch.data.image import load_image


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class IdentityFolderDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        image_size: int = 112,
        val_fraction: float = 0.1,
        split_seed: int = 42,
        bgr: bool = True,
        augment: bool = False,
    ):
        base = pathlib.Path(root)
        imgs = base / "imgs" if (base / "imgs").exists() else base
        self.classes = sorted(p.name for p in imgs.iterdir() if p.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        samples: List[Tuple[pathlib.Path, int]] = []
        for c in self.classes:
            for f in sorted((imgs / c).iterdir()):
                if f.suffix.lower() in IMG_EXTS:
                    samples.append((f, self.class_to_idx[c]))

        rng = np.random.default_rng(split_seed)
        idx = rng.permutation(len(samples))
        n_val = int(len(samples) * val_fraction)
        chosen = idx[n_val:] if split == "train" else idx[:n_val]
        self.samples = [samples[i] for i in chosen]
        self.image_size = image_size
        self.bgr = bgr
        self.augment = augment
        self._rng = np.random.default_rng(split_seed + 1)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        path, label = self.samples[i]
        img = load_image(path)
        if self.augment and self._rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
        # raw uint8 resize + BGR swap on the host (reference BGR quirk:
        # face_recognition/datamodule.py:103-104); the mean/std-0.5
        # normalization happens on the device (apply_image_norm "half") so
        # batches ship at 1 byte/px
        x = native.resize_bilinear_u8(img, self.image_size, self.image_size)
        if self.bgr:
            x = np.ascontiguousarray(x[..., ::-1])
        return {"image": x, "label": np.int32(label)}
