"""The packed raw-tensor dataset format and the on-device normalisation of
raw pixels (``prpe_tpu/data/packed.py``, an own copy: the same directory
layout and ``meta.json`` bytes).

A dataset is preprocessed once into one ``.npy`` memmap per batch key, of
shape ``(N, *sample_shape)``, images stored as uint8 (4x smaller on disk
and on the way to the card than fp32), plus ``meta.json`` with the keys,
shapes, dtypes and the normalisation the device re-applies
(``apply_image_norm``; each task's step applies its own). Reading a batch is
one row copy per key out of the page cache, no decode. ``pack_dataset``
converts any of the port's datasets (index-addressable, fixed-shape sample
dicts); ``PackedDataset`` serves the result with the same
``__getitem__``/``collate`` protocol, so it drops into
``data/pipeline.py::make_epoch_loader``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["apply_image_norm", "pack_dataset", "PackedDataset"]

_META = "meta.json"

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _quantize_image(a: np.ndarray, norm: str) -> np.ndarray:
    """f32 normalized image -> uint8 raw pixels (inverse of the normalize
    the dataset applied; recorded in meta so the device re-applies it).
    Already-uint8 images (the loaders' native output) pass through."""
    if a.dtype == np.uint8:
        return a
    if norm == "unit":  # x/255
        return np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
    if norm == "half":  # (x/255 - .5)/.5
        return np.clip(np.rint((a * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)
    if norm == "imagenet":  # (x/255 - mean)/std
        return np.clip(
            np.rint((a * _IMAGENET_STD + _IMAGENET_MEAN) * 255.0), 0, 255
        ).astype(np.uint8)
    raise ValueError(norm)


def apply_image_norm(img: torch.Tensor, norm: Optional[str]) -> torch.Tensor:
    """uint8 pixels -> the task's normalisation in fp32 (``unit`` x/255,
    ``half`` x/127.5 - 1, ``imagenet`` (x - 255 mean) / (255 std)); a float
    input passes through."""
    if img.dtype != torch.uint8:
        return img
    x = img.float()
    const = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=img.device)  # noqa: E731
    if norm is None or norm == "unit":
        return x * const(1.0 / 255.0)
    if norm == "half":
        return x * const(1.0 / 127.5) - const(1.0)
    if norm == "imagenet":
        return (x - const(_IMAGENET_MEAN * 255.0)) * const(1.0 / (_IMAGENET_STD * 255.0))
    raise ValueError(norm)


def pack_dataset(
    dataset,
    out_dir,
    *,
    indices: Optional[Sequence[int]] = None,
    image_key: str = "image",
    image_norm: Optional[str] = "unit",
    progress_every: int = 0,
) -> "PackedDataset":
    """Materialize ``dataset`` into ``out_dir`` as per-key raw memmaps.

    ``image_norm`` names the normalization the source dataset already applied
    to ``image_key`` ("unit" = /255, "half" = mean/std 0.5, None = store
    as-is); the image is de-normalized to uint8 on disk and ``PackedDataset``
    reports the norm for on-device re-application.
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = list(range(len(dataset))) if indices is None else list(indices)
    if not idx:
        raise ValueError("cannot pack an empty dataset")

    first = dataset[idx[0]]
    mms: Dict[str, np.ndarray] = {}
    meta: Dict[str, dict] = {"keys": {}, "n": len(idx), "image_key": image_key,
                             "image_norm": image_norm}
    for k, v in first.items():
        v = np.asarray(v)
        if k == image_key and image_norm is not None:
            v = _quantize_image(v, image_norm)
        mms[k] = np.lib.format.open_memmap(
            out / f"{k}.npy", mode="w+", dtype=v.dtype,
            shape=(len(idx),) + v.shape,
        )
        meta["keys"][k] = {"shape": list(v.shape), "dtype": str(v.dtype)}

    for row, i in enumerate(idx):
        sample = first if row == 0 else dataset[i]
        for k, mm in mms.items():
            v = np.asarray(sample[k])
            if k == image_key and image_norm is not None:
                v = _quantize_image(v, image_norm)
            mm[row] = v
        if progress_every and (row + 1) % progress_every == 0:
            print(f"[pack] {row + 1}/{len(idx)}", flush=True)
    for mm in mms.values():
        mm.flush()
    (out / _META).write_text(json.dumps(meta))
    return PackedDataset(out)


class PackedDataset:
    """Reads a ``pack_dataset`` directory; batch assembly is one fancy-index
    gather per key straight out of the OS page cache."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        meta = json.loads((self.root / _META).read_text())
        self.n = int(meta["n"])
        self.image_key = meta.get("image_key", "image")
        self.image_norm = meta.get("image_norm")
        self._arrs: Dict[str, np.ndarray] = {
            k: np.load(self.root / f"{k}.npy", mmap_mode="r")
            for k in meta["keys"]
        }
        self._bufs: Dict[tuple, list] = {}  # gather() buffer pool

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: a[i] for k, a in self._arrs.items()}

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Collate a whole batch as row-wise memcpys out of the page cache.

        numpy fancy-indexing on a memmap takes an element-wise gather path
        far slower than row memcpy; copying row slices into a preallocated
        buffer is the fast path. Buffers rotate through a pool of two per
        (key, batch) so the previous batch stays valid while the caller
        consumes it (the prefetcher copies it into pinned memory) and
        first-touch page faults are paid once.
        """
        idx = np.asarray(indices)
        self._flip = getattr(self, "_flip", 0) ^ 1
        out = {}
        for k, a in self._arrs.items():
            pool = self._bufs.setdefault((k, idx.size), [None, None])
            buf = pool[self._flip]
            if buf is None:
                buf = pool[self._flip] = np.empty(
                    (idx.size,) + a.shape[1:], a.dtype)
            for j, i in enumerate(idx):
                buf[j] = a[i]
            out[k] = buf
        return out

    # make_epoch_loader protocol: collate(list-of-samples). Stacking the
    # per-sample mmap views is still a straight memcpy; gather() is the
    # faster path when the caller controls batching.
    @staticmethod
    def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def batches(
        self, indices: Sequence[int], batch_size: int, drop_last: bool = True
    ) -> Iterable[Dict[str, np.ndarray]]:
        n = len(indices)
        nb = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(nb):
            yield self.gather(
                np.asarray(indices[b * batch_size : (b + 1) * batch_size])
            )
