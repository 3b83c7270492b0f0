"""Face-identity metrics (``prpe_tpu/eval/verification.py``, an own numpy
copy; ``make_pairs`` draws from the same generator in the same order).

The reference reports top-1 classification accuracy over the 85,742-identity
logits (reference: training/lightning/face_recognition/module.py:111-145).
The BASELINE north star additionally asks for *verification accuracy* (the
standard LFW-style protocol the AdaFace paper reports): pairs of embeddings,
cosine threshold chosen by k-fold cross-validation.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return (a * b).sum(-1)


def best_threshold_accuracy(
    scores: np.ndarray, same: np.ndarray, thresholds: np.ndarray
) -> Tuple[float, float]:
    accs = [( (scores >= t) == same ).mean() for t in thresholds]
    i = int(np.argmax(accs))
    return float(accs[i]), float(thresholds[i])


def verification_accuracy(
    emb_a: np.ndarray,
    emb_b: np.ndarray,
    same: np.ndarray,
    n_folds: int = 10,
) -> Dict[str, float]:
    """K-fold verification accuracy with per-fold threshold selection on the
    train folds (the published LFW protocol).

    Args:
      emb_a, emb_b: (N, D) embedding pairs.
      same: (N,) bool — same identity.

    Returns {accuracy, accuracy_std, threshold}.
    """
    scores = cosine_similarity(emb_a, emb_b)
    same = np.asarray(same, bool)
    n = len(scores)
    # fewer pairs than folds would produce empty test folds (NaN fold means);
    # clamp, degenerating to leave-one-out for tiny pair sets
    n_folds = max(1, min(n_folds, n))
    idx = np.arange(n)
    folds = np.array_split(idx, n_folds)
    thresholds = np.linspace(-1.0, 1.0, 401)

    accs, thrs = [], []
    for k in range(n_folds):
        test = folds[k]
        others = [folds[j] for j in range(n_folds) if j != k]
        # single-fold degenerate case: fit the threshold on the test fold
        train = np.concatenate(others) if others else test
        _, thr = best_threshold_accuracy(scores[train], same[train], thresholds)
        accs.append(((scores[test] >= thr) == same[test]).mean())
        thrs.append(thr)
    return {
        "accuracy": float(np.mean(accs)),
        "accuracy_std": float(np.std(accs)),
        "threshold": float(np.mean(thrs)),
    }


def top1_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((logits.argmax(-1) == labels).mean())


def make_pairs(labels: np.ndarray, seed: int = 0,
               max_pairs: int = 2000) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic same/different index pairs from a labeled set (the
    LFW-protocol pair construction, balanced 50/50 where possible).

    Returns (idx_a, idx_b, same)."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    by_class: Dict[int, np.ndarray] = {
        int(c): np.flatnonzero(labels == c) for c in np.unique(labels)
    }
    pos = []
    for idx in by_class.values():
        if len(idx) < 2:
            continue
        sh = rng.permutation(idx)
        pos += [(int(sh[i]), int(sh[i + 1])) for i in range(0, len(sh) - 1, 2)]
    n = min(len(pos), max_pairs // 2)
    pos = pos[:n]
    neg = []
    classes = list(by_class)
    if len(classes) >= 2:
        while len(neg) < max(n, 1):
            a, b = rng.choice(len(classes), 2, replace=False)
            neg.append((int(rng.choice(by_class[classes[a]])),
                        int(rng.choice(by_class[classes[b]]))))
    pairs = pos + neg
    same = np.array([1] * len(pos) + [0] * len(neg), bool)
    ia = np.array([p[0] for p in pairs], np.int64)
    ib = np.array([p[1] for p in pairs], np.int64)
    return ia, ib, same


def face_verification_hook(n_folds: int = 10, seed: int = 0):
    """Round-robin ``eval_hook`` for face_recognition: accumulates the eval
    step's (embeddings, batch) pairs over the val epoch and reports k-fold
    verification accuracy (the AdaFace paper's LFW protocol — BASELINE.md
    north star) as ``ver_acc``/``ver_thr``."""

    def hook(outputs) -> Dict[str, float]:
        embs, labels = [], []
        for emb, batch in outputs:
            if emb is None:
                return {}
            embs.append(np.asarray(emb))
            labels.append(np.asarray(batch["label"]))
        if not embs:
            return {}
        emb = np.concatenate(embs)
        lab = np.concatenate(labels)
        ia, ib, same = make_pairs(lab, seed=seed)
        if len(ia) < 2 or same.all() or not same.any():
            return {}
        v = verification_accuracy(emb[ia], emb[ib], same, n_folds=n_folds)
        return {"ver_acc": v["accuracy"], "ver_thr": v["threshold"]}

    return hook
