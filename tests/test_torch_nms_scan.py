"""The algorithm of the NMS kernel (``prpe_tpu_torch/csrc/nms.cu``), spelled
out in PyTorch and held on the CPU against the port's ``greedy_scan`` and the
Pallas kernel in interpret mode. Keep masks must be equal.

The kernel builds the suppression matrix as 32-bit words: rows i < n_iter
(the last valid index + 1), words from i's own word up to n_iter, one
32 x 32 block a warp, one row a lane. Words it never writes hold whatever
shared memory held; the emulation fills them with random bits, so a scan
that read one would fail. The scan goes by 32-candidate words: lane w holds
word w of the suppressed mask; in round w the warp resolves word w as the
fixed point of K = cand & ~OR(diagonal rows of K), iterated from K = cand,
and the kept bits propagate to the later words as the OR of the kept
candidates' rows. A row past n_iter is never read: its words were never
written.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops.pallas.nms_kernel import pallas_greedy_nms
from prpe_tpu_torch.ops.boxes import pairwise_iou
from prpe_tpu_torch.ops.kernels.nms import greedy_scan, nms_keep_plain
from torch_one_thread import torch_on_one_thread  # noqa: F401

WORD = 0xFFFFFFFF
MAX_STEPS = 33  # the fixed point is reached within 33 steps


def build_words(suppress: torch.Tensor, n_iter: int, words: int, gen: torch.Generator):
    """Phase 1 of one image: ``mask[i][w]`` as the kernel leaves it. The
    32 x 32 blocks (a, w), a <= w < n_iter / 32, are numbered w-major; lane
    r of block t's warp computes row 32 a + r against columns
    [32 w, 32 w + 32) below n_iter."""
    # 32 * words rows: the scan loads whole 32-row words, past K too
    mask = torch.randint(0, WORD + 1, (32 * words, words), generator=gen,
                         dtype=torch.int64).tolist()
    wlim = (n_iter + 31) // 32
    for t in range(wlim * (wlim + 1) // 2):
        w = int(((8 * t + 1) ** 0.5 - 1) / 2)
        w += (w + 1) * (w + 2) // 2 <= t
        w -= w * (w + 1) // 2 > t
        a = t - w * (w + 1) // 2
        for lane in range(32):
            i = 32 * a + lane
            if i >= n_iter:
                continue
            mask[i][w] = sum(1 << jj for jj in range(32)
                             if 32 * w + jj < n_iter and bool(suppress[i, 32 * w + jj]))
    return mask


def resolve(cand: int, dg) -> tuple:
    """Word w's kept bits: lane r holds diagonal row ``dg[r]`` (bits after r
    only); K = cand & ~OR(dg[r] for r in K) is iterated from K = cand until
    it stops changing, one warp-wide OR a step. Returns (K, steps)."""
    kw = cand
    for step in range(1, MAX_STEPS + 1):
        reduced = 0
        for r in range(32):
            reduced |= dg[r] if kw >> r & 1 else 0
        nxt = cand & ~reduced & WORD
        if nxt == kw:
            return kw, step
        kw = nxt
    raise AssertionError("no fixed point within 33 steps")


def scan_words(mask, valid_words, n_iter: int, words: int):
    """Phase 2 of one image: the kept bits of every word."""
    wlim = (n_iter + 31) // 32
    sup, kept = [0] * words, [0] * words
    for w in range(wlim):
        dg = [mask[32 * w + r][w] & (0xFFFFFFFE << r) & WORD if 32 * w + r < n_iter else 0
              for r in range(32)]
        cand = valid_words[w] & ~sup[w] & WORD  # lane w's word, broadcast
        kept[w], _ = resolve(cand, dg)
        for lane in range(w + 1, wlim):
            # word w's rows at this lane's column, loaded before the resolve
            # (rows past n_iter hold stale words); the kept bits select them
            col = [mask[32 * w + i][lane] for i in range(32)]
            for i in range(32):
                sup[lane] |= col[i] & -(kept[w] >> i & 1) & WORD
    return kept


def word_blocked_keep(suppress: torch.Tensor, valid: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """keep (B, K) bool from ``suppress`` (B, K, K) and ``valid`` (B, K) bool,
    one image at a time as the kernel's clusters run them."""
    b, k = valid.shape
    words = (k + 31) // 32
    gen = torch.Generator().manual_seed(seed)
    keep = torch.zeros(b, k, dtype=torch.bool)
    shifts = torch.arange(32, dtype=torch.int64)
    for img in range(b):
        padded = torch.zeros(words * 32, dtype=torch.int64)
        padded[:k] = valid[img].long()
        valid_words = (padded.view(words, 32) << shifts).sum(-1).tolist()
        idx = valid[img].nonzero()
        n_iter = int(idx.max()) + 1 if len(idx) else 0
        mask = build_words(suppress[img], n_iter, words, gen)
        kept = torch.tensor(scan_words(mask, valid_words, n_iter, words), dtype=torch.int64)
        keep[img] = ((kept[:, None] >> shifts) & 1).flatten()[:k].bool()
    return keep


def make_case(k: int, validity: str, seed: int, b: int = 2):
    """Boxes clustered around a few centres (many overlaps) and a validity
    mask: a prefix, random (not a prefix), or empty."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(50, 550, size=(b, max(2, k // 16), 2))
    pick = rng.integers(0, centres.shape[1], size=(b, k))
    cxy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 8, (b, k, 2))
    wh = rng.uniform(20, 80, size=(b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    if validity == "prefix":
        valid = np.arange(k)[None, :] < np.array([[max(1, k * 3 // 5)], [k]])
    elif validity == "random":
        valid = rng.uniform(size=(b, k)) < 0.7
    else:
        valid = np.zeros((b, k), bool)
    return boxes, valid


@pytest.mark.parametrize("thr", [0.0, 0.65])
@pytest.mark.parametrize("validity", ["prefix", "random", "empty"])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 300])
def test_word_blocked_scan_equals_greedy_scan(k, validity, thr):
    boxes, valid = make_case(k, validity, seed=k)
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    suppress = pairwise_iou(boxes, boxes) > thr
    got = word_blocked_keep(suppress, valid, seed=k + 1)
    want = greedy_scan(suppress, valid)
    assert torch.equal(got, want)
    assert torch.equal(got, nms_keep_plain(boxes, valid, thr))
    if validity == "empty":
        assert not got.any()
    elif k >= 32:
        assert 0 < int(got.sum()) < int(valid.sum())  # real suppression happened


@pytest.mark.parametrize("thr", [0.0, 0.65])
@pytest.mark.parametrize("k", [1, 33, 300])
def test_word_blocked_scan_equals_pallas(k, thr):
    boxes, valid = make_case(k, "random", seed=100 + k)
    got = word_blocked_keep(pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)) > thr,
                            torch.from_numpy(valid))
    want = np.asarray(pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(valid),
                                        iou_threshold=thr, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def greedy_word(cand: int, dg) -> int:
    """The greedy scan of one word, candidate by candidate."""
    for r in range(32):
        if cand >> r & 1:
            cand &= ~dg[r] & WORD
    return cand


@pytest.mark.parametrize("pattern", ["chain", "all", "none", "random_dense", "random_sparse"])
def test_resolve_fixed_point(pattern):
    """The fixed point equals the greedy scan of the word, within 33 steps,
    for diagonal blocks from no suppression to the longest chain (row r
    suppresses only r + 1: the kept set alternates, and each step settles
    one more candidate)."""
    rng = np.random.default_rng(7)
    upper = [0xFFFFFFFE << r & WORD for r in range(32)]
    if pattern == "chain":
        dg = [1 << (r + 1) & WORD for r in range(32)]
    elif pattern == "all":
        dg = upper
    elif pattern == "none":
        dg = [0] * 32
    else:
        p = 0.5 if pattern == "random_dense" else 0.05
        dg = [sum(1 << c for c in range(32) if rng.uniform() < p) & upper[r] for r in range(32)]
    for cand in (WORD, 0, 0x55555555, int(rng.integers(0, WORD + 1))):
        kw, steps = resolve(cand, dg)
        assert kw == greedy_word(cand, dg)
        assert steps <= MAX_STEPS
    if pattern == "chain":
        assert resolve(WORD, dg) == (0x55555555, 32)


def bracket(thr: float):
    """The kernel's bounds around thr (``prpe_nms_keep``), as float32."""
    if not 2.0 ** -60 <= thr <= 1.0:
        return np.float32(np.inf), np.float32(-np.inf)
    return np.float32(thr * (1 + 2.0 ** -20)), np.float32(thr * (1 - 2.0 ** -20))


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.65, 0.7, 0.45])
def test_bracket_agrees_with_division(thr):
    """inter >= hi * union proves IoU > thr and inter <= lo * union proves
    IoU <= thr, with the IoU rounded as the plain version rounds it (fp32,
    one division): on box pairs whose IoU sits at the threshold to within a
    few ulps and on pairs spread over [0, 1], neither test contradicts the
    division, and few of the spread pairs fall between them."""
    rng = np.random.default_rng(int(thr * 1000))
    n = 200_000
    a = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    wa = rng.uniform(4, 120, (n, 2)).astype(np.float32)
    box1 = np.concatenate([a, a + wa], -1)
    # box2 shares box1's corner and scales its width: IoU = s for s <= 1
    # before rounding; s near thr puts the rounded IoU at the threshold
    spread = rng.uniform(size=n) < 0.5
    s = np.where(spread, rng.uniform(0, 1, n), thr * (1 + rng.integers(-64, 65, n) * 2.0 ** -24))
    box2 = np.concatenate([a, a + wa * np.stack([s, np.ones(n)], -1)], -1).astype(np.float32)
    inter, union = _inter_union(torch.from_numpy(box1), torch.from_numpy(box2))
    inter, union = inter.numpy(), union.numpy()
    iou = inter / union  # float32 division, correctly rounded
    hi, lo = bracket(thr)
    above = inter >= hi * union
    below = inter <= lo * union
    thr32 = np.float32(thr)
    assert not (above & ~(iou > thr32)).any()
    assert not (below & (iou > thr32)).any()
    assert not (above & below).any()
    band = ~(above | below)
    assert band[spread].mean() < 1e-3 and band[~spread].any()
    assert (iou > thr32).any() and (iou <= thr32).any()


def _inter_union(box1: torch.Tensor, box2: torch.Tensor):
    """Intersection and union as ``ops/boxes.py::iou`` forms them, in fp32."""
    lt = torch.maximum(box1[..., :2], box2[..., :2])
    rb = torch.minimum(box1[..., 2:], box2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)  # noqa: E731
    return inter, area(box1) + area(box2) - inter + 1e-7
