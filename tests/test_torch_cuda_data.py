"""The input pipeline's CUDA path: the prefetcher's pinned side-stream copies
and the trainer's host copies for the eval hooks. Needs the card: every
test is marked ``cuda`` and skips where no GPU is present. On the card,
without JAX (this file imports torch, numpy and the port only):

    python -m pytest tests/test_torch_cuda_data.py -m cuda --noconftest -q

Tolerance: equality (the copies move bytes).
"""

import numpy as np
import pytest
import torch

from prpe_tpu_torch.data import pipeline
from prpe_tpu_torch.eval.map import detection_eval_hook
from prpe_tpu_torch.ops.nms import Detections
from prpe_tpu_torch.train.round_robin import _to_host_tree
from prpe_tpu_torch.train.steps import to_device
from torch_one_thread import torch_on_one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", torch.cuda.current_device())


class Records:
    """Fixed-shape samples of every dtype a reader yields; record ``bad``
    raises."""

    def __init__(self, n=48, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"corrupt record {i}")
        rng = np.random.default_rng(i)
        return {"image": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
                "boxes": rng.random((4, 4), dtype=np.float32),
                "mask": rng.random(4) < 0.5, "image_id": np.int64(i)}


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetched_batches_land_on_the_card_unchanged(cuda, workers):
    ds = Records()
    loader = pipeline.make_epoch_loader(ds, 4, shuffle=False, num_workers=workers, device=cuda)
    try:
        for epoch in (0, 1):
            got = list(loader(epoch))
            want = list(pipeline.batched(range(len(ds)), ds.__getitem__,
                                         pipeline.default_collate, 4))
            assert len(got) == len(want) == 12
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    assert g[k].device == cuda
                    # reading on the default stream after its wait on the copy
                    np.testing.assert_array_equal(g[k].cpu().numpy(), w[k], err_msg=k)
                moved = to_device(g, cuda)  # the step's transfer is then a no-op
                assert all(moved[k] is g[k] for k in g)
        assert loader.stats["batches"] == 24
    finally:
        loader.close()


def test_prefetch_to_cuda_relays_errors_and_stops_early(cuda):
    loader = pipeline.make_epoch_loader(Records(bad=9), 4, shuffle=False, device=cuda)
    got = []
    with pytest.raises(ValueError, match="corrupt record 9"):
        for b in loader(0):
            got.append(int(b["image_id"][0]))
    assert got == [0, 4]
    loader = pipeline.make_epoch_loader(Records(), 4, shuffle=False, device=cuda)
    it = loader(0)
    assert int(next(it)["image_id"][0]) == 0
    it.close()
    assert [int(b["image_id"][0]) for b in loader(1)] == list(range(0, 48, 4))


def test_hooks_read_host_copies_of_card_tensors(cuda):
    """``np.asarray`` of a CUDA tensor raises, so the trainer copies the
    predictions and the batch to the host before a hook reads them."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 40, (2, 6, 2)).astype(np.float32)
    det = Detections(torch.from_numpy(np.concatenate([xy, xy + 20], -1)).to(cuda),
                     torch.rand(2, 6, device=cuda), torch.zeros(2, 6, dtype=torch.int32,
                                                               device=cuda),
                     torch.ones(2, 6, dtype=torch.bool, device=cuda))
    batch = {"gt_boxes": torch.rand(2, 3, 4, device=cuda) * 0.5 + 0.25,
             "gt_mask": torch.ones(2, 3, dtype=torch.bool, device=cuda),
             "gt_labels": torch.zeros(2, 3, dtype=torch.int32, device=cuda),
             "image": torch.zeros(2, 64, 64, 3, dtype=torch.uint8, device=cuda)}
    with pytest.raises(TypeError):
        detection_eval_hook(64)([(det, batch)])
    host = [(_to_host_tree(det), _to_host_tree(batch))]
    assert all(isinstance(v, np.ndarray) for v in (*host[0][0], *host[0][1].values()))
    want = detection_eval_hook(64)([(Detections(*(t.cpu() for t in det)),
                                     {k: v.cpu() for k, v in batch.items()})])
    assert detection_eval_hook(64)(host) == want
