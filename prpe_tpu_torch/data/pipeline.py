"""Host-side input pipeline: sampling, batching, prefetch to the card, host
sharding (``prpe_tpu/data/pipeline.py``).

  * ``LimitedSampler`` — the reference's epoch-subsampling LimitedDataset
    (reference: object_detection/datamodule.py:17-36): shuffle then truncate
    to ``max_samples`` per epoch, reshuffled each epoch; each process of an
    initialised ``torch.distributed`` group takes a disjoint stride of the
    sample list (DistributedSampler parity)
  * ``prefetch_to_device`` — a producer thread that pins each host batch and
    copies it to the card on a side CUDA stream, so the copy overlaps the
    step before it; on the CPU it only runs the host pipeline ahead
  * ``make_epoch_loader`` — the ``epoch -> iterator`` protocol the
    round-robin trainer consumes, with decode workers (``data/loader.py``)
    when ``num_workers > 0``

The JAX package's ``device_resident_loader`` comes with the parallel slice
and its ``--device-resident`` flags.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch


def _rank_and_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class LimitedSampler:
    """Shuffled, optionally-truncated index stream, deterministic per epoch."""

    def __init__(
        self,
        num_samples: int,
        max_samples: Optional[int] = None,
        seed: int = 42,
        shuffle: bool = True,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
    ):
        rank, world = _rank_and_world()
        self.n = num_samples
        self.max_samples = max_samples
        self.seed = seed
        self.shuffle = shuffle
        self.shard_index = shard_index if shard_index is not None else rank
        self.shard_count = shard_count if shard_count is not None else world

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        if self.max_samples is not None:
            idx = idx[: self.max_samples]
        return idx[self.shard_index:: self.shard_count]


def batched(
    indices: Sequence[int],
    fetch: Callable[[int], Dict[str, np.ndarray]],
    collate: Callable[[List[Dict[str, np.ndarray]]], Dict[str, np.ndarray]],
    batch_size: int,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    buf: List[Dict[str, np.ndarray]] = []
    for i in indices:
        buf.append(fetch(int(i)))
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)


def default_collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def prefetch_to_device(
    it: Iterable[Dict[str, Any]], size: int = 2, device=None,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[Dict[str, Any]]:
    """Run ``it`` on a producer thread, ``size`` batches ahead.

    On a CUDA ``device`` the producer pins each array of a host batch and
    copies it on a side stream; the consumer's stream waits on an event
    recorded after the copy, and ``record_stream`` keeps the allocator from
    handing the batch's memory to the side stream while the consumer still
    reads it. Yields dicts of CUDA tensors. Otherwise (``device`` None or
    the CPU) yields copies of the host batches (a worker pool recycles its
    batches' memory when ``it`` advances).

    An exception of the producer (a bad record, a dead decode worker) is
    raised in the consumer; it does not end the epoch quietly. ``stats``,
    when given, accumulates ``wait_s`` (seconds the consumer waited on the
    queue) and ``batches``. Closing the generator early stops the producer
    and closes ``it``.
    """
    device = None if device is None else torch.device(device)
    cuda = device is not None and device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if cuda else None
            for batch in it:
                if cuda:
                    with torch.cuda.stream(stream):
                        out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                               .to(device, non_blocking=True) for k, v in batch.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                    item = (out, event)
                else:
                    # a copy, as a device transfer would make: a worker
                    # pool's batch views are recycled when ``it`` advances
                    item = ({k: np.array(v) for k, v in batch.items()}, None)
                if not put(item):
                    break
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put((e, None))
        else:
            put((sentinel, None))
        finally:
            if hasattr(it, "close"):
                it.close()

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item, event = q.get()
            if stats is not None:
                stats["wait_s"] = stats.get("wait_s", 0.0) + time.perf_counter() - t0
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in item.values():
                    v.record_stream(current)
            if stats is not None:
                stats["batches"] = stats.get("batches", 0) + 1
            yield item
    finally:
        stop.set()
        t.join()


def make_epoch_loader(
    dataset,
    batch_size: int,
    *,
    max_samples: Optional[int] = None,
    seed: int = 42,
    shuffle: bool = True,
    prefetch: int = 2,
    device=None,
    collate: Optional[Callable] = None,
    num_workers: int = 0,
) -> Callable[[int], Iterator[Dict[str, Any]]]:
    """Bundle a dataset (len + ``__getitem__``) into the epoch -> iterator
    protocol of the round-robin trainer; batches land on ``device`` (CUDA:
    pinned copies on a side stream; None: host numpy batches).

    ``num_workers > 0`` decodes and augments in a pre-forked shared-memory
    worker pool (``data/loader.py``), the reference's
    ``DataLoader(num_workers=N)``; 0 decodes on the prefetch thread.

    The loader exposes ``host(epoch)`` (the host batches, no prefetch),
    ``close()`` (stops the workers), ``steps_per_epoch`` and ``stats``
    (``wait_s`` and ``batches`` summed over every epoch's prefetch)."""
    sampler = LimitedSampler(len(dataset), max_samples, seed, shuffle)
    collate = collate or getattr(dataset, "collate", default_collate)

    pool = None
    if num_workers > 0:
        from prpe_tpu_torch.data.loader import MultiprocessLoader

        pool = MultiprocessLoader(dataset, collate, batch_size, num_workers=num_workers,
                                  prefetch=max(prefetch, 1), seed=seed)

    def host(epoch: int):
        if pool is not None:
            return pool.run(sampler.indices(epoch))
        return batched(sampler.indices(epoch), dataset.__getitem__, collate, batch_size)

    def loader(epoch: int):
        it = host(epoch)
        if prefetch > 0:
            return prefetch_to_device(it, prefetch, device, loader.stats)
        return it

    loader.host = host
    loader.close = pool.close if pool is not None else (lambda: None)
    loader.stats = {"wait_s": 0.0, "batches": 0}
    # actual optimizer steps per epoch (drop_last batching over the
    # truncated, sharded index stream): the schedules' horizons read it
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    loader.steps_per_epoch = (n // sampler.shard_count) // batch_size
    return loader
