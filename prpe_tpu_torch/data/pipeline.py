"""Host-side input pipeline: sampling, batching, prefetch to the card, host
sharding (``prpe_tpu/data/pipeline.py``).

  * ``LimitedSampler`` — the reference's epoch-subsampling LimitedDataset
    (reference: object_detection/datamodule.py:17-36): shuffle then truncate
    to ``max_samples`` per epoch, reshuffled each epoch; each shard (a
    mesh's data rank, which the caller passes, else each process of an
    initialised ``torch.distributed`` group) takes a disjoint stride of the
    sample list, of equal length (DistributedSampler parity,
    ``drop_last``). The ranks of one model group share a data rank and read
    the same samples.
  * ``prefetch_to_device`` — a producer thread that pins each host batch and
    copies it to the card on a side CUDA stream, so the copy overlaps the
    step before it; on the CPU it only runs the host pipeline ahead
  * ``make_epoch_loader`` — the ``epoch -> iterator`` protocol the
    round-robin trainer consumes, with decode workers (``data/loader.py``)
    when ``num_workers > 0``
  * ``device_resident_loader`` — one epoch staged on the card before the
    first step and replayed every epoch, optionally refreshed by a host
    thread that augments the next epoch meanwhile
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

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
        # equal shards: every rank takes as many steps as the others
        idx = idx[: len(idx) - len(idx) % self.shard_count]
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
    shard: Optional[Tuple[int, int]] = None,
) -> Callable[[int], Iterator[Dict[str, Any]]]:
    """Bundle a dataset (len + ``__getitem__``) into the epoch -> iterator
    protocol of the round-robin trainer; batches land on ``device`` (CUDA:
    pinned copies on a side stream; None: host numpy batches).

    ``num_workers > 0`` decodes and augments in a pre-forked shared-memory
    worker pool (``data/loader.py``), the reference's
    ``DataLoader(num_workers=N)``; 0 decodes on the prefetch thread.

    The loader exposes ``host(epoch)`` (the host batches, no prefetch),
    ``close()`` (stops the workers), ``steps_per_epoch``, ``stats``
    (``wait_s`` and ``batches`` summed over every epoch's prefetch) and
    ``per_rank``: its batches are this data rank's rows (of
    ``batch_size`` each; a mesh's global batch is ``batch_size`` times the
    data axis). ``shard``: the (index, count) of the samples this process
    reads, under a mesh its (data rank, data-axis size); None: the
    sampler's default."""
    index, count = shard or (None, None)
    sampler = LimitedSampler(len(dataset), max_samples, seed, shuffle, index, count)
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
    loader.per_rank = True
    # actual optimizer steps per epoch (drop_last batching over the
    # truncated, sharded index stream): the schedules' horizons read it
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    loader.steps_per_epoch = (n // sampler.shard_count) // batch_size
    return loader


def device_resident_loader(
    loader: Callable[[int], Iterable],
    *,
    device=None,
    reshuffle: bool = True,
    seed: int = 0,
    name: str = "",
    refresh: bool = False,
    shard: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
) -> Callable[[int], Iterator[Dict[str, Any]]]:
    """Stage one epoch of ``loader`` on ``device`` up front and replay it
    every epoch, in a new order each epoch unless ``reshuffle=False``
    (``prpe_tpu/data/pipeline.py::device_resident_loader``). For a dataset
    that fits the card: the host's decoding then stays out of every step.

    ``refresh=False``: the augmentation is frozen to the staged epoch (every
    epoch replays epoch 0's samples), which is not the reference's regimen
    of fresh augmentation per epoch (training/yolopt/dataset.py:105-176).

    ``refresh=True``: a host thread decodes and augments epoch N+1 while
    the card steps through epoch N; the replay copies one of its batches to
    the card per yielded batch, on a side stream, one copy in flight, and
    swaps the new epoch in when it ends. An epoch that starts before the
    host thread is done replays the newest staged epoch again, frozen (the
    training never waits on the host). ``stats`` counts ``fresh_epochs`` and
    ``stale_epochs`` and names the ``host_epoch`` ready to swap in; the card
    holds at most two epochs of this loader.
    An error of the host thread is raised in the consumer at the next swap.

    ``shard`` (the rank's rows of a global batch) is applied to each host
    batch before it is staged. The loader exposes ``total_bytes`` (2x with
    ``refresh``, for the budget check), ``steps_per_epoch``, ``stats``,
    ``per_rank`` and ``close``; it stages when this function is called.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    cuda = device.type == "cuda"
    # the raw host batches: the epoch loader's prefetch would copy them to
    # the card on a thread of its own
    host_loader = getattr(loader, "host", loader)
    select = shard or (lambda b: b)

    def to_device(batch, pin: bool = False):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v))
            if pin and cuda:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin and cuda) if cuda else t.clone()
        return out

    batches: List[Dict[str, Any]] = []
    total = 0
    for batch in host_loader(0):
        batch = select(batch)
        batches.append(to_device(batch))
        total += sum(int(np.asarray(v).nbytes) for v in batch.values())
    if cuda:
        torch.cuda.synchronize(device)

    # host_epoch: the epoch the host thread has ready (or failed), if any
    state: Dict[str, Any] = {"batches": batches, "fresh_epochs": 1, "stale_epochs": 0,
                             "host_epoch": None}
    host_next: Dict[str, Any] = {"epoch": None, "batches": None}
    stop, wake, ready = threading.Event(), threading.Event(), threading.Event()

    def producer():
        # the host side (decode + augment) of the next epoch; the copies to
        # the card run on the consumer's thread between its yields
        e = 1
        while not stop.is_set():
            try:
                hb = [select(b) for b in host_loader(e)]
            except BaseException as exc:  # noqa: BLE001 - raised at the swap
                host_next.update(epoch=e, batches=exc)
                state["host_epoch"] = e
                ready.set()
                return
            host_next.update(epoch=e, batches=hb)
            state["host_epoch"] = e
            ready.set()
            wake.wait()  # taken: go augment the epoch after it
            wake.clear()
            e += 1

    if refresh:
        threading.Thread(target=producer, daemon=True, name=f"dr-refresh-{name}").start()
    elif hasattr(loader, "close"):
        loader.close()

    def replay(epoch: int) -> Iterator[Dict[str, Any]]:
        cur = state["batches"]
        staging = None
        if refresh and epoch > 0:
            if ready.is_set() and host_next["epoch"] is not None:
                staging = host_next["batches"]
                if isinstance(staging, BaseException):
                    raise staging
                state["fresh_epochs"] += 1
            else:
                state["stale_epochs"] += 1
        order = np.arange(len(cur))
        if reshuffle and epoch > 0:
            np.random.default_rng(seed + epoch).shuffle(order)
        stream = torch.cuda.Stream(device) if cuda and staging is not None else None
        staged: List[Dict[str, Any]] = []
        pending = None  # (batch, event) of the copy in flight

        def finish(p):
            if p is not None:
                if p[1] is not None:
                    p[1].synchronize()
                staged.append(p[0])

        def start(host_batch):
            if stream is None:
                return to_device(host_batch), None
            with torch.cuda.stream(stream):
                b = to_device(host_batch, pin=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            return b, ev

        for n, i in enumerate(order):
            if staging is not None and n < len(staging):
                finish(pending)  # one copy in flight at a time
                pending = start(staging[n])
            yield cur[int(i)]
        if staging is not None:
            finish(pending)
            for n in range(len(staged), len(staging)):  # a longer new epoch
                finish(start(staging[n]))
            if stream is not None:
                current = torch.cuda.current_stream(device)
                current.wait_stream(stream)
                for b in staged:
                    for v in b.values():
                        v.record_stream(current)
            state["batches"] = staged
            state["host_epoch"] = None
            host_next.update(epoch=None, batches=None)
            ready.clear()
            wake.set()  # let the producer start the following epoch

    def close():
        stop.set()
        wake.set()
        if hasattr(loader, "close"):
            loader.close()

    replay.close = close
    replay.total_bytes = total * (2 if refresh else 1)
    replay.steps_per_epoch = getattr(loader, "steps_per_epoch", len(batches))
    replay.stats = state
    replay.per_rank = shard is not None or getattr(loader, "per_rank", False)
    if name:
        print(f"[device-resident] {name}: staged {len(batches)} batches "
              f"({total / 2**20:.0f} MiB) on {device}"
              + (" [refresh double-buffer]" if refresh else ""), flush=True)
    return replay
