"""Parallel host input pipeline: pre-forked decode workers + shared memory
(``prpe_tpu/data/loader.py``, an own copy).

The reference's multi-worker torch DataLoader (reference:
training/yolopt/main.py:48-49 ``DataLoader(num_workers=8, pin_memory=True)``,
training/lightning/object_detection/datamodule.py:287-305
``num_workers=4``), redesigned:

  * **pre-forked pool, persistent across epochs** — the pool lives for the
    run, as ``persistent_workers=True`` would keep torch's.
  * **whole-batch work units in shared memory** — each task is one *batch*
    (indices + slot id); the worker decodes, augments and collates directly
    into a preallocated anonymous shared mapping. One wakeup and zero
    pickling per batch, vs torch's per-sample IPC + collate in the parent.
    The parent's prefetcher (``data/pipeline.py``) copies the slot's views
    into pinned memory and then recycles the slot.
  * **deterministic batch order** — tasks carry sequence numbers; results
    are re-ordered in the parent, so output is reproducible for any worker
    count (same property torch guarantees).

Workers are forked (the parent may already hold a CUDA context) and run the
dataset's ``__getitem__`` and the collate only: numpy and the native host
library, never CUDA nor torch ops (torch's intra-op thread pool does not
survive a fork).

Per-worker RNG: each worker reseeds the dataset's augmentation RNG to
``seed + 1000003 * worker_id`` after fork, so workers do not repeat one
stream. Which worker takes a batch depends on which is free first, so with
augmentation the draws a batch gets vary from run to run; the order of the
batches and their un-augmented content do not (as in the JAX package,
whose docstring claims more, ROADMAP.md §3).
"""

from __future__ import annotations

import mmap
import multiprocessing as mp
import queue
import traceback
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BatchSpec", "MultiprocessLoader"]

_ALIGN = 128  # slot-internal alignment so each array starts on a cache line


class BatchSpec:
    """Fixed byte layout of one collated batch: key -> (shape, dtype, offset)."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.layout: Dict[str, Tuple[Tuple[int, ...], np.dtype, int]] = {}
        off = 0
        for k in sorted(arrays):
            a = np.asarray(arrays[k])
            self.layout[k] = (a.shape, a.dtype, off)
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        self.nbytes = max(off, _ALIGN)

    def views(self, buf: memoryview) -> Dict[str, np.ndarray]:
        out = {}
        for k, (shape, dtype, off) in self.layout.items():
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out[k] = np.frombuffer(buf[off : off + n], dtype=dtype).reshape(shape)
        return out

    def write(self, buf: memoryview, batch: Dict[str, np.ndarray]) -> None:
        views = self.views(buf)
        for k, v in views.items():
            src = np.asarray(batch[k])
            if src.shape != v.shape or src.dtype != v.dtype:
                raise ValueError(
                    f"batch key {k!r}: got {src.dtype}{src.shape}, "
                    f"slot expects {v.dtype}{v.shape} (batches must be "
                    "fixed-shape for shared-memory slots)"
                )
            v[...] = src


def _worker_main(
    worker_id: int,
    dataset,
    collate: Callable,
    spec: BatchSpec,
    slots: List[mmap.mmap],
    task_q,
    result_q,
    seed: int,
):
    # Re-seed augmentation RNG per worker (forked copy would otherwise
    # duplicate the parent's stream in every worker).
    rng = getattr(dataset, "_rng", None)
    if rng is not None:
        dataset._rng = np.random.default_rng(seed + 1000003 * worker_id)
    base = getattr(dataset, "base", None)  # mosaic wrapper holds the base ds
    if base is not None and getattr(base, "_rng", None) is not None:
        base._rng = np.random.default_rng(seed + 1000003 * worker_id + 1)

    while True:
        task = task_q.get()
        if task is None:
            return
        seq, slot, indices = task
        try:
            samples = [dataset[int(i)] for i in indices]
            spec.write(memoryview(slots[slot]), collate(samples))
            result_q.put((seq, slot, None))
        except Exception:  # noqa: BLE001 — relayed to parent
            result_q.put((seq, slot, traceback.format_exc()))


class MultiprocessLoader:
    """Pre-forked worker pool producing collated batches in shared memory.

    ``dataset`` must be index-addressable with fixed-shape sample dicts (all
    the port's datasets are). The pool is created once and reused across
    epochs; ``run(batches)`` streams one epoch of index lists through it.
    """

    def __init__(
        self,
        dataset,
        collate: Callable[[List[Dict[str, np.ndarray]]], Dict[str, np.ndarray]],
        batch_size: int,
        num_workers: int = 2,
        prefetch: int = 2,
        seed: int = 0,
        timeout: float = 300.0,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.timeout = timeout
        self._closed = False

        # Discover the batch byte layout from one real batch built in the
        # parent (also validates the dataset before forking).
        probe = collate([dataset[i % len(dataset)] for i in range(batch_size)])
        self.spec = BatchSpec(probe)

        # Anonymous MAP_SHARED slots: forked workers inherit the mappings
        # directly — no /dev/shm names, no resource tracker, freed by the OS
        # when the last process exits (robust against consumers still holding
        # numpy views at close time, unlike multiprocessing.shared_memory).
        n_slots = num_workers + max(prefetch, 1)
        self._slots = [mmap.mmap(-1, self.spec.nbytes) for _ in range(n_slots)]
        self._free: "queue.SimpleQueue[int]" = queue.SimpleQueue()
        for i in range(n_slots):
            self._free.put(i)

        # fork: workers inherit the dataset (open label caches, file lists)
        # and the slot mappings with no pickling — same start method the
        # reference relies on (yolopt/util.py:28-30 forces 'fork').
        ctx = mp.get_context("fork")
        self._task_q = ctx.SimpleQueue()
        self._result_q = ctx.SimpleQueue()
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(w, dataset, collate, self.spec, self._slots,
                      self._task_q, self._result_q, seed),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self._procs:
            p.start()

    # -- epoch streaming ---------------------------------------------------

    def run(self, indices: Sequence[int], drop_last: bool = True
            ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield collated batches for ``indices`` in deterministic order.

        Yielded arrays are views into a shared-memory slot that is recycled
        on the NEXT ``next()`` call — consume (copy) each batch before
        advancing.
        """
        if self._closed:
            raise RuntimeError("loader is closed")
        n = len(indices)
        nb = n // self.batch_size if drop_last else -(-n // self.batch_size)
        batches = [
            np.asarray(indices[i * self.batch_size : (i + 1) * self.batch_size])
            for i in range(nb)
        ]

        issued = 0
        done: Dict[int, int] = {}
        next_out = 0
        hold: Optional[int] = None  # slot the consumer is currently reading
        failed = 0  # results already collected with an error
        try:
            while next_out < nb:
                # keep every free slot filled with outstanding work
                while issued < nb:
                    try:
                        slot = self._free.get_nowait()
                    except queue.Empty:
                        break
                    self._task_q.put((issued, slot, batches[issued]))
                    issued += 1
                if next_out in done:
                    slot = done.pop(next_out)
                    if hold is not None:
                        self._free.put(hold)  # recycle previous batch's slot
                    hold = slot
                    next_out += 1
                    yield self.spec.views(memoryview(self._slots[slot]))
                    continue
                seq, slot, err = self._collect()
                if err is not None:
                    self._free.put(slot)
                    failed += 1
                    raise RuntimeError(
                        f"dataloader worker failed on batch {seq}:\n{err}"
                    )
                done[seq] = slot
        finally:
            if hold is not None:
                self._free.put(hold)
            # drain stragglers so slots return to the pool (generator may be
            # closed early, e.g. a LimitedSampler epoch or an exception); a
            # failed batch's result is already in (the JAX package's loader
            # waits for it until its timeout, ROADMAP.md §3)
            outstanding = issued - next_out - len(done) - failed
            for _ in range(max(outstanding, 0)):
                try:
                    _, slot, _ = self._collect()
                    self._free.put(slot)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    break
            for slot in done.values():
                self._free.put(slot)

    def _collect(self) -> Tuple[int, str, Optional[str]]:
        """Result-queue get with liveness checks (a SIGKILLed worker would
        otherwise hang the parent forever)."""
        import time

        deadline = time.monotonic() + self.timeout
        while True:
            # SimpleQueue has no timeout; poll the underlying pipe
            if self._result_q._reader.poll(1.0):  # noqa: SLF001
                return self._result_q.get()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no batch from workers within {self.timeout}s"
                )
            for p in self._procs:
                if not p.is_alive():
                    raise RuntimeError(
                        f"dataloader worker pid={p.pid} died "
                        f"(exitcode={p.exitcode})"
                    )

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for m in self._slots:
            try:
                m.close()
            except BufferError:
                # a consumer still holds views into this slot; the anonymous
                # mapping is freed by the OS once those arrays are collected
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; explicit close() is the contract
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
