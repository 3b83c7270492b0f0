"""Process-group bootstrap (``prpe_tpu/parallel/distributed.py``): one
process per device, joined by ``torch.distributed``, the NCCL backend on
CUDA and gloo on the CPU.

Two ways in, as the reference's ``init_process_group(backend='nccl',
init_method='env://')`` (training/yolopt/main.py:271-277) and the JAX
package's explicit coordinator:

    from prpe_tpu_torch.parallel import distributed
    distributed.initialize()                 # torchrun: RANK, WORLD_SIZE,
                                             # LOCAL_RANK, MASTER_ADDR/PORT
    distributed.initialize(                  # explicit rendezvous
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=rank)

One departure from the JAX package: where a rendezvous was asked for and
fails, ``initialize`` raises. JAX logs it and carries on as one process
(``prpe_tpu/parallel/distributed.py:81-84``), which would train with the
wrong share of the batch and no error.

Each process reads the samples of its mesh data coordinates: the training
CLI passes them to its loaders (``parallel/mesh.py``,
``data/pipeline.py::LimitedSampler``).
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_initialized = False
_device: Optional[torch.device] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: Optional[str] = None,
               device=None, timeout_s: float = 600.0, shutdown_at_exit: bool = True) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` ``host:port`` (``tcp://``) or any init method
    URL (``file://``, ``tcp://``, ``env://``) with ``num_processes`` and
    ``process_id``; without one, the launcher's ``RANK`` / ``WORLD_SIZE``
    and ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``); one process without
    a coordinator needs no rendezvous (a store in memory). The backend is
    NCCL for a CUDA device and gloo for the CPU unless ``backend`` names
    one; the device is ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the
    process id) where CUDA is present, else the CPU, unless ``device`` names
    one. Raises when the rendezvous fails or no process count is known.
    """
    global _initialized, _device
    if _initialized or dist.is_initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise RuntimeError(f"distributed.initialize: a process group of "
                               f"{dist.get_world_size()} is up, not of {num_processes}")
        _initialized = True
        return
    if coordinator_address is None:
        init_method = "env://"
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        rank = process_id if process_id is not None else _env_int("RANK")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    if world is None or rank is None:
        raise RuntimeError(
            "distributed.initialize: no process count or process id (pass num_processes "
            "and process_id, or launch with torchrun, which sets RANK and WORLD_SIZE)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if device is None:
        device = (torch.device("cuda", local_rank % torch.cuda.device_count())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    rendezvous = ({"store": dist.HashStore()} if coordinator_address is None and world == 1
                  else {"init_method": init_method})
    try:
        dist.init_process_group(backend, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s),
                                device_id=device if backend == "nccl" else None, **rendezvous)
    except Exception as e:
        raise RuntimeError(f"distributed.initialize: the rendezvous at {init_method} "
                           f"(process {rank} of {world}, {backend}) failed: {e}") from e
    _initialized, _device = True, device
    logger.info("process group up: process %d/%d, %s on %s", rank, world, backend, device)
    if shutdown_at_exit:
        atexit.register(shutdown)


def shutdown() -> None:
    """Leave the process group (``destroy_process_group``)."""
    global _initialized, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _device = False, None


def local_device() -> Optional[torch.device]:
    """The device ``initialize`` bound this process to (None before)."""
    return _device


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (the reference
    gates on rank 0, yolopt/main.py:34,135)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_hosts(name: str = "barrier") -> None:
    """A barrier over every process; nothing without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
