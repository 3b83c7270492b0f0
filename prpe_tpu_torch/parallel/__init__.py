"""Data- and class-parallel training over ``torch.distributed``
(``prpe_tpu/parallel/``): the process-group bootstrap, the (data, model)
mesh with its sharding rules, and the collectives that GSPMD inserts in the
JAX package."""

from prpe_tpu_torch.parallel import collectives, distributed
from prpe_tpu_torch.parallel.mesh import (
    batch_sharding,
    build_mesh,
    make_param_shardings,
    replicated,
    shard_batch,
)

__all__ = [
    "batch_sharding",
    "build_mesh",
    "collectives",
    "distributed",
    "make_param_shardings",
    "replicated",
    "shard_batch",
]
