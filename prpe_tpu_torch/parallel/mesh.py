"""The (data, model) process mesh and its sharding rules
(``prpe_tpu/parallel/mesh.py``).

The JAX package runs one program over a **global** batch on a 2-axis
``Mesh``: ``data`` splits the batch (DDP's all-reduce of the gradients and
SyncBatchNorm come from the global-mean loss under GSPMD) and ``model``
splits the AdaFace classifier ``face_kernel`` (E, C) by class. The port runs
one process per device on a ``torch.distributed.device_mesh`` of the same
shape (ranks in row-major order, as ``np.reshape(devices, (dp, mp))``):

* a data rank takes its block of ``batch / dp`` rows of each global batch;
  the ranks of one model group (one data index) take the same rows;
* each model rank holds ``face_kernel[:, c0:c1]``; everything else is
  replicated;
* the reductions GSPMD makes global are collectives over the mesh's
  ``data_group`` and ``model_group`` (``parallel/collectives.py``).

A mesh built without a process group has shape (1, 1) and no groups: every
collective is then the identity.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from prpe_tpu_torch.core.config import MeshConfig
from prpe_tpu_torch.parallel import collectives as C

# the parameters split over the model axis, by name, and their split dim
SHARDED_PARAMS = {"face_kernel": 1}


class Spec(NamedTuple):
    """Where a tensor is split: ``axis`` (None: replicated) along ``dim``
    (``PartitionSpec`` of the JAX package, for the one dim that splits)."""

    axis: Optional[str] = None
    dim: int = 0


class Mesh:
    """Shape, this process's coordinates and the axes' process groups."""

    def __init__(self, shape: Tuple[int, int], axis_names=("data", "model"), device_mesh=None):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.data_group = self.model_group = self.world_group = None
            self.data_rank = self.model_rank = 0
        else:
            self.data_group = device_mesh.get_group(self.axis_names[0])
            self.model_group = device_mesh.get_group(self.axis_names[1])
            self.world_group = dist.group.WORLD
            self.data_rank = dist.get_rank(self.data_group)
            self.model_rank = dist.get_rank(self.model_group)

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def mp(self) -> int:
        return self.shape[1]

    @property
    def is_primary(self) -> bool:
        return self.data_rank == 0 and self.model_rank == 0

    def class_range(self, num_classes: int) -> Tuple[int, int]:
        """This model rank's classes [c0, c1) of ``num_classes``."""
        n = _split(num_classes, self.mp, "classes")
        return self.model_rank * n, (self.model_rank + 1) * n

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, data_rank={self.data_rank}, "
                f"model_rank={self.model_rank})")


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{n} {what} do not split into {parts} equal parts")
    return n // parts


def mesh_shape(cfg: MeshConfig, world_size: int) -> Tuple[int, int]:
    """(dp, mp) of ``cfg`` over ``world_size`` processes; ``data_parallel``
    -1 fills the world. Raises ``ValueError`` when dp * mp != world."""
    mp = max(1, cfg.model_parallel)
    dp = world_size // mp if cfg.data_parallel == -1 else cfg.data_parallel
    if dp * mp != world_size:
        raise ValueError(f"mesh {dp}x{mp} != {world_size} devices")
    return dp, mp


def build_mesh(cfg: MeshConfig = MeshConfig(), world_size: Optional[int] = None,
               device=None) -> Mesh:
    """The (data, model) mesh over the process group (a 2-D
    ``init_device_mesh`` of ``device``'s type). Without a process group,
    only a (1, 1) mesh with no groups; a larger one raises."""
    initialized = dist.is_available() and dist.is_initialized()
    world = world_size if world_size is not None else (
        dist.get_world_size() if initialized else 1)
    shape = mesh_shape(cfg, world)
    names = (cfg.data_axis, cfg.model_axis)
    if not initialized:
        if world != 1:
            raise RuntimeError(f"a {shape[0]}x{shape[1]} mesh needs torch.distributed: "
                               "call parallel.distributed.initialize first")
        return Mesh(shape, names)
    if world != dist.get_world_size():
        raise ValueError(f"mesh {shape[0]}x{shape[1]} != {dist.get_world_size()} processes")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type if device is not None else (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    return Mesh(shape, names, init_device_mesh(device_type, shape, mesh_dim_names=names))


# ----------------------------------------------------------------- batches

def batch_sharding(mesh: Mesh) -> Spec:
    """The leading (batch) dim split over the data axis."""
    return Spec(mesh.axis_names[0], 0)


def replicated(mesh: Mesh) -> Spec:
    return Spec(None, 0)


def shard(x, spec: Spec, mesh: Mesh):
    """This process's block of ``x`` (a tensor or numpy array) under
    ``spec``; ``x`` itself when replicated or the axis has size 1."""
    if spec.axis is None:
        return x
    parts = mesh.dp if spec.axis == mesh.axis_names[0] else mesh.mp
    if parts == 1:
        return x
    n = _split(x.shape[spec.dim], parts, f"entries of dim {spec.dim}")
    start = (mesh.data_rank if spec.axis == mesh.axis_names[0] else mesh.model_rank) * n
    index = [slice(None)] * x.ndim
    index[spec.dim] = slice(start, start + n)
    return x[tuple(index)]


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This data rank's rows of every array of a global batch."""
    spec = batch_sharding(mesh)
    return {k: (shard(v, spec, mesh) if getattr(v, "ndim", 0) >= 1 else v)
            for k, v in batch.items()}


# -------------------------------------------------------------- parameters

def make_param_shardings(mesh: Mesh, model) -> Dict[str, Spec]:
    """name -> ``Spec`` for each parameter of ``model``: the 2-D
    ``face_kernel`` split by class over the model axis, the rest
    replicated."""
    return {name: (Spec(mesh.axis_names[1], SHARDED_PARAMS[name])
                   if name in SHARDED_PARAMS and p.dim() == 2 else Spec())
            for name, p in model.named_parameters()}


@torch.no_grad()
def shard_params(model, mesh: Mesh) -> None:
    """Replace each split parameter of ``model`` (full size, equal on every
    rank) by this rank's block, in place, and tell the model its mesh
    (``model.set_mesh``, where it has one)."""
    for name, spec in make_param_shardings(mesh, model).items():
        if spec.axis is None:
            continue
        p = dict(model.named_parameters())[name]
        p.data = shard(p.data, spec, mesh).contiguous()
    if hasattr(model, "set_mesh"):
        model.set_mesh(mesh)


def _walk(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_walk(v, fn, key) for v in tree)
    if isinstance(tree, torch.Tensor) and key in SHARDED_PARAMS and tree.dim() == 2:
        return fn(tree, SHARDED_PARAMS[key])
    return tree


def gather_params(tree, mesh: Optional[Mesh]):
    """Every split tensor of a nested dict (a state dict, optimizer states,
    the EMA: the entries keyed by a split parameter's name) gathered to its
    full size over the model axis. Collective: every rank calls it."""
    if mesh is None or mesh.mp == 1:
        return tree
    return _walk(tree, lambda t, dim: C.all_gather(t, mesh.model_group, dim))


def slice_params(tree, mesh: Optional[Mesh]):
    """The inverse: each full-size split tensor of a nested dict cut to this
    rank's block (a checkpoint restored at another model-axis size)."""
    if mesh is None or mesh.mp == 1:
        return tree
    return _walk(tree, lambda t, dim: shard(t, Spec(mesh.axis_names[1], dim), mesh)
                 .contiguous())


# --------------------------------------------------------------- gradients

def _split_names(named: Dict[str, torch.Tensor]):
    split = {n for n, t in named.items() if n in SHARDED_PARAMS and t.dim() == 2}
    return split, [n for n in named if n not in split]


def all_reduce_gradients(grads: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> None:
    """The gradient of the global loss from each rank's share, in place:
    each gradient summed over the data axis through one flat buffer per
    dtype (DDP's all-reduce, without its wrapper). The replicated ones are
    summed over the whole mesh and divided by the model axis's size: the
    ranks of one model group hold equal gradients, and the mean keeps their
    parameters bit-equal where the card's kernels are not deterministic."""
    if mesh is None or mesh.data_group is None:
        return
    split, repl = _split_names(grads)
    for names, group, scale in ((repl, mesh.world_group if mesh.mp > 1 else mesh.data_group,
                                 mesh.mp), (sorted(split), mesh.data_group, 1)):
        by_dtype: Dict[torch.dtype, list] = {}
        for n in names:
            by_dtype.setdefault(grads[n].dtype, []).append(grads[n])
        for tensors in by_dtype.values():
            C.all_reduce_coalesced_(tensors, group)
            if scale > 1:
                torch._foreach_div_(tensors, float(scale))


def global_norm(named: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """sqrt of the sum of squares (fp32 at least) of every element of the
    whole tensors: the split ones' squares added over the model axis."""
    from prpe_tpu_torch.train.optim import sum_of_squares

    split, repl = _split_names(named)
    sq = [sum_of_squares(named[n]) for n in repl]
    total = (torch.stack(sq).sum() if sq
             else torch.zeros((), device=next(iter(named.values())).device))
    if split:
        total = total + C.sharded_sum_of_squares([named[n] for n in sorted(split)],
                                                 None if mesh is None else mesh.model_group)
    return total.sqrt()
