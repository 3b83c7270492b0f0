"""The collectives that GSPMD inserts in the JAX package, written out.

Under ``jax.jit`` with a (data, model) mesh every reduction over the batch
or over the classes is global without a line of code
(``prpe_tpu/parallel/mesh.py:1-21``): BatchNorm's statistics
(``prpe_tpu/nn/common.py``), the YOLO loss normaliser
(``prpe_tpu/ops/losses.py:168``), the AdaFace norm statistics
(``prpe_tpu/ops/margin.py:90-91``), the softmax over the class-sharded
logits and their argmax (``prpe_tpu/train/steps.py``), the gradient of the
global-mean loss and its global norm (``prpe_tpu/train/optim.py``). With one
process per device each of them is a ``torch.distributed`` call on a process
group, here and in the modules that use these functions.

``group=None`` means one process: every function is then the identity (or
its local counterpart), so the single-process path computes what it always
did. The autograd functions are small ``torch.autograd.Function``s
(``torch.distributed.nn.functional`` is deprecated); the vocab-parallel
cross-entropy is Megatron-LM's.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group`` (nothing for one process); returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_coalesced_(tensors: Sequence[torch.Tensor], group,
                          op=ReduceOp.SUM) -> None:
    """All-reduce many tensors of one dtype and device in place through one
    flat buffer: one collective instead of one per tensor."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op, group=group)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order; ``t`` itself for one process. No gradient."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_object(obj, group) -> List:
    """Every rank's picklable ``obj`` in rank order; ``[obj]`` alone."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ------------------------------------------------------- autograd functions

class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a replicated input whose
    consumers on each rank see part of the output (the embeddings entering
    the class-sharded logits), so that the producer gets the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: partial results of one
    replicated value."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, group_rank(ctx.group) * ctx.n, ctx.n), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return x if group is None else _GatherFromGroup.apply(x, group, dim % x.dim())


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Softmax cross-entropy over logits whose class dimension is split over
    ``group``: the row max, the sum of exponentials and the label's logit
    are all-reduced; the backward, softmax minus one-hot, is local."""

    @staticmethod
    def forward(ctx, logits, labels, class_offset, group):
        n_local = logits.shape[-1]
        m = all_reduce_(logits.detach().amax(-1), group, ReduceOp.MAX)
        shifted = logits - m[..., None]
        e = torch.exp(shifted)
        sum_e = all_reduce_(e.sum(-1), group)
        local = labels.long() - class_offset
        hit = (local >= 0) & (local < n_local)
        target = torch.gather(shifted, -1, local.clamp(0, n_local - 1)[..., None])[..., 0]
        target = all_reduce_(torch.where(hit, target, torch.zeros_like(target)), group)
        ctx.save_for_backward(e / sum_e[..., None], local, hit)
        return torch.log(sum_e) - target

    @staticmethod
    def backward(ctx, g):
        softmax, local, hit = ctx.saved_tensors
        grad = softmax.clone()
        rows = hit.nonzero(as_tuple=True)
        grad[rows + (local[rows],)] -= 1.0
        return grad * g[..., None], None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 class_offset: int, group) -> torch.Tensor:
    """(..., C_local) logits of classes ``class_offset`` ... on this rank,
    (...,) global labels -> the (...,) cross-entropy over all classes."""
    return _VocabParallelCrossEntropy.apply(logits, labels, class_offset, group)


@torch.no_grad()
def vocab_parallel_argmax(logits: torch.Tensor, class_offset: int, group) -> torch.Tensor:
    """The global argmax of class-sharded logits: the largest value wins,
    ties go to the lowest class, as ``argmax`` over the whole row does."""
    value, index = logits.amax(-1), logits.argmax(-1)
    best = all_reduce_(value.clone(), group, ReduceOp.MAX)
    cand = torch.where(value == best, index + class_offset,
                       torch.full_like(index, torch.iinfo(index.dtype).max))
    return all_reduce_(cand, group, ReduceOp.MIN)


def sharded_sum_of_squares(tensors: Sequence[torch.Tensor], group) -> torch.Tensor:
    """Sum of squares (fp32 at least) of the shards of tensors split over
    ``group``, added over the group."""
    sq = []
    for t in tensors:
        t = t.to(torch.promote_types(t.dtype, torch.float32))
        sq.append((t * t).sum())
    return all_reduce_(torch.stack(sq).sum(), group)
